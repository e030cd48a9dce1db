"""Kokoro-82M, non-autoregressive TTS (counterpart of
``mlx_audio_tpu/models/tts/kokoro/model.py``).

Two stages, both batched and mask-exact under bucket padding:

* ``duration_stage``: PLBERT -> prosody text encoder -> BiLSTM -> duration
  head; emits the duration-context features and integer durations.
* ``synthesis_stage``: the alignment matrix as a cumsum-compare, F0/N
  prediction, text encoding and the ISTFTNet decoder, at a frame bucket.

The only host sync between the stages is the duration read-out that picks
the frame bucket.  PyTorch runs eagerly, so the stages are plain functions.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np
import torch
from torch import nn

from mlx_audio_tpu_torch.models.base import (
    BaseModelArgs,
    GenerationResult,
    check_array_shape,
    init_weights,
    make_generation_result,
    model_device,
)
from mlx_audio_tpu_torch.models.tts.kokoro.albert import (
    AlbertModelArgs,
    CustomAlbert,
)
from mlx_audio_tpu_torch.models.tts.kokoro.istftnet import Decoder
from mlx_audio_tpu_torch.models.tts.kokoro.modules import (
    ProsodyPredictor,
    TextEncoder,
)
from mlx_audio_tpu_torch.models.tts.kokoro.pipeline import KokoroPipeline
from mlx_audio_tpu_torch.nn import Linear, promote_operands


@dataclass
class ModelConfig(BaseModelArgs):
    istftnet: dict
    dim_in: int
    dropout: float
    hidden_dim: int
    max_conv_dim: int
    max_dur: int
    multispeaker: bool
    n_layer: int
    n_mels: int
    n_token: int
    style_dim: int
    text_encoder_kernel_size: int
    plbert: dict
    vocab: Dict[str, int]
    sample_rate: int = 24000


PHONEME_BUCKETS = (16, 32, 64, 128, 256, 512)
FRAME_BUCKET_STEP = 100


def pick_phoneme_bucket(n: int) -> int:
    for b in PHONEME_BUCKETS:
        if n <= b:
            return b
    raise ValueError(f"phoneme sequence too long: {n}")


def pick_frame_bucket(total: int) -> int:
    return max(FRAME_BUCKET_STEP,
               -(-total // FRAME_BUCKET_STEP) * FRAME_BUCKET_STEP)


@torch.no_grad()
def duration_stage(model: "Model", input_ids: torch.Tensor,
                   lengths: torch.Tensor, style: torch.Tensor,
                   speed: torch.Tensor):
    """input_ids [B, N], lengths [B], style [B, 128] (prosody half),
    speed [B] -> (d [B, N, C+S], pred_dur int32 [B, N])."""
    n = input_ids.shape[1]
    pad_mask = torch.arange(n, device=input_ids.device)[None, :] >= lengths[:, None]
    bert_out, _ = model.bert(input_ids, attention_mask=(~pad_mask).int())
    d_en = model.bert_encoder(bert_out)
    d = model.predictor.text_encoder(d_en, style, lengths, pad_mask)
    dur_logits = model.predictor.predict_durations(d, lengths)
    duration = torch.sigmoid(dur_logits).sum(dim=-1) / speed[:, None]
    # torch.round, like jnp.round, rounds half to even
    pred_dur = torch.clamp(torch.round(duration), min=1).to(torch.int32)
    pred_dur = torch.where(pad_mask, torch.zeros_like(pred_dur), pred_dur)
    return d, pred_dur


@torch.no_grad()
def synthesis_stage(model: "Model", input_ids: torch.Tensor,
                    lengths: torch.Tensor, d: torch.Tensor,
                    pred_dur: torch.Tensor, ref_s: torch.Tensor,
                    num_frames: int, rand_ini: Optional[torch.Tensor] = None,
                    noise: Optional[torch.Tensor] = None, seed: int = 0):
    """Frame-bucketed synthesis at ``num_frames`` frames.  ``rand_ini``
    [B, 9] and ``noise`` [B, 600 num_frames, 9] are the source's draws,
    drawn from ``seed`` when not given.  Returns (audio [B, 600 F],
    total_frames [B])."""
    n = input_ids.shape[1]
    dev = input_ids.device
    pad_mask = torch.arange(n, device=dev)[None, :] >= lengths[:, None]
    style_p = ref_s[:, 128:]
    style_d = ref_s[:, :128]

    cum = torch.cumsum(pred_dur, dim=-1)           # [B, N]
    start = cum - pred_dur
    t_idx = torch.arange(num_frames, device=dev)[None, None, :]
    aln = ((t_idx >= start[..., None])
           & (t_idx < cum[..., None])).to(d.dtype)  # [B, N, F]
    total = torch.clamp(cum[:, -1], max=num_frames)

    en = torch.einsum("bnc,bnf->bfc", d, aln)
    f0_pred, n_pred = model.predictor.F0Ntrain(en, style_p, frame_lengths=total)
    t_en = model.text_encoder(input_ids, lengths, pad_mask)
    # the text encoder's bf16 against a float32 alignment (float32 style in
    # a bf16 model) promotes, as jnp.einsum does
    asr = torch.einsum("bnc,bnf->bfc", *promote_operands(t_en, aln))
    audio = model.decoder(asr, f0_pred, n_pred, style_d, rand_ini, noise,
                          seed, frame_lengths=total)
    return audio, total


class Model(nn.Module):
    """Kokoro model graph (language-blind; text processing lives in
    pipeline.py).

    Runs on ``device``, "cuda" unless the caller asks for "cpu"; weights
    are drawn from ``seed`` with the JAX package's init scales, and
    checkpoints load through ``sanitize`` + ``load_state_dict``.
    """

    SAMPLES_PER_FRAME = 600  # 24 kHz / (2x upsample * 10 * 6 * 5)

    def __init__(self, config: ModelConfig, device: str = "cuda",
                 seed: int = 0):
        super().__init__()
        device = model_device(device, "Model")
        self.config = config
        self.vocab = config.vocab
        self.bert = CustomAlbert(AlbertModelArgs.from_dict(
            {"vocab_size": config.n_token, **config.plbert}))
        self.bert_encoder = Linear(self.bert.config.hidden_size,
                                   config.hidden_dim)
        self.context_length = self.bert.config.max_position_embeddings
        self.predictor = ProsodyPredictor(
            style_dim=config.style_dim, d_hid=config.hidden_dim,
            nlayers=config.n_layer, max_dur=config.max_dur,
            dropout=config.dropout)
        self.text_encoder = TextEncoder(
            channels=config.hidden_dim,
            kernel_size=config.text_encoder_kernel_size,
            depth=config.n_layer, n_symbols=config.n_token)
        self.decoder = Decoder(dim_in=config.hidden_dim,
                               style_dim=config.style_dim,
                               dim_out=config.n_mels, **config.istftnet)
        init_weights(self, torch.Generator().manual_seed(seed))
        self.device = device
        self.to(device)

    @property
    def sample_rate(self) -> int:
        return self.config.sample_rate

    # -- synthesis ---------------------------------------------------------

    def phonemes_to_ids(self, phonemes: str) -> list[int]:
        return [self.vocab[p] for p in phonemes if p in self.vocab]

    def synthesize(self, phonemes: str, ref_s: np.ndarray, speed: float = 1.0,
                   seed: int = 0):
        """phonemes -> (audio np.float32 [T], pred_dur np.int32 [n])."""
        (audio, pred_dur), = self.synthesize_batch([phonemes], ref_s,
                                                   speeds=speed, seed=seed)
        return audio, pred_dur

    def synthesize_batch(self, phonemes_list: list, ref_s: np.ndarray,
                         speeds=None, seed: int = 0):
        """Batched synthesis: B phoneme strings -> list of (audio, pred_dur).

        One duration pass and one synthesis pass for the whole batch, with
        ragged lengths through per-row masks: durations are bit-exact with
        respect to single-row runs, and so are the source's draws, which
        are per row.
        """
        b = len(phonemes_list)
        toks = [[0, *self.phonemes_to_ids(p), 0] for p in phonemes_list]
        n_valid = [len(t) for t in toks]
        if max(n_valid) > self.context_length:
            raise ValueError(f"phoneme sequence too long: {max(n_valid)} > "
                             f"{self.context_length}")
        bucket = pick_phoneme_bucket(max(n_valid))
        ids = np.zeros((b, bucket), dtype=np.int64)
        for i, t in enumerate(toks):
            ids[i, :len(t)] = t
        dev = self.device
        input_ids = torch.as_tensor(ids, device=dev)
        lengths = torch.as_tensor(n_valid, device=dev)
        ref = torch.as_tensor(np.asarray(ref_s, dtype=np.float32).reshape(b, -1),
                              device=dev)
        if speeds is None:
            speeds = 1.0
        speed = torch.as_tensor(np.broadcast_to(
            np.asarray(speeds, np.float32), (b,)).copy(), device=dev)

        d, pred_dur = duration_stage(self, input_ids, lengths, ref[:, 128:],
                                     speed)
        pred_np = pred_dur.cpu().numpy()
        totals = pred_np.sum(axis=1)
        f_bucket = pick_frame_bucket(int(totals.max()))
        audio, _ = synthesis_stage(self, input_ids, lengths, d, pred_dur, ref,
                                   f_bucket, seed=seed)
        audio_np = audio.float().cpu().numpy()
        return [(audio_np[i, :int(totals[i]) * self.SAMPLES_PER_FRAME],
                 pred_np[i, :n_valid[i]]) for i in range(b)]

    def generate_batch(self, texts: list, voice: Optional[str] = None,
                       speed: float = 1.0, lang_code: str = "a",
                       split_pattern: str = r"\n+", **kwargs) -> list:
        """Batched text->speech: G2P each text on the host, then synthesize
        every resulting segment in one batched pass.  Returns one
        GenerationResult per input text (segments concatenated)."""
        pipeline = KokoroPipeline(model=self, lang_code=lang_code)
        pack = pipeline.load_voice(voice)
        start = time.time()

        seg_ps, owner = [], []
        for ti, text in enumerate(texts):
            for _, ps, _ in pipeline.iter_phoneme_segments(text, split_pattern):
                seg_ps.append(ps)
                owner.append(ti)
        if not seg_ps:
            return [make_generation_result(
                audio=np.zeros((0,), dtype=np.float32),
                sample_rate=self.config.sample_rate, segment_idx=ti,
                token_count=0, segment_time=0.0, device=self.device,
            ) for ti in range(len(texts))]
        refs = np.stack([pack[len(ps) - 1].reshape(-1) for ps in seg_ps])
        outs = self.synthesize_batch(seg_ps, refs, speeds=speed)

        elapsed = time.time() - start
        results = []
        for ti in range(len(texts)):
            segs = [outs[i] for i in range(len(outs)) if owner[i] == ti]
            # one result per text even when G2P yielded nothing: batched
            # servers match results to requests by index
            audio = (np.concatenate([a for a, _ in segs])
                     if segs else np.zeros((0,), dtype=np.float32))
            n_tok = sum(len(p) for i, p in enumerate(seg_ps) if owner[i] == ti)
            results.append(make_generation_result(
                audio=audio, sample_rate=self.config.sample_rate,
                segment_idx=ti, token_count=n_tok,
                segment_time=elapsed / len(texts), device=self.device,
            ))
        return results

    def generate(self, text: str, voice: Optional[str] = None,
                 speed: float = 1.0, lang_code: str = "a",
                 split_pattern: str = r"\n+",
                 **kwargs) -> Iterator[GenerationResult]:
        """Text -> audio segments with the standard metrics record."""
        pipeline = KokoroPipeline(model=self, lang_code=lang_code)
        start = time.time()
        for idx, (_, phonemes, audio) in enumerate(
            pipeline(text, voice=voice, speed=speed,
                     split_pattern=split_pattern)
        ):
            now = time.time()
            seg_time = now - start
            start = now
            yield make_generation_result(
                audio=audio, sample_rate=self.config.sample_rate,
                segment_idx=idx, token_count=len(phonemes) if phonemes else 0,
                segment_time=seg_time, device=self.device,
            )

    # -- checkpoint loading ------------------------------------------------

    def sanitize(self, weights: dict) -> dict:
        return sanitize(weights)


_LSTM_SUFFIXES = {
    "weight_ih_l0_reverse": "Wx_backward",
    "weight_hh_l0_reverse": "Wh_backward",
    "bias_ih_l0_reverse": "bias_ih_backward",
    "bias_hh_l0_reverse": "bias_hh_backward",
    "weight_ih_l0": "Wx_forward",
    "weight_hh_l0": "Wh_forward",
    "bias_ih_l0": "bias_ih_forward",
    "bias_hh_l0": "bias_hh_forward",
}


def sanitize(weights: dict) -> dict:
    """Map torch / MLX Kokoro checkpoint keys and layouts to this module's
    state_dict.  The port stores convs in torch's own layouts, so torch
    conv weights pass unchanged and MLX's [O, K, I] convs become [O, I, K].
    """
    out = {}
    for key, w in weights.items():
        w = np.asarray(w)
        if "position_ids" in key:
            continue
        renamed = next((key[:-len(s)] + new for s, new in _LSTM_SUFFIXES.items()
                        if key.endswith(s)), None)
        if renamed is not None:
            out[renamed] = w
        elif key.endswith(".gamma"):
            out[key[:-len(".gamma")] + ".weight"] = w
        elif key.endswith(".beta"):
            out[key[:-len(".beta")] + ".bias"] = w
        elif ".duration_proj.linear_layer." in key:
            out[key.replace(".linear_layer.", ".")] = w
        elif (".alpha1." in key or ".alpha2." in key) and w.ndim == 3:
            out[key] = w.reshape(-1)  # [1, C, 1] -> [C]
        elif (key.endswith(("weight_v", ".weight")) and w.ndim == 3
              and ".ups." not in key and ".pool." not in key
              and check_array_shape(w)):
            out[key] = w.transpose(0, 2, 1)  # MLX [O, K, I] -> [O, I, K]
        else:
            out[key] = w
    return out
