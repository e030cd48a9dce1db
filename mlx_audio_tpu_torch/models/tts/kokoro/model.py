"""Kokoro-82M, non-autoregressive TTS (counterpart of
``mlx_audio_tpu/models/tts/kokoro/model.py``).

Two stages, both batched and mask-exact under bucket padding:

* ``duration_stage``: PLBERT -> prosody text encoder -> BiLSTM -> duration
  head; emits the duration-context features and integer durations.
* ``synthesis_stage``: the alignment matrix as a cumsum-compare, F0/N
  prediction, text encoding and the ISTFTNet decoder, at a frame bucket.

The only host sync between the stages is the duration read-out that picks
the frame bucket.  PyTorch runs eagerly, so the stages are plain functions.

Under an active mesh with dp > 1 (``parallel.context``) a batch pads to a
dp multiple by repeating its last row; every data replica runs the
duration stage on its slice at the whole batch's phoneme bucket, the frame
bucket is picked from every real row, and each replica then synthesizes
its slice at that bucket with its rows' own source draws, so a row computes
as it does in the whole batch.  ``generate`` then synthesizes all its
segments in that one batched pass.  When the mesh spans a process group
(``parallel.distributed``), every process is given the whole batch, runs
the data rows of its own devices, and gathers the durations (for the frame
bucket) and the audio of every row from the group.
"""

from __future__ import annotations

import json
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
from mlx_audio_tpu_torch.models.tts.kokoro.istftnet import Decoder, source_noise
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
                         speeds=None, seed: int = 0, buckets=None, rows=None):
        """Batched synthesis: B phoneme strings -> list of (audio, pred_dur).

        One duration pass and one synthesis pass for the whole batch, with
        ragged lengths through per-row masks: durations are bit-exact with
        respect to single-row runs, and so are the source's draws, which
        are per row.  ``buckets`` (phoneme bucket, frame bucket) runs the
        batch at those, which must fit it, in place of the least that do;
        ``rows`` gives row i the source draws of batch row ``rows[i]``.
        With both, a string alone computes as it does in a larger batch.
        """
        from mlx_audio_tpu_torch.parallel.context import data_parallel, pad_list

        b = len(phonemes_list)
        toks = [[0, *self.phonemes_to_ids(p), 0] for p in phonemes_list]
        n_valid = [len(t) for t in toks]
        if max(n_valid) > self.context_length:
            raise ValueError(f"phoneme sequence too long: {max(n_valid)} > "
                             f"{self.context_length}")
        bucket = pick_phoneme_bucket(max(n_valid)) if buckets is None else buckets[0]
        ref_rows = list(np.asarray(ref_s, dtype=np.float32).reshape(b, -1))
        speed_rows = list(np.broadcast_to(np.asarray(
            1.0 if speeds is None else speeds, np.float32), (b,)))
        dp = data_parallel(b) if buckets is None and rows is None else None
        if dp is None:
            models, slices = [self], [(0, b)]
        else:
            toks, ref_rows, speed_rows = (pad_list(dp, x) for x in (toks, ref_rows, speed_rows))
            replicas, row_slices = dp.place_replicated(self), dp.row_slices(len(toks))
            models = [replicas[r] for r in dp.own_rows()]
            slices = [row_slices[r] for r in dp.own_rows()]
        stages = [m._duration_pass(toks[lo:hi], ref_rows[lo:hi], speed_rows[lo:hi], bucket)
                  for m, (lo, hi) in zip(models, slices)]
        pred_np = np.concatenate([st[3].cpu().numpy() for st in stages])
        if dp is not None:
            pred_np = dp.gather_rows(pred_np)
        totals = pred_np.sum(axis=1)
        f_bucket = pick_frame_bucket(int(totals[:b].max())) if buckets is None else buckets[1]
        audio = []
        for m, (lo, hi), st in zip(models, slices, stages):
            own = rows if rows is not None else None if dp is None else range(lo, hi)
            draws = (None, None) if own is None else source_noise(
                hi - lo, self.SAMPLES_PER_FRAME * f_bucket,
                self.decoder.generator.m_source.l_sin_gen.dim, m.device, seed, rows=own)
            out, _ = synthesis_stage(m, *st, f_bucket, *draws, seed=seed)
            audio.append(out.float().cpu().numpy())
        audio_np = np.concatenate(audio)
        if dp is not None:
            audio_np = dp.gather_rows(audio_np)
        return [(audio_np[i, :int(totals[i]) * self.SAMPLES_PER_FRAME],
                 pred_np[i, :n_valid[i]]) for i in range(b)]

    def _duration_pass(self, toks: list, ref_rows: list, speed_rows: list,
                       bucket: int) -> tuple:
        """Rows of ids ``toks`` padded to ``bucket``, on this model's device,
        through the duration stage: (input_ids, lengths, d, pred_dur, ref),
        the arguments of ``synthesis_stage`` before the frame bucket."""
        ids = np.zeros((len(toks), bucket), dtype=np.int64)
        for i, t in enumerate(toks):
            ids[i, :len(t)] = t
        dev = self.device
        input_ids = torch.as_tensor(ids, device=dev)
        lengths = torch.as_tensor([len(t) for t in toks], device=dev)
        ref = torch.as_tensor(np.stack(ref_rows), device=dev)
        speed = torch.as_tensor(np.asarray(speed_rows, np.float32), device=dev)
        d, pred_dur = duration_stage(self, input_ids, lengths, ref[:, 128:], speed)
        return input_ids, lengths, d, pred_dur, ref

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
        """Text -> audio segments with the standard metrics record.  Under a
        mesh with dp > 1 every segment synthesizes in one batched pass."""
        from mlx_audio_tpu_torch.parallel.context import data_parallel

        pipeline = KokoroPipeline(model=self, lang_code=lang_code)
        if data_parallel() is not None:
            pack = pipeline.load_voice(voice)
            start = time.time()
            segs = list(pipeline.iter_phoneme_segments(text, split_pattern))
            if not segs:
                return
            refs = np.stack([pack[len(ps) - 1].reshape(-1) for _, ps, _ in segs])
            outs = self.synthesize_batch([ps for _, ps, _ in segs], refs, speeds=speed)
            elapsed = time.time() - start
            for idx, ((_, ps, _), (audio, _)) in enumerate(zip(segs, outs)):
                yield make_generation_result(
                    audio=audio, sample_rate=self.config.sample_rate,
                    segment_idx=idx, token_count=len(ps) if ps else 0,
                    segment_time=elapsed / len(segs), device=self.device)
            return
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

    # -- serving -----------------------------------------------------------

    def prewarm(self, max_phonemes: int = 128, frames_per_phoneme: int = 3,
                batch_sizes=(1,), generator: Optional[torch.Generator] = None) -> int:
        """Run every stage shape a live request can reach before traffic
        arrives: for each batch size, one ``duration_stage`` call a phoneme
        bucket up to ``max_phonemes``'s, and one ``synthesis_stage`` call a
        frame bucket up to ``frames_per_phoneme`` frames a phoneme of that
        bucket (the JAX package's grid; pred_dur is at least 1, and real
        speech sits near 2.5 frames a phoneme).  The dummy inputs have the
        dtypes ``synthesize`` gives the stages; the source's draws come from
        ``generator``, or, when it is None, from seed 0's row generators as
        a ``synthesize`` draws them.

        Eager PyTorch keeps no compiled graph a shape, so what this warms on
        the card is a process's first use of each library: the first
        ``build.load`` of each kernel the path launches (an ``nvcc`` build
        when the build cache is cold), cuBLAS's and cuDNN's handles and
        algorithm choices, and the caching allocator's growth to the
        largest bucket.  Synchronizes the device at the end; returns the
        number of stage calls."""
        dev = self.device
        harmonics = self.decoder.generator.m_source.l_sin_gen.dim
        issued = 0
        top = pick_phoneme_bucket(max_phonemes)
        for b in batch_sizes:
            for p in PHONEME_BUCKETS:
                if p > top:
                    break
                input_ids = torch.zeros((b, p), dtype=torch.int64, device=dev)
                lengths = torch.full((b,), p, dtype=torch.int64, device=dev)
                ref_s = torch.zeros((b, 256), dtype=torch.float32, device=dev)
                speed = torch.ones((b,), dtype=torch.float32, device=dev)
                d, pred_dur = duration_stage(self, input_ids, lengths, ref_s[:, 128:], speed)
                issued += 1
                f_max = pick_frame_bucket(p * frames_per_phoneme)
                for f in range(FRAME_BUCKET_STEP, f_max + 1, FRAME_BUCKET_STEP):
                    draws = (None, None) if generator is None else (
                        torch.randn((b, harmonics), generator=generator, device=dev),
                        torch.randn((b, self.SAMPLES_PER_FRAME * f, harmonics),
                                    generator=generator, device=dev))
                    synthesis_stage(self, input_ids, lengths, d, pred_dur, ref_s, f,
                                    *draws)
                    issued += 1
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return issued

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


def load_config(config_path_or_dict) -> ModelConfig:
    """A ``ModelConfig`` from a dict or from a ``config.json`` path."""
    if isinstance(config_path_or_dict, dict):
        return ModelConfig.from_dict(config_path_or_dict)
    with open(config_path_or_dict) as f:
        return ModelConfig.from_dict(json.load(f))
