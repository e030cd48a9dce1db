"""Parakeet speech to text (NeMo lineage): a Conformer encoder and a TDT,
RNN-T or CTC decoder (counterpart of
``mlx_audio_tpu/models/stt/parakeet/parakeet.py``).

The JAX package runs the TDT and RNN-T greedy label loops as one jitted
``lax.while_loop``; here ``transducer_greedy_loop`` is a Python loop on the
device over the same batched step: every row keeps its own time cursor,
prediction state and symbol count, and a finished row freezes (its further
steps change nothing).  The host reads whether any row is still active
every ``_CHECK_EVERY`` steps, not every step.  Long audio is cut into
overlapping chunks: the full-length ones go through one batched encoder
pass and one batched label loop, the shorter tail alone, and the host
merges the chunks' tokens (``alignment``).

Models are built on ``device`` ("cuda" unless the caller passes "cpu")
with weights drawn from ``seed``; ``from_pretrained`` loads a local NeMo-
or HF-transformers-layout checkpoint directory (nothing is fetched).
Under an active mesh with dp > 1 the batch of full-length chunks pads to a
dp multiple and each data row decodes its slice on its replica.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from mlx_audio_tpu_torch.models.base import init_weights, model_device
from mlx_audio_tpu_torch.models.stt.parakeet import alignment as al
from mlx_audio_tpu_torch.models.stt.parakeet.audio import (
    PreprocessArgs,
    log_mel_spectrogram,
)
from mlx_audio_tpu_torch.models.stt.parakeet.conformer import Conformer, ConformerArgs
from mlx_audio_tpu_torch.models.stt.parakeet.ctc import ConvASRDecoder, ConvASRDecoderArgs
from mlx_audio_tpu_torch.models.stt.parakeet.rnnt import (
    JointArgs,
    JointNetwork,
    JointNetworkArgs,
    PredictArgs,
    PredictNetwork,
    PredictNetworkArgs,
)
from mlx_audio_tpu_torch.utils.audio_io import load_audio


def _sub(cls, d):
    return cls(**{k: v for k, v in d.items() if k in cls.__dataclass_fields__})


def _predict_args(d: dict) -> PredictArgs:
    return PredictArgs(blank_as_pad=d.get("blank_as_pad", True), vocab_size=d["vocab_size"],
                       prednet=_sub(PredictNetworkArgs, d["prednet"]))


def _joint_args(d: dict) -> JointArgs:
    return JointArgs(num_classes=d["num_classes"], vocabulary=d["vocabulary"],
                     jointnet=_sub(JointNetworkArgs, d["jointnet"]),
                     num_extra_outputs=d.get("num_extra_outputs", 0))


# ---------------------------------------------------------------------------
# Greedy label loop
# ---------------------------------------------------------------------------

_CHECK_EVERY = 8  # loop steps between the host's looks at the active rows


@torch.no_grad()
def transducer_greedy_loop(model, features, max_length, durations, vocab_size: int,
                           max_symbols: int, max_out: int, tdt: bool):
    """Greedy TDT or RNN-T decoding of a batch, all rows in lockstep.

    features [B, T, D]; max_length [B]; durations [n_dur] (TDT; unused by
    RNN-T).  Returns (tokens, times, durations [B, max_out], counts [B],
    steps): row b's first counts[b] slots hold its labels.  ``steps`` is the
    number of loop steps taken, a multiple of ``_CHECK_EVERY``."""
    b, t_len, _ = features.shape
    dev = features.device
    h, c = model.decoder.init_state(b, features.dtype, dev)
    blank = vocab_size
    rows = torch.arange(b, device=dev)
    max_length = torch.as_tensor(max_length, device=dev).long()
    durations = torch.as_tensor(durations, device=dev).long()
    zeros = torch.zeros(b, dtype=torch.long, device=dev)
    time, count, new_syms = zeros.clone(), zeros.clone(), zeros.clone()
    last_tok = torch.full((b,), blank, dtype=torch.long, device=dev)
    use_emb = torch.zeros(b, dtype=torch.bool, device=dev)
    toks, times, durs = (torch.zeros((b, max_out), dtype=torch.long, device=dev)
                         for _ in range(3))
    steps = 0
    while True:
        for _ in range(_CHECK_EVERY):
            active = (time < max_length) & (count < max_out)
            feature = features[rows, time.clamp(0, t_len - 1)]
            dec_out, (h2, c2) = model.decoder.step(last_tok, (h, c), use_emb)
            joint = model.joint(feature, dec_out).float()
            pred = joint[:, :blank + 1].argmax(-1)
            if tdt:
                dur = durations[joint[:, blank + 1:].argmax(-1)]
            else:
                dur = (pred == blank).long()
            emit = (pred != blank) & active
            slot = count.clamp(max=max_out - 1)
            toks[rows, slot] = torch.where(emit, pred, toks[rows, slot])
            times[rows, slot] = torch.where(emit, time, times[rows, slot])
            durs[rows, slot] = torch.where(emit, dur if tdt else torch.ones_like(dur),
                                           durs[rows, slot])
            count = count + emit.long()
            last_tok = torch.where(emit, pred, last_tok)
            use_emb = use_emb | emit
            gate = emit[None, :, None]
            h, c = torch.where(gate, h2, h), torch.where(gate, c2, c)
            dur = torch.where(active, dur, 0)
            time = time + dur
            # max_symbols labels at one frame force the time on by one
            if tdt:
                new_syms = torch.where(dur != 0, 0, new_syms + active.long())
            else:
                new_syms = torch.where(emit, new_syms + 1,
                                       torch.where(active, 0, new_syms))
            if max_symbols > 0:
                bump = (active if tdt else emit) & (new_syms >= max_symbols)
                time = time + bump.long()
                new_syms = torch.where(bump, 0, new_syms)
            steps += 1
        if not bool(((time < max_length) & (count < max_out)).any()):
            return toks, times, durs, count, steps


def _ctc_logits(model, mel):
    feats, lengths = model.encoder(mel)
    return model.decoder(feats), lengths


# ---------------------------------------------------------------------------


class BaseParakeet(nn.Module):
    """The transcription entry point shared by the three heads: chunking of long
    audio and the merge of the chunks' tokens."""

    def _build(self, device, seed: int, build: Callable[[], None]) -> None:
        self.device = model_device(device, type(self).__name__)
        with torch.device(self.device):
            build()
        init_weights(self, torch.Generator(self.device).manual_seed(seed))

    def decode(self, mel):
        raise NotImplementedError

    def _mel(self, audio) -> torch.Tensor:
        return log_mel_spectrogram(audio, self.preprocessor_config, device=self.device)

    def decode_chunk(self, audio_data, verbose=False) -> al.AlignedResult:
        result = self.decode(self._mel(audio_data))[0]
        if verbose:
            print(result.text)
        return result

    def generate(self, path, *, chunk_duration: Optional[float] = None,
                 overlap_duration: float = 15.0,
                 chunk_callback: Optional[Callable] = None,
                 **kwargs) -> al.AlignedResult:
        """Transcribe a file path (read at the model's sample rate) or
        samples; with ``chunk_duration``, longer audio in overlapping
        chunks."""
        kwargs.pop("max_tokens", None)
        verbose = kwargs.pop("verbose", False)
        sr = self.preprocessor_config.sample_rate
        if isinstance(path, (str, Path)):
            audio_data = load_audio(path, sr)
        else:
            audio_data = np.asarray(path)
        if chunk_duration is None or len(audio_data) / sr <= chunk_duration:
            return self.decode_chunk(audio_data, verbose)
        if chunk_duration <= overlap_duration:
            raise ValueError(f"chunk_duration ({chunk_duration}s) must exceed "
                             f"overlap_duration ({overlap_duration}s)")
        chunk_samples = int(chunk_duration * sr)
        overlap_samples = int(overlap_duration * sr)

        # every full-length chunk through one batched encoder pass and label
        # loop; only the shorter tail decodes alone
        starts = list(range(0, len(audio_data), chunk_samples - overlap_samples))
        full = [s for s in starts if s + chunk_samples <= len(audio_data)]
        batch_results = {}
        if len(full) > 1:
            from mlx_audio_tpu_torch.parallel.context import data_parallel

            mels = torch.cat([self._mel(audio_data[s:s + chunk_samples]) for s in full])
            dp = data_parallel(len(full))
            if dp is None:
                results = self.decode(mels)
            else:
                mels, n = dp.pad_batch(mels)
                parts = dp.map_rows(dp.place_replicated(self), mels.shape[0],
                                    lambda m, lo, hi: m.decode(mels[lo:hi].to(m.device)))
                results = [r for part in parts for r in part][:n]
            batch_results = dict(zip(full, results))

        all_tokens = []
        for start in starts:
            end = min(start + chunk_samples, len(audio_data))
            if chunk_callback is not None:
                chunk_callback(end, len(audio_data))
            chunk_result = batch_results.get(start)
            if chunk_result is None:
                chunk_result = self.decode_chunk(audio_data[start:end])
            offset = start / sr
            chunk_tokens = []
            for sentence in chunk_result.sentences:
                for token in sentence.tokens:
                    token.start += offset
                    token.end = token.start + token.duration
                chunk_tokens.extend(sentence.tokens)
            if all_tokens:
                try:
                    all_tokens = al.merge_longest_contiguous(
                        all_tokens, chunk_tokens, overlap_duration=overlap_duration)
                except RuntimeError:
                    all_tokens = al.merge_longest_common_subsequence(
                        all_tokens, chunk_tokens, overlap_duration=overlap_duration)
            else:
                all_tokens = chunk_tokens
        return al.sentences_to_result(al.tokens_to_sentences(all_tokens))

    def _time_scale(self) -> float:
        return (self.encoder_config.subsampling_factor
                / self.preprocessor_config.sample_rate
                * self.preprocessor_config.hop_length)

    @classmethod
    def from_config(cls, config: dict, device: str = "cuda", seed: int = 0):
        """A NeMo config (``target``, ``preprocessor``, ``encoder``, ...) or
        an HF-transformers ``ParakeetCTCConfig`` dict."""
        if config.get("model_type") == "parakeet_ctc" or (
                "encoder_config" in config and "preprocessor" not in config):
            return cls._from_hf_config(config, device, seed)
        target = config.get("target", "")
        has_tdt = config.get("model_defaults", {}).get("tdt_durations") is not None
        pre = PreprocessArgs.from_dict(config["preprocessor"])
        enc = ConformerArgs.from_dict(config["encoder"])
        kw = dict(device=device, seed=seed)
        if "rnnt" in target and has_tdt and "hybrid" not in target:
            return ParakeetTDT(pre, enc, _predict_args(config["decoder"]),
                               _joint_args(config["joint"]), config["decoding"], **kw)
        if "hybrid" in target and has_tdt:
            return ParakeetTDT(pre, enc, _predict_args(config["decoder"]),
                               _joint_args(config["joint"]), config["decoding"],
                               aux_ctc=_sub(ConvASRDecoderArgs, config["aux_ctc"]["decoder"]),
                               **kw)
        if "rnnt" in target:
            return ParakeetRNNT(pre, enc, _predict_args(config["decoder"]),
                                _joint_args(config["joint"]), config["decoding"], **kw)
        if "ctc" in target:
            return ParakeetCTC(pre, enc, _sub(ConvASRDecoderArgs, config["decoder"]), **kw)
        raise ValueError("Model is not supported yet!")

    @classmethod
    def _from_hf_config(cls, config: dict, device: str = "cuda",
                        seed: int = 0) -> "ParakeetCTC":
        """An HF-transformers ParakeetCTCConfig dict (the layout of the
        nvidia/parakeet-* HF checkpoints); the weights go through
        ``sanitize_hf_parakeet`` in ``sanitize``."""
        enc = config.get("encoder_config", {}) or {}
        pre = PreprocessArgs(sample_rate=16000, normalize="per_feature", window_size=0.025,
                             window_stride=0.01, window="hann",
                             features=enc.get("num_mel_bins", 80), n_fft=512)
        conf = ConformerArgs(
            feat_in=enc.get("num_mel_bins", 80),
            n_layers=enc.get("num_hidden_layers", 24),
            d_model=enc.get("hidden_size", 1024),
            n_heads=enc.get("num_attention_heads", 8),
            ff_expansion_factor=(enc.get("intermediate_size", 4096)
                                 // enc.get("hidden_size", 1024)),
            subsampling_factor=enc.get("subsampling_factor", 8),
            self_attention_model="rel_pos", subsampling="dw_striding",
            conv_kernel_size=enc.get("conv_kernel_size", 9),
            subsampling_conv_channels=enc.get("subsampling_conv_channels", 256),
            pos_emb_max_len=enc.get("max_position_embeddings", 5000))
        # the vocabulary comes from the checkpoint's tokenizer.json or
        # vocab.json; without one, index placeholders (ids still decode)
        vocab = (config.get("vocabulary")
                 or _vocab_from_checkpoint_dir(config.get("tokenizer_name")))
        if vocab:
            # CTC classes are the vocabulary and the blank: drop a trailing
            # blank or pad entry the tokenizer file may carry
            vocab = list(vocab)[: config.get("vocab_size", len(vocab) + 1) - 1]
        else:
            import warnings

            warnings.warn("no tokenizer.json/vocab.json found next to the "
                          "checkpoint; transcripts will be token indices")
            vocab = [str(i) for i in range(config.get("vocab_size", 1025) - 1)]
        dec = ConvASRDecoderArgs(feat_in=conf.d_model, num_classes=-1, vocabulary=vocab)
        return ParakeetCTC(pre, conf, dec, device=device, seed=seed)

    def sanitize(self, weights: dict) -> dict:
        """A checkpoint -> the JAX package's layout (``convert.params_from_jax``
        takes it on to the port's): HF-transformers keys are renamed and
        their convs moved; NeMo-layout weights pass as they are."""
        if any(k.startswith(("encoder.subsampling.", "ctc_head.")) for k in weights):
            return sanitize_hf_parakeet(weights)
        return weights

    @classmethod
    def from_pretrained(cls, path: str, device: str = "cuda") -> "BaseParakeet":
        """Load a local checkpoint directory (``config.json`` and
        ``*.safetensors``, NeMo or HF-transformers layout); the vocabulary
        of an HF config comes from the directory's tokenizer files."""
        from mlx_audio_tpu_torch.codec.loading import (
            checkpoint_dir,
            load_config,
            load_weights_files,
        )
        from mlx_audio_tpu_torch.convert import params_from_jax

        model_path = checkpoint_dir(path)
        config = load_config(model_path)
        config.setdefault("tokenizer_name", str(model_path))
        model = BaseParakeet.from_config(config, device=device)
        weights = model.sanitize(load_weights_files(model_path))
        model.load_state_dict(params_from_jax(weights, model), strict=False)
        return model


def _aligned_results(toks, times, durs, counts, scale: float, vocabulary) -> list:
    results = []
    for b in range(toks.shape[0]):
        hypothesis = [
            al.AlignedToken(int(toks[b, i]), start=float(times[b, i]) * scale,
                            duration=float(durs[b, i]) * scale,
                            text=al.decode_tokens([int(toks[b, i])], vocabulary))
            for i in range(int(counts[b]))]
        results.append(al.sentences_to_result(al.tokens_to_sentences(hypothesis)))
    return results


class ParakeetTDT(BaseParakeet):
    def __init__(self, preprocess_args, encoder_args, decoder_args, joint_args,
                 decoding: dict, tdt: bool = True,
                 aux_ctc: Optional[ConvASRDecoderArgs] = None,
                 device: str = "cuda", seed: int = 0):
        super().__init__()
        self.preprocessor_config = preprocess_args
        self.encoder_config = encoder_args
        self.vocabulary = joint_args.vocabulary
        self.durations = decoding.get("durations", [0, 1, 2, 3, 4]) if tdt else [1]
        greedy = decoding.get("greedy") or {}
        self.max_symbols = greedy.get("max_symbols") or 10
        self.is_tdt = tdt

        def build():
            self.encoder = Conformer(encoder_args)
            self.decoder = PredictNetwork(decoder_args)
            self.joint = JointNetwork(joint_args)
            if aux_ctc is not None:
                self.ctc_decoder = ConvASRDecoder(aux_ctc)

        self._build(device, seed, build)

    @torch.no_grad()
    def decode(self, mel):
        """Log-mel [B, frames, features] (or [frames, features]) -> one
        AlignedResult a row."""
        mel = torch.as_tensor(mel, dtype=torch.float32, device=self.device)
        if mel.ndim == 2:
            mel = mel[None]
        features, lengths = self.encoder(mel)
        # the worst case, max_symbols labels a frame before the forced time
        # advance: a smaller buffer would cut the transcript
        max_out = max(16, (int(self.max_symbols) + 1) * int(lengths.max()))
        toks, times, durs, counts, _ = transducer_greedy_loop(
            self, features, lengths, self.durations, vocab_size=len(self.vocabulary),
            max_symbols=int(self.max_symbols), max_out=max_out, tdt=self.is_tdt)
        return _aligned_results(toks.cpu().numpy(), times.cpu().numpy(),
                                durs.cpu().numpy(), counts.cpu().numpy(),
                                self._time_scale(), self.vocabulary)


class ParakeetRNNT(ParakeetTDT):
    def __init__(self, preprocess_args, encoder_args, decoder_args, joint_args,
                 decoding: dict, device: str = "cuda", seed: int = 0):
        super().__init__(preprocess_args, encoder_args, decoder_args, joint_args,
                         decoding, tdt=False, device=device, seed=seed)


def ctc_collapse(best: np.ndarray, blank: int) -> list:
    """NeMo's CTC collapse of one row's frame argmaxes: a label is emitted
    where it differs from the previous frame's (blank included), so a label
    repeated across a blank frame is emitted twice.  Returns [(token,
    start frame, end frame)], a token ending where the next starts, the last
    one after the last non-blank frame."""
    emitted, prev = [], blank
    for t, tok in enumerate(best.tolist()):
        if tok != blank and tok != prev:
            emitted.append((tok, t))
        prev = tok
    n = len(best)
    last_non_blank = next((t for t in range(n - 1, -1, -1) if int(best[t]) != blank), n - 1)
    return [(tok, t0, emitted[i + 1][1] if i + 1 < len(emitted) else last_non_blank + 1)
            for i, (tok, t0) in enumerate(emitted)]


class ParakeetCTC(BaseParakeet):
    def __init__(self, preprocess_args, encoder_args, decoder_args,
                 device: str = "cuda", seed: int = 0):
        super().__init__()
        self.preprocessor_config = preprocess_args
        self.encoder_config = encoder_args
        self.vocabulary = decoder_args.vocabulary

        def build():
            self.encoder = Conformer(encoder_args)
            self.decoder = ConvASRDecoder(decoder_args)

        self._build(device, seed, build)

    @torch.no_grad()
    def decode(self, mel):
        mel = torch.as_tensor(mel, dtype=torch.float32, device=self.device)
        if mel.ndim == 2:
            mel = mel[None]
        logits, lengths = _ctc_logits(self, mel)
        best_all = logits.argmax(-1).cpu().numpy()
        lengths = torch.as_tensor(lengths).cpu().numpy()
        scale = self._time_scale()
        blank = len(self.vocabulary)
        results = []
        for b in range(best_all.shape[0]):
            hypothesis = [
                al.AlignedToken(tok, start=t0 * scale, duration=(t1 - t0) * scale,
                                text=al.decode_tokens([tok], self.vocabulary))
                for tok, t0, t1 in ctc_collapse(best_all[b, :int(lengths[b])], blank)]
            results.append(al.sentences_to_result(al.tokens_to_sentences(hypothesis)))
        return results


def sanitize_hf_parakeet(weights: dict) -> dict:
    """An HF-transformers Parakeet state dict (the format of the
    nvidia/parakeet-* HF checkpoints) -> the JAX package's NeMo-style
    layout (ParakeetCTC keys).

    The subsampling Sequential of HF interleaves ReLU modules (the conv at
    0, then depthwise and pointwise at 3k-1 and 3k for each further stage);
    ours holds the convs alone (2k-1 and 2k).  Conv weights go torch [O,
    I/g, ...] -> K-major ([K, I/g, O] for 1-d, HWIO for 2-d)."""
    import re

    out = {}
    for k, v in weights.items():
        v = np.asarray(v)
        if k.endswith("num_batches_tracked"):
            continue
        if k.startswith("ctc_head."):
            if k.endswith("weight"):
                out["decoder.decoder_layers.0.weight"] = v.transpose(2, 1, 0)
            else:
                out["decoder.decoder_layers.0.bias"] = v
            continue
        m = re.match(r"encoder\.subsampling\.layers\.(\d+)\.(weight|bias)", k)
        if m:
            j, leaf = int(m.group(1)), m.group(2)
            if j == 0:
                idx = 0
            elif j % 3 == 2:  # the depthwise conv of stage (j + 1) / 3
                idx = 2 * ((j + 1) // 3) - 1
            else:  # the pointwise conv of stage j / 3
                idx = 2 * (j // 3)
            if leaf == "weight":
                v = v.transpose(2, 3, 1, 0)  # [O, I/g, kh, kw] -> HWIO
            out[f"encoder.pre_encode.conv.{idx}.{leaf}"] = v
            continue
        k = k.replace("encoder.subsampling.linear.", "encoder.pre_encode.out.")
        k = (k.replace(".self_attn.q_proj.", ".self_attn.linear_q.")
             .replace(".self_attn.k_proj.", ".self_attn.linear_k.")
             .replace(".self_attn.v_proj.", ".self_attn.linear_v.")
             .replace(".self_attn.o_proj.", ".self_attn.linear_out.")
             .replace(".self_attn.relative_k_proj.", ".self_attn.linear_pos.")
             .replace(".self_attn.bias_u", ".self_attn.pos_bias_u")
             .replace(".self_attn.bias_v", ".self_attn.pos_bias_v")
             .replace(".conv.norm.", ".conv.batch_norm."))
        if ".conv." in k and v.ndim == 3:
            v = v.transpose(2, 1, 0)  # torch [O, I/g, K] -> [K, I/g, O]
        out[k] = v
    return out


def _vocab_from_checkpoint_dir(d) -> Optional[list]:
    """id -> token list from an HF tokenizer.json (a BPE or WordLevel dict,
    or a Unigram [token, score] list) or a vocab.json in directory ``d``."""
    if not d:
        return None
    tj = Path(d) / "tokenizer.json"
    if tj.exists():
        with open(tj) as f:
            vocab = json.load(f).get("model", {}).get("vocab")
        if isinstance(vocab, dict):
            inv = [""] * (max(vocab.values()) + 1)
            for t, i in vocab.items():
                inv[i] = t
            return inv
        if isinstance(vocab, list):
            return [t for t, _score in vocab]
    vj = Path(d) / "vocab.json"
    if vj.exists():
        with open(vj) as f:
            v = json.load(f)
        inv = [""] * (max(v.values()) + 1)
        for t, i in v.items():
            inv[i] = t
        return inv
    return None


class Model:
    """The family's entry point: dispatches on the NeMo config's target."""

    def __new__(cls, config: dict, device: str = "cuda", seed: int = 0):
        return BaseParakeet.from_config(config, device=device, seed=seed)
