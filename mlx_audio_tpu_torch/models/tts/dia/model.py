"""Dia-1.6B: encoder-decoder dialogue TTS over 9 DAC codebooks (counterpart
of ``mlx_audio_tpu/models/tts/dia/model.py``).

Byte-level text with [S1]/[S2] speaker tags; classifier-free guidance over
interleaved (uncond, cond) row pairs, text b in rows (2b, 2b+1); the
per-channel delay pattern; the EOS countdown tail; DAC-44kHz synthesis,
whose resblock convs take the conv kernels their route names.

The JAX package's jitted ``lax.scan`` chunk is ``_dia_chunk`` here, a
Python loop of up to 64 steps between the host's looks at EOS, so the
stops and the budget are the JAX package's.  Greedy decodes (temperature
0) are held to the JAX package's; the JAX PRNG cannot be reproduced, so a
sampled step draws text b's Gumbel noise from a generator of its own
(``models.sampling.row_generator`` on a seed taken from a host generator
seeded ``seed``), and a text's draws do not depend on its batch.  The
encoder and decoder projections are float32 ``tensordot`` calls, as in the
JAX package.  Left for later: the tensor- and data-parallel placements,
and fetching the DAC from the hub (``dac_model`` is a DAC or a local
checkpoint directory).
"""

from __future__ import annotations

import re
import time
from typing import List, Optional

import numpy as np
import torch
from torch import nn

from mlx_audio_tpu_torch.models.base import (
    init_weights,
    make_generation_result,
    model_device,
)
from mlx_audio_tpu_torch.models.sampling import call_seed, gumbel, row_generator
from mlx_audio_tpu_torch.models.tts.dia.audio import (
    audio_to_codebook,
    codebook_to_audio,
    codebook_to_audio_batch,
)
from mlx_audio_tpu_torch.models.tts.dia.config import DiaConfig
from mlx_audio_tpu_torch.models.tts.dia.layers import DiaDecoder, DiaEncoder

# the DAC-44kHz checkpoint Dia speaks, as a local directory
DAC_PATH = "mlx-community/descript-audio-codec-44khz"
# decode steps between the host's looks at EOS
CHUNK = 64
# the classes a step may pick: the 1024 codes and EOS
VALID_CLASSES = 1025


class DiaModel(nn.Module):
    def __init__(self, config: DiaConfig):
        super().__init__()
        self.encoder = DiaEncoder(config)
        self.decoder = DiaDecoder(config)


def _pick(logits, cfg_scale: float, top_k: int, temperature: float, seed):
    """One step's codes [B, C] from decoder logits [2B, C, V]: CFG over the
    (uncond, cond) row pairs, the valid classes, the top-k threshold, then
    greedy, or a draw at ``temperature`` with text b's noise from
    ``row_generator(seed, b)``."""
    b = logits.shape[0] // 2
    pair = logits.reshape(b, 2, *logits.shape[1:])
    uncond, cond = pair[:, 0], pair[:, 1]
    cfg = cond + cfg_scale * (cond - uncond)                     # [B, C, V]
    ids = torch.arange(cfg.shape[-1], device=cfg.device)[None, None, :]
    cfg = torch.where(ids < VALID_CLASSES, cfg, float("-inf"))
    if top_k > 0:
        kth = torch.topk(cfg, top_k, dim=-1).values[..., -1:]
        cfg = torch.where(cfg < kth, float("-inf"), cfg)
    if temperature == 0:
        return torch.argmax(cfg, dim=-1).to(torch.int32)
    noise = torch.stack([gumbel(cfg.shape[1:], row_generator(seed, i, cfg.device),
                                cfg.device) for i in range(b)])
    temp = torch.tensor(temperature, dtype=torch.float32, device=cfg.device)
    return torch.argmax(cfg / temp + noise, dim=-1).to(torch.int32)


@torch.no_grad()
def _dia_chunk(model, sa_caches, cross_kvs, ca_mask, last_tokens, step0: int,
               gen_start: int, delay: torch.Tensor, generator, bos_value: int,
               chunk: int, temperature: float, top_k: int, cfg_scale: float,
               force_bos: bool):
    """``chunk`` decode steps from the codes ``last_tokens`` [2B, C] fed at
    position ``step0``; the caches are written in place.  Returns (codes
    [chunk, B, C], the last fed codes [2B, C]).  With ``force_bos`` a
    channel's code is BOS until the step reaches its delay."""
    dev = last_tokens.device
    preds = []
    last = last_tokens
    for step in range(step0, step0 + chunk):
        pos = torch.full((1, 1), step, dtype=torch.long, device=dev)
        logits, _ = model.decoder.step(last[:, None, :], pos, sa_caches,
                                       cross_kvs, None, ca_mask)
        seed = None if temperature == 0 else call_seed(generator)
        pred = _pick(logits[:, -1], cfg_scale, top_k, temperature, seed)
        if force_bos:
            pred = torch.where((step - gen_start) >= delay[None], pred, bos_value)
        last = torch.repeat_interleave(pred, 2, dim=0)           # both rows of a pair
        preds.append(pred)
    return torch.stack(preds), last


def _trim_cross(cross_kvs, pad2, step: int = 64):
    """Slice the cross-attention keys to a ``step``-bucket covering the
    longest real text in the batch.  Pad keys are masked to -1e9, whose
    float32 softmax weight underflows to exactly 0, so dropping them leaves
    every output as it was.  Returns (cross_kvs, the cross mask [B, 1, 1,
    S'])."""
    s_len = pad2.shape[-1]
    s_real = int(pad2.sum(-1).max())
    sl = min(s_len, max(step, -(-s_real // step) * step))
    if sl >= s_len:
        return cross_kvs, pad2[:, None, None, :]
    cross_kvs = [(k[:, :, :sl], v[:, :, :sl]) for k, v in cross_kvs]
    return cross_kvs, pad2[:, None, None, :sl]


def _eos_tail(c: int, eos: int, pad_tok: int, delay) -> list:
    """Per-channel EOS/PAD countdown rows appended after the EOS frame; the
    delay revert discards this tail region."""
    rows = []
    for extra in range(1, max(delay) + 1):
        row = np.full((c,), pad_tok, dtype=np.int32)
        for i, d in enumerate(delay):
            if extra == d:
                row[i] = eos
            elif extra < d:
                row[i] = 0
        rows.append(row)
    return rows


@torch.no_grad()
def _encode_text(model, src, src_pos, enc_mask):
    """Encoder output and every decoder layer's cross-attention keys and
    values."""
    encoder_out = model.encoder(src, src_pos, enc_mask)
    return encoder_out, model.decoder.precompute_cross_kv(encoder_out, src_pos)


class Model(nn.Module):
    """User-facing Dia model.  Runs on ``device``, "cuda" unless the caller
    asks for "cpu", with weights drawn from ``seed`` on the device.
    ``dac_model`` is a DAC-44kHz or a local checkpoint directory (default
    ``DAC_PATH``), loaded on first use."""

    def __init__(self, config, dac_model=None, device: str = "cuda",
                 seed: int = 0):
        super().__init__()
        self.config = config if isinstance(config, DiaConfig) else DiaConfig.load_dict(config)
        device = model_device(device, "Model")
        with torch.device(device):
            self.model = DiaModel(self.config)
        init_weights(self.model, torch.Generator(device).manual_seed(seed))
        self._dac = dac_model
        self.device = device

    @property
    def sample_rate(self):
        return self.config.model.sample_rate

    def _get_dac(self):
        if self._dac is None or isinstance(self._dac, str):
            from mlx_audio_tpu_torch.codec.dac import DAC

            self._dac = DAC.from_pretrained(self._dac or DAC_PATH,
                                            device=str(self.device))
        return self._dac

    # -- text prep ----------------------------------------------------------

    def _prepare_text_input(self, text: str):
        """Bytes with [S1]/[S2] as 0x01/0x02, padded to text_length: (src [1,
        S], positions [1, S], pad mask [1, S], encoder mask [1, 1, S, S]).
        The encoder mask is segment-compatible: real to real, pad to pad."""
        pad = self.config.data.text_pad_value
        max_len = self.config.data.text_length
        b = text.encode("utf-8").replace(b"[S1]", b"\x01").replace(b"[S2]", b"\x02")
        tokens = list(b)[:max_len]
        padded = np.full(max_len, pad, dtype=np.int64)
        padded[: len(tokens)] = tokens
        src = torch.as_tensor(padded, device=self.device)[None]
        positions = torch.arange(max_len, device=self.device)[None]
        pad_mask = src != pad
        q = pad_mask[:, :, None]
        kk = pad_mask[:, None, :]
        mask = (q & kk) | (~q & ~kk)
        return src, positions, pad_mask, mask[:, None]

    def _split_turns(self, text: str) -> List[str]:
        pattern = re.compile(
            r"\[S1\]\s*(.*?)\s*\[S2\]\s*(.*?)(?=(?:\[S1\])|$)", re.DOTALL)
        segments = [
            f"[S1] {a.strip()} [S2] {b.strip()}" for a, b in pattern.findall(text)]
        if len(segments) > 1:
            merged = []
            for i in range(0, len(segments), 2):
                if i + 1 < len(segments):
                    merged.append(f"{segments[i]} {segments[i + 1]}")
                else:
                    merged.append(segments[i])
            segments = merged
        return segments

    # -- generation ---------------------------------------------------------

    def _start(self, texts: List[str], cache_len: int, bucketed: bool = False,
               encoder_len: Optional[int] = None, model: Optional[DiaModel] = None):
        """Decode state of ``texts``: the encoder over (uncond, cond) row
        pairs, text b in rows (2b, 2b+1), every decoder layer's cross keys
        trimmed (``_trim_cross``), fresh self-attention caches of
        ``cache_len`` slots and the BOS frame to feed first.  The encoder
        sees all text_length positions, or with ``bucketed`` a 128-bucket
        of the longest real text (real positions never attend pad keys and
        the cross attention masks pad keys, so the codes stay as they
        were); ``encoder_len`` forces the length.  ``model`` is
        ``self.model`` or a copy of it on another device.  Returns (caches,
        cross keys, cross mask, the codes fed first [2B, C])."""
        model = self.model if model is None else model
        dev = model.decoder.norm.weight.device
        data = self.config.data
        parts = [self._prepare_text_input(t) for t in texts]
        src, pos, pad, mask = (torch.cat(p).to(dev) for p in zip(*parts))
        s_len = src.shape[1]
        if bucketed:
            s_real = int(pad.sum(-1).max())
            s_len = min(s_len, max(128, -(-s_real // 128) * 128))
        s_len = int(encoder_len or s_len)
        src, pos, pad = src[:, :s_len], pos[:, :s_len], pad[:, :s_len]
        mask = mask[:, :, :s_len, :s_len]
        b = len(texts)
        src2 = torch.stack([torch.zeros_like(src), src], dim=1).reshape(2 * b, s_len)
        pos2, pad2, mask2 = (torch.repeat_interleave(a, 2, dim=0)
                             for a in (pos, pad, mask))
        _, cross_kvs = _encode_text(model, src2, pos2, mask2)
        cross_kvs, ca_mask = _trim_cross(cross_kvs, pad2)
        caches = model.decoder.init_cache(2 * b, cache_len,
                                          dtype=model.decoder.norm.weight.dtype)
        last = torch.full((2 * b, data.channels), data.audio_bos_value,
                          dtype=torch.long, device=dev)
        return caches, cross_kvs, ca_mask, last

    def _generate(self, text: str, max_tokens: Optional[int] = None,
                  cfg_scale: float = 3.0, temperature: float = 1.3,
                  cfg_filter_top_k: int = 35, ref_audio=None,
                  ref_text: Optional[str] = None, seed: int = 0):
        """One text: (waveform, frames decoded, BOS included)."""
        data = self.config.data
        c = data.channels
        bos, eos, pad_tok = data.audio_bos_value, data.audio_eos_value, data.audio_pad_value
        delay = data.delay_pattern
        max_tokens = max_tokens or data.audio_length
        model = self.model

        if ref_text is not None:
            text = ref_text.strip() + " " + text

        generated = [np.full((c,), bos, dtype=np.int32)]  # the BOS frame
        current_step = 0
        prompt_np = None
        if ref_audio is not None:
            audio = torch.as_tensor(np.asarray(ref_audio, dtype=np.float32),
                                    device=self.device)[None, None]
            with torch.no_grad():
                prompt_np = audio_to_codebook(self._get_dac(), audio,
                                              data)[0].cpu().numpy()
        # the cache holds BOS, the prompt's frames and the generated ones
        n_prompt = 0 if prompt_np is None else prompt_np.shape[0]
        cache_len = max_tokens + n_prompt + 64
        sa_caches, cross_kvs, ca_mask, last = self._start([text], cache_len)

        if ref_audio is not None:
            frames = np.concatenate([generated[0][None], prompt_np], axis=0)
            tgt = torch.as_tensor(np.stack([frames, frames]), dtype=torch.long,
                                  device=self.device)                # [2, T, C]
            t = tgt.shape[1]
            positions = torch.arange(t, device=self.device)[None].repeat(2, 1)
            i = torch.arange(t, device=self.device)[:, None]
            j = torch.arange(cache_len, device=self.device)[None, :]
            sa_mask = ((j <= i) & (j < t))[None, None]
            with torch.no_grad():
                model.decoder.step(tgt, positions, sa_caches, cross_kvs,
                                   sa_mask, ca_mask)
            generated = list(frames)
            current_step = t - 1
            # rewind: the last frame is fed again as the next step's input
            for cache in sa_caches:
                cache.idx = t - 1
            last = torch.as_tensor(np.stack([frames[-1], frames[-1]]),
                                   dtype=torch.long, device=self.device)

        generator = torch.Generator().manual_seed(seed)
        delay_t = torch.as_tensor(delay, device=self.device)
        step = current_step
        out_frames = list(generated)
        eos_seen = False
        while (step - current_step) < max_tokens and not eos_seen:
            n = min(CHUNK, max_tokens - (step - current_step))
            preds, last = _dia_chunk(
                model, sa_caches, cross_kvs, ca_mask, last, step, current_step,
                delay_t, generator, bos, chunk=n, temperature=temperature,
                top_k=cfg_filter_top_k, cfg_scale=cfg_scale,
                force_bos=ref_audio is None)
            for row in preds[:, 0].cpu().numpy():
                out_frames.append(row.astype(np.int32))
                step += 1
                if row[0] == eos:
                    eos_seen = True
                    break

        # the EOS tail: the not-yet-EOS channels are filled with code 0, in
        # the region the delay revert discards
        if eos_seen:
            out_frames.extend(_eos_tail(c, eos, pad_tok, delay))
        # voice cloning: the reference prompt's frames are not output; the
        # BOS column stays for codebook_to_audio to drop
        if n_prompt:
            out_frames = [out_frames[0]] + out_frames[1 + n_prompt:]
        codes = np.stack(out_frames, axis=1)  # [C, T]
        audio = codebook_to_audio(codes, self._get_dac(), delay, c=c)
        return audio, len(out_frames)

    def generate_batch(self, texts: List[str],
                       max_tokens: Optional[int] = None,
                       cfg_scale: float = 3.0, temperature: float = 1.3,
                       cfg_filter_top_k: int = 35, seed: int = 0,
                       **kwargs) -> list:
        """B texts decode in one CFG loop over 2B interleaved (uncond, cond)
        rows, sharing every decoder weight read.  EOS is tracked per text on
        the host between chunks; rows of equal length synthesize through
        one DAC call.  One GenerationResult per text."""
        data = self.config.data
        c = data.channels
        bos, eos, pad_tok = (data.audio_bos_value, data.audio_eos_value,
                             data.audio_pad_value)
        delay = data.delay_pattern
        max_tokens = max_tokens or data.audio_length
        start_time = time.perf_counter()
        model = self.model
        b = len(texts)

        # a test hook: force the encoder length
        sa_caches, cross_kvs, ca_mask, last = self._start(
            texts, max_tokens + 64, bucketed=True,
            encoder_len=kwargs.pop("_encoder_bucket", None))

        generator = torch.Generator().manual_seed(seed)
        delay_t = torch.as_tensor(delay, device=self.device)
        first = np.full((c,), bos, dtype=np.int32)
        out_frames = [[first.copy()] for _ in range(b)]
        done = np.zeros((b,), dtype=bool)
        step = 0
        while step < max_tokens and not done.all():
            n = min(CHUNK, max_tokens - step)
            preds, last = _dia_chunk(
                model, sa_caches, cross_kvs, ca_mask, last, step, 0, delay_t,
                generator, bos, chunk=n, temperature=temperature,
                top_k=cfg_filter_top_k, cfg_scale=cfg_scale, force_bos=True)
            for row in preds.cpu().numpy():     # [n, B, C]
                for i in range(b):
                    if done[i]:
                        continue
                    out_frames[i].append(row[i].astype(np.int32))
                    if row[i][0] == eos:
                        done[i] = True
                step += 1

        codes_list = []
        for i in range(b):
            frames = out_frames[i]
            if done[i]:
                frames = frames + _eos_tail(c, eos, pad_tok, delay)
            codes_list.append(np.stack(frames, axis=1))   # [C, T]
        audios = codebook_to_audio_batch(codes_list, self._get_dac(), delay, c=c)
        elapsed = time.perf_counter() - start_time
        return [make_generation_result(
            audios[i], self.config.model.sample_rate, i,
            codes_list[i].shape[1], elapsed / b, self.device) for i in range(b)]

    def generate(self, text: str, temperature: float = 1.3, top_p: float = 0.95,
                 split_pattern: str = "\n", max_tokens: Optional[int] = None,
                 ref_audio=None, ref_text: Optional[str] = None,
                 cfg_scale: float = 3.0, seed: int = 0, **kwargs):
        """One GenerationResult per segment: ``text`` split on
        ``split_pattern``, and dialogue lines into pairs of turns."""
        prompt = text.replace("\\n", "\n").replace("\\t", "\t")
        segments = []
        for p in prompt.split(split_pattern):
            if "[S1]" in p and "[S2]" in p:
                segments.extend(self._split_turns(p))
            else:
                segments.append(p)
        for seg_idx, segment in enumerate(segments):
            start = time.perf_counter()
            audio, token_count = self._generate(
                segment, max_tokens=max_tokens, cfg_scale=cfg_scale,
                temperature=temperature, ref_audio=ref_audio,
                ref_text=ref_text, seed=seed + seg_idx)
            yield make_generation_result(
                audio, self.config.model.sample_rate, seg_idx, token_count,
                time.perf_counter() - start, self.device)

    def sanitize(self, weights: dict) -> dict:
        """nari-labs checkpoints already use the DenseGeneral layouts;
        HF-transformers ``DiaForConditionalGeneration`` checkpoints
        (flattened 2-d projections, fused embeddings) are detected and
        reshaped."""
        if any(".mlp.gate_up_proj." in k or "embeddings.embed." in k
               for k in weights):
            return sanitize_hf_dia(weights, self.config)
        return {k if k.startswith("model.") else f"model.{k}": np.asarray(v)
                for k, v in weights.items()}


def sanitize_hf_dia(weights: dict, config) -> dict:
    """HF-transformers Dia checkpoints -> the DenseGeneral layouts: q/k/v
    [D, H, hd], o [H, hd, D], gate_up [D, 2, hidden], down [hidden, D]; the
    fused channel embeddings and logits head split per channel."""
    enc, dec = config.model.encoder, config.model.decoder
    channels = config.data.channels
    tgt_v = config.model.tgt_vocab_size

    def qkv(v, heads, hd):
        return v.T.reshape(v.shape[1], heads, hd)

    out = {}
    for k, v in weights.items():
        v = np.asarray(v)
        k = k.removeprefix("model.")
        if k == "logits_dense.weight":
            out["model.decoder.logits_dense.weight"] = v.T.reshape(
                v.shape[1], channels, tgt_v)
            continue
        if k == "decoder.embeddings.embed.weight":
            for c in range(channels):
                out[f"model.decoder.embeddings.{c}.weight"] = (
                    v[c * tgt_v:(c + 1) * tgt_v])
            continue
        if ".self_attention." in k or ".cross_attention." in k:
            is_enc = k.startswith("encoder.")
            is_cross = ".cross_attention." in k
            if is_enc:
                h, hd, kvh, kvd = enc.n_head, enc.head_dim, enc.n_head, enc.head_dim
            elif is_cross:
                h, hd = dec.cross_query_heads, dec.cross_head_dim
                kvh, kvd = dec.cross_query_heads, dec.cross_head_dim
            else:
                h, hd = dec.gqa_query_heads, dec.gqa_head_dim
                kvh, kvd = dec.kv_heads, dec.gqa_head_dim
            if k.endswith("q_proj.weight"):
                v = qkv(v, h, hd)
            elif k.endswith("k_proj.weight") or k.endswith("v_proj.weight"):
                v = qkv(v, kvh, kvd)
            elif k.endswith("o_proj.weight"):
                v = v.T.reshape(h, hd, v.shape[0])
        elif k.endswith(".mlp.gate_up_proj.weight"):
            k = k.replace(".gate_up_proj.", ".wi_fused.")
            v = v.T.reshape(v.shape[1], 2, v.shape[0] // 2)
        elif k.endswith(".mlp.down_proj.weight"):
            k = k.replace(".down_proj.", ".wo.")
            v = v.T
        out["model." + k] = v
    return out
