"""Deployment artifacts through ``torch.export`` (counterpart of
``mlx_audio_tpu/export.py``).

An artifact is one serialized inference program with the weights inside:
``torch.export`` traces a closure over a model, ``torch.export.save`` writes
the graph and the weights, and ``load_program`` gives back a callable that
runs WITHOUT this package's model code or the checkpoint: the loading
process imports ``mlx_audio_tpu_torch.ops`` (the kernels as custom ops) and
nothing of ``models``, ``codec``, ``tts`` or ``stt``.

    # build + save (one artifact per shape bucket; weights inside)
    python -m mlx_audio_tpu_torch.export --model <kokoro-dir> \\
        --out kokoro.pt2 --phoneme-bucket 512 --frame-bucket 1300

    # run anywhere the port's kernels build (only torch and the op module)
    from mlx_audio_tpu_torch.export import load_program
    synth = load_program("kokoro.pt2")
    audio, pred_dur = synth(input_ids, lengths, ref_s, speeds, rand_ini, noise)

The kernels of a program's path (``lstm``, ``dilated_conv1d``,
``banded_conv1d``, ``quantized_matmul``, ``depth_draft``) are custom-op
nodes of its graph (``ops.graph_ops``): a loaded program on the card
launches them, on the CPU it runs their plain versions.  Loops whose
length depends on the data (CSM's frames and its rejected draft tail, the
causal LM's tokens, Whisper's greedy steps) are ``while_loop``s, as the JAX
package's ``lax`` loops; decode state crosses the program boundary as flat
tensors, every write position a 0-d tensor (``nn.attention.KVCache``,
Mimi's ring offsets and conv flags), and a JSON sidecar records their
shapes, dtypes and initial values so a host can make them without model
code.

Where the JAX package differs:

* randomness: ``jax.random`` cannot be reproduced, so a program takes its
  draws as inputs where the JAX program takes a key: Kokoro the source's
  ``rand_ini`` [B, 9] and ``noise`` [B, 600 F, 9]; the CSM and causal-LM
  sessions a Gumbel noise tensor a call (the meta's ``rng``); SNAC one
  normal draw a decoder block (the meta's ``snac_noise_shapes``);
* devices: a ``torch.export`` program runs on the device it was exported
  on, so ``platforms=`` is ``device=`` (default ``cuda``), the CLI's
  ``--platforms`` is ``--device``, and the metas record the device.

Exported programs have static shapes by design: the host picks the
artifact for its bucket.  G2P, voice loading and tokenization stay on the
host.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import _pytree as pytree

from mlx_audio_tpu_torch.nn.attention import KVCache, row_at

__all__ = [
    "export_program",
    "load_program",
    "kokoro_synthesis_fn",
    "export_kokoro",
    "mimi_decode_fn",
    "export_mimi_decode",
    "export_mimi_stream_decode",
    "csm_session_fns",
    "export_csm_session",
    "causal_session_fns",
    "export_causal_session",
    "export_snac_decode",
    "export_orpheus",
    "whisper_greedy_fn",
    "export_whisper_greedy",
]

RNG_CONTRACT = (
    "prefill and each chunk call take Gumbel noise (standard Gumbel, "
    "float32, the shape in noise_shapes); draw it FRESH on the host for "
    "every call, e.g. models.sampling.gumbel(shape, generator) from a "
    "session generator: the same noise replays the same draws (repetitive "
    "audio at temp>0); greedy programs (temp 0) do not read it")


class _Program(nn.Module):
    """The module ``torch.export`` traces: ``fn(*args)``, with the models
    that ``fn`` closes over registered, so their weights are the
    artifact's parameters and buffers."""

    def __init__(self, fn, modules: Sequence[nn.Module]):
        super().__init__()
        self.fn = fn
        self.models = nn.ModuleList(modules)

    def forward(self, *args):
        return self.fn(*args)


def export_program(fn, example_args: Sequence, path, device: str = "cuda",
                   modules: Sequence[nn.Module] = ()) -> int:
    """Trace ``fn(*example_args)`` with ``torch.export`` and save it to
    ``path``, the weights of ``modules`` (the models ``fn`` closes over)
    inside.  Every example tensor must lie on ``device``: the program runs
    there.  Returns the artifact size in bytes."""
    dev = torch.device(device)
    for t in pytree.tree_leaves(list(example_args)):
        if isinstance(t, torch.Tensor) and t.device.type != dev.type:
            raise ValueError(f"export on {device}: an example input lies on "
                             f"{t.device}")
    with torch.no_grad():
        program = torch.export.export(_Program(fn, modules), tuple(example_args),
                                      strict=False)
    with open(path, "wb") as f:  # a buffer: any file name, not only *.pt2
        torch.export.save(program, f)
    return Path(path).stat().st_size


def load_program(path):
    """Load a saved program; returns a callable of the exported signature.
    Needs only torch and ``mlx_audio_tpu_torch.ops`` (the kernels' custom
    ops): no model code, no checkpoint."""
    from mlx_audio_tpu_torch import ops  # noqa: F401  (registers the ops)

    with open(path, "rb") as f:
        return torch.export.load(f).module()


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _write_meta(path, meta: dict) -> None:
    with open(path, "w") as f:
        json.dump(meta, f, indent=1)


def _position(value, device) -> torch.Tensor:
    """A write position or flag as the 0-d tensor a program carries."""
    dtype = torch.bool if isinstance(value, bool) else torch.int64
    return torch.tensor(value, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Kokoro: phonemes -> waveform, weights inside
# ---------------------------------------------------------------------------


def kokoro_synthesis_fn(model, frame_bucket: int):
    """Whole-graph synthesis closure over ``model``: (input_ids [B, P],
    lengths [B], ref_s [B, 256], speeds [B], rand_ini [B, 9], noise
    [B, 600 F, 9]) -> (audio [B, 600 F], pred_dur [B, P]); ``rand_ini``
    and ``noise`` are the source's draws (``synthesis_stage``'s)."""
    from mlx_audio_tpu_torch.models.tts.kokoro.model import (
        duration_stage,
        synthesis_stage,
    )

    def fn(input_ids, lengths, ref_s, speeds, rand_ini, noise):
        d, pred_dur = duration_stage(model, input_ids, lengths, ref_s[:, 128:],
                                     speeds)
        audio, _ = synthesis_stage(model, input_ids, lengths, d, pred_dur, ref_s,
                                   frame_bucket, rand_ini, noise)
        return audio, pred_dur

    return fn


def export_kokoro(model, out_path, batch: int = 1, phoneme_bucket: int = 512,
                  frame_bucket: int = 1300, device: str = "cuda") -> int:
    """Export one (batch, phoneme_bucket, frame_bucket) Kokoro program."""
    b = batch
    example = (
        torch.zeros((b, phoneme_bucket), dtype=torch.int64, device=device),
        torch.ones((b,), dtype=torch.int64, device=device),
        torch.zeros((b, 256), device=device),
        torch.ones((b,), device=device),
        torch.zeros((b, 9), device=device),
        torch.zeros((b, 600 * frame_bucket, 9), device=device),
    )
    return export_program(kokoro_synthesis_fn(model, frame_bucket), example,
                          out_path, device, [model])


# ---------------------------------------------------------------------------
# Mimi: RVQ codes -> waveform (the CSM vocoder half)
# ---------------------------------------------------------------------------


def mimi_decode_fn(mimi):
    def fn(codes):
        return mimi.decode(codes)

    return fn


def export_mimi_decode(mimi, out_path, batch: int = 1, frames: int = 63,
                       device: str = "cuda") -> int:
    example = (torch.zeros((batch, mimi.cfg.quantizer_nq, frames),
                           dtype=torch.int64, device=device),)
    return export_program(mimi_decode_fn(mimi), example, out_path, device, [mimi])


def export_mimi_stream_decode(mimi, out_path, batch: int = 1,
                              chunk_frames: int = 32,
                              device: str = "cuda") -> dict:
    """Export the STATEFUL chunked Mimi decode: (codes [B, nq, n],
    *flat_state) -> (audio [B, 1, n*1920], *flat_state).

    Successive chunks continue ONE conv/transformer stream, so chunked
    decode is seamless (the guarantee of the reference's
    MimiStreamingDecoder) instead of O(n^2) re-decode or chunk seams.  The
    decode half of ``MimiState`` crosses the boundary as flat tensors: conv
    tails, transformer rings, the rings' offsets (0-d int64) and the convs'
    stream-start flags (0-d bool); a JSON sidecar records their shapes,
    dtypes and initial values (``"zeros"`` or the scalar)."""
    state0 = mimi.init_state(batch)
    sub0 = pytree.tree_map(
        lambda x: x if isinstance(x, torch.Tensor) else _position(x, device),
        (state0.upsample, state0.decoder_tf, state0.decoder))
    flat, spec = pytree.tree_flatten(sub0)

    def decode_chunk(codes, *flat_state):
        up, dtf, dec = pytree.tree_unflatten(list(flat_state), spec)
        state = state0._replace(upsample=up, decoder_tf=dtf, decoder=dec)
        audio, state = mimi.decode_frames_stateful(codes, state)
        out = pytree.tree_leaves((state.upsample, state.decoder_tf, state.decoder))
        # a leaf that a step passes through is returned as a copy
        return (audio, *[t.clone() if any(t is s for s in flat_state) else t
                         for t in out])

    nq = mimi.cfg.quantizer_nq
    example = (torch.zeros((batch, nq, chunk_frames), dtype=torch.int64,
                           device=device), *flat)
    n = export_program(decode_chunk, example, out_path, device, [mimi])

    def leaf_init(x):
        if x.ndim == 0:          # ring offsets and stream-start flags
            return x.item()
        if x.any():
            raise ValueError("non-scalar state leaf with non-zero init")
        return "zeros"

    meta = {
        "chunk_frames": chunk_frames,
        "batch": batch,
        "nq": nq,
        "samples_per_frame": int(mimi.samples_per_frame),
        "device": str(device),
        "state_shapes": [list(x.shape) for x in flat],
        "state_dtypes": [_dtype_name(x.dtype) for x in flat],
        "state_init": [leaf_init(x) for x in flat],
    }
    _write_meta(f"{out_path}.meta.json", meta)
    return {"bytes": n, **meta}


# ---------------------------------------------------------------------------
# Sessions: prefill + chunk programs over flat caches (the on-device
# analogue of the Swift port's SesameSession and OrpheusTTSModel)
# ---------------------------------------------------------------------------


def _flat_caches(caches) -> tuple:
    return tuple(x for c in caches for x in (c.k, c.v, c.idx))


def _caches(flat) -> list:
    return [KVCache(*flat[3 * i:3 * i + 3]) for i in range(len(flat) // 3)]


def _session_caches(caches, device) -> tuple:
    """Fresh caches as a program's flat inputs, each write index a 0-d
    tensor."""
    for c in caches:
        c.idx = _position(0, device)
    return _flat_caches(caches)


def _chunk_loop(n: int, step, out0, last0, flat0):
    """``n`` decode steps as one ``while_loop``: ``step(i, last, caches) ->
    (out, caches)`` writes out[i]; returns (outs [n, ...], flat caches)."""
    from torch._higher_order_ops import while_loop

    def cond(i, outs, last, *flat):
        return i < n

    def body(i, outs, last, *flat):
        out, caches = step(i, last, _caches(flat))
        outs = outs.index_copy(0, i.reshape(1), out[None].to(outs.dtype))
        return (i + 1, outs, out, *_flat_caches(caches))

    i0 = torch.zeros((), dtype=torch.int64, device=out0.device)
    _, outs, _, *flat = while_loop(cond, body, (i0, out0, last0, *flat0))
    return (outs, *flat)


def noise_width(vocab: int) -> int:
    """The vocabulary padded to 128, as the CSM draft pads it: the last
    dimension of a CSM session's noise."""
    return -(-vocab // 128) * 128


def csm_session_fns(model, temp: float = 0.9, top_k: int = 50):
    """(prefill_fn, chunk_fn) closures over the CSM LM (``Model.model``).

    prefill(tokens [B,T,nc+1], mask bool, pad_len [B], noise [B, nc, Vp],
            *flat_caches) -> (frame [B, nc], *flat_caches)
    chunk(last_frame [B, nc], pad_len, noise [n, B, nc, Vp], *flat_caches,
          n) -> (frames [n, B, nc], *flat_caches)
    ``noise`` is the frames' Gumbel rows (``SesameModel.frame_from_noise``);
    at batch 1 with spec decode on, each frame drafts c2..c31 with
    ``depth_draft`` and finishes its rejected tail in a ``while_loop``.
    An all-zero frame is EOS (reference sesame.py:779)."""

    def prefill(tokens, mask, pad_len, noise, *flat_caches):
        embeds = model.embed_tokens(tokens, mask)
        h, caches = model.backbone.prefill(_caches(flat_caches), embeds, pad_len)
        frame = model.frame_from_noise(h[:, -1], noise, temp, top_k)
        return (frame, *_flat_caches(caches))

    def chunk(last_frame, pad_len, noise, *flat_caches, n: int):
        b = last_frame.shape[0]

        def step(i, last, caches):
            tokens = F.pad(last, (0, 1))[:, None]
            mask = (torch.arange(tokens.shape[-1], device=tokens.device)
                    < tokens.shape[-1] - 1).expand_as(tokens)
            h, caches = model.backbone.step(caches, model.embed_tokens(tokens, mask),
                                            pad_len)
            return model.frame_from_noise(h[:, -1], row_at(noise, i), temp, top_k), caches

        out0 = last_frame.new_zeros((n, b, last_frame.shape[1]))
        return _chunk_loop(n, step, out0, last_frame, flat_caches)

    return prefill, chunk


def export_csm_session(model, out_prefix, prompt_bucket: int = 256,
                       max_frames: int = 1125, chunk_frames: int = 32,
                       temp: float = 0.9, top_k: int = 50, batch: int = 1,
                       device: str = "cuda") -> dict:
    """Write <prefix>.prefill / <prefix>.chunk / <prefix>.meta.json.
    ``model``: the SesameModel (Model.model).  Mimi decode is exported
    separately with export_mimi_decode."""
    import functools

    from mlx_audio_tpu_torch.models.tts.sesame.model import DRAFT_CACHE

    lm = model
    nc = lm.audio_num_codebooks
    vp = noise_width(lm.audio_vocab_size)
    # a traced step reads RoPE rows below its caches' capacity: any rows
    # past the tables are computed here, before tracing
    lm.backbone._rope(prompt_bucket + max_frames)
    lm.decoder._rope(DRAFT_CACHE)
    flat = _session_caches(lm.backbone.init_cache(
        batch, max_len=prompt_bucket + max_frames, dtype=lm.lm_dtype()), device)
    prefill, chunk = csm_session_fns(lm, temp=temp, top_k=top_k)
    pre_args = (
        torch.zeros((batch, prompt_bucket, nc + 1), dtype=torch.int64, device=device),
        torch.zeros((batch, prompt_bucket, nc + 1), dtype=torch.bool, device=device),
        torch.zeros((batch,), dtype=torch.int64, device=device),
        torch.zeros((batch, nc, vp), device=device),
        *flat,
    )
    n1 = export_program(prefill, pre_args, f"{out_prefix}.prefill", device, [lm])
    chunk_args = (
        torch.zeros((batch, nc), dtype=torch.int64, device=device),
        torch.zeros((batch,), dtype=torch.int64, device=device),
        torch.zeros((chunk_frames, batch, nc, vp), device=device),
        *flat,
    )
    n2 = export_program(functools.partial(chunk, n=chunk_frames), chunk_args,
                        f"{out_prefix}.chunk", device, [lm])
    meta = {
        "audio_num_codebooks": nc,
        "prompt_bucket": prompt_bucket,
        "chunk_frames": chunk_frames,
        "batch": batch,
        "device": str(device),
        "spec_decode": bool(lm._use_spec(batch)),
        "rng": RNG_CONTRACT,
        "noise_shapes": {"prefill": [batch, nc, vp],
                         "chunk": [chunk_frames, batch, nc, vp]},
        "cache_shapes": [list(x.shape) for x in flat],
        "cache_dtypes": [_dtype_name(x.dtype) for x in flat],
        "eos": "all-zero frame",
        "frame_ms": 80,
    }
    _write_meta(f"{out_prefix}.meta.json", meta)
    return {"prefill_bytes": n1, "chunk_bytes": n2, **meta}


def causal_session_fns(lm, temp: float, top_k: int, top_p: float):
    """(prefill_fn, chunk_fn) closures over a LlamaForCausalLM.

    prefill(input_ids [B,T], pad_len [B], noise [B, V], *flat_caches)
            -> (first_token [B], *flat_caches)
    chunk(last [B], pad_len, noise [n, B, V], *flat_caches, n)
            -> (toks [n, B], *flat_caches)
    A token draws from its noise row as ``sample_top_k_rows`` /
    ``sample_top_p_rows`` draw from theirs (``models.sampling.
    sample_from_noise``).  Stop-token handling is the consumer's (host)
    job, as in the in-process loop (models/lm/causal.py)."""
    from mlx_audio_tpu_torch.models.sampling import sample_from_noise

    def sample(logits, noise):
        return sample_from_noise(logits, temp, top_k, top_p, noise)

    def prefill(input_ids, pad_len, noise, *flat_caches):
        h, caches = lm.model.prefill(_caches(flat_caches), input_ids, pad_len)
        first = sample(lm.logits(h[:, -1]).float(), noise)
        return (first, *_flat_caches(caches))

    def chunk(last, pad_len, noise, *flat_caches, n: int):
        def step(i, prev, caches):
            h, caches = lm.model.step(caches, prev[:, None], pad_len)
            return sample(lm.logits(h[:, -1]).float(), row_at(noise, i)), caches

        return _chunk_loop(n, step, last.new_zeros((n, last.shape[0])), last,
                           flat_caches)

    return prefill, chunk


def export_causal_session(lm, out_prefix, prompt_bucket: int = 128,
                          max_tokens: int = 1200, chunk_tokens: int = 64,
                          temp: float = 0.6, top_k: int = 0,
                          top_p: float = 1.0, batch: int = 1,
                          extra_meta: Optional[dict] = None,
                          device: str = "cuda") -> dict:
    """Write <prefix>.prefill / <prefix>.chunk / <prefix>.meta.json for a
    causal-LM token session."""
    import functools

    from mlx_audio_tpu_torch.models.lm.llama import lm_dtype

    vocab = lm.config.vocab_size
    lm.model._rope(prompt_bucket + max_tokens)  # rows past the table, before tracing
    flat = _session_caches(lm.model.init_cache(
        batch, max_len=prompt_bucket + max_tokens, dtype=lm_dtype(lm)), device)
    prefill, chunk = causal_session_fns(lm, temp, top_k, top_p)
    pre_args = (
        torch.zeros((batch, prompt_bucket), dtype=torch.int64, device=device),
        torch.zeros((batch,), dtype=torch.int64, device=device),
        torch.zeros((batch, vocab), device=device),
        *flat,
    )
    n1 = export_program(prefill, pre_args, f"{out_prefix}.prefill", device, [lm])
    chunk_args = (
        torch.zeros((batch,), dtype=torch.int32, device=device),
        torch.zeros((batch,), dtype=torch.int64, device=device),
        torch.zeros((chunk_tokens, batch, vocab), device=device),
        *flat,
    )
    n2 = export_program(functools.partial(chunk, n=chunk_tokens), chunk_args,
                        f"{out_prefix}.chunk", device, [lm])
    meta = {
        "prompt_bucket": prompt_bucket,
        "chunk_tokens": chunk_tokens,
        "batch": batch,
        "device": str(device),
        "rng": RNG_CONTRACT,
        "noise_shapes": {"prefill": [batch, vocab],
                         "chunk": [chunk_tokens, batch, vocab]},
        "cache_shapes": [list(x.shape) for x in flat],
        "cache_dtypes": [_dtype_name(x.dtype) for x in flat],
        **(extra_meta or {}),
    }
    _write_meta(f"{out_prefix}.meta.json", meta)
    return {"prefill_bytes": n1, "chunk_bytes": n2, **meta}


def snac_noise_shapes(snac, frames: int, batch: int = 1) -> list:
    """The decoder blocks' draws of a SNAC decode of ``frames`` finest-level
    codes: one [B, T_i, 1] a block (none without noise blocks)."""
    if not snac.config.noise:
        return []
    w = snac.attn_window_size
    t = -(-frames // w) * w if w else frames
    shapes = []
    for rate in snac.config.decoder_rates:
        t *= rate
        shapes.append([batch, t, 1])
    return shapes


def export_snac_decode(snac, out_path, frames: int = 64, batch: int = 1,
                       device: str = "cuda") -> int:
    """Export SNAC decode: the code streams at the strides of the frame
    count, then the decoder blocks' normal draws (``snac_noise_shapes``) ->
    waveform [B, 1, samples]."""
    strides = list(snac.vq_strides)

    def fn(*args):
        codes, noise = args[:len(strides)], args[len(strides):]
        return snac.decode(list(codes), noise=list(noise) or None)

    example = (*[torch.zeros((batch, frames // s), dtype=torch.int64, device=device)
                 for s in strides],
               *[torch.zeros(s, device=device)
                 for s in snac_noise_shapes(snac, frames, batch)])
    return export_program(fn, example, out_path, device, [snac])


def export_orpheus(model, out_prefix, prompt_bucket: int = 128,
                   max_tokens: int = 1200, chunk_tokens: int = 64,
                   snac_frames: int = 64, batch: int = 1,
                   device: str = "cuda") -> dict:
    """Orpheus on-device set: the LM token session + the SNAC vocoder
    program + a meta sidecar carrying the 7-token frame constants the host
    needs to parse codes out of the token stream (models/tts/llama)."""
    from mlx_audio_tpu_torch.models.tts.llama.llama import (
        AUDIO_MARK,
        CODE_OFFSET,
        STOP_AUDIO,
    )

    info = export_causal_session(
        model.lm, out_prefix, prompt_bucket=prompt_bucket,
        max_tokens=max_tokens, chunk_tokens=chunk_tokens,
        temp=0.6, top_p=0.8, batch=batch,
        extra_meta={
            "family": "orpheus",
            "stop_token": int(STOP_AUDIO),
            "audio_mark": int(AUDIO_MARK),
            "code_offset": int(CODE_OFFSET),
            "codes_per_frame": 7,
            "snac_program": f"{out_prefix}.snac",
            "snac_frames": snac_frames,
            "snac_noise_shapes": snac_noise_shapes(model._snac, snac_frames),
        },
        device=device,
    )
    info["snac_bytes"] = export_snac_decode(
        model._snac, f"{out_prefix}.snac", frames=snac_frames, batch=1,
        device=device)
    return info


# ---------------------------------------------------------------------------
# Whisper greedy window decode: the STT path as one exported program
# ---------------------------------------------------------------------------


def whisper_greedy_fn(model, tokenizer, sample_len: int = 224):
    """mel [B, 3000, n_mels] f32 -> (tokens [B, L], t_end, sum_logprob [B],
    no_speech_prob [B]): encoder + cross-KV + prefill + the greedy
    ``while_loop`` with the standard logit filters, language and task fixed
    at export time.  Host-side finalize (slice at sample_begin, cut at
    EOT, decode text) is recorded in the meta sidecar."""
    import numpy as np

    from mlx_audio_tpu_torch.models.stt.whisper.api import (
        _initial_tokens,
        _prefill,
        _suppress_token_list,
    )
    from mlx_audio_tpu_torch.models.stt.whisper.audio import CHUNK_LENGTH
    from mlx_audio_tpu_torch.models.stt.whisper.decoding import (
        DecodingOptions,
        FilterConfig,
        greedy_decode_graph,
    )

    options = DecodingOptions(language=tokenizer.language, temperature=0.0,
                              sample_len=sample_len)
    n_ctx = model.dims.n_text_ctx
    initial = list(_initial_tokens(tokenizer, options, n_ctx, sample_len))
    sot_index = initial.index(tokenizer.sot)
    n_init = len(initial)
    cfg = FilterConfig(
        eot=tokenizer.eot,
        timestamp_begin=tokenizer.timestamp_begin,
        no_timestamps=tokenizer.no_timestamps,
        max_initial_timestamp_index=round(
            1.0 / (CHUNK_LENGTH / model.dims.n_audio_ctx)),
        apply_timestamp_rules=True,
    )
    n_vocab = model.dims.n_vocab
    suppress = np.zeros((n_vocab,), np.float32)
    suppress[list(_suppress_token_list(tokenizer, options))] = -np.inf
    blank = np.zeros((n_vocab,), np.float32)
    blank[tokenizer.encode(" ") + [tokenizer.eot]] = -np.inf
    dev = model.device
    suppress_mask = torch.as_tensor(suppress, device=dev)
    blank_mask = torch.as_tensor(blank, device=dev)
    buf_len = n_init + sample_len + 1
    prompt = torch.as_tensor(initial + [tokenizer.eot] * (buf_len - n_init),
                             dtype=torch.int64, device=dev)
    no_speech = tokenizer.no_speech

    def fn(mel):
        b = mel.shape[0]
        features = model.encoder(mel.to(model.encoder.conv1.weight.dtype))
        tokens0 = prompt.repeat(b, 1)
        cross_kv = model.decoder.compute_cross_kv(features)
        caches = model.decoder.init_cache(b, buf_len, dtype=features.dtype)
        _session_caches(caches, mel.device)
        sot_logits, caches = _prefill(model, caches, cross_kv, tokens0[:, :n_init],
                                      n_init, sot_index)
        for c in caches:  # the prefill rewinds to the last prompt slot
            c.idx = _position(n_init - 1, mel.device)
        ns_prob = torch.softmax(sot_logits, dim=-1)[:, no_speech]
        toks, t_end, sum_lp = greedy_decode_graph(
            model, caches, cross_kv, tokens0, n_init, n_init, suppress_mask,
            blank_mask, sample_len=sample_len, params=cfg)
        return toks, t_end, sum_lp, ns_prob

    return fn, {"sample_begin": n_init, "eot": int(tokenizer.eot),
                "sample_len": sample_len}


def export_whisper_greedy(model, out_path, batch: int = 1,
                          language: str = "en", task: str = "transcribe",
                          sample_len: int = 224, device: str = "cuda") -> dict:
    """Export one greedy Whisper window-decode program (30 s window,
    language and task fixed)."""
    tokenizer = model._tokenizer(language, task)
    fn, finalize = whisper_greedy_fn(model, tokenizer, sample_len=sample_len)
    n_frames = 2 * model.dims.n_audio_ctx
    example = (torch.zeros((batch, n_frames, model.dims.n_mels), device=device),)
    n = export_program(fn, example, out_path, device, [model])
    meta = {
        "batch": batch, "language": language, "task": task,
        "n_frames": n_frames, "n_mels": model.dims.n_mels,
        "device": str(device), "finalize": finalize,
    }
    _write_meta(f"{out_path}.meta.json", meta)
    return {"bytes": n, **meta}


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        description="Export an inference artifact (torch.export; weights "
                    "inside, the port's kernels as custom ops)")
    ap.add_argument("--model", required=True,
                    help="local model directory (kokoro, csm, orpheus, "
                         "whisper) or codec directory (mimi)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--kind", default="kokoro",
                    choices=["kokoro", "mimi", "mimi-stream", "csm",
                             "orpheus", "whisper"])
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--phoneme-bucket", type=int, default=512)
    ap.add_argument("--frame-bucket", type=int, default=1300)
    ap.add_argument("--frames", type=int, default=63,
                    help="mimi: codes length of the exported program")
    ap.add_argument("--chunk-frames", type=int, default=32,
                    help="mimi-stream: frames per stateful decode chunk")
    ap.add_argument("--language", default="en", help="whisper export")
    ap.add_argument("--device", default="cuda",
                    help="the device the program runs on (cuda or cpu)")
    args = ap.parse_args(argv)

    device = args.device
    if args.kind in ("kokoro", "csm", "orpheus"):
        from mlx_audio_tpu_torch.utils.loader import load_model

        model = load_model(args.model, domain="tts", device=device)
    if args.kind == "kokoro":
        inner = getattr(model, "model", model)
        n = export_kokoro(inner, args.out, batch=args.batch,
                          phoneme_bucket=args.phoneme_bucket,
                          frame_bucket=args.frame_bucket, device=device)
    elif args.kind == "csm":
        info = export_csm_session(model.model, args.out, batch=args.batch,
                                  device=device)
        print(f"wrote {args.out}.prefill/.chunk/.meta.json "
              f"({(info['prefill_bytes'] + info['chunk_bytes']) / 1e6:.1f} MB, "
              f"device={device})")
        return
    elif args.kind == "orpheus":
        info = export_orpheus(model, args.out, batch=args.batch, device=device)
        total = info["prefill_bytes"] + info["chunk_bytes"] + info["snac_bytes"]
        print(f"wrote {args.out}.prefill/.chunk/.snac/.meta.json "
              f"({total / 1e6:.1f} MB)")
        return
    elif args.kind == "whisper":
        from mlx_audio_tpu_torch.models.stt.whisper import Model as WhisperM

        model = WhisperM.from_pretrained(args.model, device=device)
        info = export_whisper_greedy(model, args.out, batch=args.batch,
                                     language=args.language, device=device)
        print(f"wrote {args.out} ({info['bytes'] / 1e6:.1f} MB, "
              f"language={args.language})")
        return
    else:
        from mlx_audio_tpu_torch.codec.mimi import Mimi

        mimi = Mimi.from_pretrained(args.model, device=device)
        if args.kind == "mimi-stream":
            info = export_mimi_stream_decode(
                mimi, args.out, batch=args.batch,
                chunk_frames=args.chunk_frames, device=device)
            print(f"wrote {args.out} (+.meta.json, {info['bytes'] / 1e6:.1f} MB, "
                  f"chunk={args.chunk_frames} frames)")
            return
        n = export_mimi_decode(mimi, args.out, batch=args.batch,
                               frames=args.frames, device=device)
    print(f"wrote {args.out} ({n / 1e6:.1f} MB, device={device})")


if __name__ == "__main__":
    main()
