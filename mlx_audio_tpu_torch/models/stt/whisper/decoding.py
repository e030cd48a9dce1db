"""Whisper's decode loops, logit filters and batched beam search
(counterpart of ``mlx_audio_tpu/models/stt/whisper/decoding.py``).

* The JAX package's ``lax.while_loop`` over fixed-size token buffers is a
  Python loop here, a step a decoder call on the device.  The host reads the
  finished flags every ``_CHECK_EVERY`` steps only; the step at which every
  row had finished is kept on the device, so the loop returns what the
  JAX package's does.
* The timestamp rules follow original Whisper (token values), vectorised
  over the batch.
* Beam search keeps [n_audio * beam] rows on the device, reorders beams
  through an origin map instead of copying the caches, and retires an
  audio once it has its candidates (its pool then freezes).  The JAX
  package's power-of-two row buckets are jit shapes and are gone: a
  compaction keeps exactly the live audios.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Dict, Iterable, List, NamedTuple, Optional, Union

import numpy as np
import torch

from mlx_audio_tpu_torch.models.sampling import call_seed, sample_top_k_rows

_CHECK_EVERY = 8  # decode steps between the host's looks at the finished rows


def compression_ratio(text: str) -> float:
    text_bytes = text.encode("utf-8")
    return len(text_bytes) / len(zlib.compress(text_bytes))


@dataclass(frozen=True)
class DecodingOptions:
    task: str = "transcribe"
    language: Optional[str] = None
    temperature: float = 0.0
    sample_len: Optional[int] = None
    best_of: Optional[int] = None
    beam_size: Optional[int] = None
    patience: Optional[float] = None
    length_penalty: Optional[float] = None
    prompt: Optional[Union[str, List[int]]] = None
    prefix: Optional[Union[str, List[int]]] = None
    suppress_tokens: Optional[Union[str, Iterable[int]]] = "-1"
    suppress_blank: bool = True
    without_timestamps: bool = False
    max_initial_timestamp: Optional[float] = 1.0
    fp16: bool = False
    # an additive logit bias {token_id: bias} at every decode step
    logit_bias: Optional[Dict[int, float]] = None
    # per-audio finish lengths (tokens after sample_begin): row i is forced
    # to emit EOT once it has decoded eot_cutoff[i] tokens (a test and bench
    # instrument for staggered finishes)
    eot_cutoff: Optional[List[int]] = None
    # finished-audio compaction in beam search (the results are equal
    # either way)
    beam_compact: bool = True


@dataclass(frozen=True)
class DecodingResult:
    audio_features: Optional[torch.Tensor]
    language: str
    language_probs: Optional[Dict[str, float]] = None
    tokens: List[int] = field(default_factory=list)
    text: str = ""
    avg_logprob: float = np.nan
    no_speech_prob: float = np.nan
    temperature: float = np.nan
    compression_ratio: float = np.nan


# ---------------------------------------------------------------------------
# Logit filters
# ---------------------------------------------------------------------------


class FilterConfig(NamedTuple):
    """The constants of the logit filters; the suppress and blank masks
    travel as tensors."""

    eot: int
    timestamp_begin: int
    no_timestamps: int
    max_initial_timestamp_index: int  # -1 disables
    apply_timestamp_rules: bool


def apply_filters(logits: torch.Tensor, tokens: torch.Tensor, t: int,
                  sample_begin: int, p: FilterConfig,
                  suppress_mask: torch.Tensor, blank_mask: torch.Tensor) -> torch.Tensor:
    """logits [B, V]; tokens [B, L], a buffer whose first ``t`` are valid."""
    t, sample_begin = int(t), int(sample_begin)
    v = logits.shape[-1]
    logits = logits + suppress_mask
    at_start = t == sample_begin
    if at_start:
        logits = logits + blank_mask
    if not p.apply_timestamp_rules:
        return logits

    ninf = float("-inf")
    ts_begin = p.timestamp_begin
    dev = logits.device
    vocab_ids = torch.arange(v, device=dev)[None, :]
    logits = torch.where(vocab_ids == p.no_timestamps, ninf, logits)

    pos = torch.arange(tokens.shape[1], device=dev)[None, :]
    in_seq = (pos >= sample_begin) & (pos < t)
    last = tokens[:, max(t - 1, 0)]
    penult = tokens[:, max(t - 2, 0)]
    seq_len = t - sample_begin
    last_was_ts = (last >= ts_begin) & (seq_len >= 1)
    penult_was_ts = (penult >= ts_begin) | (seq_len < 2)

    # timestamps come in pairs, except before EOT
    force_text = last_was_ts & penult_was_ts
    force_ts_or_eot = last_was_ts & ~penult_was_ts
    logits = torch.where(force_text[:, None] & (vocab_ids >= ts_begin), ninf, logits)
    logits = torch.where(force_ts_or_eot[:, None] & (vocab_ids < p.eot), ninf, logits)

    # timestamps do not decrease: below the last one's value, or below it
    # plus one where it must advance
    ts_tokens = torch.where(in_seq & (tokens >= ts_begin), tokens,
                            torch.full_like(tokens, -1))
    last_ts_val = ts_tokens.amax(dim=1)
    has_ts = last_ts_val >= 0
    bump = (~last_was_ts) | penult_was_ts
    floor = last_ts_val + bump.to(last_ts_val.dtype)
    logits = torch.where(has_ts[:, None] & (vocab_ids >= ts_begin)
                         & (vocab_ids < floor[:, None]), ninf, logits)

    # at the very beginning: timestamps only, up to max_initial_timestamp
    if at_start:
        start_mask = vocab_ids < ts_begin
        if p.max_initial_timestamp_index >= 0:
            start_mask = start_mask | (vocab_ids > ts_begin + p.max_initial_timestamp_index)
        logits = torch.where(start_mask, ninf, logits)

    # a timestamp is forced where their total probability beats the best
    # text token
    logprobs = torch.log_softmax(logits, dim=-1)
    ts_logprob = torch.logsumexp(logprobs[:, ts_begin:], dim=-1, keepdim=True)
    max_text = logprobs[:, :ts_begin].amax(dim=-1, keepdim=True)
    return torch.where((ts_logprob > max_text) & (vocab_ids < ts_begin), ninf, logits)


# ---------------------------------------------------------------------------
# Greedy / sampling loop
# ---------------------------------------------------------------------------


def _force_eot(logits, force_rows, eot):
    """A one-hot EOT distribution on the forced rows (the eot_cutoff
    instrument: it overrides any -inf the filters put on EOT)."""
    v = logits.shape[-1]
    ids = torch.arange(v, device=logits.device)[None, :]
    forced = torch.where(ids == eot, 0.0, -1e30)
    return torch.where(force_rows[:, None], forced, logits)


@torch.no_grad()
def greedy_decode_loop(model, caches, cross_kv, tokens_buf, t0: int,
                       sample_begin: int, generator: Optional[torch.Generator],
                       suppress_mask, blank_mask, sample_len: int,
                       temperature: float, params: FilterConfig, eot_cutoff=None):
    """tokens_buf [B, L] with the prompt in [0, t0); decodes until every row
    has emitted EOT or the budget is spent.  A sampled step (temperature >
    0) takes its seed from ``generator`` (``models.sampling``).

    Returns (tokens_buf, t_end, sum_logprobs [B])."""
    b, l = tokens_buf.shape
    eot = params.eot
    dev = tokens_buf.device
    tokens = tokens_buf.clone()
    finished = torch.zeros(b, dtype=torch.bool, device=dev)
    sum_lp = torch.zeros(b, dtype=torch.float32, device=dev)
    end = min(t0 + sample_len, l)
    # the step after which every row had finished, else `end`
    t_done = torch.full((), end, dtype=torch.int64, device=dev)
    t = t0
    while t < end:
        logits, caches = model.decoder.step(caches, tokens[:, t - 1:t], cross_kv)
        logits = apply_filters(logits.float(), tokens, t, sample_begin, params,
                               suppress_mask, blank_mask)
        if eot_cutoff is not None:
            logits = _force_eot(logits, (t - sample_begin) >= eot_cutoff, eot)
        if temperature == 0:
            next_tok = torch.argmax(logits, dim=-1)
        else:
            next_tok = sample_top_k_rows(logits, temperature, 0,
                                         call_seed(generator)).long()
        logprobs = torch.log_softmax(logits, dim=-1)
        cur_lp = torch.gather(logprobs, 1, next_tok[:, None])[:, 0]
        sum_lp = sum_lp + torch.where(finished, 0.0, cur_lp)
        next_tok = torch.where(finished, eot, next_tok)
        tokens[:, t] = next_tok.to(tokens.dtype)
        finished = finished | (next_tok == eot)
        t += 1
        t_done = torch.where(finished.all() & (t_done == end), t, t_done)
        if (t - t0) % _CHECK_EVERY == 0 and bool(finished.all()):
            break
    return tokens, min(int(t_done), t), sum_lp


# ---------------------------------------------------------------------------
# Beam search
# ---------------------------------------------------------------------------


def _iter_top_k(x: torch.Tensor, k: int):
    """Top-k of each row by k (argmax, mask) passes: the values of a sorted
    top-k, ties broken by the lowest index (as ``lax.top_k``)."""
    rows = torch.arange(x.shape[0], device=x.device)
    vals, idxs = [], []
    x = x.clone()
    for _ in range(k):
        i = torch.argmax(x, dim=-1)
        vals.append(x[rows, i])
        idxs.append(i)
        x[rows, i] = float("-inf")
    return torch.stack(vals, -1), torch.stack(idxs, -1)


def _top_k_stable(x: torch.Tensor, k: int):
    """Top-k of each row, ties in index order (``lax.top_k``'s rule) for
    the small pools."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


@torch.no_grad()
def _beam_step(model, s: SimpleNamespace, t: int, sample_begin: int, suppress_mask,
               blank_mask, k_beam: int, n_cand: int, params: FilterConfig,
               eot_cutoff) -> None:
    """One beam step at position t, in place on ``s``: harvest EOT
    candidates into each audio's finished pool (an audio whose pool was
    full at the step's start is frozen), refill the K alive beams."""
    ab, l = s.tokens.shape
    a = ab // k_beam
    dev = s.tokens.device
    eot = params.eot
    neg = -1e30
    was_done = s.n_done >= n_cand
    # position t-1's keys and values are written by each row for itself
    # this step: record that before the attention's gather
    s.origins[:, t - 1] = torch.arange(ab, dtype=s.origins.dtype, device=dev)
    logits, s.caches = model.decoder.step(s.caches, s.tokens[:, t - 1:t], s.cross_kv,
                                          origins=s.origins)
    logits = apply_filters(logits.float(), s.tokens, t, sample_begin, params,
                           suppress_mask, blank_mask)
    if eot_cutoff is not None:
        # every beam of a forced audio emits EOT: its pool fills at the
        # scripted step
        logits = _force_eot(logits, torch.repeat_interleave(
            (t - sample_begin) >= eot_cutoff, k_beam), eot)
    logprobs = torch.log_softmax(logits, dim=-1)
    v = logprobs.shape[-1]
    cand = (s.alive_scores.reshape(ab, 1) + logprobs).reshape(a, k_beam * v)
    # the best 2K: the EOT finishes harvested and K alive beams refilled
    top_scores, top_idx = _iter_top_k(cand, 2 * k_beam)
    src_beam = top_idx // v
    tok = (top_idx % v).to(s.tokens.dtype)
    is_eot = tok == eot

    eot_scores = torch.where(is_eot & ~was_done[:, None], top_scores,
                             torch.full_like(top_scores, neg))
    merged = torch.cat([s.fin_scores, eot_scores], dim=1)
    keep_scores, keep_idx = _top_k_stable(merged, n_cand)
    grouped = s.tokens.reshape(a, k_beam, l)
    src_tokens = torch.gather(grouped, 1, src_beam[..., None].expand(-1, -1, l))
    at_t = torch.arange(l, device=dev)[None, None, :] == t
    cand_tokens = torch.where(at_t, tok[..., None], src_tokens)
    cand_len = torch.full((a, 2 * k_beam), t + 1, dtype=s.fin_len.dtype, device=dev)
    pool_tokens = torch.cat([s.fin_tokens, cand_tokens], dim=1)
    pool_len = torch.cat([s.fin_len, cand_len], dim=1)
    s.fin_tokens = torch.gather(pool_tokens, 1, keep_idx[..., None].expand(-1, -1, l))
    s.fin_len = torch.gather(pool_len, 1, keep_idx)
    s.fin_scores = keep_scores
    s.n_done = (s.fin_scores > neg / 2).sum(dim=1)

    alive_cand = torch.where(is_eot, torch.full_like(top_scores, neg), top_scores)
    s.alive_scores, alive_idx = _top_k_stable(alive_cand, k_beam)
    new_src = torch.gather(src_beam, 1, alive_idx)
    new_tok = torch.gather(tok, 1, alive_idx)
    new_tokens = torch.gather(grouped, 1, new_src[..., None].expand(-1, -1, l))
    s.tokens = torch.where(at_t, new_tok[..., None], new_tokens).reshape(ab, l)
    # the lazy beam reorder: move the origin map, not the caches
    flat_src = (torch.arange(a, device=dev)[:, None] * k_beam + new_src).reshape(-1)
    s.origins = s.origins[flat_src]


def beam_search_loop(model, caches, cross_kv, tokens_buf, t0: int, sample_begin: int,
                     suppress_mask, blank_mask, sample_len: int, beam_size: int,
                     params: FilterConfig, patience: float = 1.0,
                     eot_cutoff=None, compact: bool = True):
    """Batched beam search over [n_audio * beam] rows, each audio's beams
    tiled from one prefill.  ``patience`` searches until round(beam *
    patience) candidates of an audio have finished (original Whisper's
    BeamSearchDecoder; a full pool freezes, as HF's early_stopping=True).
    When the host sees a full pool (every ``_CHECK_EVERY`` steps) the audio
    retires: its candidates move to the host and its rows leave the
    batch (``compact``), which freezing makes exact.  Returns
    (finished_tokens [A, Kc, L], finished_lengths [A, Kc],
    finished_scores [A, Kc]) as numpy, in the input's audio order."""
    ab, l = tokens_buf.shape
    k_beam = beam_size
    n_cand = max(k_beam, int(round(k_beam * (patience or 1.0))))
    a = ab // k_beam
    eot = params.eot
    neg = np.float32(-1e30)
    dev = tokens_buf.device
    budget_end = min(t0 + sample_len, l)

    # every beam is the same after the prefill: only beam 0 expands first
    first = torch.tensor([0.0] + [float(neg)] * (k_beam - 1), device=dev)
    # the device state over [A * K] rows
    s = SimpleNamespace(
        caches=caches, cross_kv=cross_kv, tokens=tokens_buf.clone(),
        origins=torch.arange(ab, dtype=torch.int64, device=dev)[:, None].repeat(
            1, caches[0].k.shape[-2]),
        alive_scores=first[None, :].repeat(a, 1),
        fin_tokens=torch.zeros((a, n_cand, l), dtype=tokens_buf.dtype, device=dev),
        fin_len=torch.zeros((a, n_cand), dtype=torch.int64, device=dev),
        fin_scores=torch.full((a, n_cand), float(neg), device=dev),
        n_done=torch.zeros((a,), dtype=torch.int64, device=dev))

    out_tokens = np.zeros((a, n_cand, l), dtype=np.int32)
    out_len = np.zeros((a, n_cand), dtype=np.int32)
    out_scores = np.full((a, n_cand), neg, dtype=np.float32)
    live = np.arange(a)  # the input audio of each row group

    def harvest(local_rows, ft, fl, fs):
        for local in local_rows:
            out_tokens[live[local]] = ft[local]
            out_len[live[local]] = fl[local]
            out_scores[live[local]] = fs[local]

    t = t0
    while t < budget_end:
        _beam_step(model, s, t, sample_begin, suppress_mask, blank_mask, k_beam,
                   n_cand, params, eot_cutoff)
        t += 1
        if (t - t0) % _CHECK_EVERY and t < budget_end:
            continue
        done = s.n_done.cpu().numpy() >= n_cand
        if done.all() or t >= budget_end:
            break
        if not compact or not done.any():
            continue
        # retire the finished audios (their pools are frozen: exact)
        harvest(np.nonzero(done)[0], s.fin_tokens.cpu().numpy(),
                s.fin_len.cpu().numpy(), s.fin_scores.cpu().numpy())
        keep = np.nonzero(~done)[0]
        live = live[keep]
        rows_np = (keep[:, None] * k_beam + np.arange(k_beam)[None, :]).reshape(-1)
        rows = torch.as_tensor(rows_np, device=dev)
        keep_t = torch.as_tensor(keep, device=dev)
        # origin values index cache rows, which move with the rows: map the
        # old row ids to the new ones
        remap = torch.zeros(ab, dtype=torch.int64, device=dev)
        remap[rows] = torch.arange(len(rows_np), device=dev)
        s.origins = remap[s.origins[rows]]
        s.tokens = s.tokens[rows]
        for c in s.caches:
            c.k, c.v = c.k[rows], c.v[rows]
        s.cross_kv = [(ck[rows], cv[rows]) for ck, cv in s.cross_kv]
        s.alive_scores, s.n_done = s.alive_scores[keep_t], s.n_done[keep_t]
        s.fin_tokens, s.fin_len = s.fin_tokens[keep_t], s.fin_len[keep_t]
        s.fin_scores = s.fin_scores[keep_t]
        if eot_cutoff is not None:
            eot_cutoff = eot_cutoff[keep_t]
        ab = len(rows_np)

    # the audios still in flight take their best alive beams, cut at t with
    # a forced EOT
    ft, fl, fs = (s.fin_tokens.cpu().numpy(), s.fin_len.cpu().numpy(),
                  s.fin_scores.cpu().numpy())
    toks = s.tokens.cpu().numpy().reshape(len(fs), k_beam, l)
    asc = s.alive_scores.cpu().numpy()
    if t < l:
        toks[:, :, t] = eot
    pad_n = n_cand - k_beam
    toks = np.pad(toks, ((0, 0), (0, pad_n), (0, 0)), constant_values=eot)
    asc = np.pad(asc, ((0, 0), (0, pad_n)), constant_values=neg)
    need = fs <= neg / 2
    ft = np.where(need[..., None], toks, ft)
    fl = np.where(need, t + 1, fl)
    fs = np.where(need, asc, fs)
    harvest(range(len(live)), ft, fl, fs)
    return out_tokens, out_len, out_scores
