"""Token sampling (counterpart of ``mlx_audio_tpu/models/sampling.py``).

A categorical draw is an argmax over ``logits + Gumbel noise``, as
``jax.random.categorical`` computes it.  The noise comes from an explicit
``torch.Generator``, or is passed in as ``noise`` (the same shape as the
logits): a test that hands in the JAX package's Gumbel draws gets the JAX
package's samples.  ``temp == 0`` is greedy and draws nothing.

``sample_top_k_rows`` and ``sample_top_p_rows`` sample [B, V] logits row
by row: row i draws its noise from a generator of its own seeded
``(seed * 1_000_003 + i) mod 2**64``, so a row's sample depends on the
call's seed, its row index and its own logits only, whatever rows share
its batch (the JAX package keys row i with ``fold_in(key, i)``).  A decode
loop takes each call's seed from ``call_seed`` on a host-side generator.
A data-parallel replica that holds rows ``lo ..`` of a batch runs under
``row_offset(lo)``: its row i draws as batch row ``lo + i`` does, so a row
draws the same numbers whichever replica runs it.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import torch

# Above this vocabulary size top-k draws among the k kept values, as the
# JAX package does (a full-vocabulary sort per token costs more there).
_BISECT_MIN_VOCAB = 16384


def gumbel(shape, generator: Optional[torch.Generator] = None,
           device=None) -> torch.Tensor:
    """Standard Gumbel noise in float32, -log(-log(u)) with u in (0, 1)."""
    u = torch.rand(shape, generator=generator, device=device)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(u.clamp(min=tiny, max=1.0 - 2 ** -24)))


def _categorical(logits, generator, noise):
    if noise is None:
        noise = gumbel(logits.shape, generator, logits.device)
    return torch.argmax(logits + noise, dim=-1).to(torch.int32)


def _bisect_threshold(z: torch.Tensor, keep_fn, iters: int = 48) -> torch.Tensor:
    """Largest tau such that ``keep_fn(tau)`` holds, by value bisection:
    ``keep_fn(tau [..., 1]) -> bool [..., 1]`` is true at min(z) and false
    above max(z).  48 halvings shrink the bracket below float32 resolution,
    so masking ``z >= tau`` keeps exactly the sorted-threshold set (ties at
    the boundary kept)."""
    finite = torch.isfinite(z)
    inf = torch.full((), float("inf"), device=z.device)
    lo = torch.where(finite, z, inf).amin(-1, keepdim=True)
    hi = torch.where(finite, z, -inf).amax(-1, keepdim=True)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        ge = keep_fn(mid)
        lo, hi = torch.where(ge, mid, lo), torch.where(ge, hi, mid)
    # a fully masked row keeps the unfiltered distribution
    return torch.where(finite.any(-1, keepdim=True), lo, -inf)


def sample_top_k(logits: torch.Tensor, temp: float = 1.0, top_k: int = 0,
                 generator: Optional[torch.Generator] = None,
                 noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits [..., V] -> int32 samples [...].  ``top_k=0`` disables the
    filter; ``temp=0`` is greedy."""
    if temp == 0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.float() / temp
    v = logits.shape[-1]
    if 0 < top_k < v:
        if v < _BISECT_MIN_VOCAB:
            # sorted-filter semantics: ties at the k-th value all kept
            tau = torch.sort(logits, dim=-1).values[..., -top_k, None]
            logits = torch.where(logits < tau, float("-inf"), logits)
        else:
            vals, idx = torch.topk(logits, top_k, dim=-1)
            pick = _categorical(vals, generator, noise)
            return torch.gather(idx, -1, pick[..., None].long())[..., 0].to(torch.int32)
    return _categorical(logits, generator, noise)


def sample_top_p(logits: torch.Tensor, temp: float = 1.0, top_p: float = 1.0,
                 generator: Optional[torch.Generator] = None,
                 noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Nucleus sampling: keep the smallest set of top tokens whose mass
    reaches ``top_p`` (the boundary token and its ties kept)."""
    if temp == 0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.float() / temp
    if top_p < 1.0:
        probs = torch.softmax(logits, dim=-1)
        if logits.shape[-1] < _BISECT_MIN_VOCAB:
            sl = torch.sort(logits, dim=-1, descending=True).values
            sp = torch.sort(probs, dim=-1, descending=True).values
            keep = torch.cumsum(sp, dim=-1) - sp < top_p
            tau = torch.where(keep, sl, float("inf")).amin(-1, keepdim=True)
        else:
            tau = _bisect_threshold(
                logits,
                lambda t: torch.where(logits >= t, probs, 0.0).sum(
                    -1, keepdim=True) >= top_p)
        logits = torch.where(logits < tau, float("-inf"), logits)
    return _categorical(logits, generator, noise)


def make_sampler(temp: float = 1.0, top_k: int = 0, top_p: float = 1.0):
    """``sampler(logits, generator=None, noise=None) -> tokens``: nucleus
    sampling when ``top_p < 1``, else top-k (mlx_lm's factory, as the JAX
    package's ``make_sampler``, with torch's draws in place of a key)."""
    if top_p < 1.0:
        return lambda logits, generator=None, noise=None: sample_top_p(
            logits, temp, top_p, generator, noise)
    return lambda logits, generator=None, noise=None: sample_top_k(
        logits, temp, top_k, generator, noise)


def apply_repetition_penalty(logits: torch.Tensor, history: torch.Tensor,
                             penalty) -> torch.Tensor:
    """Logits [..., V] with every token of ``history`` [..., H] (int, -1
    pads) penalised: a positive logit divided by ``penalty``, a negative one
    multiplied by it; a ``penalty`` of 1.0 returns ``logits``.  A float
    penalty becomes a tensor first: CUDA divides by a Python scalar as a
    multiplication by its reciprocal, which rounds otherwise."""
    if not isinstance(penalty, torch.Tensor):
        if penalty == 1.0:
            return logits
        penalty = torch.tensor(penalty, dtype=logits.dtype, device=logits.device)
    v = logits.shape[-1]
    hist = torch.where(history < 0, v, history).long()  # pads past the vocabulary
    seen = torch.zeros((*hist.shape[:-1], v + 1), dtype=torch.bool,
                       device=logits.device).scatter_(-1, hist, True)[..., :v]
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen, penalized, logits)


def call_seed(generator: torch.Generator) -> int:
    """The seed of one sampling call: 62 random bits from a CPU generator
    (drawn on the host, so a decode loop does not wait for the card)."""
    return int(torch.randint(0, 2 ** 62, (), generator=generator))


_ROW_OFFSET = contextvars.ContextVar("row_offset", default=0)


@contextlib.contextmanager
def row_offset(lo: int):
    """Within the block, row i of a batch draws as row ``lo + i``: a
    data-parallel replica holding rows ``lo ..`` of a batch."""
    token = _ROW_OFFSET.set(lo)
    try:
        yield
    finally:
        _ROW_OFFSET.reset(token)


def row_generator(seed: int, row: int, device=None) -> torch.Generator:
    """Row ``row``'s generator of a call seeded ``seed`` (shifted by the
    enclosing ``row_offset``)."""
    row += _ROW_OFFSET.get()
    return torch.Generator(device).manual_seed((seed * 1_000_003 + row) % 2 ** 64)


def _row_noise(logits: torch.Tensor, n: int, seed: int) -> torch.Tensor:
    dev = logits.device
    return torch.stack([gumbel((n,), row_generator(seed, i, dev), dev)
                        for i in range(logits.shape[0])])


def sample_top_k_rows(logits: torch.Tensor, temp: float = 1.0, top_k: int = 0,
                      seed: int = 0) -> torch.Tensor:
    """Per-row top-k over [B, V] logits: row i's Gumbel noise comes from
    ``row_generator(seed, i)``.  Returns int32 [B]."""
    if temp == 0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    v = logits.shape[-1]
    # the large-vocabulary path draws among the k kept values
    n = top_k if 0 < top_k < v and v >= _BISECT_MIN_VOCAB else v
    return sample_top_k(logits, temp, top_k, noise=_row_noise(logits, n, seed))


def sample_from_noise(logits: torch.Tensor, temp: float, top_k: int,
                      top_p: float, noise: torch.Tensor) -> torch.Tensor:
    """The draw of ``sample_top_p_rows`` (top_p < 1) or
    ``sample_top_k_rows`` over [B, V] logits from given Gumbel rows noise
    [B, V] in place of the rows' generators' (an exported program's
    input): the large-vocabulary top-k draw reads the first k of a row.
    With each row's noise drawn as those functions draw it, the tokens
    are theirs.  Returns int32 [B]."""
    if temp == 0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if top_p < 1.0:
        return sample_top_p(logits, temp, top_p, noise=noise)
    v = logits.shape[-1]
    n = top_k if 0 < top_k < v and v >= _BISECT_MIN_VOCAB else v
    return sample_top_k(logits, temp, top_k, noise=noise[..., :n])


def sample_top_p_rows(logits: torch.Tensor, temp: float = 1.0,
                      top_p: float = 1.0, seed: int = 0) -> torch.Tensor:
    """Per-row nucleus sampling over [B, V] logits (see
    ``sample_top_k_rows``)."""
    if temp == 0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    return sample_top_p(logits, temp, top_p,
                        noise=_row_noise(logits, logits.shape[-1], seed))
