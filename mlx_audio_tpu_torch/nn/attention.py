"""Attention: scaled dot-product attention with grouped-query heads, the
causal mask, rotary tables, the decode KV cache and the generic
``MultiHeadAttention`` module (counterpart of
``mlx_audio_tpu/nn/attention.py``).

The JAX package threads an immutable cache through its jitted steps; here
``KVCache`` is a small mutable object whose ``update`` writes the new keys
and values into its fixed-capacity buffers in place (no copy of the cache per
step) and advances a Python-int write index.  An exported program
(``mlx_audio_tpu_torch.export``) takes its caches as inputs and reads the
write position from them: there the index is a 0-d integer tensor, and
``update`` writes out of place at tensor positions (``index_copy``), which
a traced loop body may do; ``valid_mask`` and ``apply_rope`` take either
kind of position and compute the same values.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from mlx_audio_tpu_torch.nn.layers import Linear, promote_operands


def scaled_dot_product_attention(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor,
                                 mask: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """q: [B, Hq, Lq, D]; k, v: [B, Hkv, Lk, D] with Hq a multiple of Hkv
    (grouped-query heads share a key/value head without a copy of the cache);
    ``mask`` additive, broadcast to [B, Hq, Lq, Lk] scores.

    Written as matmul + softmax, with the scores taken to float32, divided
    by sqrt(D) and put through the softmax there, as the JAX package's
    attention does.  Mixed dtypes promote, as its einsums do: a float32
    query (a bf16 LM's prompt that holds float32 embeddings) over a bf16
    cache scores in float32.
    """
    b, hq, lq, d = q.shape
    hkv = k.shape[1]
    if hq != hkv:
        rep = hq // hkv
        qg = q.reshape(b, hkv, rep, lq, d)
        scores = torch.matmul(*promote_operands(
            qg, k[:, :, None].transpose(-1, -2))).float() / math.sqrt(d)
        if mask is not None:
            if mask.ndim == 4 and mask.shape[1] == hq:
                mask = mask.reshape(mask.shape[0], hkv, rep, *mask.shape[2:])
            elif mask.ndim == 4:
                mask = mask[:, :, None]
            scores = scores + mask
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        return torch.matmul(*promote_operands(probs, v[:, :, None])).reshape(b, hq, lq, d)
    scores = torch.matmul(*promote_operands(q, k.transpose(-1, -2))).float() / math.sqrt(d)
    if mask is not None:
        scores = scores + mask
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.matmul(*promote_operands(probs, v))


def causal_mask(length: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """[length, length] additive causal mask: -1e9 above the diagonal."""
    i = torch.arange(length, device=device)
    return torch.where(i[None, :] > i[:, None], -1e9, 0.0).to(dtype)


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------


def rope_table(head_dim: int, max_len: int, base: float = 10000.0,
               scaling: Optional[dict] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) tables [max_len, head_dim // 2] in float32, computed in
    float64 with numpy as the JAX package computes them, so they are equal.

    ``scaling`` is Llama-3 frequency scaling: keys ``factor``,
    ``low_freq_factor``, ``high_freq_factor``,
    ``original_max_position_embeddings``."""
    inv_freq = 1.0 / (base ** (np.arange(0, head_dim, 2) / head_dim))
    if scaling:
        factor = scaling.get("factor", 8.0)
        low = scaling.get("low_freq_factor", 1.0)
        high = scaling.get("high_freq_factor", 4.0)
        orig = scaling.get("original_max_position_embeddings", 8192)
        wavelen = 2 * np.pi / inv_freq
        low_wl = orig / low
        high_wl = orig / high
        smooth = (orig / wavelen - low) / (high - low)
        inv_freq = np.where(
            wavelen > low_wl, inv_freq / factor,
            np.where(wavelen < high_wl, inv_freq,
                     (1 - smooth) * inv_freq / factor + smooth * inv_freq))
    freqs = np.outer(np.arange(max_len), inv_freq)
    return (torch.tensor(np.cos(freqs), dtype=torch.float32),
            torch.tensor(np.sin(freqs), dtype=torch.float32))


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               start=0) -> torch.Tensor:
    """Rotate [B, H, L, D] queries or keys at positions start .. start+L-1
    (``start`` an int or a 0-d integer tensor), or at the positions that
    ``start`` lists, [L] or one row a batch row [B, L].  Pairs are
    (x[..., :D/2], x[..., D/2:]), the half-split convention of Llama
    checkpoints."""
    length = x.shape[-2]
    if isinstance(start, torch.Tensor) and start.ndim > 0:
        c, s = cos[start].to(x.dtype), sin[start].to(x.dtype)
        if start.ndim == 2:  # [B, L, D/2] -> [B, 1, L, D/2]
            c, s = c[:, None], s[:, None]
    elif isinstance(start, torch.Tensor):
        rows = start + torch.arange(length, device=cos.device)
        c, s = cos[rows].to(x.dtype), sin[rows].to(x.dtype)
    else:
        c = cos[start:start + length].to(x.dtype)
        s = sin[start:start + length].to(x.dtype)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def row_at(x: torch.Tensor, i) -> torch.Tensor:
    """x[i] for an int or a 0-d integer tensor ``i`` (a traced loop's
    position, which the trace cannot read as a number)."""
    if isinstance(i, torch.Tensor):
        return x.index_select(0, i.reshape(1))[0]
    return x[i]


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------


class KVCache:
    """Fixed-capacity decode cache: k, v [B, Hkv, max_len, D] and the next
    write position ``idx``, an int, or a 0-d integer tensor in an exported
    program."""

    def __init__(self, k: torch.Tensor, v: torch.Tensor, idx=0):
        self.k, self.v, self.idx = k, v, idx

    @classmethod
    def create(cls, batch: int, num_kv_heads: int, max_len: int,
               head_dim: int, dtype=torch.float32,
               device=None) -> "KVCache":
        shape = (batch, num_kv_heads, max_len, head_dim)
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))

    def update(self, k_new: torch.Tensor, v_new: torch.Tensor) -> "KVCache":
        """Write [B, Hkv, S, D] at the write position, in place, and advance
        it; at a tensor position the buffers are replaced by written copies
        (no check of the capacity, which the exporter sizes).  Returns
        self."""
        s = k_new.shape[-2]
        if isinstance(self.idx, torch.Tensor):
            pos = self.idx + torch.arange(s, device=self.k.device)
            self.k = self.k.index_copy(2, pos, k_new.to(self.k.dtype))
            self.v = self.v.index_copy(2, pos, v_new.to(self.v.dtype))
            self.idx = self.idx + s
            return self
        if self.idx + s > self.k.shape[-2]:
            raise ValueError(f"KV cache full: {self.idx} + {s} > "
                             f"{self.k.shape[-2]}")
        self.k[:, :, self.idx:self.idx + s] = k_new.to(self.k.dtype)
        self.v[:, :, self.idx:self.idx + s] = v_new.to(self.v.dtype)
        self.idx += s
        return self

    def valid_mask(self, q_len: int, causal: bool = True) -> torch.Tensor:
        """Additive mask [q_len, max_len] hiding unwritten slots (and the
        future, if causal) for a step appending ``q_len`` entries; called on
        the cache before its update."""
        max_len = self.k.shape[-2]
        j = torch.arange(max_len, device=self.k.device)[None, :]
        i = torch.arange(q_len, device=self.k.device)[:, None]
        limit = self.idx + i + 1 if causal else self.idx + q_len + 0 * i
        return torch.where(j < limit, 0.0, -1e9).float()


def cached_attention(q: torch.Tensor, k_new: torch.Tensor,
                     v_new: torch.Tensor, cache: KVCache,
                     extra_mask: Optional[torch.Tensor] = None
                     ) -> tuple[torch.Tensor, KVCache]:
    """One decode step: append keys and values, attend over the cache.
    ``extra_mask`` (additive, e.g. padding) adds to the validity mask."""
    mask = cache.valid_mask(q.shape[-2])
    cache.update(k_new, v_new)
    if extra_mask is not None:
        mask = mask + extra_mask
    return scaled_dot_product_attention(q, cache.k, cache.v, mask), cache


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


class MultiHeadAttention(nn.Module):
    """Attention with separate q/k/v/o projections and grouped-query heads
    over NLC input (the JAX package's generic ``MultiHeadAttention``)."""

    def __init__(self, dim: int, num_heads: int,
                 num_kv_heads: Optional[int] = None,
                 head_dim: Optional[int] = None, bias: bool = False,
                 out_dim: Optional[int] = None):
        super().__init__()
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads or num_heads
        self.head_dim = head_dim or dim // num_heads
        inner = self.num_heads * self.head_dim
        inner_kv = self.num_kv_heads * self.head_dim
        self.q_proj = Linear(dim, inner, bias=bias)
        self.k_proj = Linear(dim, inner_kv, bias=bias)
        self.v_proj = Linear(dim, inner_kv, bias=bias)
        self.o_proj = Linear(inner, out_dim or dim, bias=bias)

    def _split(self, x: torch.Tensor, heads: int) -> torch.Tensor:
        b, l, _ = x.shape
        return x.reshape(b, l, heads, self.head_dim).transpose(1, 2)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                rope: Optional[tuple] = None, positions=None,
                cache: Optional[KVCache] = None,
                xk: Optional[torch.Tensor] = None):
        """Self-attention, or cross-attention over ``xk``; ``rope`` (cos,
        sin) rotates queries and keys at ``positions`` (``apply_rope``'s
        ``start``: none is 0).  With a ``cache`` the keys and values append
        to it and the caller's ``mask`` adds to the cache's validity mask.
        Returns the output, or (output, cache) when a cache is passed."""
        q = self._split(self.q_proj(x), self.num_heads)
        src = x if xk is None else xk
        k = self._split(self.k_proj(src), self.num_kv_heads)
        v = self._split(self.v_proj(src), self.num_kv_heads)
        if rope is not None:
            start = 0 if positions is None else positions
            q = apply_rope(q, *rope, start)
            k = apply_rope(k, *rope, start)
        if cache is not None:
            out, cache = cached_attention(q, k, v, cache, extra_mask=mask)
        else:
            out = scaled_dot_product_attention(q, k, v, mask)
        b, h, l, d = out.shape
        out = self.o_proj(out.transpose(1, 2).reshape(b, l, h * d))
        return out if cache is None else (out, cache)
