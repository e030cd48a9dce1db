"""Mimi's transformer, batch and streaming paths (counterpart of
``mlx_audio_tpu/codec/mimi/transformer.py``): windowed causal self-attention
(``context`` frames) with the interleaved-pair ("traditional") RoPE.  The
streaming step carries a rotating KV cache of ``context`` slots."""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from mlx_audio_tpu_torch.nn.layers import LayerNorm, Linear, RMSNorm, promote_operands


@dataclass
class TransformerConfig:
    d_model: int
    num_heads: int
    num_layers: int
    causal: bool
    norm_first: bool
    bias_ff: bool
    bias_attn: bool
    layer_scale: Optional[float]
    positional_embedding: str
    use_conv_bias: bool
    gating: bool
    norm: str
    context: int
    max_period: int
    max_seq_len: int
    kv_repeat: int
    dim_feedforward: int
    conv_layout: bool
    use_conv_block: bool = False
    cross_attention: bool = False
    conv_kernel_size: int = 3

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads


def rope_traditional(x: torch.Tensor, positions: torch.Tensor,
                     max_period: float) -> torch.Tensor:
    """Interleaved-pair rotary embedding, pairs (x[..., 2i], x[..., 2i+1]);
    x [B, H, L, D], positions [L]."""
    d = x.shape[-1]
    exps = torch.arange(0, d, 2, device=x.device, dtype=torch.float32) / d
    inv_freq = 1.0 / (max_period ** exps)
    freqs = positions[:, None].float() * inv_freq[None, :]
    cos, sin = torch.cos(freqs), torch.sin(freqs)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


class RotCacheState(NamedTuple):
    """Rotating KV cache: [B, H, W, D] ring buffers and the number of tokens
    written so far (slot p % W holds position p)."""

    k: torch.Tensor
    v: torch.Tensor
    offset: int


class Attention(nn.Module):
    """Packed-QKV windowed causal self-attention."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        if cfg.kv_repeat != 1:
            raise NotImplementedError("only kv_repeat == 1")
        self.num_heads, self.head_dim = cfg.num_heads, cfg.head_dim
        self.context, self.max_period = cfg.context, cfg.max_period
        self.use_rope = cfg.positional_embedding == "rope"
        self.in_proj = Linear(cfg.d_model, 3 * cfg.d_model, bias=cfg.bias_attn)
        self.out_proj = Linear(cfg.d_model, cfg.d_model, bias=cfg.bias_attn)

    def _qkv(self, x: torch.Tensor, positions: torch.Tensor):
        b, t, _ = x.shape
        qkv = self.in_proj(x).reshape(b, t, 3, self.num_heads, self.head_dim)
        q, k, v = (qkv[:, :, n].transpose(1, 2) for n in range(3))
        if self.use_rope:
            q = rope_traditional(q, positions, self.max_period)
            k = rope_traditional(k, positions, self.max_period)
        return q, k, v

    def _attend(self, q, k, v, allowed) -> torch.Tensor:
        """Scores in float32; a float32 cache against bf16 queries (a bf16
        model streaming from the default state) promotes, as in JAX."""
        b, _, t, _ = q.shape
        qp, kp = promote_operands(q, k)
        scores = (qp @ kp.transpose(-1, -2)).float() * self.head_dim ** -0.5
        scores = torch.where(allowed, scores, -1e9)
        probs, vp = promote_operands(torch.softmax(scores, dim=-1).to(q.dtype), v)
        return self.out_proj((probs @ vp).transpose(1, 2).reshape(b, t, -1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pos = torch.arange(x.shape[1], device=x.device)
        q, k, v = self._qkv(x, pos)
        i, j = pos[:, None], pos[None, :]
        return self._attend(q, k, v, (j <= i) & (i - j < self.context))

    # -- streaming ---------------------------------------------------------

    def init_cache(self, batch: int, dtype=torch.float32) -> RotCacheState:
        w = self.in_proj.weight
        shape = (batch, self.num_heads, self.context, self.head_dim)
        return RotCacheState(k=w.new_zeros(shape, dtype=dtype),
                             v=w.new_zeros(shape, dtype=dtype), offset=0)

    def step(self, cache: RotCacheState, x: torch.Tensor):
        """One streaming step of t <= context tokens, x [B, t, D] ->
        (out [B, t, D], cache).  The step attends over the ring as it was
        before this step (each slot's position known from the offset) plus
        its own keys, causally; only then are the new keys written, so that
        no write evicts a key still inside an earlier query's window."""
        t, w, off = x.shape[1], self.context, cache.offset
        dev = x.device
        positions = off + torch.arange(t, device=dev)
        q, k, v = self._qkv(x, positions)
        # slot s holds the largest position p <= off - 1 with p = s (mod w)
        s = torch.arange(w, device=dev)
        p_old = (off - 1) - torch.remainder(off - 1 - s, w)
        qp = positions[:, None]
        valid_old = (p_old[None] >= 0) & (p_old[None] <= qp) & (p_old[None] > qp - w)
        i = torch.arange(t, device=dev)
        valid = torch.cat([valid_old, i[None, :] <= i[:, None]], dim=1)
        out = self._attend(q, torch.cat([cache.k, k], dim=2),
                           torch.cat([cache.v, v], dim=2), valid)
        slots = torch.remainder(positions, w)
        # the ring keeps its dtype (JAX's .at[].set casts to it)
        return out, RotCacheState(k=cache.k.index_copy(2, slots, k.to(cache.k.dtype)),
                                  v=cache.v.index_copy(2, slots, v.to(cache.v.dtype)),
                                  offset=off + t)


class LayerScale(nn.Module):
    def __init__(self, dim: int, init: float = 1.0):
        super().__init__()
        self.init = init
        self.scale = nn.Parameter(torch.full((dim,), init), requires_grad=False)

    def init_weights(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.scale.fill_(self.init)

    def forward(self, x):
        return x * self.scale


class MlpNoGating(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.linear1 = Linear(cfg.d_model, cfg.dim_feedforward, bias=cfg.bias_ff)
        self.linear2 = Linear(cfg.dim_feedforward, cfg.d_model, bias=cfg.bias_ff)

    def forward(self, x):
        return self.linear2(F.gelu(self.linear1(x), approximate="tanh"))


class MlpGating(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        hidden = 2 * cfg.dim_feedforward // 3
        if cfg.dim_feedforward == 4 * cfg.d_model:
            hidden = 11 * cfg.d_model // 4
        self.linear_in = Linear(cfg.d_model, 2 * hidden, bias=cfg.bias_ff)
        self.linear_out = Linear(hidden, cfg.d_model, bias=cfg.bias_ff)

    def forward(self, x):
        b, t, _ = x.shape
        h = self.linear_in(x).reshape(b, t, 2, -1)
        return self.linear_out(F.silu(h[:, :, 0]) * h[:, :, 1])


class TransformerLayer(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.gating = MlpGating(cfg) if cfg.gating else MlpNoGating(cfg)
        if cfg.norm == "layer_norm":
            self.norm1, self.norm2 = LayerNorm(cfg.d_model, 1e-5), LayerNorm(cfg.d_model, 1e-5)
        else:
            self.norm1, self.norm2 = RMSNorm(cfg.d_model, 1e-8), RMSNorm(cfg.d_model, 1e-8)
        if cfg.layer_scale is not None:
            self.layer_scale_1 = LayerScale(cfg.d_model, cfg.layer_scale)
            self.layer_scale_2 = LayerScale(cfg.d_model, cfg.layer_scale)
        else:
            self.layer_scale_1 = self.layer_scale_2 = None
        self.self_attn = Attention(cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.self_attn(self.norm1(x))
        x = x + (a if self.layer_scale_1 is None else self.layer_scale_1(a))
        m = self.gating(self.norm2(x))
        return x + (m if self.layer_scale_2 is None else self.layer_scale_2(m))

    def step(self, cache: RotCacheState, x: torch.Tensor):
        a, cache = self.self_attn.step(cache, self.norm1(x))
        x = x + (a if self.layer_scale_1 is None else self.layer_scale_1(a))
        m = self.gating(self.norm2(x))
        return x + (m if self.layer_scale_2 is None else self.layer_scale_2(m)), cache


class ProjectedTransformer(nn.Module):
    """Transformer stack with optional input and output projections."""

    def __init__(self, cfg: TransformerConfig, input_dim: int, output_dims: list):
        super().__init__()
        self.layers = nn.ModuleList(TransformerLayer(cfg) for _ in range(cfg.num_layers))
        self.input_proj = (Linear(input_dim, cfg.d_model, bias=False)
                           if input_dim != cfg.d_model else None)
        self.output_projs = nn.ModuleList(
            Linear(cfg.d_model, od, bias=False) if od != cfg.d_model else None
            for od in output_dims)

    def forward(self, x: torch.Tensor) -> list:
        if self.input_proj is not None:
            x = self.input_proj(x)
        for layer in self.layers:
            x = layer(x)
        return [x if p is None else p(x) for p in self.output_projs]

    def init_cache(self, batch: int, dtype=torch.float32) -> list:
        return [layer.self_attn.init_cache(batch, dtype) for layer in self.layers]

    def step(self, caches: list, x: torch.Tensor):
        if self.input_proj is not None:
            x = self.input_proj(x)
        new_caches = []
        for layer, c in zip(self.layers, caches):
            x, c = layer.step(c, x)
            new_caches.append(c)
        return [x if p is None else p(x) for p in self.output_projs], new_caches
