"""Dia's encoder-decoder transformer layers (counterpart of
``mlx_audio_tpu/models/tts/dia/layers.py``).

* ``DenseGeneral`` keeps the JAX weight layout, ``in_shapes +
  out_features`` (q/k/v ``[D, H, hd]``, o ``[H, hd, D]``, the fused MLP
  input ``[D, 2, hidden]``, the logits head ``[D, C, V]``), and contracts
  with ``tensordot``, so weights cross as they are.  These projections are
  plain float32 matmuls in the JAX package too.  Mixed operands promote,
  as ``lax.dot_general`` promotes them: the logits head takes a float32
  ``x`` into the bf16 weight of a cast model and gives float32 logits.
* Attention scores are NOT divided by sqrt(d) (a Dia quirk): ``_attend``
  takes float32 scores, ``where(mask, s, -1e9)`` and a float32 softmax, so
  it does not use the shared ``nn.attention`` path, which scales.
* RoPE is Dia's timescale form, ``positions / timescale`` in float32 at
  every call with ``timescale = min * (max / min) ** (2i / h)``, not the
  Llama tables.  Cross-attention applies it unless the config says not
  (HF-format checkpoints).
* The decoder's self-attention caches are ``nn.attention.KVCache`` objects
  holding the unexpanded kv heads, written in place; a cached step attends
  only to written slots, ``j < idx + i + 1`` taken before the write.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from mlx_audio_tpu_torch.models.tts.dia.config import DiaConfig
from mlx_audio_tpu_torch.nn.attention import KVCache
from mlx_audio_tpu_torch.nn.layers import (
    Embedding,
    RMSNorm,
    _param,
    _uniform_,
    promote_operands,
)


class DenseGeneral(nn.Module):
    """tensordot projection with multi-axis in and out shapes; weight
    ``in_shapes + out_features``."""

    def __init__(self, in_shapes: tuple, out_features: tuple):
        super().__init__()
        self.in_shapes = tuple(in_shapes)
        self.out_features = tuple(out_features)
        self.weight = _param(*(self.in_shapes + self.out_features))

    def init_weights(self, generator: torch.Generator) -> None:
        _uniform_(self.weight, 1.0 / math.sqrt(np.prod(self.in_shapes)), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n_in = len(self.in_shapes)
        x, w = promote_operands(x, self.weight)
        return torch.tensordot(x, w,
                               dims=(list(range(x.ndim - n_in, x.ndim)),
                                     list(range(n_in))))


class MlpBlock(nn.Module):
    """Fused gate/up MLP: ``wi_fused`` -> [gate, up], silu(gate) * up."""

    def __init__(self, embed_dim: int, intermediate_dim: int):
        super().__init__()
        self.wi_fused = DenseGeneral((embed_dim,), (2, intermediate_dim))
        self.wo = DenseGeneral((intermediate_dim,), (embed_dim,))

    def forward(self, x):
        fused = self.wi_fused(x)
        gate = torch.nn.functional.silu(fused[..., 0, :])
        return self.wo(gate * fused[..., 1, :])


def rope_timescale(x: torch.Tensor, positions: torch.Tensor,
                   min_timescale: float = 1.0,
                   max_timescale: float = 10000.0) -> torch.Tensor:
    """Dia's RoPE: x [B, T, N, H], positions [B, T] (integers)."""
    h = x.shape[-1]
    fraction = (2.0 * np.arange(h // 2)) / h
    timescale = min_timescale * (max_timescale / min_timescale) ** fraction
    timescale = torch.as_tensor(timescale, dtype=torch.float32, device=x.device)
    sinusoid = positions[..., None, None].to(torch.float32) / timescale
    sin = torch.sin(sinusoid).to(x.dtype)
    cos = torch.cos(sinusoid).to(x.dtype)
    first, second = x.chunk(2, dim=-1)
    return torch.cat([first * cos - second * sin, second * cos + first * sin],
                     dim=-1)


class DiaAttention(nn.Module):
    """GQA/MHA attention with unscaled scores."""

    def __init__(self, cfg: DiaConfig, q_embed_dim: int, kv_embed_dim: int,
                 num_query_heads: int, num_kv_heads: int, head_dim: int,
                 is_cross_attn: bool = False,
                 out_embed_dim: Optional[int] = None):
        super().__init__()
        self.num_query_heads = num_query_heads
        self.num_kv_heads = num_kv_heads
        self.head_dim = head_dim
        self.is_cross_attn = is_cross_attn
        self.use_rope = (not is_cross_attn) or cfg.model.cross_attn_rope
        self.num_gqa_groups = num_query_heads // num_kv_heads
        self.rope_min = cfg.model.rope_min_timescale
        self.rope_max = cfg.model.rope_max_timescale
        out_dim = out_embed_dim or q_embed_dim
        self.q_proj = DenseGeneral((q_embed_dim,), (num_query_heads, head_dim))
        self.k_proj = DenseGeneral((kv_embed_dim,), (num_kv_heads, head_dim))
        self.v_proj = DenseGeneral((kv_embed_dim,), (num_kv_heads, head_dim))
        self.o_proj = DenseGeneral((num_query_heads, head_dim), (out_dim,))

    def _rope(self, x, pos):
        if not self.use_rope:
            return x
        return rope_timescale(x, pos, self.rope_min, self.rope_max)

    def _kv(self, xkv, kv_positions):
        k = self._rope(self.k_proj(xkv), kv_positions).transpose(1, 2)  # [B, K, S, H]
        v = self.v_proj(xkv).transpose(1, 2)
        if self.num_gqa_groups > 1:
            k = torch.repeat_interleave(k, self.num_gqa_groups, dim=1)
            v = torch.repeat_interleave(v, self.num_gqa_groups, dim=1)
        return k, v

    def _attend(self, q, k, v, mask):
        scores = torch.einsum("bnth,bnsh->bnts", q, k).float()
        if mask is not None:
            scores = torch.where(mask, scores, -1e9)
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        out = torch.einsum("bnts,bnsh->bnth", probs, v)
        return self.o_proj(out.transpose(1, 2))

    def full(self, xq, xkv, q_positions, kv_positions, mask=None):
        q = self._rope(self.q_proj(xq), q_positions).transpose(1, 2)
        k, v = self._kv(xkv, kv_positions)
        return self._attend(q, k, v, mask)

    def precompute_cross_kv(self, encoder_out, src_positions):
        return self._kv(encoder_out, src_positions)

    def cross_step(self, xq, q_positions, cross_kv, mask=None):
        q = self._rope(self.q_proj(xq), q_positions).transpose(1, 2)
        k, v = cross_kv
        return self._attend(q, k, v, mask)

    def self_cached(self, xq, q_positions, cache: KVCache, mask):
        """Write this step's keys and values into ``cache`` (in place) and
        attend over its written slots: causally up to the write frontier,
        whatever ``mask`` says (unwritten zero keys would otherwise take
        softmax weight)."""
        q = self._rope(self.q_proj(xq), q_positions).transpose(1, 2)
        k = self._rope(self.k_proj(xq), q_positions).transpose(1, 2)
        v = self.v_proj(xq).transpose(1, 2)
        q_len = xq.shape[1]
        max_len = cache.k.shape[-2]
        dev = xq.device
        j = torch.arange(max_len, device=dev)[None, None, None, :]
        i = torch.arange(q_len, device=dev)[None, None, :, None]
        valid = j < (cache.idx + i + 1)  # the frontier before the write
        mask = valid if mask is None else (mask & valid)
        cache.update(k, v)
        return self._attend_gqa(q, cache.k, cache.v, mask), cache

    def _attend_gqa(self, q, k, v, mask):
        """Grouped-query attention without repeating K/V: q [B, N, T, H]
        against k, v [B, Kv, S, H]."""
        b, n, t, h = q.shape
        kv = k.shape[1]
        g = n // kv
        if g == 1:
            return self._attend(q, k, v, mask)
        qg = q.reshape(b, kv, g, t, h)
        scores = torch.einsum("bkgth,bksh->bkgts", qg, k).float()
        if mask is not None:
            m = mask if mask.ndim == 5 else mask[:, :, None]
            scores = torch.where(m, scores, -1e9)
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        out = torch.einsum("bkgts,bksh->bkgth", probs, v).reshape(b, n, t, h)
        return self.o_proj(out.transpose(1, 2))


class EncoderLayer(nn.Module):
    def __init__(self, cfg: DiaConfig):
        super().__init__()
        enc = cfg.model.encoder
        eps = cfg.model.normalization_layer_epsilon
        self.pre_sa_norm = RMSNorm(enc.n_embd, eps)
        self.self_attention = DiaAttention(
            cfg, enc.n_embd, enc.n_embd, enc.n_head, enc.n_head, enc.head_dim,
            out_embed_dim=enc.n_embd)
        self.post_sa_norm = RMSNorm(enc.n_embd, eps)
        self.mlp = MlpBlock(enc.n_embd, enc.n_hidden)

    def forward(self, x, src_positions, mask):
        h = self.pre_sa_norm(x)
        x = x + self.self_attention.full(h, h, src_positions, src_positions, mask)
        return x + self.mlp(self.post_sa_norm(x))


class DiaEncoder(nn.Module):
    def __init__(self, cfg: DiaConfig):
        super().__init__()
        enc = cfg.model.encoder
        self.embedding = Embedding(cfg.model.src_vocab_size, enc.n_embd)
        self.layers = nn.ModuleList(EncoderLayer(cfg) for _ in range(enc.n_layer))
        self.norm = RMSNorm(enc.n_embd, cfg.model.normalization_layer_epsilon)

    def forward(self, x_ids, src_positions, mask):
        x = self.embedding(x_ids)
        for layer in self.layers:
            x = layer(x, src_positions, mask)
        return self.norm(x)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: DiaConfig):
        super().__init__()
        dec = cfg.model.decoder
        enc = cfg.model.encoder
        eps = cfg.model.normalization_layer_epsilon
        self.pre_sa_norm = RMSNorm(dec.n_embd, eps)
        self.pre_ca_norm = RMSNorm(dec.n_embd, eps)
        self.pre_mlp_norm = RMSNorm(dec.n_embd, eps)
        self.self_attention = DiaAttention(
            cfg, dec.n_embd, dec.n_embd, dec.gqa_query_heads, dec.kv_heads,
            dec.gqa_head_dim, out_embed_dim=dec.n_embd)
        self.cross_attention = DiaAttention(
            cfg, dec.n_embd, enc.n_embd, dec.cross_query_heads,
            dec.cross_query_heads, dec.cross_head_dim, is_cross_attn=True,
            out_embed_dim=dec.n_embd)
        self.mlp = MlpBlock(dec.n_embd, dec.n_hidden)

    def step(self, x, tgt_positions, sa_cache, cross_kv, sa_mask, ca_mask):
        sa_out, sa_cache = self.self_attention.self_cached(
            self.pre_sa_norm(x), tgt_positions, sa_cache, sa_mask)
        x = x + sa_out
        x = x + self.cross_attention.cross_step(
            self.pre_ca_norm(x), tgt_positions, cross_kv, ca_mask)
        x = x + self.mlp(self.pre_mlp_norm(x))
        return x, sa_cache


class DiaDecoder(nn.Module):
    def __init__(self, cfg: DiaConfig):
        super().__init__()
        dec = cfg.model.decoder
        self.num_channels = cfg.data.channels
        self.num_layers = dec.n_layer
        self.num_query_heads = dec.gqa_query_heads
        self.num_kv_heads = dec.kv_heads
        self.head_dim = dec.gqa_head_dim
        self.embeddings = nn.ModuleList(
            Embedding(cfg.model.tgt_vocab_size, dec.n_embd)
            for _ in range(self.num_channels))
        self.layers = nn.ModuleList(DecoderLayer(cfg) for _ in range(self.num_layers))
        self.norm = RMSNorm(dec.n_embd, cfg.model.normalization_layer_epsilon)
        self.logits_dense = DenseGeneral(
            (dec.n_embd,), (self.num_channels, cfg.model.tgt_vocab_size))

    def embed(self, tgt_ids):
        """tgt_ids [B, T, C] -> summed channel embeddings [B, T, D]."""
        x = 0
        for i in range(self.num_channels):
            x = x + self.embeddings[i](tgt_ids[:, :, i])
        return x

    def init_cache(self, batch: int, max_len: int, dtype=torch.float32) -> list:
        dev = self.norm.weight.device
        return [KVCache.create(batch, self.num_kv_heads, max_len, self.head_dim,
                               dtype, dev)
                for _ in self.layers]

    def precompute_cross_kv(self, encoder_out, src_positions) -> list:
        return [layer.cross_attention.precompute_cross_kv(encoder_out, src_positions)
                for layer in self.layers]

    def step(self, tgt_ids, tgt_positions, sa_caches, cross_kvs, sa_mask,
             ca_mask):
        """tgt_ids [B, S, C] -> (float32 logits [B, S, C, V], caches); the
        caches are written in place."""
        x = self.embed(tgt_ids)
        for layer, cache, cross_kv in zip(self.layers, sa_caches, cross_kvs):
            x, _ = layer.step(x, tgt_positions, cache, cross_kv, sa_mask, ca_mask)
        x = self.norm(x)
        return self.logits_dense(x.float()), sa_caches
