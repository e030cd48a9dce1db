"""Llama: the LM stack CSM's backbone and depth decoder share (counterpart of
``mlx_audio_tpu/models/lm/llama.py``).

Decode state is a list of ``nn.attention.KVCache`` objects, written in
place.  Prompts are left-padded to a bucket: every cache slot below
``pad_len`` [B] is masked out, and RoPE is relative, so the shift leaves the
scores over valid tokens unchanged.  A model built with
``use_embed_tokens=False`` takes embeddings directly (CSM feeds fused audio
and text embeddings).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mlx_audio_tpu_torch.nn.attention import (
    KVCache,
    apply_rope,
    rope_table,
    scaled_dot_product_attention,
)
from mlx_audio_tpu_torch.nn.layers import Embedding, Linear, RMSNorm


@dataclass
class LlamaConfig:
    num_hidden_layers: int
    num_attention_heads: int
    num_key_value_heads: int
    head_dim: int
    hidden_size: int
    intermediate_size: int
    rms_norm_eps: float
    vocab_size: int
    max_position_embeddings: int = 2048
    attention_bias: bool = False
    mlp_bias: bool = False
    rope_theta: float = 10000.0
    rope_scaling: Optional[dict] = None
    tie_word_embeddings: bool = False
    qkv_bias: bool = False
    use_qk_norm: bool = False


@torch.no_grad()
def cast_lm(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Every floating parameter and buffer of ``module`` in ``dtype`` but
    the RoPE tables, which stay float32 (``apply_rope`` casts them a use),
    as the JAX package's ``cast_lm`` and chat ``from_pretrained`` cast.
    Returns ``module``."""
    for mod in module.modules():
        for table in (mod._parameters, mod._buffers):
            for key, t in table.items():
                if t is None or not t.is_floating_point() or key in ("rope_cos", "rope_sin"):
                    continue
                cast = t.detach().to(dtype)
                table[key] = (nn.Parameter(cast, requires_grad=False)
                              if isinstance(t, nn.Parameter) else cast)
    return module


def lm_dtype(model: nn.Module) -> torch.dtype:
    """Activation and cache dtype of an LM: its first floating tensor other
    than the RoPE tables (quantized modules hold uint8 codes)."""
    for key, t in model.state_dict().items():
        if t.is_floating_point() and "rope_" not in key:
            return t.dtype
    return torch.float32


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.num_heads = cfg.num_attention_heads
        self.num_kv_heads = cfg.num_key_value_heads
        self.head_dim = cfg.head_dim
        inner = cfg.num_attention_heads * cfg.head_dim
        inner_kv = cfg.num_key_value_heads * cfg.head_dim
        qkv_bias = cfg.attention_bias or cfg.qkv_bias
        self.q_proj = Linear(cfg.hidden_size, inner, bias=qkv_bias)
        self.k_proj = Linear(cfg.hidden_size, inner_kv, bias=qkv_bias)
        self.v_proj = Linear(cfg.hidden_size, inner_kv, bias=qkv_bias)
        self.o_proj = Linear(inner, cfg.hidden_size, bias=cfg.attention_bias)
        self.q_norm = RMSNorm(cfg.head_dim, cfg.rms_norm_eps) if cfg.use_qk_norm else None
        self.k_norm = RMSNorm(cfg.head_dim, cfg.rms_norm_eps) if cfg.use_qk_norm else None

    def _split(self, x, heads):
        b, l, _ = x.shape
        return x.reshape(b, l, heads, self.head_dim).transpose(1, 2)

    def forward(self, x, rope, start: int, mask,
                cache: Optional[KVCache] = None):
        q = self._split(self.q_proj(x), self.num_heads)
        k = self._split(self.k_proj(x), self.num_kv_heads)
        v = self._split(self.v_proj(x), self.num_kv_heads)
        if self.q_norm is not None:
            q, k = self.q_norm(q), self.k_norm(k)
        cos, sin = rope
        q = apply_rope(q, cos, sin, start)
        k = apply_rope(k, cos, sin, start)
        if cache is not None:
            cache.update(k, v)
            k, v = cache.k, cache.v
        out = scaled_dot_product_attention(q, k, v, mask)
        b, _, l, _ = out.shape
        return self.o_proj(out.transpose(1, 2).reshape(b, l, -1)), cache


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.gate_proj = Linear(cfg.hidden_size, cfg.intermediate_size, bias=cfg.mlp_bias)
        self.up_proj = Linear(cfg.hidden_size, cfg.intermediate_size, bias=cfg.mlp_bias)
        self.down_proj = Linear(cfg.intermediate_size, cfg.hidden_size, bias=cfg.mlp_bias)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.self_attn = LlamaAttention(cfg)
        self.mlp = LlamaMLP(cfg)
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)

    def forward(self, x, rope, start: int, mask, cache=None):
        attn, cache = self.self_attn(self.input_layernorm(x), rope, start,
                                     mask, cache)
        x = x + attn
        return x + self.mlp(self.post_attention_layernorm(x)), cache


class LlamaModel(nn.Module):
    """Embedding and transformer stack, no LM head (models add their own).
    The RoPE tables are buffers, so a checkpoint carries them as the JAX
    package's does."""

    def __init__(self, cfg: LlamaConfig, use_embed_tokens: bool = True):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = (Embedding(cfg.vocab_size, cfg.hidden_size)
                             if use_embed_tokens else None)
        self.layers = nn.ModuleList(LlamaBlock(cfg)
                                    for _ in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        cos, sin = rope_table(cfg.head_dim, cfg.max_position_embeddings,
                              base=cfg.rope_theta, scaling=cfg.rope_scaling)
        self.register_buffer("rope_cos", cos)
        self.register_buffer("rope_sin", sin)
        self._rope_longer = None  # (cos, sin) past max_position_embeddings

    def init_cache(self, batch: int, max_len: Optional[int] = None,
                   dtype=torch.float32) -> list:
        max_len = max_len or self.cfg.max_position_embeddings
        return [KVCache.create(batch, self.cfg.num_key_value_heads, max_len,
                               self.cfg.head_dim, dtype, self.rope_cos.device)
                for _ in self.layers]

    def _embed(self, x):
        if self.embed_tokens is not None and not x.is_floating_point():
            return self.embed_tokens(x)
        return x

    def _rope(self, length: int) -> tuple:
        """RoPE tables covering positions [0, length).  A prompt left-padded
        to its bucket can take the decode past ``max_position_embeddings``
        although its own tokens fit (the JAX package then reads NaN rows
        and decodes token 0); past the buffers, tables computed from the
        same config, kept for later calls."""
        if length <= self.rope_cos.shape[0]:
            return self.rope_cos, self.rope_sin
        ext = self._rope_longer
        if ext is None or ext[0].shape[0] < length or ext[0].device != self.rope_cos.device:
            if torch.compiler.is_compiling():
                raise RuntimeError(f"RoPE rows past the table ({length}): call "
                                   f"_rope({length}) before tracing")
            cos, sin = rope_table(self.cfg.head_dim, length, base=self.cfg.rope_theta,
                                  scaling=self.cfg.rope_scaling)
            self._rope_longer = (cos.to(self.rope_cos.device), sin.to(self.rope_cos.device))
        return self._rope_longer

    def _run(self, h, start, mask, caches):
        # a tensor start (an exported program's) reads rows below the
        # caches' capacity
        rope = self._rope(caches[0].k.shape[-2] if isinstance(start, torch.Tensor)
                          else start + h.shape[1])
        for i, layer in enumerate(self.layers):
            h, _ = layer(h, rope, start, mask,
                         None if caches is None else caches[i])
        return self.norm(h)

    def forward(self, x, mask=None):
        """Full-sequence causal forward (no cache).  x: ids [B, T] or
        embeddings [B, T, D]."""
        h = self._embed(x)
        t = h.shape[1]
        if mask is None:
            i = torch.arange(t, device=h.device)
            mask = torch.where(i[None, :] <= i[:, None], 0.0, -1e9)
        return self._run(h, 0, mask, None)

    def prefill(self, caches: list, x, pad_len: torch.Tensor):
        """A left-padded prompt [B, T(, D)] into fresh caches (slots
        [0, T)); slots below ``pad_len`` [B] are masked.  Returns (hidden
        [B, T, D], caches); continue with ``step``."""
        h = self._embed(x)
        t = h.shape[1]
        max_len = caches[0].k.shape[-2]
        dev = h.device
        i = torch.arange(t, device=dev)[:, None]
        j = torch.arange(max_len, device=dev)[None, :]
        causal = (j <= i) & (j < t)
        valid_key = j[None] >= pad_len[:, None, None]
        mask = torch.where(causal[None] & valid_key, 0.0, -1e9)[:, None]
        return self._run(h, 0, mask, caches), caches

    def step(self, caches: list, x, pad_len: torch.Tensor):
        """One (or a few) decode positions [B, S(, D)] at the caches' write
        position; attends to slots [pad_len, idx + S)."""
        h = self._embed(x)
        s = h.shape[1]
        max_len = caches[0].k.shape[-2]
        idx = caches[0].idx
        dev = h.device
        j = torch.arange(max_len, device=dev)[None, None, :]
        qpos = idx + torch.arange(s, device=dev)[None, :, None]
        valid = (j >= pad_len[:, None, None]) & (j <= qpos)
        mask = torch.where(valid, 0.0, -1e9)[:, None]
        return self._run(h, idx, mask, caches), caches


def _flavor(layers, heads, kv_heads, head_dim, hidden):
    return LlamaConfig(
        num_hidden_layers=layers, num_attention_heads=heads,
        num_key_value_heads=kv_heads, head_dim=head_dim, hidden_size=hidden,
        intermediate_size=8192, rms_norm_eps=1e-5, vocab_size=128_256,
        max_position_embeddings=2048, rope_theta=500_000,
        rope_scaling={"factor": 32.0, "low_freq_factor": 1.0,
                      "high_freq_factor": 4.0,
                      "original_max_position_embeddings": 8192,
                      "rope_type": "llama3"})


LLAMA_FLAVORS = {
    # CSM's backbone and depth decoder (mlx_audio_tpu/models/lm/llama.py:225)
    "llama-1B": _flavor(16, 32, 8, 64, 2048),
    "llama-100M": _flavor(4, 8, 2, 128, 1024),
}
