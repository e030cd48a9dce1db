"""Bark's GPT stacks: the causal semantic and coarse GPTs and the
non-causal fine GPT (counterpart of ``mlx_audio_tpu/models/tts/bark/gpt.py``).

The causal GPTs have learned absolute positions and a prefill / step split
over ``nn.attention.KVCache``: a prefill takes right-padded rows that share
one valid length and rewinds the caches to it.  Attention is float32
matmul and softmax over the cache's whole capacity, unwritten slots masked
to -1e9, as in the JAX package; every projection is a float32 matmul.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from mlx_audio_tpu_torch.models.base import BaseModelArgs
from mlx_audio_tpu_torch.nn.attention import KVCache
from mlx_audio_tpu_torch.nn.layers import Embedding, LayerNorm, Linear


@dataclass
class GPTConfig(BaseModelArgs):
    block_size: int = 1024
    input_vocab_size: int = 129600
    output_vocab_size: int = 129600
    n_layer: int = 12
    n_head: int = 12
    n_embd: int = 768
    bias: bool = False
    model_type: str = "semantic"
    dropout: float = 0.0
    n_codes_total: int = 8
    n_codes_given: int = 1

    # HF-transformers BarkConfig field names -> the suno names used here
    _HF_ALIASES = {"num_layers": "n_layer", "num_heads": "n_head",
                   "hidden_size": "n_embd"}

    @classmethod
    def from_dict(cls, params: dict):
        params = {cls._HF_ALIASES.get(k, k): v for k, v in params.items()}
        return super(GPTConfig, cls).from_dict(params)


class CausalSelfAttention(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.n_head = cfg.n_head
        self.head_dim = cfg.n_embd // cfg.n_head
        self.att_proj = Linear(cfg.n_embd, 3 * cfg.n_embd, bias=cfg.bias)
        self.out_proj = Linear(cfg.n_embd, cfg.n_embd, bias=cfg.bias)

    def _split(self, x):
        b, t, _ = x.shape
        return x.reshape(b, t, self.n_head, self.head_dim).transpose(1, 2)

    def _merge(self, x):
        b, h, t, d = x.shape
        return x.transpose(1, 2).reshape(b, t, h * d)

    def _attend(self, q, k, v, mask):
        scores = (q @ k.transpose(-1, -2)).float() * self.head_dim ** -0.5
        if mask is not None:
            scores = scores + mask
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        return self.out_proj(self._merge(probs @ v))

    def forward(self, x, cache: KVCache, mask):
        """Cached attention: writes this call's keys and values at the
        cache's write position, attends over its whole capacity."""
        q, k, v = (self._split(t) for t in self.att_proj(x).chunk(3, dim=2))
        cache.update(k, v)
        return self._attend(q, cache.k, cache.v, mask), cache

    def full(self, x, causal: bool = True):
        q, k, v = (self._split(t) for t in self.att_proj(x).chunk(3, dim=2))
        mask = None
        if causal:
            t = x.shape[1]
            i = torch.arange(t, device=x.device)[:, None]
            j = torch.arange(t, device=x.device)[None, :]
            mask = torch.where(j <= i, 0.0, -1e9)
        return self._attend(q, k, v, mask)


class MLP(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.in_proj = Linear(cfg.n_embd, 4 * cfg.n_embd, bias=cfg.bias)
        self.out_proj = Linear(4 * cfg.n_embd, cfg.n_embd, bias=cfg.bias)

    def forward(self, x):
        return self.out_proj(torch.nn.functional.gelu(self.in_proj(x)))


class Block(nn.Module):
    """A causal block.  The bias-free stages keep a layer-norm bias of
    zeros, as the JAX package does."""

    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.layernorm_1 = LayerNorm(cfg.n_embd)
        self.layernorm_2 = LayerNorm(cfg.n_embd)
        self.attn = CausalSelfAttention(cfg)
        self.mlp = MLP(cfg)

    def forward(self, x, cache, mask):
        attn, cache = self.attn(self.layernorm_1(x), cache, mask)
        x = x + attn
        return x + self.mlp(self.layernorm_2(x)), cache


class GPT(nn.Module):
    """Causal GPT with learned positions (the semantic and coarse stages)."""

    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.cfg_n_head = cfg.n_head
        self.cfg_head_dim = cfg.n_embd // cfg.n_head
        self.block_size = cfg.block_size
        self.input_embeds_layer = Embedding(cfg.input_vocab_size, cfg.n_embd)
        self.position_embeds_layer = Embedding(cfg.block_size, cfg.n_embd)
        self.layers = nn.ModuleList(Block(cfg) for _ in range(cfg.n_layer))
        self.layernorm_final = LayerNorm(cfg.n_embd)
        self.lm_head = Linear(cfg.n_embd, cfg.output_vocab_size, bias=False)

    def init_cache(self, batch: int, max_len: int, dtype=torch.float32) -> list:
        dev = self.lm_head.weight.device
        return [KVCache.create(batch, self.cfg_n_head, max_len, self.cfg_head_dim,
                               dtype, dev) for _ in self.layers]

    def prefill(self, caches: list, embeds: torch.Tensor, n_valid: int):
        """Right-padded prompt embeddings [B, Lb, D] at positions 0..Lb-1.
        Returns (the logits [B, V] at the last valid position, the caches
        rewound to ``n_valid``)."""
        lb = embeds.shape[1]
        dev = embeds.device
        x = embeds + self.position_embeds_layer(torch.arange(lb, device=dev))[None]
        max_len = caches[0].k.shape[-2]
        i = torch.arange(lb, device=dev)[:, None]
        j = torch.arange(max_len, device=dev)[None, :]
        mask = torch.where((j <= i) & (j < lb), 0.0, -1e9)
        for layer, cache in zip(self.layers, caches):
            x, _ = layer(x, cache, mask)
            cache.idx = int(n_valid)
        x = self.layernorm_final(x)
        return self.lm_head(x[:, int(n_valid) - 1]), caches

    def step(self, caches: list, token: torch.Tensor):
        """One token [B, 1] at position ``caches[0].idx`` -> (logits [B, V],
        caches)."""
        pos = caches[0].idx
        dev = token.device
        x = (self.input_embeds_layer(token)
             + self.position_embeds_layer.weight[pos][None, None])
        max_len = caches[0].k.shape[-2]
        j = torch.arange(max_len, device=dev)[None, None, None, :]
        mask = torch.where(j <= pos, 0.0, -1e9)
        for layer, cache in zip(self.layers, caches):
            x, _ = layer(x, cache, mask)
        x = self.layernorm_final(x)
        return self.lm_head(x[:, -1]), caches


class FineBlock(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.layernorm_1 = LayerNorm(cfg.n_embd)
        self.layernorm_2 = LayerNorm(cfg.n_embd)
        self.attn = CausalSelfAttention(cfg)
        self.mlp = MLP(cfg)

    def forward(self, x):
        x = x + self.attn.full(self.layernorm_1(x), causal=False)
        return x + self.mlp(self.layernorm_2(x))


class FineGPT(nn.Module):
    """The non-causal fine stage: the codebooks' embeddings summed up to the
    one predicted, one head a predicted codebook."""

    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.n_codes_total = cfg.n_codes_total
        self.n_codes_given = cfg.n_codes_given
        self.block_size = cfg.block_size
        self.input_embeds_layers = nn.ModuleList(
            Embedding(cfg.input_vocab_size, cfg.n_embd)
            for _ in range(cfg.n_codes_total))
        self.position_embeds_layer = Embedding(cfg.block_size, cfg.n_embd)
        self.layers = nn.ModuleList(FineBlock(cfg) for _ in range(cfg.n_layer))
        self.layernorm_final = LayerNorm(cfg.n_embd)
        self.lm_heads = nn.ModuleList(
            Linear(cfg.n_embd, cfg.output_vocab_size, bias=False)
            for _ in range(cfg.n_codes_given, cfg.n_codes_total))

    def forward(self, pred_idx: int, idx: torch.Tensor) -> torch.Tensor:
        """idx [B, T, n_codes_total] -> logits [B, T, V] of codebook
        ``pred_idx``."""
        t = idx.shape[1]
        x = 0
        for i in range(pred_idx + 1):
            x = x + self.input_embeds_layers[i](idx[:, :, i])
        x = x + self.position_embeds_layer(torch.arange(t, device=idx.device))[None]
        for block in self.layers:
            x = block(x)
        x = self.layernorm_final(x)
        return self.lm_heads[pred_idx - self.n_codes_given](x)
