"""IndexTTS's perceiver resampler (counterpart of
``mlx_audio_tpu/models/tts/indextts/perceiver.py``): learned latents (0 at
init) attend over concat(context, latents), then a gated feed-forward with
the exact GELU on its gate; a gamma-only RMSNorm at the end.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mlx_audio_tpu_torch.models.tts.indextts.attention import MultiHeadAttention
from mlx_audio_tpu_torch.nn.layers import Linear, RMSNorm, _param


class GatedGELUFeedForward(nn.Module):
    def __init__(self, dim: int, d_ff: int, use_bias: bool = True):
        super().__init__()
        self.w_1 = Linear(dim, d_ff * 2, bias=use_bias)
        self.w_2 = Linear(d_ff, dim, bias=use_bias)

    def forward(self, x):
        h, gate = self.w_1(x).chunk(2, dim=-1)
        return self.w_2(F.gelu(gate) * h)  # the exact GELU


class PerceiverResampler(nn.Module):
    def __init__(self, n_dim: int, n_depth: int = 2, n_dim_context: Optional[int] = None,
                 n_latents: int = 32, n_dim_head: int = 64, n_heads: int = 8,
                 n_ff_mult: int = 4):
        super().__init__()
        n_dim_context = n_dim if n_dim_context is None else n_dim_context
        self.proj_context = (Linear(n_dim_context, n_dim)
                             if n_dim_context != n_dim else None)
        self.latents = _param(n_latents, n_dim)
        self.layers = nn.ModuleList(
            nn.ModuleList([MultiHeadAttention(n_heads, n_dim, False, n_dim_head),
                           GatedGELUFeedForward(n_dim, (n_dim * n_ff_mult * 2) // 3)])
            for _ in range(n_depth))
        self.norm = RMSNorm(n_dim)

    def init_weights(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.latents.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """context [B, T, n_dim_context] -> latents [B, n_latents, n_dim]."""
        if self.proj_context is not None:
            x = self.proj_context(x)
        latents = self.latents[None].expand(x.shape[0], -1, -1)
        for attn, ff in self.layers:
            kv = torch.cat([x, latents], dim=-2)
            latents = latents + attn(latents, kv, kv)
            latents = latents + ff(latents)
        return self.norm(latents)
