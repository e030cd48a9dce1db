"""Kokoro text encoder and prosody predictor (counterpart of
``mlx_audio_tpu/models/tts/kokoro/modules.py``).

NLC layout, batched, with masked-flip backward LSTM passes so that padded
buckets give exact results.  Masks are applied at the same points as in the
JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mlx_audio_tpu_torch.models.tts.kokoro.istftnet import AdainResBlk1d
from mlx_audio_tpu_torch.nn import (
    LSTM,
    AdaLayerNorm,
    Conv1d,
    Embedding,
    LayerNorm,
    Linear,
    WNConv1d,
    leaky_relu,
)


def _keep(x: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Zero the padded positions: keep [B, N, 1] (True = valid)."""
    return torch.where(keep, x, torch.zeros((), dtype=x.dtype, device=x.device))


class TextEncoder(nn.Module):
    """Embedding -> depth x (WN-conv, LN, LeakyReLU) -> BiLSTM."""

    def __init__(self, channels: int, kernel_size: int, depth: int,
                 n_symbols: int):
        super().__init__()
        self.embedding = Embedding(n_symbols, channels)
        padding = (kernel_size - 1) // 2
        self.cnn = nn.ModuleList(
            nn.ModuleList([WNConv1d(channels, channels, kernel_size,
                                    padding=padding), LayerNorm(channels)])
            for _ in range(depth))
        self.lstm = LSTM(channels, channels // 2)

    def forward(self, input_ids: torch.Tensor, lengths: torch.Tensor,
                pad_mask: torch.Tensor) -> torch.Tensor:
        """input_ids: [B, N]; pad_mask: [B, N] True = padding."""
        keep = (~pad_mask)[..., None]
        x = _keep(self.embedding(input_ids), keep)
        for conv, norm in self.cnn:
            x = _keep(conv(x), keep)
            x = _keep(norm(x), keep)
            x = _keep(leaky_relu(x, 0.2), keep)
        x, _ = self.lstm(x, lengths=lengths)
        return _keep(x, keep)


class DurationEncoder(nn.Module):
    """Alternating (BiLSTM, AdaLayerNorm) stack over style-concatenated
    features."""

    def __init__(self, sty_dim: int, d_model: int, nlayers: int,
                 dropout: float = 0.1):
        super().__init__()
        blocks = []
        for _ in range(nlayers):
            blocks.append(LSTM(d_model + sty_dim, d_model // 2))
            blocks.append(AdaLayerNorm(sty_dim, d_model))
        self.lstms = nn.ModuleList(blocks)
        self.d_model = d_model
        self.sty_dim = sty_dim

    def forward(self, x: torch.Tensor, style: torch.Tensor,
                lengths: torch.Tensor, pad_mask: torch.Tensor) -> torch.Tensor:
        """x: [B, N, C]; style: [B, S]; returns [B, N, C + S]."""
        keep = (~pad_mask)[..., None]
        s = style[:, None, :].expand(*x.shape[:2], style.shape[-1])
        x = _keep(torch.cat([x, s], dim=-1), keep)
        for block in self.lstms:
            if isinstance(block, AdaLayerNorm):
                x = block(x, style)
                x = _keep(torch.cat([x, s], dim=-1), keep)
            else:
                x, _ = block(x, lengths=lengths)
        return x


class ProsodyPredictor(nn.Module):
    """Duration + F0/energy prediction."""

    def __init__(self, style_dim: int, d_hid: int, nlayers: int,
                 max_dur: int = 50, dropout: float = 0.1):
        super().__init__()
        self.text_encoder = DurationEncoder(sty_dim=style_dim, d_model=d_hid,
                                            nlayers=nlayers, dropout=dropout)
        self.lstm = LSTM(d_hid + style_dim, d_hid // 2)
        self.duration_proj = Linear(d_hid, max_dur)
        self.shared = LSTM(d_hid + style_dim, d_hid // 2)
        self.F0 = nn.ModuleList([
            AdainResBlk1d(d_hid, d_hid, style_dim),
            AdainResBlk1d(d_hid, d_hid // 2, style_dim, upsample=True),
            AdainResBlk1d(d_hid // 2, d_hid // 2, style_dim),
        ])
        self.N = nn.ModuleList([
            AdainResBlk1d(d_hid, d_hid, style_dim),
            AdainResBlk1d(d_hid, d_hid // 2, style_dim, upsample=True),
            AdainResBlk1d(d_hid // 2, d_hid // 2, style_dim),
        ])
        self.F0_proj = Conv1d(d_hid // 2, 1, 1, padding=0)
        self.N_proj = Conv1d(d_hid // 2, 1, 1, padding=0)

    def predict_durations(self, d: torch.Tensor,
                          lengths: torch.Tensor) -> torch.Tensor:
        """d: [B, N, d_hid + style] -> raw duration logits [B, N, max_dur]."""
        x, _ = self.lstm(d, lengths=lengths)
        return self.duration_proj(x)

    def _curve(self, x, s, blocks, proj, frame_lengths):
        mask = None
        if frame_lengths is not None:
            mask = (torch.arange(x.shape[1], device=x.device)[None, :]
                    < frame_lengths[:, None])
        for block in blocks:
            x = block(x, s, mask)
            if block.do_upsample and mask is not None:
                mask = mask.repeat_interleave(2, dim=-1)
        return proj(x)[..., 0]

    def F0Ntrain(self, en: torch.Tensor, s: torch.Tensor,
                 frame_lengths: Optional[torch.Tensor] = None):
        """en: [B, F, d_hid + style] -> (F0 [B, 2F], N [B, 2F])."""
        x, _ = self.shared(en, lengths=frame_lengths)
        return (self._curve(x, s, self.F0, self.F0_proj, frame_lengths),
                self._curve(x, s, self.N, self.N_proj, frame_lengths))
