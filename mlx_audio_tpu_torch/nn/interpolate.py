"""PyTorch-compatible 1-D interpolation on NLC input, as index gathers with
host-side indices (counterpart of ``mlx_audio_tpu/nn/interpolate.py``)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def interpolate1d(x: torch.Tensor, size: int, mode: str = "nearest",
                  align_corners: Optional[bool] = None) -> torch.Tensor:
    """x: [B, L, C] -> [B, size, C]."""
    in_width = x.shape[-2]
    size = max(1, int(size))

    def take(idx):
        return x.index_select(-2, torch.as_tensor(idx, dtype=torch.long,
                                                  device=x.device))

    if mode == "nearest":
        if size == 1:
            idx = np.zeros(1, dtype=np.int64)
        else:
            scale = in_width / size
            idx = np.clip(np.floor(np.arange(size) * scale).astype(np.int64),
                          0, in_width - 1)
        return take(idx)

    if mode != "linear":
        raise ValueError(f"unsupported mode {mode}")

    if in_width == 1:
        return x.expand(*x.shape[:-2], size, x.shape[-1])

    if align_corners and size > 1:
        pos = np.arange(size) * ((in_width - 1) / (size - 1))
    elif size == 1:
        pos = np.array([0.0])
    else:
        pos = np.arange(size) * (in_width / size)
        if not align_corners:
            pos = pos + 0.5 * (in_width / size) - 0.5

    lo = np.floor(pos).astype(np.int64)
    hi = np.minimum(lo + 1, in_width - 1)
    frac = (pos - lo).astype(np.float32)
    # a negative lo (from the -0.5 shift) is clamped, as torch does at the
    # edge
    y_lo = take(np.clip(lo, 0, in_width - 1))
    y_hi = take(hi)
    frac = torch.as_tensor(frac, device=x.device)[:, None]
    return y_lo * (1 - frac) + y_hi * frac


def interpolate(x: torch.Tensor, size: Optional[int] = None,
                scale_factor: Optional[float] = None, mode: str = "nearest",
                align_corners: Optional[bool] = None) -> torch.Tensor:
    """Resize the time axis of [B, L, C] input by size or scale factor."""
    if (size is None) == (scale_factor is None):
        raise ValueError("exactly one of size / scale_factor must be given")
    if size is None:
        # epsilon-tolerant ceil: 300000 * (1/300) must give 1000, not 1001
        size = max(1, int(np.ceil(x.shape[-2] * scale_factor - 1e-6)))
    return interpolate1d(x, size, mode, align_corners)
