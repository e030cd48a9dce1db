"""Attention: what ALBERT needs (counterpart of part of
``mlx_audio_tpu/nn/attention.py``)."""

from __future__ import annotations

import math
from typing import Optional

import torch


def scaled_dot_product_attention(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor,
                                 mask: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """q, k, v: [B, H, L, D]; ``mask`` additive, broadcast to the scores.

    Written as matmul + softmax, with the scores divided by sqrt(D) and the
    softmax taken in float32, as the JAX package's ALBERT attention does.
    """
    scores = (q @ k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if mask is not None:
        scores = scores + mask
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return probs @ v
