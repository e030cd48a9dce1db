"""IndexTTS attention primitives (counterpart of
``mlx_audio_tpu/models/tts/indextts/attention.py``).

``RelPositionMultiHeadAttention`` is wenet's, not Parakeet's: it has no
rel-shift, its position term ``matrix_bd`` rides into the softmax as the
additive mask, and a boolean mask enters that term as -1e9.  The sinusoid
table of ``RelPositionalEncoding`` is computed on the host (float64, cast
to float32) and grows when an input outgrows it; it is no parameter
(``convert.params_from_jax`` drops the JAX package's ``pe`` array).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from mlx_audio_tpu_torch.nn.layers import Embedding, Linear, _param, promote_operands


def _sdpa(q, k, v, scale: float, mask=None):
    """[B, H, T, D] attention, scores scaled after the product and the
    softmax taken in float32; mixed operands promote, as the JAX package's
    einsums do (a bf16 model's float32 conditioning meets its bf16 latents)."""
    scores = torch.matmul(*promote_operands(q, k.transpose(-1, -2))).float() * scale
    if mask is not None:
        scores = scores + mask.float()
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.matmul(*promote_operands(probs, v))


class MultiHeadAttention(nn.Module):
    """Multi-head attention whose ``head_dim`` may differ from n_feat / n_head
    (the perceiver's)."""

    def __init__(self, n_head: int, n_feat: int, bias: bool = True,
                 head_dim: Optional[int] = None):
        super().__init__()
        self.n_head = n_head
        self.head_dim = n_feat // n_head if not head_dim else head_dim
        self.scale = self.head_dim ** -0.5
        inner = self.head_dim * n_head
        self.linear_q = Linear(n_feat, inner, bias=bias)
        self.linear_k = Linear(n_feat, inner, bias=bias)
        self.linear_v = Linear(n_feat, inner, bias=bias)
        self.linear_out = Linear(inner, n_feat, bias=bias)

    def _split(self, x, b, t):
        return x.reshape(b, t, self.n_head, self.head_dim).transpose(1, 2)

    def _merge(self, o):
        b, _, t, _ = o.shape
        return self.linear_out(o.transpose(1, 2).reshape(b, t, -1))

    def forward(self, q, k, v, pos_emb=None, mask=None):
        b, tq, _ = q.shape
        tk = k.shape[1]
        qh = self._split(self.linear_q(q), b, tq)
        kh = self._split(self.linear_k(k), b, tk)
        vh = self._split(self.linear_v(v), b, tk)
        return self._merge(_sdpa(qh, kh, vh, self.scale, mask))


class RelPositionMultiHeadAttention(MultiHeadAttention):
    """Transformer-XL-style attention with position-projection biases:
    matrix_bd = (q + pos_bias_v) @ linear_pos(pe)^T, scaled, is added to the
    (q + pos_bias_u) @ k^T scores inside the softmax.  ``pos_bias_u`` and
    ``pos_bias_v`` [heads, head_dim] are 0 at init."""

    def __init__(self, n_head: int, n_feat: int, bias: bool = True,
                 head_dim: Optional[int] = None):
        super().__init__(n_head=n_head, n_feat=n_feat, bias=bias, head_dim=head_dim)
        self.linear_pos = Linear(n_feat, n_feat, bias=False)
        self.pos_bias_u = _param(self.n_head, self.head_dim)
        self.pos_bias_v = _param(self.n_head, self.head_dim)

    def init_weights(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.pos_bias_u.zero_()
            self.pos_bias_v.zero_()

    def forward(self, q, k, v, pos_emb=None, mask=None):
        if pos_emb is None:
            raise ValueError("pos_emb is necessary!")
        b, tq, _ = q.shape
        tk = k.shape[1]
        qh = self.linear_q(q).reshape(b, tq, self.n_head, self.head_dim)
        q_u = (qh + self.pos_bias_u).transpose(1, 2)
        q_v = (qh + self.pos_bias_v).transpose(1, 2)
        kh = self._split(self.linear_k(k), b, tk)
        vh = self._split(self.linear_v(v), b, tk)
        p = self.linear_pos(pos_emb)
        p = p.reshape(p.shape[0], p.shape[1], self.n_head, self.head_dim).transpose(1, 2)
        matrix_bd = torch.matmul(*promote_operands(q_v, p.transpose(-1, -2))) * self.scale
        if mask is not None:
            matrix_bd = matrix_bd.masked_fill(mask, -1e9)
        return self._merge(_sdpa(q_u, kh, vh, self.scale, mask=matrix_bd))


class RelPositionalEncoding(nn.Module):
    """Absolute sin/cos table [1, max_len, d_model] served per offset; the
    input is scaled by sqrt(d_model) when ``scale_input``."""

    def __init__(self, d_model: int, max_len: int = 5000, scale_input: bool = True):
        super().__init__()
        assert d_model % 2 == 0 and max_len > 0
        self.d_model = d_model
        self.max_len = max_len
        self.xscale = math.sqrt(d_model) if scale_input else 1.0
        self._pe = self._table(max_len)
        self._on = {}  # the table on each device it has been asked for on

    def _table(self, max_len: int) -> np.ndarray:
        positions = np.arange(max_len, dtype=np.float64)[:, None]
        div = np.exp(np.arange(0, self.d_model, 2, dtype=np.float64)
                     * -(math.log(10000.0) / self.d_model))
        pe = np.zeros((max_len, self.d_model), dtype=np.float32)
        pe[:, 0::2] = np.sin(positions * div)
        pe[:, 1::2] = np.cos(positions * div)
        return pe[None]

    @property
    def pe(self) -> np.ndarray:
        return self._pe

    def forward(self, x: torch.Tensor, offset: int = 0):
        t = x.shape[1]
        if t + offset > self._pe.shape[1]:
            self._pe = self._table(t + offset)
            self._on = {}
        pe = self._on.get(x.device)
        if pe is None:
            pe = self._on[x.device] = torch.as_tensor(self._pe, device=x.device)
        return x * self.xscale, pe[:, offset:offset + t].to(x.dtype)


class LearnedPositionEncoding(nn.Module):
    """Embedding-table positions: the rows offset .. offset + T - 1."""

    def __init__(self, seq_len: int, model_dim: int):
        super().__init__()
        self.emb = Embedding(seq_len, model_dim)

    def forward(self, x: torch.Tensor, offset: int = 0) -> torch.Tensor:
        positions = offset + torch.arange(x.shape[1], device=self.emb.weight.device)
        return self.emb(positions)
