"""Causal convolutions of the streaming codecs, batch and stateful paths
(counterpart of ``mlx_audio_tpu/nn/streaming.py``).

NLC layout.  Weights in torch's layouts: conv [out, in/groups, k],
transposed conv [in, out, k] or depthwise [C, 1, k].  ``init_state`` gives
a carry and ``step`` returns a new one (the old one is left as it was), as
the JAX package threads them; a step's chunk length is a multiple of the
conv's stride, as every codec frame is.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from mlx_audio_tpu_torch.nn.layers import (
    _param,
    _uniform_,
    conv1d,
    conv_transpose1d,
)


class ConvState(NamedTuple):
    """Carry of a streaming causal conv: the trailing receptive-field tail."""

    buf: torch.Tensor  # [B, K_eff - S, C_in]
    first: bool        # the left pad is not applied yet


class ConvTrState(NamedTuple):
    """Carry of a streaming transposed conv: the pending overlap tail."""

    buf: torch.Tensor  # [B, K - S, C_out], bias-free partial sums


class StreamableConv1d(nn.Module):
    """Conv1d with the codec's causal (or centred) padding; its convolution
    goes through ``nn.layers.conv1d`` and so through ``conv1d_route``."""

    def __init__(self, in_channels: int, out_channels: int, ksize: int,
                 stride: int = 1, dilation: int = 1, groups: int = 1,
                 bias: bool = True, causal: bool = True,
                 pad_mode: str = "constant"):
        super().__init__()
        self.stride, self.dilation, self.groups = stride, dilation, groups
        self.causal, self.pad_mode, self.ksize = causal, pad_mode, ksize
        self.scale = 1.0 / (in_channels * ksize)
        self.weight = _param(out_channels, in_channels // groups, ksize)
        self.bias = _param(out_channels) if bias else None

    def init_weights(self, generator: torch.Generator) -> None:
        _uniform_(self.weight, self.scale, generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    @property
    def effective_ksize(self) -> int:
        return (self.ksize - 1) * self.dilation + 1

    def _pad_input(self, x: torch.Tensor) -> torch.Tensor:
        k_eff = self.effective_ksize
        padding_total = k_eff - self.stride
        length = x.shape[-2]
        nframes = max(length + padding_total - k_eff, 0) / self.stride + 1.0
        ideal = (int(math.ceil(nframes)) - 1) * self.stride + k_eff - padding_total
        extra = max(0, ideal - length)
        if self.causal:
            left, right = padding_total, extra
        else:
            right = padding_total // 2
            left = padding_total - right
            right += extra
        if self.pad_mode == "edge":
            return F.pad(x.transpose(1, 2), (left, right),
                         mode="replicate").transpose(1, 2)
        return F.pad(x, (0, 0, left, right))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, L, C_in] -> [B, ceil(L / S), C_out]."""
        y = conv1d(self._pad_input(x), self.weight, self.stride, 0,
                   self.dilation, self.groups)
        return y + self.bias if self.bias is not None else y

    # -- streaming ---------------------------------------------------------

    def init_state(self, batch: int, dtype=torch.float32) -> ConvState:
        pad = self.effective_ksize - self.stride
        in_ch = self.weight.shape[1] * self.groups
        return ConvState(
            buf=self.weight.new_zeros((batch, pad, in_ch), dtype=dtype),
            first=True)

    def step(self, state: ConvState, x: torch.Tensor):
        """x [B, L, C_in], L a multiple of the stride -> ([B, L / S, C_out],
        state).  With ``pad_mode="edge"`` the first step's left pad repeats
        the first sample, as the batch path pads."""
        pad = self.effective_ksize - self.stride
        if pad > 0:
            init = state.buf
            if self.pad_mode == "edge" and state.first:
                init = x[:, :1].expand_as(init)
            full = torch.cat([init, x], dim=1)
        else:
            full = x
        y = conv1d(full, self.weight, self.stride, 0, self.dilation, self.groups)
        if self.bias is not None:
            y = y + self.bias
        new_buf = full[:, full.shape[1] - pad:] if pad > 0 else state.buf
        return y, ConvState(buf=new_buf, first=False)


class StreamableConvTranspose1d(nn.Module):
    """Causal transposed conv: groups 1 or depthwise."""

    def __init__(self, in_channels: int, out_channels: int, ksize: int,
                 stride: int = 1, groups: int = 1, bias: bool = True,
                 causal: bool = True):
        super().__init__()
        if groups != 1 and not in_channels == out_channels == groups:
            raise NotImplementedError("only depthwise grouped convT supported")
        self.stride, self.groups, self.causal, self.ksize = stride, groups, causal, ksize
        self.scale = 1.0 / (in_channels * ksize)
        self.weight = _param(in_channels, out_channels // groups, ksize)
        self.bias = _param(out_channels) if bias else None

    def init_weights(self, generator: torch.Generator) -> None:
        _uniform_(self.weight, self.scale, generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, L, C_in] -> [B, L * S, C_out], unpadded on the right (causal)
        or on both sides."""
        padding_total = max(self.ksize - self.stride, 0)
        y = conv_transpose1d(x, self.weight, self.stride, groups=self.groups)
        if self.bias is not None:
            y = y + self.bias
        if self.causal:
            return y[:, :y.shape[1] - padding_total]
        left = padding_total - padding_total // 2
        return y[:, left:y.shape[1] - padding_total // 2]

    # -- streaming ---------------------------------------------------------

    def init_state(self, batch: int, dtype=torch.float32) -> ConvTrState:
        if self.ksize < self.stride:
            # a "gappy" transposed conv: the batch path works, but exact
            # streaming would need an end-of-stream flush of the ragged tail
            raise NotImplementedError(
                "streaming ConvTranspose1d requires ksize >= stride")
        out_ch = self.weight.shape[1] * self.groups
        return ConvTrState(buf=self.weight.new_zeros(
            (batch, self.ksize - self.stride, out_ch), dtype=dtype))

    def step(self, state: ConvTrState, x: torch.Tensor):
        """x [B, L, C_in] -> ([B, L * S, C_out], state).  The carried overlap
        is bias-free; the bias is added to the emitted samples only."""
        pad = self.ksize - self.stride
        y = conv_transpose1d(x, self.weight, self.stride, groups=self.groups)
        if pad > 0:
            # the overlap is added in y's dtype (JAX's .at[].add casts it)
            y = torch.cat([y[:, :pad] + state.buf.to(y.dtype), y[:, pad:]], dim=1)
        emit_len = y.shape[1] - pad
        emit = y[:, :emit_len]
        if self.bias is not None:
            emit = emit + self.bias
        new_buf = y[:, emit_len:] if pad > 0 else state.buf
        return emit, ConvTrState(buf=new_buf)
