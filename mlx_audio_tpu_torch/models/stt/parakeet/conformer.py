"""Parakeet's Conformer encoder (NeMo FastConformer lineage), channels last
(counterpart of ``mlx_audio_tpu/models/stt/parakeet/conformer.py``).

Depthwise-striding 2-d subsampling (``Conv2dLayer``: ``F.conv2d`` on NHWC
data, weight [out, in/groups, kh, kw]), relative-position multi-head
attention with the Transformer-XL rel-shift, and the GLU conv module with
inference batch norm.  The module's convs are K = 1 pointwise convs and a
depthwise conv (groups = d_model): ``nn.layers.conv1d`` sends both to the
library, no kernel of this repo.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mlx_audio_tpu_torch.nn.layers import (
    BatchNorm,
    Conv1d,
    LayerNorm,
    Linear,
    _param,
    _uniform_,
    promote_operands,
)


@dataclass
class ConformerArgs:
    feat_in: int
    n_layers: int
    d_model: int
    n_heads: int
    ff_expansion_factor: int
    subsampling_factor: int
    self_attention_model: str
    subsampling: str
    conv_kernel_size: int
    subsampling_conv_channels: int
    pos_emb_max_len: int
    causal_downsampling: bool = False
    use_bias: bool = True
    xscaling: bool = False
    subsampling_conv_chunking_factor: int = 1

    @classmethod
    def from_dict(cls, d: dict) -> "ConformerArgs":
        return cls(**{k: v for k, v in d.items() if k in cls.__dataclass_fields__})


class FeedForward(nn.Module):
    def __init__(self, d_model: int, d_ff: int, use_bias: bool = True):
        super().__init__()
        self.linear1 = Linear(d_model, d_ff, bias=use_bias)
        self.linear2 = Linear(d_ff, d_model, bias=use_bias)

    def forward(self, x):
        return self.linear2(F.silu(self.linear1(x)))


class Convolution(nn.Module):
    def __init__(self, args: ConformerArgs):
        super().__init__()
        self.pointwise_conv1 = Conv1d(args.d_model, args.d_model * 2, 1,
                                      bias=args.use_bias)
        self.depthwise_conv = Conv1d(
            args.d_model, args.d_model, args.conv_kernel_size, stride=1,
            padding=(args.conv_kernel_size - 1) // 2, groups=args.d_model,
            bias=args.use_bias)
        self.batch_norm = BatchNorm(args.d_model)
        self.pointwise_conv2 = Conv1d(args.d_model, args.d_model, 1,
                                      bias=args.use_bias)

    def forward(self, x):
        a, b = self.pointwise_conv1(x).chunk(2, dim=-1)
        x = a * torch.sigmoid(b)  # GLU
        x = F.silu(self.batch_norm(self.depthwise_conv(x)))
        return self.pointwise_conv2(x)


class RelPositionMultiHeadAttention(nn.Module):
    """Transformer-XL relative-position attention; ``pos_bias_u`` and
    ``pos_bias_v`` [heads, head_dim] are parameters (0 at init)."""

    def __init__(self, n_head: int, n_feat: int, bias: bool = True):
        super().__init__()
        self.n_head = n_head
        self.head_dim = n_feat // n_head
        self.scale = self.head_dim ** -0.5
        self.linear_q = Linear(n_feat, n_feat, bias=bias)
        self.linear_k = Linear(n_feat, n_feat, bias=bias)
        self.linear_v = Linear(n_feat, n_feat, bias=bias)
        self.linear_out = Linear(n_feat, n_feat, bias=bias)
        self.linear_pos = Linear(n_feat, n_feat, bias=False)
        self.pos_bias_u = _param(n_head, self.head_dim)
        self.pos_bias_v = _param(n_head, self.head_dim)

    def init_weights(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.pos_bias_u.zero_()
            self.pos_bias_v.zero_()

    @staticmethod
    def rel_shift(x: torch.Tensor) -> torch.Tensor:
        b, h, tq, pos_len = x.shape
        x = F.pad(x, (1, 0))
        x = x.reshape(b, h, pos_len + 1, tq)[:, :, 1:, :]
        return x.reshape(b, h, tq, pos_len)

    def forward(self, x, pos_emb, mask=None):
        b, t, _ = x.shape
        q = self.linear_q(x).reshape(b, t, self.n_head, self.head_dim)
        k = self.linear_k(x).reshape(b, t, self.n_head, self.head_dim).transpose(1, 2)
        v = self.linear_v(x).reshape(b, t, self.n_head, self.head_dim).transpose(1, 2)
        pos_len = pos_emb.shape[1]
        p = self.linear_pos(pos_emb).reshape(-1, pos_len, self.n_head,
                                             self.head_dim).transpose(1, 2)
        q_u = (q + self.pos_bias_u).transpose(1, 2)
        q_v = (q + self.pos_bias_v).transpose(1, 2)
        matrix_ac = q_u @ k.transpose(-1, -2)
        matrix_bd = self.rel_shift(q_v @ p.transpose(-1, -2))[..., :t]
        scores = (matrix_ac + matrix_bd).float() * self.scale
        if mask is not None:
            scores = scores.masked_fill(mask, float("-inf"))
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        out = (probs @ v).transpose(1, 2).reshape(b, t, -1)
        return self.linear_out(out)


class RelPositionalEncoding:
    """Sinusoidal relative positions from max_len - 1 down to -(max_len - 1),
    a host table (no parameters) that grows when an input outgrows it."""

    def __init__(self, d_model: int, max_len: int = 5000, scale_input: bool = False):
        self.d_model = d_model
        self.max_len = max_len
        self.scale = math.sqrt(d_model) if scale_input else 1.0
        self._pe = self._calculate(max_len)
        self._on = {}  # the table on each device it has been asked for on

    def _calculate(self, max_len: int) -> np.ndarray:
        positions = np.arange(max_len - 1, -max_len, -1, dtype=np.float32)[:, None]
        div = np.exp(np.arange(0, self.d_model, 2, dtype=np.float32)
                     * -(math.log(10000.0) / self.d_model))
        pe = np.zeros((2 * max_len - 1, self.d_model), dtype=np.float32)
        pe[:, 0::2] = np.sin(positions * div)
        pe[:, 1::2] = np.cos(positions * div)
        return pe[None]

    def __call__(self, x: torch.Tensor):
        input_len = x.shape[1]
        if input_len > self.max_len:
            self.max_len = input_len + 1
            self._pe = self._calculate(self.max_len)
            self._on = {}
        pe = self._on.get(x.device)
        if pe is None:
            pe = self._on[x.device] = torch.as_tensor(self._pe, device=x.device)
        x = x * self.scale
        center = pe.shape[1] // 2
        return x, pe[:, center - (input_len - 1):center + input_len].to(x.dtype)


class ConformerBlock(nn.Module):
    def __init__(self, args: ConformerArgs):
        super().__init__()
        ff_dim = args.d_model * args.ff_expansion_factor
        self.norm_feed_forward1 = LayerNorm(args.d_model)
        self.feed_forward1 = FeedForward(args.d_model, ff_dim, args.use_bias)
        self.norm_self_att = LayerNorm(args.d_model)
        self.self_attn = RelPositionMultiHeadAttention(args.n_heads, args.d_model,
                                                       bias=args.use_bias)
        self.norm_conv = LayerNorm(args.d_model)
        self.conv = Convolution(args)
        self.norm_feed_forward2 = LayerNorm(args.d_model)
        self.feed_forward2 = FeedForward(args.d_model, ff_dim, args.use_bias)
        self.norm_out = LayerNorm(args.d_model)

    def forward(self, x, pos_emb, mask=None):
        x = x + 0.5 * self.feed_forward1(self.norm_feed_forward1(x))
        x = x + self.self_attn(self.norm_self_att(x), pos_emb, mask)
        x = x + self.conv(self.norm_conv(x))
        x = x + 0.5 * self.feed_forward2(self.norm_feed_forward2(x))
        return self.norm_out(x)


class Conv2dLayer(nn.Module):
    """conv2d over NHWC data for the subsampling stack; weight [out,
    in/groups, kh, kw] (``convert`` moves the JAX package's HWIO)."""

    def __init__(self, in_ch, out_ch, kernel, stride, padding, groups=1):
        super().__init__()
        self.stride, self.padding, self.groups = stride, padding, groups
        self.fan_in = in_ch * kernel * kernel / groups
        self.weight = _param(out_ch, in_ch // groups, kernel, kernel)
        self.bias = _param(out_ch)

    def init_weights(self, generator: torch.Generator) -> None:
        scale = 1.0 / math.sqrt(self.fan_in)
        _uniform_(self.weight, scale, generator)
        _uniform_(self.bias, scale, generator)

    def forward(self, x):
        # mixed operands promote (the JAX package's promote_conv_operands):
        # a float32 log-mel takes a bf16 model's encoder to float32
        x, w = promote_operands(x, self.weight)
        y = F.conv2d(x.permute(0, 3, 1, 2), w, self.bias.to(w.dtype), self.stride,
                     self.padding, 1, self.groups)
        return y.permute(0, 2, 3, 1)


class DwStridingSubsampling(nn.Module):
    """Depthwise-striding 2-d subsampling, NHWC: a 3x3 stride-2 conv, then
    (log2(factor) - 1) times a depthwise 3x3 stride-2 and a pointwise conv,
    a ReLU after the first conv and after each pointwise one."""

    def __init__(self, args: ConformerArgs):
        super().__init__()
        self._sampling_num = int(math.log2(args.subsampling_factor))
        self._stride, self._kernel_size, self._padding = 2, 3, 1
        ch = args.subsampling_conv_channels
        final_freq = args.feat_in
        for _ in range(self._sampling_num):
            final_freq = (final_freq + 2 * self._padding - self._kernel_size) // 2 + 1
        conv = [Conv2dLayer(1, ch, 3, 2, 1)]
        for _ in range(self._sampling_num - 1):
            conv.append(Conv2dLayer(ch, ch, 3, 2, 1, groups=ch))
            conv.append(Conv2dLayer(ch, ch, 1, 1, 0))
        self.conv = nn.ModuleList(conv)
        self.out = Linear(ch * final_freq, args.d_model)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor):
        """x [B, T, feat] -> ([B, T', d_model], lengths')."""
        for _ in range(self._sampling_num):
            lengths = torch.div(lengths + 2 * self._padding - self._kernel_size,
                                self._stride, rounding_mode="floor") + 1
        h = x[..., None]  # [B, T, F, 1]
        for i, layer in enumerate(self.conv):
            h = layer(h)
            if i % 2 == 0:
                h = F.relu(h)
        b, t, f, c = h.shape
        h = h.transpose(2, 3).reshape(b, t, c * f)  # the (b, t, c, f) order
        return self.out(h), lengths.to(torch.int32)


class Conformer(nn.Module):
    def __init__(self, args: ConformerArgs):
        super().__init__()
        self.args_subsampling_factor = args.subsampling_factor
        self.pos_enc = (RelPositionalEncoding(args.d_model, args.pos_emb_max_len,
                                              scale_input=args.xscaling)
                        if args.self_attention_model == "rel_pos" else None)
        self.pre_encode = (DwStridingSubsampling(args) if args.subsampling_factor > 1
                           else Linear(args.feat_in, args.d_model))
        self.layers = nn.ModuleList(ConformerBlock(args) for _ in range(args.n_layers))

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor] = None):
        """x [B, T, feat] -> ([B, T', d_model], lengths' [B] int32)."""
        if lengths is None:
            lengths = torch.full((x.shape[0],), x.shape[-2], dtype=torch.int32,
                                 device=x.device)
        if isinstance(self.pre_encode, DwStridingSubsampling):
            x, out_lengths = self.pre_encode(x, lengths)
        else:
            x, out_lengths = self.pre_encode(x), lengths
        pos_emb = None
        if self.pos_enc is not None:
            x, pos_emb = self.pos_enc(x)
        for layer in self.layers:
            x = layer(x, pos_emb)
        return x, out_lengths
