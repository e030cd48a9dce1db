"""IndexTTS's speaker encoder, a speechbrain-flavoured ECAPA-TDNN
(counterpart of ``mlx_audio_tpu/models/tts/indextts/ecapa.py``), channels
last.  It is not Spark's ECAPA: TDNN blocks reflect-pad the time axis and
then convolve with padding 0 (so ``nn.layers.conv1d`` sends every conv to
the library), Res2Net feeds the previous block's output forward, the
attentive statistics pooling has global context and eps 1e-12, and the
SeRes2Net residual adds onto the shortcut-projected input.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from mlx_audio_tpu_torch.nn.layers import BatchNorm, Conv1d


@dataclass
class ECPATDNNArgs:
    input_size: int
    lin_neurons: int = 192
    channels: List[int] = field(default_factory=lambda: [512, 512, 512, 512, 1536])
    kernel_sizes: List[int] = field(default_factory=lambda: [5, 3, 3, 3, 1])
    dilations: List[int] = field(default_factory=lambda: [1, 2, 3, 4, 1])
    attention_channels: int = 128
    res2net_scale: int = 8
    se_channels: int = 128
    global_context: bool = True
    groups: List[int] = field(default_factory=lambda: [1, 1, 1, 1, 1])


class TDNN(nn.Module):
    """Reflect pad, conv with padding 0, ReLU, batch norm."""

    def __init__(self, in_channels, out_channels, kernel_size, dilation=1, groups=1,
                 bias=True):
        super().__init__()
        self.pad = ((kernel_size - 1) * dilation) // 2
        self.conv = Conv1d(in_channels, out_channels, kernel_size, 1, 0, dilation, groups,
                           bias)
        self.norm = BatchNorm(out_channels)

    def forward(self, x):
        if self.pad > 0:
            x = F.pad(x.transpose(1, 2), (self.pad, self.pad), mode="reflect").transpose(1, 2)
        return self.norm(F.relu(self.conv(x)))


class Res2Net(nn.Module):
    def __init__(self, in_channels, out_channels, kernel_size, scale, dilation=1,
                 groups=1, bias=True):
        super().__init__()
        assert in_channels % scale == out_channels % scale == 0
        self.scale = scale
        self.blocks = nn.ModuleList(
            TDNN(in_channels // scale, out_channels // scale, kernel_size, dilation,
                 groups, bias)
            for _ in range(scale - 1))

    def forward(self, x):
        segments = x.chunk(self.scale, dim=-1)
        y = [segments[0]]
        for i in range(1, len(segments)):
            prev = y[-1] if i > 1 else 0
            y.append(self.blocks[i - 1](segments[i] + prev))
        return torch.cat(y, dim=-1)


class SE(nn.Module):
    def __init__(self, in_channels, se_channels, out_channels):
        super().__init__()
        self.conv1 = Conv1d(in_channels, se_channels, 1)
        self.conv2 = Conv1d(se_channels, out_channels, 1)

    def forward(self, x):
        s = x.mean(1, keepdim=True)
        return torch.sigmoid(self.conv2(F.relu(self.conv1(s)))) * x


class SeRes2Net(nn.Module):
    def __init__(self, in_channels, out_channels, scale, attention_channels,
                 kernel_size=1, dilation=1, groups=1, bias=True):
        super().__init__()
        self.tdnn1 = TDNN(in_channels, out_channels, 1, 1, groups)
        self.res2net_block = Res2Net(out_channels, out_channels, kernel_size, scale,
                                     dilation=dilation)
        self.tdnn2 = TDNN(out_channels, out_channels, 1, 1, groups)
        self.se_block = SE(out_channels, attention_channels, out_channels)
        self.shortcut = (Conv1d(in_channels, out_channels, 1)
                         if in_channels != out_channels else None)

    def forward(self, x):
        if self.shortcut is not None:
            x = self.shortcut(x)
        return x + self.se_block(self.tdnn2(self.res2net_block(self.tdnn1(x))))


class AttentiveStatisticsPooling(nn.Module):
    """[B, T, C] -> [B, 1, 2C] attention-weighted mean and std."""

    def __init__(self, channels, attention_channels, global_context=True):
        super().__init__()
        self.eps = 1e-12
        self.global_context = global_context
        self.tdnn = TDNN(channels * 3 if global_context else channels, attention_channels, 1)
        self.conv = Conv1d(attention_channels, channels, 1)

    def forward(self, x):
        if self.global_context:
            mean = x.mean(1, keepdim=True)
            std = torch.sqrt(((x - mean) ** 2).mean(1, keepdim=True) + self.eps)
            attn = torch.cat([x, mean.expand_as(x), std.expand_as(x)], dim=-1)
        else:
            attn = x
        attn = torch.softmax(self.conv(torch.tanh(self.tdnn(attn))), dim=1)
        mean = (x * attn).sum(1, keepdim=True)
        std = torch.sqrt(((x - mean) ** 2 * attn).sum(1, keepdim=True) + self.eps)
        return torch.cat([mean, std], dim=-1)


class ECPATDNN(nn.Module):
    def __init__(self, args: ECPATDNNArgs):
        super().__init__()
        self.args = args
        ch, ks, dil, gr = args.channels, args.kernel_sizes, args.dilations, args.groups
        self.blocks = nn.ModuleList(
            [TDNN(args.input_size, ch[0], ks[0], dilation=dil[0], groups=gr[0])]
            + [SeRes2Net(ch[i - 1], ch[i], scale=args.res2net_scale,
                         attention_channels=args.se_channels, kernel_size=ks[i],
                         dilation=dil[i], groups=gr[i])
               for i in range(1, len(ch) - 1)])
        self.mfa = TDNN(ch[-2] * (len(ch) - 2), ch[-1], ks[-1], dilation=dil[-1],
                        groups=gr[-1])
        self.asp = AttentiveStatisticsPooling(ch[-1], attention_channels=args.attention_channels,
                                              global_context=args.global_context)
        self.asp_bn = BatchNorm(ch[-1] * 2)
        self.fc = Conv1d(ch[-1] * 2, args.lin_neurons, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """mel [B, T, input_size] -> speaker embedding [B, 1, lin_neurons]."""
        skips = []
        for layer in self.blocks:
            x = layer(x)
            if isinstance(layer, SeRes2Net):
                skips.append(x)
        x = self.mfa(torch.cat(skips, dim=-1))
        return self.fc(self.asp_bn(self.asp(x)))
