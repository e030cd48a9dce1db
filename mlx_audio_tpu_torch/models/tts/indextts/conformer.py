"""IndexTTS's conditioning Conformer, wenet-style (counterpart of
``mlx_audio_tpu/models/tts/indextts/conformer.py``), channels last.

A VALID-padded conv2d subsampling stack on Parakeet's ``Conv2dLayer``
(NHWC data, H = time, W = frequency), whose [B, T', F', C] output is
flattened C before F; then blocks of an optional macaron feed-forward,
relative-position attention, the GLU conv module (LayerNorm in place of
batch norm) and a feed-forward.  Its convs are pointwise and depthwise
(groups = d_model): ``nn.layers.conv1d`` sends them to the library, no
kernel of this repository.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from mlx_audio_tpu_torch.models.stt.parakeet.conformer import Conv2dLayer
from mlx_audio_tpu_torch.models.tts.indextts.attention import (
    MultiHeadAttention,
    RelPositionalEncoding,
    RelPositionMultiHeadAttention,
)
from mlx_audio_tpu_torch.nn.layers import Conv1d, LayerNorm, Linear


@dataclass
class ConformerArgs:
    input_size: int = 100
    output_size: int = 256
    num_blocks: int = 6
    linear_units: int = 2048
    attention_heads: int = 4
    pos_enc_layer_type: str = "rel_pos"
    input_layer: str = "conv2d"
    cnn_module_kernel: int = 15
    pos_emb_max_len: int = 2048
    causal_downsampling: bool = False
    use_bias: bool = True
    xscaling: bool = True
    macaron_style: bool = False
    perceiver_mult: int = 2


class FeedForward(nn.Module):
    def __init__(self, dim: int, d_ff: int, use_bias: bool = True):
        super().__init__()
        self.w_1 = Linear(dim, d_ff, bias=use_bias)
        self.w_2 = Linear(d_ff, dim, bias=use_bias)

    def forward(self, x):
        return self.w_2(F.silu(self.w_1(x)))


class Convolution(nn.Module):
    """GLU pointwise -> depthwise -> LayerNorm -> SiLU -> pointwise."""

    def __init__(self, args: ConformerArgs):
        super().__init__()
        assert (args.cnn_module_kernel - 1) % 2 == 0
        d = args.output_size
        k = args.cnn_module_kernel
        self.pointwise_conv1 = Conv1d(d, d * 2, 1, bias=args.use_bias)
        self.depthwise_conv = Conv1d(d, d, k, padding=(k - 1) // 2, groups=d,
                                     bias=args.use_bias)
        self.norm = LayerNorm(d)
        self.pointwise_conv2 = Conv1d(d, d, 1, bias=args.use_bias)

    def forward(self, x):
        a, b = self.pointwise_conv1(x).chunk(2, dim=-1)
        x = self.depthwise_conv(a * torch.sigmoid(b))
        return self.pointwise_conv2(F.silu(self.norm(x)))


class ConformerBlock(nn.Module):
    def __init__(self, args: ConformerArgs):
        super().__init__()
        self.macaron_style = args.macaron_style
        self.ff_scale = 0.5 if args.macaron_style else 1.0
        if args.macaron_style:
            self.norm_ff_macaron = LayerNorm(args.output_size)
            self.feed_forward_macaron = FeedForward(args.output_size, args.linear_units,
                                                    args.use_bias)
        self.norm_mha = LayerNorm(args.output_size)
        if args.pos_enc_layer_type == "rel_pos":
            self.self_attn = RelPositionMultiHeadAttention(
                args.attention_heads, args.output_size, bias=args.use_bias)
        else:
            self.self_attn = MultiHeadAttention(args.attention_heads, args.output_size,
                                                bias=True)
        self.norm_conv = LayerNorm(args.output_size)
        self.conv_module = Convolution(args)
        self.norm_ff = LayerNorm(args.output_size)
        self.feed_forward = FeedForward(args.output_size, args.linear_units, args.use_bias)
        self.norm_final = LayerNorm(args.output_size)

    def forward(self, x, pos_emb=None, mask=None):
        if self.macaron_style:
            x = x + self.ff_scale * self.feed_forward_macaron(self.norm_ff_macaron(x))
        xn = self.norm_mha(x)
        x = x + self.self_attn(xn, xn, xn, pos_emb=pos_emb, mask=mask)
        x = x + self.conv_module(self.norm_conv(x))
        x = x + self.ff_scale * self.feed_forward(self.norm_ff(x))
        return self.norm_final(x)


class Conv2dSubsampling(nn.Module):
    """VALID-padded conv2d stack over [B, T, F]."""

    CONV_LAYERS = {
        "conv2d2": [(3, 2)],
        "conv2d3": [(5, 3)],
        "conv2d4": [(3, 2), (3, 2)],
        "conv2d6": [(3, 2), (5, 3)],
        "conv2d8": [(3, 2), (3, 2), (3, 2)],
    }

    def __init__(self, args: ConformerArgs):
        super().__init__()
        conv = []
        in_channels = 1
        out_freq = args.input_size
        for kernel_size, stride in self.CONV_LAYERS[args.input_layer]:
            conv.append(Conv2dLayer(in_channels, args.output_size, kernel_size, stride, 0))
            in_channels = args.output_size
            out_freq = (out_freq - kernel_size + stride) // stride
        self.conv = nn.ModuleList(conv)
        self.out = Linear(args.output_size * out_freq, args.output_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, T, F] -> [B, T', output_size]."""
        x = x[..., None]  # NHWC: H = time, W = frequency
        for conv in self.conv:
            x = F.relu(conv(x))
        b, t = x.shape[:2]
        return self.out(x.transpose(2, 3).reshape(b, t, -1))  # C before F


class Conformer(nn.Module):
    def __init__(self, args: ConformerArgs):
        super().__init__()
        self.args = args
        self.pos_enc = (RelPositionalEncoding(args.output_size, args.pos_emb_max_len,
                                              scale_input=args.xscaling)
                        if args.pos_enc_layer_type == "rel_pos" else None)
        self.embed = Conv2dSubsampling(args)
        self.encoders = nn.ModuleList(ConformerBlock(args) for _ in range(args.num_blocks))
        self.after_norm = LayerNorm(args.output_size, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """mel [B, T, input_size] -> latent [B, T', output_size]."""
        x = self.embed(x)
        pos_emb = None
        if self.pos_enc is not None:
            x, pos_emb = self.pos_enc(x)
        for layer in self.encoders:
            x = layer(x, pos_emb=pos_emb)
        return self.after_norm(x)
