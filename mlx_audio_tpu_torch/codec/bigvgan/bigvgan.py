"""BigVGAN, the anti-aliased multi-periodicity vocoder (counterpart of
``mlx_audio_tpu/codec/bigvgan/bigvgan.py``).

AMP resblocks with Snake or SnakeBeta inside a kaiser-windowed 2x up and
down sampled activation.  The resblock convs are the port's ``WNConv1d``:
``nn.layers.conv1d`` routes each 'same' dilated conv by its shape, and at
BigVGAN-v2's 768- and 384-channel stages they take this repository's
``dilated_conv1d`` and ``banded_conv1d`` kernels.  The anti-aliasing
filters are depthwise convolutions (groups = C) with a kaiser-sinc filter
computed on the host: they take the library (``F.conv_transpose1d`` up,
``F.conv1d`` down).

Sequences are channels last inside; ``BigVGAN(mel)`` takes the reference's
[B, num_mels, T] (NCL) and returns [B, T * prod(upsample_rates), 1].
``BigVGAN(config, device="cuda", seed=0)`` draws the weights from ``seed``;
``from_pretrained`` loads a local directory.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mlx_audio_tpu_torch.models.base import BaseModelArgs, init_weights, model_device
from mlx_audio_tpu_torch.nn.layers import (
    WNConv1d,
    WNConvTranspose1d,
    _param,
    snake,
    snake_beta,
)


@dataclass
class BigVGANConfig(BaseModelArgs):
    num_mels: int
    upsample_rates: List[int]
    upsample_kernel_sizes: List[int]
    upsample_initial_channel: int
    resblock: str
    resblock_kernel_sizes: List[int]
    resblock_dilation_sizes: List[List[int]]
    activation: str
    snake_logscale: bool
    use_bias_at_final: bool = True
    use_tanh_at_final: bool = True


def kaiser_sinc_filter1d(cutoff: float, half_width: float,
                         kernel_size: int) -> np.ndarray:
    """[kernel_size] kaiser-windowed sinc lowpass."""
    even = kernel_size % 2 == 0
    half_size = kernel_size // 2
    delta_f = 4 * half_width
    a = 2.285 * (half_size - 1) * math.pi * delta_f + 7.95
    if a > 50.0:
        beta = 0.1102 * (a - 8.7)
    elif a >= 21.0:
        beta = 0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21.0)
    else:
        beta = 0.0
    window = np.kaiser(kernel_size, beta)
    if even:
        time = np.arange(-half_size, half_size) + 0.5
    else:
        time = np.arange(kernel_size) - half_size
    if cutoff == 0:
        return np.zeros(kernel_size)
    filt = 2 * cutoff * window * np.sinc(2 * cutoff * time)
    return filt / filt.sum()


class LowPassFilter1d(nn.Module):
    """Depthwise lowpass of [B, T, C], edge-padded; ``filter`` [K] is a
    buffer (the JAX package keeps it among the model's arrays)."""

    def __init__(self, cutoff=0.5, half_width=0.6, stride: int = 1,
                 padding: bool = True, padding_mode: str = "edge",
                 kernel_size: int = 12):
        super().__init__()
        if padding_mode != "edge":
            raise NotImplementedError("LowPassFilter1d pads at the edges only")
        even = kernel_size % 2 == 0
        self.stride = stride
        self.pad_left = kernel_size // 2 - int(even)
        self.pad_right = kernel_size // 2
        self.padding = padding
        self.register_buffer("filter", torch.tensor(
            kaiser_sinc_filter1d(cutoff, half_width, kernel_size), dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[-1]
        x = x.transpose(1, 2)
        if self.padding:
            x = F.pad(x, (self.pad_left, self.pad_right), mode="replicate")
        w = self.filter.expand(c, 1, -1).to(x.dtype)
        return F.conv1d(x, w, stride=self.stride, groups=c).transpose(1, 2)


class UpSample1d(nn.Module):
    def __init__(self, ratio: int = 2, kernel_size: Optional[int] = None):
        super().__init__()
        self.ratio = ratio
        self.kernel_size = int(6 * ratio // 2) * 2 if kernel_size is None else kernel_size
        self.stride = ratio
        self.pad = self.kernel_size // ratio - 1
        self.pad_left = self.pad * self.stride + (self.kernel_size - self.stride) // 2
        self.pad_right = self.pad * self.stride + (self.kernel_size - self.stride + 1) // 2
        self.register_buffer("filter", torch.tensor(
            kaiser_sinc_filter1d(0.5 / ratio, 0.6 / ratio, self.kernel_size),
            dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[-1]
        x = F.pad(x.transpose(1, 2), (self.pad, self.pad), mode="replicate")
        w = self.filter.expand(c, 1, -1).to(x.dtype)
        y = self.ratio * F.conv_transpose1d(x, w, stride=self.stride, groups=c)
        return y.transpose(1, 2)[:, self.pad_left:y.shape[-1] - self.pad_right]


class DownSample1d(nn.Module):
    def __init__(self, ratio: int = 2, kernel_size: Optional[int] = None):
        super().__init__()
        ks = int(6 * ratio // 2) * 2 if kernel_size is None else kernel_size
        self.lowpass = LowPassFilter1d(cutoff=0.5 / ratio, half_width=0.6 / ratio,
                                       stride=ratio, kernel_size=ks)

    def forward(self, x):
        return self.lowpass(x)


class SnakeAct(nn.Module):
    def __init__(self, channels: int, alpha_logscale: bool = False):
        super().__init__()
        self.alpha_logscale = alpha_logscale
        self.alpha = _param(channels)

    def init_weights(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.alpha.fill_(0.0 if self.alpha_logscale else 1.0)

    def forward(self, x):
        return snake(x, self.alpha, alpha_logscale=self.alpha_logscale)


class SnakeBetaAct(nn.Module):
    def __init__(self, channels: int, alpha_logscale: bool = False):
        super().__init__()
        self.alpha_logscale = alpha_logscale
        self.alpha = _param(channels)
        self.beta = _param(channels)

    def init_weights(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            for t in (self.alpha, self.beta):
                t.fill_(0.0 if self.alpha_logscale else 1.0)

    def forward(self, x):
        return snake_beta(x, self.alpha, self.beta, alpha_logscale=self.alpha_logscale)


class Activation1d(nn.Module):
    """Anti-aliased activation: up 2x, the activation, down 2x."""

    def __init__(self, activation, up_ratio=2, down_ratio=2, up_kernel_size=12,
                 down_kernel_size=12):
        super().__init__()
        self.act = activation
        self.upsample = UpSample1d(up_ratio, up_kernel_size)
        self.downsample = DownSample1d(down_ratio, down_kernel_size)

    def forward(self, x):
        return self.downsample(self.act(self.upsample(x)))


def _make_act(channels, activation, logscale):
    core = (SnakeAct(channels, logscale) if activation == "snake"
            else SnakeBetaAct(channels, logscale))
    return Activation1d(core)


class AMPBlock1(nn.Module):
    def __init__(self, channels, snake_logscale, activation, kernel_size=3,
                 dilation=(1, 3, 5)):
        super().__init__()
        self.convs1 = nn.ModuleList(
            WNConv1d(channels, channels, kernel_size, stride=1, dilation=d,
                     padding=((kernel_size - 1) * d) // 2)
            for d in dilation)
        self.convs2 = nn.ModuleList(
            WNConv1d(channels, channels, kernel_size, stride=1, dilation=1,
                     padding=(kernel_size - 1) // 2)
            for _ in dilation)
        self.activations = nn.ModuleList(
            _make_act(channels, activation, snake_logscale)
            for _ in range(len(dilation) * 2))

    def forward(self, x):
        acts = list(self.activations)
        for c1, c2, a1, a2 in zip(self.convs1, self.convs2, acts[::2], acts[1::2]):
            x = x + c2(a2(c1(a1(x))))
        return x


class AMPBlock2(nn.Module):
    def __init__(self, channels, snake_logscale, activation, kernel_size=3,
                 dilation=(1, 3, 5)):
        super().__init__()
        self.convs = nn.ModuleList(
            WNConv1d(channels, channels, kernel_size, stride=1, dilation=d,
                     padding=((kernel_size - 1) * d) // 2)
            for d in dilation)
        self.activations = nn.ModuleList(
            _make_act(channels, activation, snake_logscale) for _ in dilation)

    def forward(self, x):
        for conv, act in zip(self.convs, self.activations):
            x = x + conv(act(x))
        return x


class BigVGAN(nn.Module):
    def __init__(self, config, device: str = "cuda", seed: int = 0):
        super().__init__()
        if isinstance(config, dict):
            config = BigVGANConfig.from_dict(config)
        self.config = config
        self.device = model_device(device, "BigVGAN")
        self.num_kernels = len(config.resblock_kernel_sizes)
        self.num_upsamples = len(config.upsample_rates)
        self.use_tanh_at_final = config.use_tanh_at_final
        ch0 = config.upsample_initial_channel
        block_cls = AMPBlock1 if config.resblock == "1" else AMPBlock2
        final_ch = ch0 // (2 ** self.num_upsamples)
        with torch.device(self.device):
            self.conv_pre = WNConv1d(config.num_mels, ch0, 7, 1, 3)
            self.ups = nn.ModuleList(
                nn.ModuleList([WNConvTranspose1d(ch0 // (2 ** i), ch0 // (2 ** (i + 1)), k,
                                                 stride=u, padding=(k - u) // 2)])
                for i, (u, k) in enumerate(zip(config.upsample_rates,
                                               config.upsample_kernel_sizes)))
            self.resblocks = nn.ModuleList(
                block_cls(ch0 // (2 ** (i + 1)), config.snake_logscale, config.activation,
                          k, d)
                for i in range(self.num_upsamples)
                for k, d in zip(config.resblock_kernel_sizes,
                                config.resblock_dilation_sizes))
            self.activation_post = _make_act(final_ch, config.activation,
                                             config.snake_logscale)
            self.conv_post = WNConv1d(final_ch, 1, 7, 1, padding=3,
                                      bias=config.use_bias_at_final)
        init_weights(self, torch.Generator(self.device).manual_seed(seed))

    @torch.no_grad()
    def forward(self, x) -> torch.Tensor:
        """mel [B, num_mels, T] (NCL, the reference's contract; NLC passes
        as it is) -> audio [B, T * upsampling, 1]."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        if x.shape[1] == self.config.num_mels and x.shape[-1] != self.config.num_mels:
            x = x.transpose(1, 2)  # NCL -> NLC
        x = self.conv_pre(x)
        for step in range(self.num_upsamples):
            for up in self.ups[step]:
                x = up(x)
            blocks = self.resblocks[step * self.num_kernels:(step + 1) * self.num_kernels]
            xs = blocks[0](x)
            for block in blocks[1:]:
                xs = xs + block(x)
            x = xs / self.num_kernels
        x = self.conv_post(self.activation_post(x))
        if self.use_tanh_at_final:
            return torch.tanh(x)
        return torch.clamp(x, -1.0, 1.0)

    def sanitize(self, weights: dict) -> dict:
        """An MLX-layout checkpoint -> the JAX package's layout (conv [O, K,
        I] -> [K, I, O], ``weight_g`` [O, 1, 1] -> [1, 1, O], snake alphas
        and betas flat); ``convert.params_from_jax`` takes it on to the
        port's.  The anti-aliasing filters are flattened to the [K] of the
        buffers."""
        out = {}
        for k, v in weights.items():
            v = np.asarray(v)
            if (k.endswith("weight_v") or k.endswith("weight_g")) and v.ndim == 3:
                v = v.transpose(1, 2, 0)
            if (".alpha" in k or ".beta" in k or k.endswith(".filter")) and v.ndim > 1:
                v = v.reshape(-1)
            out[k] = v
        return out

    @classmethod
    def from_pretrained(cls, path: str, device: str = "cuda") -> "BigVGAN":
        """A local checkpoint directory (``config.json``, whose nvidia/bigvgan_*
        field names match BigVGANConfig, and ``*.safetensors``)."""
        from mlx_audio_tpu_torch.codec.loading import (
            checkpoint_dir,
            load_config,
            load_weights_files,
        )
        from mlx_audio_tpu_torch.convert import params_from_jax

        model_path = checkpoint_dir(path)
        model = cls(BigVGANConfig.from_dict(load_config(model_path)), device=device)
        weights = model.sanitize(load_weights_files(model_path))
        model.load_state_dict(params_from_jax(weights, model), strict=False)
        return model
