"""SNAC, the multi-scale neural audio codec of Orpheus's token space
(counterpart of ``mlx_audio_tpu/codec/snac/snac.py``).

Hierarchical RVQ at per-codebook temporal strides, optional depthwise convs
(every conv of the published 24 kHz codec, ``groups = C``, takes the
library route: the conv kernels need ``groups == 1``, as the JAX package's
do), and optional windowed local attention with the JAX package's
half-split rotary.  Channels last between blocks.

The decoder's noise blocks draw ``normal(b, t, 1)``; the JAX package draws
from ``PRNGKey(0)`` in every block when given no key, which torch cannot
reproduce.  So ``decode`` takes the draws as an input, one ``[B, T_i, 1]``
tensor a decoder block, and otherwise draws them from ``generator`` (or, in
every block, from a generator seeded 0).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mlx_audio_tpu_torch.codec.dac.dac import (
    ResidualUnit,
    Snake1d,
    nearest_code,
    sanitize_mlx,
)
from mlx_audio_tpu_torch.models.base import BaseModelArgs, init_weights, model_device
from mlx_audio_tpu_torch.nn.layers import (
    Embedding,
    LayerNorm,
    Linear,
    WNConv1d,
    WNConvTranspose1d,
)


@dataclass
class SNACConfig(BaseModelArgs):
    sampling_rate: int = 44100
    encoder_dim: int = 64
    encoder_rates: List[int] = field(default_factory=lambda: [3, 3, 7, 7])
    latent_dim: Optional[int] = None
    decoder_dim: int = 1536
    decoder_rates: List[int] = field(default_factory=lambda: [7, 7, 3, 3])
    attn_window_size: Optional[int] = 32
    codebook_size: int = 4096
    codebook_dim: int = 8
    vq_strides: List[int] = field(default_factory=lambda: [8, 4, 2, 1])
    noise: bool = True
    depthwise: bool = True


class LocalMHA(nn.Module):
    """Windowed self-attention with rotary positions."""

    def __init__(self, dim: int = 1024, window_size: int = 32,
                 dim_head: int = 64):
        super().__init__()
        self.norm = LayerNorm(dim)
        self.heads = dim // dim_head
        self.dim_head = dim_head
        self.window_size = window_size
        self.to_qkv = Linear(dim, dim * 3, bias=False)
        self.to_out = Linear(dim, dim, bias=False)

    @staticmethod
    def _rotary(x):
        """GPT-NeoX half-split rotation over the window positions."""
        n, d = x.shape[-2], x.shape[-1]
        inv_freq = 1.0 / (10000 ** (np.arange(0, d, 2) / d))
        freqs = np.concatenate([np.outer(np.arange(n), inv_freq)] * 2, axis=-1)
        cos = torch.as_tensor(np.cos(freqs), dtype=x.dtype, device=x.device)
        sin = torch.as_tensor(np.sin(freqs), dtype=x.dtype, device=x.device)
        x1, x2 = x.chunk(2, dim=-1)
        return x * cos + torch.cat([-x2, x1], dim=-1) * sin

    def forward(self, x):
        """[B, T, C], T a multiple of the window (SNAC pads to one)."""
        b, t, c = x.shape
        q, k, v = self.to_qkv(self.norm(x)).chunk(3, dim=-1)
        w = t // self.window_size

        def to_windows(z):  # -> [B, H, W, N, D]
            return z.reshape(b, w, self.window_size, self.heads,
                             self.dim_head).permute(0, 3, 1, 2, 4)

        q, k, v = to_windows(q), to_windows(k), to_windows(v)
        q, k = self._rotary(q), self._rotary(k)
        scores = (torch.einsum("bhwnd,bhwmd->bhwnm", q, k)
                  * (1.0 / math.sqrt(self.dim_head)))
        probs = torch.softmax(scores.float(), dim=-1).to(x.dtype)
        out = torch.einsum("bhwnm,bhwmd->bhwnd", probs, v)
        out = out.permute(0, 2, 3, 1, 4).reshape(b, t, c)
        return self.to_out(out) + x


class EncoderBlock(nn.Module):
    def __init__(self, output_dim=16, input_dim=None, stride=1, groups=1):
        super().__init__()
        input_dim = input_dim or output_dim // 2
        self.block = nn.ModuleList([
            ResidualUnit(input_dim, dilation=1, groups=groups),
            ResidualUnit(input_dim, dilation=3, groups=groups),
            ResidualUnit(input_dim, dilation=9, groups=groups),
            Snake1d(input_dim),
            WNConv1d(input_dim, output_dim, kernel_size=2 * stride,
                     stride=stride, padding=math.ceil(stride / 2)),
        ])

    def forward(self, x):
        for layer in self.block:
            x = layer(x)
        return x


class Encoder(nn.Module):
    def __init__(self, d_model=64, strides=(3, 3, 7, 7), depthwise=False,
                 attn_window_size=32):
        super().__init__()
        layers = [WNConv1d(1, d_model, kernel_size=7, padding=3)]
        for stride in strides:
            d_model *= 2
            groups = d_model // 2 if depthwise else 1
            layers.append(EncoderBlock(output_dim=d_model, stride=stride,
                                       groups=groups))
        if attn_window_size is not None:
            layers.append(LocalMHA(dim=d_model, window_size=attn_window_size))
        layers.append(WNConv1d(d_model, d_model, kernel_size=7, padding=3,
                               groups=d_model if depthwise else 1))
        self.block = nn.ModuleList(layers)

    def forward(self, x):
        for layer in self.block:
            x = layer(x)
        return x


class NoiseBlock(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.linear = WNConv1d(dim, dim, kernel_size=1, bias=False)

    def forward(self, x, noise):
        """x [B, T, C] + noise [B, T, 1] * linear(x)."""
        return x + noise * self.linear(x)


class DecoderBlock(nn.Module):
    def __init__(self, input_dim=16, output_dim=8, stride=1, noise=False,
                 groups=1):
        super().__init__()
        self.pre = nn.ModuleList([
            Snake1d(input_dim),
            WNConvTranspose1d(input_dim, output_dim, kernel_size=2 * stride,
                              stride=stride, padding=math.ceil(stride / 2),
                              output_padding=stride % 2),
        ])
        self.noise_block = NoiseBlock(output_dim) if noise else None
        self.post = nn.ModuleList([
            ResidualUnit(output_dim, dilation=1, groups=groups),
            ResidualUnit(output_dim, dilation=3, groups=groups),
            ResidualUnit(output_dim, dilation=9, groups=groups),
        ])

    def forward(self, x, noise=None, generator=None):
        for layer in self.pre:
            x = layer(x)
        if self.noise_block is not None:
            if noise is None:
                gen = generator or torch.Generator(x.device).manual_seed(0)
                noise = torch.randn((x.shape[0], x.shape[1], 1), generator=gen,
                                    device=x.device, dtype=x.dtype)
            x = self.noise_block(x, noise.to(x.device, x.dtype))
        for layer in self.post:
            x = layer(x)
        return x


class Decoder(nn.Module):
    def __init__(self, input_channel, channels, rates, noise=False,
                 depthwise=False, attn_window_size=32, d_out=1):
        super().__init__()
        if depthwise:
            pre = [WNConv1d(input_channel, input_channel, kernel_size=7,
                            padding=3, groups=input_channel),
                   WNConv1d(input_channel, channels, kernel_size=1)]
        else:
            pre = [WNConv1d(input_channel, channels, kernel_size=7, padding=3)]
        self.pre = nn.ModuleList(pre)
        self.attn = (LocalMHA(dim=channels, window_size=attn_window_size)
                     if attn_window_size is not None else None)
        blocks = []
        output_dim = channels
        for i, stride in enumerate(rates):
            input_dim = channels // (2 ** i)
            output_dim = channels // (2 ** (i + 1))
            blocks.append(DecoderBlock(input_dim, output_dim, stride, noise,
                                       groups=output_dim if depthwise else 1))
        self.blocks = nn.ModuleList(blocks)
        self.post = nn.ModuleList([Snake1d(output_dim),
                                   WNConv1d(output_dim, d_out, 7, padding=3)])

    def forward(self, x, noise: Optional[Sequence[torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None):
        for layer in self.pre:
            x = layer(x)
        if self.attn is not None:
            x = self.attn(x)
        for i, block in enumerate(self.blocks):
            x = block(x, None if noise is None else noise[i], generator)
        for layer in self.post:
            x = layer(x)
        return torch.tanh(x)


class VectorQuantize(nn.Module):
    """Strided factorized VQ: average-pool by the stride before the lookup,
    repeat each step ``stride`` times after it."""

    def __init__(self, input_dim, codebook_size, codebook_dim, stride=1):
        super().__init__()
        self.stride = stride
        self.codebook_size = codebook_size
        self.in_proj = WNConv1d(input_dim, codebook_dim, kernel_size=1)
        self.out_proj = WNConv1d(codebook_dim, input_dim, kernel_size=1)
        self.codebook = Embedding(codebook_size, codebook_dim)

    def forward(self, z):
        """z [B, T, D] -> (z_q [B, T, D], indices [B, T / stride])."""
        if self.stride > 1:
            b, t, d = z.shape
            z = z.reshape(b, t // self.stride, self.stride, d).mean(dim=2)
        indices = nearest_code(self.in_proj(z), self.codebook.weight)
        return self.decode_code(indices), indices

    def decode_code(self, indices):
        z_q = self.out_proj(self.codebook(indices))
        if self.stride > 1:
            z_q = z_q.repeat_interleave(self.stride, dim=1)
        return z_q


class ResidualVectorQuantize(nn.Module):
    def __init__(self, input_dim=512, codebook_size=1024, codebook_dim=8,
                 vq_strides=(1, 1, 1, 1)):
        super().__init__()
        self.n_codebooks = len(vq_strides)
        self.quantizers = nn.ModuleList(
            VectorQuantize(input_dim, codebook_size, codebook_dim, stride)
            for stride in vq_strides)

    def forward(self, z):
        z_q = 0
        residual = z
        codes = []
        for quantizer in self.quantizers:
            z_q_i, indices_i = quantizer(residual)
            z_q = z_q + z_q_i
            residual = residual - z_q_i
            codes.append(indices_i)
        return z_q, codes

    def from_codes(self, codes: List[torch.Tensor]) -> torch.Tensor:
        z_q = 0
        for quantizer, c in zip(self.quantizers, codes):
            z_q = z_q + quantizer.decode_code(c)
        return z_q


class SNAC(nn.Module):
    def __init__(self, config=None, device: str = "cuda", seed: int = 0):
        super().__init__()
        if isinstance(config, dict):
            config = SNACConfig.from_dict(config)
        config = config or SNACConfig()
        device = model_device(device, "SNAC")
        self.config = config
        self.sampling_rate = config.sampling_rate
        latent_dim = config.latent_dim or config.encoder_dim * (
            2 ** len(config.encoder_rates))
        self.latent_dim = latent_dim
        self.hop_length = int(np.prod(config.encoder_rates))
        self.vq_strides = list(config.vq_strides)
        self.attn_window_size = config.attn_window_size
        with torch.device(device):
            self.encoder = Encoder(config.encoder_dim, config.encoder_rates,
                                   depthwise=config.depthwise,
                                   attn_window_size=config.attn_window_size)
            self.quantizer = ResidualVectorQuantize(
                input_dim=latent_dim, codebook_size=config.codebook_size,
                codebook_dim=config.codebook_dim, vq_strides=config.vq_strides)
            self.decoder = Decoder(latent_dim, config.decoder_dim,
                                   config.decoder_rates, config.noise,
                                   depthwise=config.depthwise,
                                   attn_window_size=config.attn_window_size)
        init_weights(self, torch.Generator(device).manual_seed(seed))
        self.device = device

    def preprocess(self, audio: torch.Tensor) -> torch.Tensor:
        """[B, 1, T] NCL -> [B, T', 1] NLC, padded to whole hops times the
        strides' (and window's) least common multiple."""
        if audio.ndim == 3 and audio.shape[1] == 1:
            audio = audio.transpose(1, 2)
        length = audio.shape[-2]
        window = [self.attn_window_size] if self.attn_window_size else []
        pad_to = self.hop_length * int(np.lcm.reduce(self.vq_strides + window))
        right_pad = math.ceil(length / pad_to) * pad_to - length
        if right_pad:
            audio = F.pad(audio, (0, 0, 0, right_pad))
        return audio

    def encode(self, audio: torch.Tensor) -> List[torch.Tensor]:
        """[B, 1, T] -> codes, one [B, T_i] a codebook."""
        z = self.encoder(self.preprocess(audio.to(self.device)))
        return self.quantizer(z)[1]

    def decode(self, codes: List[torch.Tensor],
               noise: Optional[Sequence[torch.Tensor]] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Codes -> audio [B, 1, T].  ``noise``: one [B, T_i, 1] draw a
        decoder block (T_i its output length), else drawn from
        ``generator``."""
        z_q = self.quantizer.from_codes([c.to(self.device) for c in codes])
        t0 = z_q.shape[1]
        w = self.attn_window_size
        if w and t0 % w:
            # the decoder's windows need T % window == 0, which only encode's
            # padding guarantees: pad codes made elsewhere (an LM's), and trim
            # the synthesized tail
            z_q = F.pad(z_q, (0, 0, 0, w - t0 % w))
        audio = self.decoder(z_q, noise, generator)
        if w and t0 % w:
            audio = audio[:, : t0 * (audio.shape[1] // z_q.shape[1])]
        return audio.transpose(1, 2)

    def forward(self, audio: torch.Tensor, noise=None, generator=None):
        length = audio.shape[-1]
        z = self.encoder(self.preprocess(audio.to(self.device)))
        z_q, codes = self.quantizer(z)
        out = self.decoder(z_q, noise, generator)
        return out.transpose(1, 2)[..., :length], codes

    def sanitize(self, weights: dict) -> dict:
        """Checkpoint keys and layouts -> the JAX package's."""
        return sanitize_mlx(weights)

    @classmethod
    def from_pretrained(cls, path: str, device: str = "cuda") -> "SNAC":
        """Load a local checkpoint directory (the hubertsiuzdak/snac_*
        config format)."""
        from mlx_audio_tpu_torch.codec.loading import (
            checkpoint_dir,
            load_config,
            load_weights_files,
        )
        from mlx_audio_tpu_torch.convert import params_from_jax

        path = checkpoint_dir(path)
        model = cls(SNACConfig.from_dict(load_config(path)), device=device)
        state = params_from_jax(model.sanitize(load_weights_files(path)), model)
        model.load_state_dict(state, strict=False)
        return model
