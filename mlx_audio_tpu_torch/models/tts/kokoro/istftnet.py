"""ISTFTNet decoder for Kokoro (counterpart of
``mlx_audio_tpu/models/tts/kokoro/istftnet.py``).

AdaIN-conditioned HiFiGAN-style generator with a harmonic-plus-noise source
and an ISTFT head, NLC layout, mask-aware so that a run at a bucketed frame
count equals an exact-length run.  The resblock convolutions reach the CUDA
kernels through ``nn.layers.conv1d``.

The source's random draws are inputs: ``rand_ini`` [B, harmonics] (the
initial phase offsets) and ``noise`` [B, L, harmonics] (standard normals at
audio rate).  When they are not given, ``SineGen`` draws them with
``source_noise`` from ``seed``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mlx_audio_tpu_torch import dsp
from mlx_audio_tpu_torch.nn import (
    AdaIN1d,
    Conv1d,
    Identity,
    Linear,
    WNConv1d,
    WNConvTranspose1d,
    get_padding,
    interpolate,
    leaky_relu,
    promote_operands,
)


def length_mask(total_len: int, lengths: Optional[torch.Tensor]
                ) -> Optional[torch.Tensor]:
    """[B, total_len] True for valid positions; None passes through."""
    if lengths is None:
        return None
    return torch.arange(total_len, device=lengths.device)[None, :] < lengths[:, None]


def apply_mask(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return x
    return torch.where(mask[..., None], x, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))


class AdaINResBlock1(nn.Module):
    """HiFiGAN ResBlock with AdaIN conditioning and Snake activation;
    alpha parameters stored [C]."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: Sequence[int] = (1, 3, 5), style_dim: int = 64):
        super().__init__()
        self.convs1 = nn.ModuleList(
            WNConv1d(channels, channels, kernel_size, stride=1,
                     padding=get_padding(kernel_size, d), dilation=d)
            for d in dilation)
        self.convs2 = nn.ModuleList(
            WNConv1d(channels, channels, kernel_size, stride=1,
                     padding=get_padding(kernel_size, 1), dilation=1)
            for _ in dilation)
        self.adain1 = nn.ModuleList(AdaIN1d(style_dim, channels) for _ in dilation)
        self.adain2 = nn.ModuleList(AdaIN1d(style_dim, channels) for _ in dilation)
        self.alpha1 = nn.ParameterList(
            nn.Parameter(torch.ones(channels), requires_grad=False)
            for _ in dilation)
        self.alpha2 = nn.ParameterList(
            nn.Parameter(torch.ones(channels), requires_grad=False)
            for _ in dilation)

    def init_weights(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            for a in [*self.alpha1, *self.alpha2]:
                a.fill_(1.0)

    def forward(self, x, s, mask=None):
        for c1, c2, n1, n2, a1, a2 in zip(self.convs1, self.convs2,
                                          self.adain1, self.adain2,
                                          self.alpha1, self.alpha2):
            xt = n1(x, s, mask)
            xt = xt + (1 / a1) * torch.sin(a1 * xt) ** 2  # Snake1d
            xt = apply_mask(xt, mask)
            xt = c1(xt)
            xt = n2(xt, s, mask)
            xt = xt + (1 / a2) * torch.sin(a2 * xt) ** 2
            xt = apply_mask(xt, mask)
            xt = c2(xt)
            x = xt + x
        return apply_mask(x, mask)


class AdainResBlk1d(nn.Module):
    """StyleTTS2 AdaIN residual block with optional 2x upsampling."""

    def __init__(self, dim_in: int, dim_out: int, style_dim: int = 64,
                 upsample: bool = False, dropout_p: float = 0.0):
        super().__init__()
        self.dim_in = dim_in
        self.do_upsample = upsample
        self.learned_sc = dim_in != dim_out
        self.conv1 = WNConv1d(dim_in, dim_out, 3, stride=1, padding=1)
        self.conv2 = WNConv1d(dim_out, dim_out, 3, stride=1, padding=1)
        self.norm1 = AdaIN1d(style_dim, dim_in)
        self.norm2 = AdaIN1d(style_dim, dim_out)
        if self.learned_sc:
            self.conv1x1 = WNConv1d(dim_in, dim_out, 1, stride=1, padding=0,
                                    bias=False)
        # depthwise transposed-conv upsampler
        self.pool = (WNConvTranspose1d(dim_in, dim_in, kernel_size=3, stride=2,
                                       padding=1, groups=dim_in)
                     if upsample else Identity())

    def _shortcut(self, x):
        if self.do_upsample:
            x = interpolate(x, scale_factor=2, mode="nearest")
        if self.learned_sc:
            x = self.conv1x1(x)
        return x

    def _residual(self, x, s, mask):
        x = self.norm1(x, s, mask)
        x = leaky_relu(x, 0.2)
        if self.do_upsample:
            x = self.pool(x)                 # [B, 2L-1, C]
            x = F.pad(x, (0, 0, 1, 0))       # left-pad 1 -> [B, 2L, C]
        x = self.conv1(x)
        out_mask = mask
        if self.do_upsample and mask is not None:
            out_mask = mask.repeat_interleave(2, dim=-1)
            x = apply_mask(x, out_mask)
        x = self.norm2(x, s, out_mask)
        x = leaky_relu(x, 0.2)
        x = self.conv2(x)
        return x, out_mask

    def forward(self, x, s, mask=None):
        res, out_mask = self._residual(x, s, mask)
        out = (res + self._shortcut(x)) / math.sqrt(2)
        return apply_mask(out, out_mask)


class TorchSTFT(nn.Module):
    """mag/phase STFT head, [B, frames, bins].  inverse() unwraps the phase
    along frames (a cumsum) before resynthesis."""

    def __init__(self, filter_length=800, hop_length=200, win_length=800,
                 window="hann_periodic"):
        super().__init__()
        # StyleTTS2 windows with the PERIODIC hann for analysis and synthesis
        self.filter_length = filter_length
        self.hop_length = hop_length
        self.win_length = win_length
        self.window = window

    def transform(self, x: torch.Tensor):
        """[B, T] -> (magnitude, phase) each [B, frames, bins]."""
        re, im = dsp.stft_realimag(x, self.filter_length, self.hop_length,
                                   self.win_length, self.window, center=True,
                                   pad_mode="reflect")
        return torch.sqrt(re * re + im * im + 1e-14), torch.atan2(im, re)

    def inverse(self, magnitude: torch.Tensor, phase: torch.Tensor) -> torch.Tensor:
        """(mag, phase) [B, frames, bins] -> audio [B, T], in float32: the
        phase unwrap is a long cumsum."""
        magnitude = magnitude.float()
        phase = unwrap(phase.float(), dim=-2)
        spec = torch.complex(magnitude * torch.cos(phase),
                             magnitude * torch.sin(phase))
        return dsp.istft(spec.transpose(-1, -2), self.hop_length,
                         self.win_length, self.window, center=True)


def unwrap(p: torch.Tensor, dim: int = -1, period: float = 2 * math.pi) -> torch.Tensor:
    """numpy.unwrap semantics."""
    discont = period / 2
    dim = dim % p.dim()
    n = p.shape[dim]
    dd = p.narrow(dim, 1, n - 1) - p.narrow(dim, 0, n - 1)
    interval_high = period / 2
    ddmod = dd - period * torch.floor((dd - (-interval_high)) / period)
    ddmod = torch.where(((dd - interval_high).abs() < 1e-10) & (dd > 0),
                        torch.full_like(dd, interval_high), ddmod)
    ph_correct = ddmod - dd
    ph_correct = torch.where(dd.abs() < discont, torch.zeros_like(dd), ph_correct)
    pad_shape = list(ph_correct.shape)
    pad_shape[dim] = 1
    padded = torch.cat([ph_correct.new_zeros(pad_shape), ph_correct], dim=dim)
    return p + torch.cumsum(padded, dim=dim)


def _downsample_linear_int_last(x: torch.Tensor, s: int) -> torch.Tensor:
    """interpolate(., scale_factor=1/s, mode='linear') along the last axis
    for integer s with L % s == 0, as reshape + slice."""
    *lead, l = x.shape
    lo = (s - 1) // 2
    frac = (0.5 * s - 0.5) - lo          # 0.5 for even s, 0.0 for odd
    xr = x.reshape(*lead, l // s, s)
    if frac == 0.0:
        return xr[..., lo]
    return (1.0 - frac) * xr[..., lo] + frac * xr[..., lo + 1]


def _upsample_linear_int_last(x: torch.Tensor, s: int) -> torch.Tensor:
    """interpolate(., scale_factor=s, mode='linear') along the last axis for
    integer s, as a broadcast lerp with edge-clamped neighbours."""
    *lead, f = x.shape
    pos = (np.arange(s) + 0.5) / s - 0.5  # [s] fractional source offset
    is_neg = pos < 0
    frac = torch.as_tensor(np.where(is_neg, pos + 1.0, pos), dtype=x.dtype,
                           device=x.device)
    x_m1 = torch.cat([x[..., :1], x[..., :-1]], dim=-1)
    x_p1 = torch.cat([x[..., 1:], x[..., -1:]], dim=-1)
    neg = torch.as_tensor(is_neg, device=x.device)
    lo_val = torch.where(neg, x_m1[..., None], x[..., None])  # [..., f, s]
    hi_val = torch.where(neg, x[..., None], x_p1[..., None])
    y = lo_val * (1.0 - frac) + hi_val * frac
    return y.reshape(*lead, f * s)


NOISE_BLOCK = 60000  # audio samples: one frame-bucket step (100 x 600)


def source_noise(b: int, length: int, harmonics: int, device,
                 seed: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """The source's draws: ``rand_ini`` [B, harmonics] and standard normal
    ``noise`` [B, length, harmonics].

    Each row has a ``torch.Generator`` of its own on ``device``, seeded from
    (seed, row), and draws its noise in blocks of ``NOISE_BLOCK`` samples.
    So a row's draws depend neither on the batch layout nor on the padded
    length: a longer frame bucket extends them, which keeps bucketed
    synthesis exact (the JAX package's per-row ``_row_normals`` contract).
    """
    n_blocks = -(-length // NOISE_BLOCK)
    rand_ini, noise = [], []
    for row in range(b):
        gen = torch.Generator(device=device).manual_seed(seed * 2 ** 20 + row)
        rand_ini.append(torch.randn(harmonics, generator=gen, device=device))
        blocks = [torch.randn(NOISE_BLOCK, harmonics, generator=gen,
                              device=device) for _ in range(n_blocks)]
        noise.append(torch.cat(blocks)[:length])
    return torch.stack(rand_ini), torch.stack(noise)


class SineGen(nn.Module):
    """Harmonic sine source, run as [B, harmonics, L]."""

    def __init__(self, samp_rate: int, upsample_scale: int, harmonic_num: int = 0,
                 sine_amp: float = 0.1, noise_std: float = 0.003,
                 voiced_threshold: float = 0.0):
        super().__init__()
        self.sine_amp = sine_amp
        self.noise_std = noise_std
        self.harmonic_num = harmonic_num
        self.dim = harmonic_num + 1
        self.sampling_rate = samp_rate
        self.voiced_threshold = voiced_threshold
        self.upsample_scale = upsample_scale

    def _f02sine_hl(self, fn: torch.Tensor, rand_ini: torch.Tensor) -> torch.Tensor:
        # fn: [B, H, L].  The phase accumulates in float32.
        s = self.upsample_scale
        rad = (fn.float() / self.sampling_rate) % 1.0
        rand_ini = rand_ini.float().clone()
        rand_ini[:, 0] = 0.0
        rad[:, :, 0] += rand_ini
        # downsample rad to frame rate, integrate, upsample the phase
        if rad.shape[-1] % s == 0:
            rad_ds = _downsample_linear_int_last(rad, s)
            phase = torch.cumsum(rad_ds, dim=-1) * 2 * math.pi
            phase_us = _upsample_linear_int_last(phase * s, s)
        else:
            rad_ds = interpolate(rad.transpose(1, 2), scale_factor=1 / s,
                                 mode="linear").transpose(1, 2)
            phase = torch.cumsum(rad_ds, dim=-1) * 2 * math.pi
            phase_us = interpolate((phase * s).transpose(1, 2), scale_factor=s,
                                   mode="linear").transpose(1, 2)
        return torch.sin(phase_us).to(fn.dtype)

    def forward(self, f0: torch.Tensor, rand_ini: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None, seed: int = 0):
        """f0: [B, L, 1] at audio rate ->
        (sine_waves [B, H, L], uv [B, L, 1], noise [B, H, L])."""
        b, l, _ = f0.shape
        if rand_ini is None or noise is None:
            drawn = source_noise(b, l, self.dim, f0.device, seed)
            rand_ini = drawn[0] if rand_ini is None else rand_ini
            noise = drawn[1] if noise is None else noise
        harmonics = torch.arange(1, self.dim + 1, device=f0.device)[None, :, None]
        fn = f0[..., 0][:, None, :] * harmonics          # [B, H, L]
        sine_waves = self._f02sine_hl(fn, rand_ini) * self.sine_amp
        uv = (f0 > self.voiced_threshold).float()       # [B, L, 1]
        uv_hl = uv[..., 0][:, None, :]
        noise_amp = uv_hl * self.noise_std + (1 - uv_hl) * self.sine_amp / 3
        noise = noise_amp * noise.movedim(-1, 1)
        return sine_waves * uv_hl + noise, uv, noise


class SourceModuleHnNSF(nn.Module):
    """Merge the harmonics into one excitation.  Returns (sine_merge
    [B, L, 1], uv [B, L, 1]); the JAX module's third output, a noise draw
    that no caller reads, is not made."""

    def __init__(self, sampling_rate, upsample_scale, harmonic_num=0,
                 sine_amp=0.1, add_noise_std=0.003, voiced_threshod=0.0):
        super().__init__()
        self.sine_amp = sine_amp
        self.l_sin_gen = SineGen(sampling_rate, upsample_scale, harmonic_num,
                                 sine_amp, add_noise_std, voiced_threshod)
        self.l_linear = Linear(harmonic_num + 1, 1)

    def forward(self, x, rand_ini=None, noise=None, seed: int = 0):
        sine_wavs, uv, _ = self.l_sin_gen(x, rand_ini, noise, seed)
        # harmonic mix: a contraction over H (float32 sine waves against a
        # bf16 weight promote, as in the JAX package)
        mixed = (torch.einsum("bhl,h->bl", *promote_operands(
            sine_wavs, self.l_linear.weight[0])) + self.l_linear.bias[0])
        return torch.tanh(mixed)[..., None], uv


class Generator(nn.Module):
    """HiFiGAN-style generator with an ISTFT head."""

    def __init__(self, style_dim, resblock_kernel_sizes, upsample_rates,
                 upsample_initial_channel, resblock_dilation_sizes,
                 upsample_kernel_sizes, gen_istft_n_fft, gen_istft_hop_size):
        super().__init__()
        self.num_kernels = len(resblock_kernel_sizes)
        self.num_upsamples = len(upsample_rates)
        self.upsample_rates = list(upsample_rates)
        self.total_upsample = int(np.prod(upsample_rates)) * gen_istft_hop_size
        self.m_source = SourceModuleHnNSF(
            sampling_rate=24000, upsample_scale=self.total_upsample,
            harmonic_num=8, voiced_threshod=10)
        self.ups = nn.ModuleList(
            WNConvTranspose1d(upsample_initial_channel // (2 ** i),
                              upsample_initial_channel // (2 ** (i + 1)),
                              k, stride=u, padding=(k - u) // 2)
            for i, (u, k) in enumerate(zip(upsample_rates, upsample_kernel_sizes)))
        self.resblocks = nn.ModuleList()
        self.noise_convs = nn.ModuleList()
        self.noise_res = nn.ModuleList()
        for i in range(len(self.ups)):
            ch = upsample_initial_channel // (2 ** (i + 1))
            for k, d in zip(resblock_kernel_sizes, resblock_dilation_sizes):
                self.resblocks.append(AdaINResBlock1(ch, k, d, style_dim))
            if i + 1 < len(upsample_rates):
                stride_f0 = int(np.prod(upsample_rates[i + 1:]))
                self.noise_convs.append(Conv1d(
                    gen_istft_n_fft + 2, ch, kernel_size=stride_f0 * 2,
                    stride=stride_f0, padding=(stride_f0 + 1) // 2))
                self.noise_res.append(AdaINResBlock1(ch, 7, [1, 3, 5], style_dim))
            else:
                self.noise_convs.append(Conv1d(gen_istft_n_fft + 2, ch, kernel_size=1))
                self.noise_res.append(AdaINResBlock1(ch, 11, [1, 3, 5], style_dim))
        self.post_n_fft = gen_istft_n_fft
        self.conv_post = WNConv1d(ch, gen_istft_n_fft + 2, 7, stride=1, padding=3)
        self.stft = TorchSTFT(filter_length=gen_istft_n_fft,
                              hop_length=gen_istft_hop_size,
                              win_length=gen_istft_n_fft)

    def forward(self, x, s, f0, rand_ini=None, noise=None, seed: int = 0,
                lengths: Optional[torch.Tensor] = None):
        """x: [B, L, C] (L = 2 x asr frames), f0: [B, L] coarse F0 curve,
        lengths: valid L per row (for bucketed execution)."""
        b = x.shape[0]
        up = self.total_upsample
        # nearest upsample of F0 to audio rate: repeat each sample
        f0_up = f0[:, :, None].expand(b, f0.shape[1], up).reshape(b, -1, 1)
        har_source, _ = self.m_source(f0_up, rand_ini, noise, seed)
        if lengths is not None:
            har_source = apply_mask(har_source,
                                    length_mask(har_source.shape[1], lengths * up))
        har_spec, har_phase = self.stft.transform(har_source[..., 0])
        # the source path runs in float32; join the decoder's dtype here
        har = torch.cat([har_spec, har_phase], dim=-1).to(x.dtype)

        cur_len = lengths
        cur_mask = None
        for i in range(self.num_upsamples):
            x = leaky_relu(x, 0.1)
            x_source = self.noise_convs[i](har)
            if cur_len is not None:
                # the final stage runs at STFT frame rate: L*up/hop + 1 frames
                extra = 1 if i == self.num_upsamples - 1 else 0
                src_len = cur_len * self.upsample_rates[i] + extra
                src_mask = length_mask(x_source.shape[1], src_len)
            else:
                src_mask = None
            x_source = apply_mask(x_source, src_mask)
            x_source = self.noise_res[i](x_source, s, src_mask)

            x = self.ups[i](x)
            if cur_len is not None:
                cur_len = cur_len * self.upsample_rates[i]
            if i == self.num_upsamples - 1:
                # the reference's "reflection pad" pads with zeros
                x = F.pad(x, (0, 0, 1, 0))
                if cur_len is not None:
                    cur_len = cur_len + 1
            cur_mask = length_mask(x.shape[1], cur_len)
            x = apply_mask(x, cur_mask) + x_source

            xs = None
            for j in range(self.num_kernels):
                y = self.resblocks[i * self.num_kernels + j](x, s, cur_mask)
                xs = y if xs is None else xs + y
            x = xs / self.num_kernels

        x = leaky_relu(x, 0.01)
        x = self.conv_post(x)
        x = apply_mask(x, cur_mask)
        spec = torch.exp(x[..., : self.post_n_fft // 2 + 1])
        phase = torch.sin(x[..., self.post_n_fft // 2 + 1:])
        return self.stft.inverse(spec, phase)


class Decoder(nn.Module):
    """Kokoro decoder: prosody-conditioned encode/decode stack + Generator."""

    def __init__(self, dim_in, style_dim, dim_out, resblock_kernel_sizes,
                 upsample_rates, upsample_initial_channel,
                 resblock_dilation_sizes, upsample_kernel_sizes,
                 gen_istft_n_fft, gen_istft_hop_size):
        super().__init__()
        bottleneck = 2 * upsample_initial_channel
        asr_ch = 64
        self.encode = AdainResBlk1d(dim_in + 2, bottleneck, style_dim)
        self.decode = nn.ModuleList([
            AdainResBlk1d(bottleneck + 2 + asr_ch, bottleneck, style_dim),
            AdainResBlk1d(bottleneck + 2 + asr_ch, bottleneck, style_dim),
            AdainResBlk1d(bottleneck + 2 + asr_ch, bottleneck, style_dim),
            AdainResBlk1d(bottleneck + 2 + asr_ch, upsample_initial_channel,
                          style_dim, upsample=True),
        ])
        self.F0_conv = WNConv1d(1, 1, kernel_size=3, stride=2, padding=1)
        self.N_conv = WNConv1d(1, 1, kernel_size=3, stride=2, padding=1)
        self.asr_res = nn.ModuleList([WNConv1d(dim_in, asr_ch, kernel_size=1,
                                               padding=0)])
        self.generator = Generator(
            style_dim, resblock_kernel_sizes, upsample_rates,
            upsample_initial_channel, resblock_dilation_sizes,
            upsample_kernel_sizes, gen_istft_n_fft, gen_istft_hop_size)

    def forward(self, asr, f0_curve, n_curve, s, rand_ini=None, noise=None,
                seed: int = 0, frame_lengths: Optional[torch.Tensor] = None):
        """asr: [B, F, C]; f0/n curves: [B, 2F]; s: [B, style];
        frame_lengths: valid F per row.  Returns audio [B, 600 F]."""
        mask = length_mask(asr.shape[1], frame_lengths)
        f0 = self.F0_conv(f0_curve[..., None])  # [B, F, 1]
        n = self.N_conv(n_curve[..., None])
        x = torch.cat([asr, f0, n], dim=-1)
        x = self.encode(x, s, mask)
        asr_res = self.asr_res[0](asr)
        res = True
        for block in self.decode:
            if res:
                x = torch.cat([x, asr_res, f0, n], dim=-1)
            x = block(x, s, mask)
            if block.do_upsample:
                res = False
                if mask is not None:
                    mask = mask.repeat_interleave(2, dim=-1)
        return self.generator(
            x, s, f0_curve, rand_ini, noise, seed,
            lengths=frame_lengths * 2 if frame_lengths is not None else None)
