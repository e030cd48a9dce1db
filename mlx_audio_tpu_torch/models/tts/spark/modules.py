"""Spark-TTS's BiCodec building blocks (counterpart of
``mlx_audio_tpu/models/tts/spark/modules.py``): the sampling block, the
factorized VQ, FSQ and residual FSQ, the perceiver resampler, and the
ECAPA-TDNN speaker encoder with its FSQ-tokenized d-vector.

Sequences are channels last, ``[batch, length, channels]``.  Every conv
here takes the library route of ``nn.layers.conv1d`` (grouped, strided, 1x1
or too short for a kernel).  FSQ's level table and basis and the residual
FSQ's scales are buffers under the JAX package's names (``_levels``,
``_basis``, ``scales``), so a JAX model's arrays load strictly.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mlx_audio_tpu_torch.codec.dac.dac import _l2_normalize
from mlx_audio_tpu_torch.nn.layers import (
    BatchNorm,
    Conv1d,
    Embedding,
    Linear,
    WNConv1d,
    WNConvTranspose1d,
    _param,
    promote_operands,
    leaky_relu,
)


# ---------------------------------------------------------------------------
# Sampling block
# ---------------------------------------------------------------------------


class SamplingBlock(nn.Module):
    """Up- and/or down-sampling of [B, T, C]: a depthwise transposed conv
    beside a repeat, a grouped strided conv beside two mean-pools; with
    both scales 1 it returns 3x its input."""

    def __init__(self, dim: int, groups: int = 1, upsample_scale: int = 1,
                 downsample_scale: int = 1):
        super().__init__()
        self.upsample_scale = upsample_scale
        self.downsample_scale = downsample_scale
        if upsample_scale > 1:
            self.de_conv_upsampler = WNConvTranspose1d(
                dim, dim, kernel_size=upsample_scale * 2, stride=upsample_scale,
                padding=upsample_scale // 2 + upsample_scale % 2, groups=groups)
        if downsample_scale > 1:
            self.conv_downsampler = Conv1d(
                dim, dim, kernel_size=2 * downsample_scale, stride=downsample_scale,
                padding=downsample_scale // 2 + downsample_scale % 2, groups=groups)

    @staticmethod
    def skip_downsampler(x, scale):
        b, t, c = x.shape
        t2 = t - t % scale
        return x[:, :t2].reshape(b, t2 // scale, scale, c).mean(2)

    def forward(self, x):
        if self.upsample_scale > 1:
            repeat_res = torch.repeat_interleave(x, self.upsample_scale, dim=1)
            upmerge = repeat_res + self.de_conv_upsampler(leaky_relu(x, 0.2))
        else:
            upmerge = repeat_res = x
        if self.downsample_scale > 1:
            conv_res = self.conv_downsampler(leaky_relu(upmerge, 0.2))
            skip2 = self.skip_downsampler(upmerge, self.downsample_scale)
            skip1 = self.skip_downsampler(repeat_res, self.downsample_scale)
        else:
            conv_res = skip2 = upmerge
            skip1 = repeat_res
        return conv_res + skip1 + skip2


# ---------------------------------------------------------------------------
# Factorized VQ
# ---------------------------------------------------------------------------


class FactorizedVectorQuantize(nn.Module):
    def __init__(self, input_dim: int, codebook_size: int, codebook_dim: int,
                 **kwargs):
        super().__init__()
        self.input_dim = input_dim
        self.codebook_size = codebook_size
        self.codebook_dim = codebook_dim
        proj = input_dim != codebook_dim
        self.in_project = WNConv1d(input_dim, codebook_dim, 1) if proj else None
        self.out_project = WNConv1d(codebook_dim, input_dim, 1) if proj else None
        self.codebook = Embedding(codebook_size, codebook_dim)

    def _in(self, z):
        return self.in_project(z) if self.in_project is not None else z

    def _out(self, z):
        return self.out_project(z) if self.out_project is not None else z

    def distances(self, z_e):
        """z_e [B, T, D] -> squared distances [B, T, codebook_size] between
        the unit-normed rows and codebook rows."""
        enc = _l2_normalize(z_e)
        cb = _l2_normalize(self.codebook.weight)
        # each norm in its own dtype, the product promoted (jnp.matmul's rule)
        dots = torch.matmul(*promote_operands(enc, cb.t()))
        return ((enc * enc).sum(-1, keepdim=True) - 2 * dots
                + (cb * cb).sum(-1)[None, None, :])

    def decode_latents(self, z_e):
        """z_e [B, T, D] -> (z_q [B, T, D], indices [B, T]): the nearest
        codebook row, the first of equals."""
        indices = torch.argmin(self.distances(z_e), dim=-1)
        return self.codebook(indices), indices

    def tokenize(self, z):
        """z [B, T, input_dim] -> indices [B, T]."""
        return self.decode_latents(self._in(z))[1]

    def detokenize(self, indices):
        """indices [B, T] -> z_q [B, T, input_dim]."""
        return self._out(self.codebook(indices.long()))

    def forward(self, z):
        z_q, indices = self.decode_latents(self._in(z))
        return {"z_q": self._out(z_q), "indices": indices}


# ---------------------------------------------------------------------------
# FSQ and residual FSQ
# ---------------------------------------------------------------------------


class FSQ(nn.Module):
    def __init__(self, levels: List[int], dim: Optional[int] = None):
        super().__init__()
        self.levels = list(levels)
        self.register_buffer("_levels", torch.tensor(levels, dtype=torch.int32))
        self.register_buffer("_basis", torch.tensor(
            np.cumprod([1] + list(levels[:-1])), dtype=torch.int32))
        self.codebook_dim = len(levels)
        self.dim = dim or self.codebook_dim
        assert self.dim == self.codebook_dim, "projections unused in Spark configs"
        self.codebook_size = int(np.prod(levels))

    def bound(self, z, eps: float = 1e-3):
        half_l = (self._levels - 1) * (1 + eps) / 2
        offset = torch.where(self._levels % 2 == 0, 0.5, 0.0)
        shift = torch.atanh(offset / half_l)
        return torch.tanh(z + shift) * half_l - offset

    def quantize(self, z):
        """Round half to even, as jnp.round."""
        return torch.round(self.bound(z)) / (self._levels // 2)

    def codes_to_indices(self, zhat):
        half_width = self._levels // 2
        scaled = zhat * half_width + half_width
        return (scaled * self._basis).sum(-1).to(torch.int32)

    def indices_to_codes(self, indices):
        half_width = self._levels // 2
        level_idx = torch.div(indices[..., None], self._basis,
                              rounding_mode="floor") % self._levels
        return (level_idx - half_width) / half_width

    def forward(self, z):
        """z [B, T, D] -> (codes [B, T, D], indices [B, T])."""
        codes = self.quantize(z.float())
        return codes, self.codes_to_indices(codes)


class ResidualFSQ(nn.Module):
    """Residual FSQ; Spark uses one quantizer."""

    def __init__(self, *, levels: List[int], num_quantizers: int,
                 dim: Optional[int] = None, is_channel_first: bool = False,
                 **kwargs):
        super().__init__()
        codebook_dim = len(levels)
        dim = dim or codebook_dim
        self.has_projections = dim != codebook_dim
        self.project_in = Linear(dim, codebook_dim) if self.has_projections else None
        self.project_out = Linear(codebook_dim, dim) if self.has_projections else None
        self.is_channel_first = is_channel_first
        self.num_quantizers = num_quantizers
        self.layers = nn.ModuleList(FSQ(levels=levels) for _ in range(num_quantizers))
        levels_np = np.asarray(levels, dtype=np.float64)
        self.register_buffer("scales", torch.tensor(
            np.stack([(levels_np - 1) ** -i for i in range(num_quantizers)]),
            dtype=torch.float32))
        self.codebook_size = self.layers[0].codebook_size

    def _maybe_cf(self, x):
        return x.transpose(1, 2) if self.is_channel_first else x

    def forward(self, x):
        """x: [B, D, T] if channel-first else [B, T, D] -> (quantized, same
        layout; indices [B, T, Q])."""
        x = self._maybe_cf(x)
        if self.project_in is not None:
            x = self.project_in(x)
        quantized_out = 0.0
        residual = x
        indices = []
        for i, layer in enumerate(self.layers):
            scale = self.scales[i]
            q, idx = layer(residual / scale)
            q = q * scale
            residual = residual - q
            quantized_out = quantized_out + q
            indices.append(idx)
        if self.project_out is not None:
            quantized_out = self.project_out(quantized_out)
        return self._maybe_cf(quantized_out), torch.stack(indices, dim=-1)

    def get_codes_from_indices(self, indices):
        """indices [B, T, Q] (or [B, T]) -> the codes summed [B, T, D]."""
        if indices.ndim == 2:
            indices = indices[..., None]
        out = 0.0
        for i, layer in enumerate(self.layers):
            out = out + layer.indices_to_codes(indices[..., i]) * self.scales[i]
        return out

    def get_output_from_indices(self, indices):
        out = self.get_codes_from_indices(indices)
        if self.project_out is not None:
            out = self.project_out(out)
        return out


# ---------------------------------------------------------------------------
# Perceiver resampler
# ---------------------------------------------------------------------------


class RMSNormL(nn.Module):
    """Unit-normalize, then scale by sqrt(dim) * gamma."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = dim ** 0.5
        self.gamma = _param(dim)

    def init_weights(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.gamma.fill_(1.0)

    def forward(self, x):
        return _l2_normalize(x) * self.scale * self.gamma


class GEGLUFeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        inner = int(dim * mult * 2 / 3)
        self.w_in = Linear(dim, inner * 2)
        self.w_out = Linear(inner, dim)

    def forward(self, x):
        h, gate = self.w_in(x).chunk(2, dim=-1)
        return self.w_out(F.gelu(gate) * h)


class PerceiverAttention(nn.Module):
    def __init__(self, dim: int, dim_context: Optional[int] = None,
                 dim_head: int = 64, heads: int = 8,
                 cross_attn_include_queries: bool = False):
        super().__init__()
        self.heads = heads
        self.dim_head = dim_head
        self.include_queries = cross_attn_include_queries
        inner = dim_head * heads
        self.to_q = Linear(dim, inner, bias=False)
        self.to_kv = Linear(dim_context or dim, inner * 2, bias=False)
        self.to_out = Linear(inner, dim, bias=False)

    def forward(self, x, context=None):
        ctx = context if context is not None else x
        if context is not None and self.include_queries:
            ctx = torch.cat([x, ctx], dim=-2)
        b, n, _ = x.shape
        m = ctx.shape[1]
        q = self.to_q(x).reshape(b, n, self.heads, self.dim_head).transpose(1, 2)
        k, v = self.to_kv(ctx).chunk(2, dim=-1)
        k = k.reshape(b, m, self.heads, self.dim_head).transpose(1, 2)
        v = v.reshape(b, m, self.heads, self.dim_head).transpose(1, 2)
        # the products promote mixed dtypes, as the JAX package's einsums do
        scores = torch.matmul(*promote_operands(q, k.transpose(-1, -2))).float()
        probs = torch.softmax(scores * self.dim_head ** -0.5, dim=-1).to(x.dtype)
        out = torch.matmul(*promote_operands(probs, v))
        return self.to_out(out.transpose(1, 2).reshape(b, n, -1))


class PerceiverResampler(nn.Module):
    def __init__(self, *, dim: int, depth: int = 2,
                 dim_context: Optional[int] = None, num_latents: int = 32,
                 dim_head: int = 64, heads: int = 8, ff_mult: int = 4):
        super().__init__()
        dim_context = dim_context or dim
        self.proj_context = Linear(dim_context, dim) if dim_context != dim else None
        self.latents = _param(num_latents, dim)
        self.layers = nn.ModuleList(
            nn.ModuleList([PerceiverAttention(dim=dim, dim_head=dim_head, heads=heads,
                                              cross_attn_include_queries=True),
                           GEGLUFeedForward(dim, ff_mult)])
            for _ in range(depth))
        self.norm = RMSNormL(dim)

    def init_weights(self, generator: torch.Generator) -> None:
        # the JAX package's draw, whatever the generator
        latents = np.random.default_rng(0).normal(scale=0.02, size=self.latents.shape)
        with torch.no_grad():
            self.latents.copy_(torch.as_tensor(latents, dtype=torch.float32))

    def forward(self, x):
        """context [B, T, D_ctx] -> latents [B, num_latents, dim]."""
        if self.proj_context is not None:
            x = self.proj_context(x)
        latents = self.latents[None].expand(x.shape[0], -1, -1)
        for attn, ff in self.layers:
            latents = attn(latents, x) + latents
            latents = ff(latents) + latents
        return self.norm(latents)


# ---------------------------------------------------------------------------
# ECAPA-TDNN speaker encoder
# ---------------------------------------------------------------------------


class Conv1dReluBn(nn.Module):
    def __init__(self, in_channels, out_channels, kernel_size=1, stride=1,
                 padding=0, dilation=1):
        super().__init__()
        self.conv = Conv1d(in_channels, out_channels, kernel_size, stride,
                           padding, dilation)
        self.bn = BatchNorm(out_channels)

    def forward(self, x):
        return self.bn(torch.relu(self.conv(x)))


class Res2Conv1dReluBn(nn.Module):
    def __init__(self, channels, kernel_size=1, stride=1, padding=0,
                 dilation=1, scale=4):
        super().__init__()
        self.scale = scale
        self.width = channels // scale
        self.nums = scale if scale == 1 else scale - 1
        self.convs = nn.ModuleList(
            Conv1d(self.width, self.width, kernel_size, stride, padding, dilation)
            for _ in range(self.nums))
        self.bns = nn.ModuleList(BatchNorm(self.width) for _ in range(self.nums))

    def forward(self, x):
        """[B, T, C]."""
        spx = x.chunk(self.scale, dim=-1)
        out = []
        sp = spx[0]
        for i, (conv, bn) in enumerate(zip(self.convs, self.bns)):
            if i >= 1:
                sp = sp + spx[i]
            sp = bn(torch.relu(conv(sp)))
            out.append(sp)
        if self.scale != 1:
            out.append(spx[self.nums])
        return torch.cat(out, dim=-1)


class SEConnect(nn.Module):
    def __init__(self, channels, se_bottleneck_dim=128):
        super().__init__()
        self.linear1 = Linear(channels, se_bottleneck_dim)
        self.linear2 = Linear(se_bottleneck_dim, channels)

    def forward(self, x):
        s = torch.sigmoid(self.linear2(torch.relu(self.linear1(x.mean(1)))))
        return x * s[:, None, :]


class SERes2Block(nn.Module):
    def __init__(self, channels, kernel_size, stride, padding, dilation, scale):
        super().__init__()
        self.block = nn.ModuleList([
            Conv1dReluBn(channels, channels, 1, 1, 0),
            Res2Conv1dReluBn(channels, kernel_size, stride, padding, dilation,
                             scale=scale),
            Conv1dReluBn(channels, channels, 1, 1, 0),
            SEConnect(channels),
        ])

    def forward(self, x):
        res = x
        for m in self.block:
            x = m(x)
        return x + res


class ASTP(nn.Module):
    """Attentive statistics pooling: [B, T, C] -> [B, 2C]."""

    def __init__(self, in_dim, bottleneck_dim=128, global_context_att=False):
        super().__init__()
        self.in_dim = in_dim
        self.global_context_att = global_context_att
        in1 = in_dim * 3 if global_context_att else in_dim
        self.linear1 = Conv1d(in1, bottleneck_dim, 1)
        self.linear2 = Conv1d(bottleneck_dim, in_dim, 1)

    def forward(self, x):
        if self.global_context_att:
            mean = x.mean(1, keepdim=True).expand_as(x)
            std = torch.sqrt(x.var(1, keepdim=True, correction=0) + 1e-7).expand_as(x)
            x_in = torch.cat([x, mean, std], dim=-1)
        else:
            x_in = x
        alpha = torch.softmax(self.linear2(torch.tanh(self.linear1(x_in))), dim=1)
        mean = (alpha * x).sum(1)
        var = (alpha * x * x).sum(1) - mean ** 2
        std = torch.sqrt(torch.clamp(var, min=1e-7))
        return torch.cat([mean, std], dim=-1)


class ECAPA_TDNN(nn.Module):
    def __init__(self, channels=512, feat_dim=80, embed_dim=192,
                 global_context_att=False):
        super().__init__()
        self.layer1 = Conv1dReluBn(feat_dim, channels, kernel_size=5, padding=2)
        self.layer2 = SERes2Block(channels, 3, 1, 2, 2, scale=8)
        self.layer3 = SERes2Block(channels, 3, 1, 3, 3, scale=8)
        self.layer4 = SERes2Block(channels, 3, 1, 4, 4, scale=8)
        out_channels = 512 * 3
        self.conv = Conv1d(channels * 3, out_channels, 1)
        self.pool = ASTP(out_channels, global_context_att=global_context_att)
        self.bn = BatchNorm(out_channels * 2)
        self.linear = Linear(out_channels * 2, embed_dim)

    def forward(self, x, return_latent: bool = False):
        """mel [B, T, F] -> embedding [B, embed_dim] (and the latent
        [B, T, 1536])."""
        out2 = self.layer2(self.layer1(x))
        out3 = self.layer3(out2)
        out4 = self.layer4(out3)
        latent = torch.relu(self.conv(torch.cat([out2, out3, out4], dim=-1)))
        out = self.linear(self.bn(self.pool(latent)))
        return (out, latent) if return_latent else out


class SpeakerEncoder(nn.Module):
    """The x-vector and the FSQ-tokenized d-vector."""

    def __init__(self, input_dim: int = 100, out_dim: int = 512,
                 latent_dim: int = 128, token_num: int = 32,
                 fsq_levels: List[int] = (4, 4, 4, 4, 4, 4),
                 fsq_num_quantizers: int = 1):
        super().__init__()
        self.speaker_encoder = ECAPA_TDNN(channels=512, feat_dim=input_dim,
                                          embed_dim=out_dim, global_context_att=True)
        self.perceiver_sampler = PerceiverResampler(dim=latent_dim, dim_context=512 * 3,
                                                    num_latents=token_num)
        self.quantizer = ResidualFSQ(dim=latent_dim, num_quantizers=fsq_num_quantizers,
                                     levels=list(fsq_levels), is_channel_first=False)
        self.project = Linear(latent_dim * token_num, out_dim)

    def forward(self, mels):
        """mels [B, T, F] -> (x_vector [B, out], d_vector [B, out])."""
        x_vector, features = self.speaker_encoder(mels, return_latent=True)
        z_q, _ = self.quantizer(self.perceiver_sampler(features))
        return x_vector, self.project(z_q.reshape(z_q.shape[0], -1))

    def tokenize(self, mels):
        """mels [B, T, F] -> global tokens [B, token_num]."""
        _, features = self.speaker_encoder(mels, return_latent=True)
        _, indices = self.quantizer(self.perceiver_sampler(features))
        return indices[..., 0]

    def detokenize(self, indices):
        """indices [B, token_num] -> d_vector [B, out]."""
        zq = self.quantizer.get_output_from_indices(indices.long())
        return self.project(zq.reshape(zq.shape[0], -1))
