"""Shared building blocks: the subset of ``mlx_audio_tpu/nn/layers.py`` that
the ported families use, in PyTorch.

Conventions:

* Sequences are channels last, ``[batch, length, channels]`` (NLC), at every
  public function and module call, as in the JAX package.  Convolutions
  transpose to NCL only around a ``torch.nn.functional`` call.
* Weights are stored in torch's layouts: conv ``[out, in/groups, k]``,
  transposed conv ``[in, out, k]``, depthwise transposed conv ``[C, 1, k]``.
  ``mlx_audio_tpu_torch.convert`` owns the mapping from the JAX layouts.
* Weight-normalised convs keep (v, g) and normalise at call time with the
  JAX package's eps of 1e-7 on the norm; ``g`` lies on the output axis of a
  conv and the input axis of a transposed conv, as torch's weight_norm puts
  it.
* Every module with parameters has ``init_weights(generator)``, drawing
  from a ``torch.Generator`` with the JAX package's init scales.
* A model cast with ``.to(torch.bfloat16)`` runs in bf16.  Where a layer's
  input and weight differ in dtype, both are promoted first
  (``promote_operands``), as ``jnp.matmul`` and the JAX package's
  ``promote_conv_operands`` do: an f32 input into a bf16 layer runs in f32.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from mlx_audio_tpu_torch.nn import kernels


def _uniform_(t: torch.Tensor, scale: float, generator: torch.Generator) -> None:
    with torch.no_grad():
        t.uniform_(-scale, scale, generator=generator)


def _param(*shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape), requires_grad=False)


def get_padding(kernel_size: int, dilation: int = 1) -> int:
    return (kernel_size * dilation - dilation) // 2


def promote_operands(x: torch.Tensor, w: torch.Tensor):
    """(x, w) in one dtype, the promotion of theirs: the counterpart of the
    JAX package's ``promote_conv_operands`` and of ``jnp.matmul``'s rule
    (torch's matmul and convs raise on mixed dtypes instead)."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        return x.to(dt), w.to(dt)
    return x, w


# ---------------------------------------------------------------------------
# Dense / embedding
# ---------------------------------------------------------------------------


class Linear(nn.Module):
    """y = x @ W^T + b, weight [out, in]."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True):
        super().__init__()
        self.in_dim = in_dim
        self.weight = _param(out_dim, in_dim)
        self.bias = _param(out_dim) if bias else None

    def init_weights(self, generator: torch.Generator) -> None:
        scale = 1.0 / math.sqrt(self.in_dim)
        _uniform_(self.weight, scale, generator)
        if self.bias is not None:
            _uniform_(self.bias, scale, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w = promote_operands(x, self.weight)
        y = x @ w.t()
        if self.bias is not None:
            y = y + self.bias
        return y


class Embedding(nn.Module):
    def __init__(self, num_embeddings: int, dim: int):
        super().__init__()
        self.weight = _param(num_embeddings, dim)

    def init_weights(self, generator: torch.Generator) -> None:
        _uniform_(self.weight, 1.0, generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight)

    def as_linear(self, x: torch.Tensor) -> torch.Tensor:
        """Tied-embedding output projection: x [..., dim] -> [..., num]."""
        x, w = promote_operands(x, self.weight)
        return x @ w.t()


# ---------------------------------------------------------------------------
# Normalization (population variance, as jnp.var)
# ---------------------------------------------------------------------------


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = _param(dim)
        self.bias = _param(dim)

    def init_weights(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(-1, keepdim=True)
        var = x.var(-1, keepdim=True, correction=0)
        return (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias


class RMSNorm(nn.Module):
    """x / rms(x) * weight, normalised in float32."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = _param(dim)

    def init_weights(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + self.eps)
        return (y * self.weight).to(x.dtype)


class BatchNorm(nn.Module):
    """Inference batch norm over the channel (last) axis of NLC input, with
    the running statistics as buffers (``running_mean``, ``running_var``)."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = _param(num_features)
        self.bias = _param(num_features)
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def init_weights(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = (x - self.running_mean) * torch.rsqrt(self.running_var + self.eps)
        return y * self.weight + self.bias


class InstanceNorm1d(nn.Module):
    """Instance norm over the time axis of NLC input, without affine
    parameters.  ``mask`` [B, L] (True = valid) makes the statistics exact
    when L is padded to a bucket; they accumulate in float32."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        xf = x.float()
        if mask is None:
            mean = xf.mean(-2, keepdim=True)
            var = xf.var(-2, keepdim=True, correction=0)
        else:
            m = mask[..., None].float()
            count = torch.clamp(m.sum(-2, keepdim=True), min=1.0)
            mean = (xf * m).sum(-2, keepdim=True) / count
            var = ((xf - mean) ** 2 * m).sum(-2, keepdim=True) / count
        return ((xf - mean) * torch.rsqrt(var + self.eps)).to(x.dtype)


class AdaIN1d(nn.Module):
    """Style-conditioned instance norm, NLC."""

    def __init__(self, style_dim: int, num_features: int):
        super().__init__()
        self.norm = InstanceNorm1d(num_features)
        self.fc = Linear(style_dim, num_features * 2)

    def forward(self, x, s, mask=None):
        gamma, beta = self.fc(s).chunk(2, dim=-1)
        return (1 + gamma[:, None, :]) * self.norm(x, mask) + beta[:, None, :]


class AdaLayerNorm(nn.Module):
    """Style-conditioned layer norm, NLC."""

    def __init__(self, style_dim: int, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.fc = Linear(style_dim, channels * 2)

    def forward(self, x, s):
        gamma, beta = self.fc(s).chunk(2, dim=-1)
        mean = x.mean(-1, keepdim=True)
        var = x.var(-1, keepdim=True, correction=0)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return (1 + gamma[:, None, :]) * y + beta[:, None, :]


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01) -> torch.Tensor:
    return torch.where(x > 0, x, x * negative_slope)


def snake(x: torch.Tensor, alpha: torch.Tensor,
          alpha_logscale: bool = False) -> torch.Tensor:
    """Snake activation ``x + sin^2(a x) / a``, per channel (last axis)."""
    if alpha_logscale:
        alpha = torch.exp(alpha)
    s = torch.sin(alpha * x)
    return x + s * s / (alpha + 1e-9)


def snake_beta(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
               alpha_logscale: bool = True) -> torch.Tensor:
    """SnakeBeta ``x + sin^2(a x) / b``, per channel (last axis); with
    ``alpha_logscale`` both a and b are given as logs."""
    if alpha_logscale:
        alpha, beta = torch.exp(alpha), torch.exp(beta)
    s = torch.sin(alpha * x)
    return x + s * s / (beta + 1e-9)


class Identity(nn.Module):
    def forward(self, x, *args, **kwargs):
        return x


def zero_pad_time(x: torch.Tensor, pad: tuple[int, int]) -> torch.Tensor:
    """Zero-pad the time (second-to-last) axis of NLC input."""
    return F.pad(x, (0, 0, *pad))


# ---------------------------------------------------------------------------
# Convolutions (NLC)
# ---------------------------------------------------------------------------


def banded_conv_supported(k: int, c: int, c_out: int, l: int,
                          dtype: torch.dtype = torch.float32) -> bool:
    """Shape rules of the JAX package's banded gate: K >= 5 and odd, C and
    Cout multiples of 128, at least 4096 rows, and a band waste 8Q/K <= 3.
    Its 10 MiB VMEM budget for W_band is a TPU fact: the Hopper kernel
    forms no band, and its own limit is shared memory, whose stages grow
    with K: K <= 13 in float32's tiles, K <= 15 in bf16's."""
    if k < 5 or k % 2 == 0 or c % 128 or c_out % 128 or l < 4096:
        return False
    return (8 * kernels.banded_groups(k) / k <= 3.0
            and kernels.banded_conv1d_smem_bytes(k, dtype)
            <= kernels.SMEM_LIMIT_BYTES)


def conv1d_route(k: int, c: int, c_out: int, l: int, dilation: int = 1,
                 stride: int = 1, groups: int = 1,
                 padding: Union[int, tuple] = 0,
                 dtype: torch.dtype = torch.float32) -> str:
    """Which implementation ``conv1d`` takes: "banded", "shifted" or
    "library".  Mirrors the dispatch of the JAX package's conv1d with both
    TPU opt-ins on, float32 and bf16 under the same shape rules.  The
    shifted route's 8 MiB VMEM weight clause becomes the Hopper kernel's own
    limit, its shared memory per block in ``dtype``'s tiles.  Every other
    dtype goes to torch.nn.functional.conv1d."""
    if isinstance(padding, int):
        padding = (padding, padding)
    span = (k - 1) * dilation
    same = (stride == 1 and groups == 1 and k > 1 and k % 2 == 1
            and tuple(padding) == (span // 2, span // 2))
    if not same or dtype not in (torch.float32, torch.bfloat16):
        return "library"
    if banded_conv_supported(k, c, c_out, l // max(dilation, 1), dtype):
        return "banded"
    if (l >= 2048 and c % 128 == 0 and c_out % 128 == 0
            and kernels.dilated_conv1d_smem_bytes(k, dilation, dtype)
            <= kernels.SMEM_LIMIT_BYTES):
        return "shifted"
    return "library"


def _dilated_conv1d_residue(x: torch.Tensor, weight: torch.Tensor,
                            dilation: int, dense_conv) -> torch.Tensor:
    """'Same' dilated conv as a dense conv over residue streams: with
    t = q d + r, neighbours at distance d are consecutive within stream r,
    so folding the d streams into the batch turns dilation d into a dense
    K-tap conv, exact at both ends.  weight [K, C, Cout]."""
    b, l, c = x.shape
    d = dilation
    lp = -(-l // d) * d
    xp = F.pad(x, (0, 0, 0, lp - l))
    xs = xp.reshape(b, lp // d, d, c).transpose(1, 2).reshape(b * d, lp // d, c)
    y = dense_conv(xs.contiguous(), weight)
    y = y.reshape(b, d, lp // d, -1).transpose(1, 2).reshape(b, lp, -1)
    return y[:, :l]


def conv1d(x: torch.Tensor, weight: torch.Tensor, stride: int = 1,
           padding: Union[int, tuple] = 0, dilation: int = 1,
           groups: int = 1) -> torch.Tensor:
    """Conv over NLC input with weight [out, in/groups, k]; mixed dtypes
    promote (``promote_operands``)."""
    if isinstance(padding, int):
        padding = (padding, padding)
    x, weight = promote_operands(x, weight)
    k = weight.shape[-1]
    route = conv1d_route(k, x.shape[-1], weight.shape[0], x.shape[1],
                         dilation, stride, groups, padding, x.dtype)
    if route != "library":
        w = weight.permute(2, 1, 0).contiguous()  # [K, C, Cout]
        x = x.contiguous()
        if route == "shifted":
            return kernels.dilated_conv1d(x, w, dilation)
        if dilation == 1:
            return kernels.banded_conv1d(x, w)
        return _dilated_conv1d_residue(x, w, dilation, kernels.banded_conv1d)
    xt = x.transpose(1, 2)
    if padding[0] == padding[1]:
        y = F.conv1d(xt, weight, None, stride, padding[0], dilation, groups)
    else:
        y = F.conv1d(F.pad(xt, padding), weight, None, stride, 0, dilation,
                     groups)
    return y.transpose(1, 2)


def conv_transpose1d(x: torch.Tensor, weight: torch.Tensor, stride: int = 1,
                     padding: int = 0, output_padding: int = 0,
                     groups: int = 1) -> torch.Tensor:
    """Transposed conv over NLC input, weight [in, out/groups, k]; mixed
    dtypes promote (``promote_operands``)."""
    x, weight = promote_operands(x, weight)
    y = F.conv_transpose1d(x.transpose(1, 2), weight, None, stride, padding,
                           output_padding, groups)
    return y.transpose(1, 2)


def depthwise_conv_transpose1d(x: torch.Tensor, weight: torch.Tensor,
                               stride: int, padding: int,
                               output_padding: int = 0) -> torch.Tensor:
    """Depthwise transposed conv: weight [C, 1, k], NLC input."""
    return conv_transpose1d(x, weight, stride, padding, output_padding,
                            groups=x.shape[-1])


def weight_norm(weight_v: torch.Tensor, weight_g: torch.Tensor) -> torch.Tensor:
    """w = g * v / (||v|| + 1e-7), the norm over every axis but the first
    (conv out-channel; transposed-conv in-channel)."""
    norm = torch.sqrt((weight_v * weight_v).sum(dim=(1, 2), keepdim=True))
    return weight_v / (norm + 1e-7) * weight_g


class Conv1d(nn.Module):
    """Standard conv, weight [out, in/groups, k]."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 groups: int = 1, bias: bool = True):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.dilation, self.groups = dilation, groups
        self.fan_in = in_channels * kernel_size / groups
        self.weight = _param(out_channels, in_channels // groups, kernel_size)
        self.bias = _param(out_channels) if bias else None

    def init_weights(self, generator: torch.Generator) -> None:
        scale = 1.0 / math.sqrt(self.fan_in)
        _uniform_(self.weight, scale, generator)
        if self.bias is not None:
            _uniform_(self.bias, scale, generator)

    def forward(self, x):
        y = conv1d(x, self.weight, self.stride, self.padding, self.dilation,
                   self.groups)
        return y + self.bias if self.bias is not None else y


class WNConv1d(nn.Module):
    """Weight-normalised conv1d: weight_v [out, in/groups, k], weight_g
    [out, 1, 1]."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 groups: int = 1, bias: bool = True):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.dilation, self.groups = dilation, groups
        self.fan_in = in_channels * kernel_size / groups
        self.weight_v = _param(out_channels, in_channels // groups, kernel_size)
        self.weight_g = _param(out_channels, 1, 1)
        self.bias = _param(out_channels) if bias else None

    def init_weights(self, generator: torch.Generator) -> None:
        _uniform_(self.weight_v, 1.0 / math.sqrt(self.fan_in), generator)
        with torch.no_grad():
            # g = ||v||, so that w == v at init (torch weight_norm convention)
            self.weight_g.copy_(self.weight_v.norm(dim=(1, 2), keepdim=True))
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x):
        w = weight_norm(self.weight_v, self.weight_g)
        y = conv1d(x, w, self.stride, self.padding, self.dilation, self.groups)
        return y + self.bias if self.bias is not None else y


class ConvTranspose1d(nn.Module):
    """Transposed conv1d over NLC input: weight [in, out, k], or [C, 1, k]
    when depthwise (groups = in = out); the JAX package stores [k, in, out]
    and [k, C, 1], which ``convert`` moves."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, output_padding: int = 0,
                 groups: int = 1, bias: bool = True):
        super().__init__()
        if groups != 1 and not in_channels == out_channels == groups:
            raise NotImplementedError("grouped convT supports depthwise only")
        self.stride, self.padding = stride, padding
        self.output_padding, self.groups = output_padding, groups
        self.fan_in = in_channels * kernel_size / groups
        self.weight = _param(in_channels, out_channels // groups, kernel_size)
        self.bias = _param(out_channels) if bias else None

    def init_weights(self, generator: torch.Generator) -> None:
        scale = 1.0 / math.sqrt(self.fan_in)
        _uniform_(self.weight, scale, generator)
        if self.bias is not None:
            _uniform_(self.bias, scale, generator)

    def forward(self, x):
        if self.groups == 1:
            y = conv_transpose1d(x, self.weight, self.stride, self.padding,
                                 self.output_padding)
        else:
            y = depthwise_conv_transpose1d(x, self.weight, self.stride,
                                           self.padding, self.output_padding)
        return y + self.bias if self.bias is not None else y


class WNConvTranspose1d(nn.Module):
    """Weight-normalised transposed conv1d: weight_v [in, out, k] (groups=1)
    or [C, 1, k] (depthwise), weight_g [in, 1, 1]."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, output_padding: int = 0,
                 groups: int = 1, bias: bool = True):
        super().__init__()
        if groups != 1 and not in_channels == out_channels == groups:
            raise NotImplementedError("grouped convT supports depthwise only")
        self.stride, self.padding = stride, padding
        self.output_padding, self.groups = output_padding, groups
        self.fan_in = in_channels * kernel_size / groups
        self.weight_v = _param(in_channels, out_channels // groups, kernel_size)
        self.weight_g = _param(in_channels, 1, 1)
        self.bias = _param(out_channels) if bias else None

    def init_weights(self, generator: torch.Generator) -> None:
        _uniform_(self.weight_v, 1.0 / math.sqrt(self.fan_in), generator)
        with torch.no_grad():
            self.weight_g.copy_(self.weight_v.norm(dim=(1, 2), keepdim=True))
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x):
        w = weight_norm(self.weight_v, self.weight_g)
        y = conv_transpose1d(x, w, self.stride, self.padding,
                             self.output_padding, self.groups)
        return y + self.bias if self.bias is not None else y


def _pair(v) -> tuple:
    return (v, v) if isinstance(v, int) else tuple(v)


class Conv2d(nn.Module):
    """2-d conv over NHWC input, weight [out, in/groups, kh, kw] (the JAX
    package stores HWIO; ``convert`` moves it).  Mixed dtypes promote
    (``promote_operands``); every shape goes to torch.nn.functional.conv2d,
    as the JAX package's goes to ``lax.conv_general_dilated``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride=1, padding=0, dilation=1, groups: int = 1,
                 bias: bool = True):
        super().__init__()
        kh, kw = _pair(kernel_size)
        self.stride, self.padding = _pair(stride), _pair(padding)
        self.dilation, self.groups = _pair(dilation), groups
        self.fan_in = in_channels * kh * kw / groups
        self.weight = _param(out_channels, in_channels // groups, kh, kw)
        self.bias = _param(out_channels) if bias else None

    def init_weights(self, generator: torch.Generator) -> None:
        scale = 1.0 / math.sqrt(self.fan_in)
        _uniform_(self.weight, scale, generator)
        if self.bias is not None:
            _uniform_(self.bias, scale, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w = promote_operands(x, self.weight)
        y = F.conv2d(x.permute(0, 3, 1, 2), w, None, self.stride,
                     self.padding, self.dilation, self.groups).permute(0, 2, 3, 1)
        return y + self.bias if self.bias is not None else y
