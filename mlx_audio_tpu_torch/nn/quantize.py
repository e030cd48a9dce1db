"""Weight-only affine quantization (counterpart of
``mlx_audio_tpu/nn/quantize.py``).

Grouped affine codes ``w ~= q * scale + bias`` are held as uint8.  Codes of
<= 4 bits pack two per byte in the "concat-half" layout: byte ``j`` holds
column ``j`` in its low nibble and column ``j + I/2`` in its high nibble.
Quantized modules replace Linear and Embedding in place, with the same call
signatures and the JAX package's attribute names (``weight`` for the codes,
``scales``, ``biases``, ``bias``), so checkpoints cross unchanged.

``QuantizedLinear`` and ``QuantizedEmbedding.as_linear`` (a tied LM head)
send a call of at most ``KERNEL_MAX_ROWS`` rows to the ``quantized_matmul``
kernel, which never forms the dense weight; a larger call dequantizes and
multiplies.  The JAX package's alignment gate
(``quant_matmul_supported``: O, I, group size and I/2 multiples of 128) was
Mosaic's layout rule and is gone: the Hopper kernel takes any group size that
divides I.  A model cast to bf16 keeps uint8 codes and bf16 scales and
biases; a bf16 x takes the kernel's bf16 variant on the card (float32 sums,
as the TPU kernel's), and on the CPU dequantizes and multiplies in bf16, as
the JAX package's CPU route does.  Codes are computed with the same float32 operations as the JAX
package's numpy code, so both give equal codes.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from mlx_audio_tpu_torch.nn import kernels
from mlx_audio_tpu_torch.nn.layers import Embedding, Linear

# rows up to which QuantizedLinear takes the kernel: decode steps and CSM's
# 32-row verify pass, which must share the kernel's summation order for
# spec-decode frames to equal plain ones.  chip_smoke.py prints where the two
# paths cross; on an H100 80GB HBM3 at 700 W the kernel is no slower than
# dequantize-and-matmul up to 64 rows at every projection of CSM-1B, and
# slower at 128 (it runs float32 FMAs, and re-reads the codes for every 8
# rows).  The JAX package's TPU kernel takes up to 512.
KERNEL_MAX_ROWS = 32

# the converter's mixed-bit recipes (``mixed_quant_predicate_builder``)
QUANT_RECIPES = ["mixed_2_6", "mixed_3_4", "mixed_3_6", "mixed_4_6"]


def _affine_quantize(w: torch.Tensor, group_size: int, bits: int):
    """w [O, I] -> (codes uint8 [O, I], scales [O, I/gs], biases [O, I/gs])."""
    o, i = w.shape
    if i % group_size:
        raise ValueError(f"in_features {i} % group_size {group_size} != 0")
    g = w.reshape(o, i // group_size, group_size).float()
    lo = g.amin(-1)
    hi = g.amax(-1)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar multiplies
    # by its reciprocal, which is not numpy's division
    n_levels = (1 << bits) - 1
    scales = torch.clamp(
        (hi - lo) / torch.tensor(float(n_levels), device=w.device), min=1e-8)
    q = torch.clamp(torch.round((g - lo[..., None]) / scales[..., None]),
                    0, n_levels).to(torch.uint8)
    return q.reshape(o, i), scales, lo


def _affine_dequantize(q, scales, biases, group_size: int):
    o, i = q.shape
    g = q.reshape(o, i // group_size, group_size).to(scales.dtype)
    return (g * scales[..., None] + biases[..., None]).reshape(o, i)


def _packable(bits: int, in_dim: int) -> bool:
    """<= 4-bit codes fit a nibble; packing needs an even minor dim."""
    return bits <= 4 and in_dim % 2 == 0


def _pack4(q: torch.Tensor) -> torch.Tensor:
    """[..., I] uint8 nibble codes -> [..., I/2] concat-half packed bytes."""
    half = q.shape[-1] // 2
    return q[..., :half] | (q[..., half:] << 4)


def _unpack4(qp: torch.Tensor) -> torch.Tensor:
    return torch.cat([qp & 0xF, qp >> 4], dim=-1)


def _matmul_codes(x, codes, scales, biases, group_size: int, packed: bool):
    """x [..., I] @ dequant(codes [O, I(/2)])^T -> [..., O] in x's dtype:
    the kernel for at most ``KERNEL_MAX_ROWS`` rows, else dequantize in x's
    dtype and multiply, as the JAX package's dense route does.  A bf16 x on
    the CPU takes the dense route at every row count (the JAX package's CPU
    route; the kernel sums in float32, as the TPU kernel does).  Float32
    scales meet bf16 x in the kernel as they are; bf16 scales meet a
    float32 x cast up, exactly."""
    x2 = x.reshape(-1, scales.shape[1] * group_size)
    if x2.shape[0] <= KERNEL_MAX_ROWS and (x.is_cuda or x.dtype == torch.float32):
        if x.dtype == torch.float32:
            scales, biases = scales.float(), biases.float()
        y = kernels.quantized_matmul(x2.contiguous(), codes, scales, biases,
                                     group_size, packed)
    else:
        q = _unpack4(codes) if packed else codes
        w = _affine_dequantize(q, scales.to(x.dtype), biases.to(x.dtype),
                               group_size)
        y = x2 @ w.t()
    return y.reshape(*x.shape[:-1], codes.shape[0])


class QuantizedLinear(nn.Module):
    """y = x @ dequant(W)^T + b; drop-in for Linear."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 group_size: int = 64, bits: int = 4, device=None):
        super().__init__()
        self.group_size = group_size
        self.bits = bits
        self.packed = _packable(bits, in_features)
        stored = in_features // 2 if self.packed else in_features
        groups = in_features // group_size
        self.register_buffer("weight", torch.zeros(
            (out_features, stored), dtype=torch.uint8, device=device))
        self.register_buffer("scales", torch.ones(
            (out_features, groups), device=device))
        self.register_buffer("biases", torch.zeros(
            (out_features, groups), device=device))
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device),
                                  requires_grad=False) if bias else None)

    @property
    def in_features(self) -> int:
        return self.scales.shape[1] * self.group_size

    @classmethod
    def from_linear(cls, lin: Linear, group_size: int = 64,
                    bits: int = 4) -> "QuantizedLinear":
        w = lin.weight.detach()
        qe = cls(w.shape[1], w.shape[0], bias=lin.bias is not None,
                 group_size=group_size, bits=bits, device=w.device)
        q, s, b = _affine_quantize(w, group_size, bits)
        qe.weight = _pack4(q) if qe.packed else q
        qe.scales, qe.biases = s, b
        if lin.bias is not None:
            qe.bias = nn.Parameter(lin.bias.detach().clone(), requires_grad=False)
        return qe

    def _codes(self) -> torch.Tensor:
        return _unpack4(self.weight) if self.packed else self.weight

    def to_linear(self) -> Linear:
        q = self._codes()
        lin = Linear(q.shape[1], q.shape[0], bias=self.bias is not None)
        lin.weight.data = _affine_dequantize(q, self.scales, self.biases,
                                             self.group_size)
        if self.bias is not None:
            lin.bias.data = self.bias.detach().clone()
        return lin

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _matmul_codes(x, self.weight, self.scales, self.biases,
                          self.group_size, self.packed)
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)
        return y


class QuantizedEmbedding(nn.Module):
    """Row gather + dequant; ``as_linear`` for a tied LM head."""

    def __init__(self, num_embeddings: int, dim: int, group_size: int = 64,
                 bits: int = 4, device=None):
        super().__init__()
        self.group_size = group_size
        self.bits = bits
        self.packed = _packable(bits, dim)
        stored = dim // 2 if self.packed else dim
        self.register_buffer("weight", torch.zeros(
            (num_embeddings, stored), dtype=torch.uint8, device=device))
        self.register_buffer("scales", torch.ones(
            (num_embeddings, dim // group_size), device=device))
        self.register_buffer("biases", torch.zeros(
            (num_embeddings, dim // group_size), device=device))

    @property
    def dim(self) -> int:
        return self.scales.shape[1] * self.group_size

    @classmethod
    def from_embedding(cls, emb: Embedding, group_size: int = 64,
                       bits: int = 4) -> "QuantizedEmbedding":
        w = emb.weight.detach()
        qe = cls(w.shape[0], w.shape[1], group_size=group_size, bits=bits,
                 device=w.device)
        q, s, b = _affine_quantize(w, group_size, bits)
        qe.weight = _pack4(q) if qe.packed else q
        qe.scales, qe.biases = s, b
        return qe

    def _codes(self) -> torch.Tensor:
        return _unpack4(self.weight) if self.packed else self.weight

    def to_embedding(self) -> Embedding:
        q = self._codes()
        emb = Embedding(q.shape[0], q.shape[1])
        emb.weight.data = _affine_dequantize(q, self.scales, self.biases,
                                             self.group_size)
        return emb

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        q = self.weight[idx]
        if self.packed:
            q = _unpack4(q)
        q = q.reshape(*idx.shape, self.dim // self.group_size,
                      self.group_size).to(self.scales.dtype)
        w = q * self.scales[idx][..., None] + self.biases[idx][..., None]
        return w.reshape(*idx.shape, self.dim)

    def as_linear(self, x: torch.Tensor) -> torch.Tensor:
        """x [..., dim] @ dequant(codes)^T: a tied LM head.  A call of at
        most ``KERNEL_MAX_ROWS`` rows takes the ``quantized_matmul`` kernel
        on the [num, dim] codes as they are; the JAX package dequantizes the
        whole table on every call."""
        return _matmul_codes(x, self.weight, self.scales, self.biases,
                             self.group_size, self.packed)


def _walk_replace(obj, fn: Callable[[str, nn.Module], Optional[nn.Module]],
                  path: str = ""):
    """Replace submodules where ``fn(path, module)`` returns a replacement.

    Covers registered children (``nn.ModuleList`` and ``nn.ModuleDict``
    included) and modules held in plain lists, tuples and dicts, so no
    submodule escapes quantization.  Returns ``obj`` or its replacement."""
    def visit(sub, value):
        repl = fn(sub, value) if isinstance(value, nn.Module) else None
        return repl if repl is not None else _walk_replace(value, fn, sub)

    def join(name):
        return f"{path}.{name}" if path else str(name)

    if isinstance(obj, nn.Module):
        for name, child in list(obj._modules.items()):
            if child is not None:
                new = visit(join(name), child)
                if new is not child:
                    setattr(obj, name, new)
        for name, value in list(vars(obj).items()):
            if isinstance(value, (list, tuple, dict)) and not name.startswith("_"):
                new = _walk_replace(value, fn, join(name))
                if new is not value:
                    setattr(obj, name, new)
        return obj
    if isinstance(obj, list):
        for i, value in enumerate(obj):
            obj[i] = visit(join(i), value)
        return obj
    if isinstance(obj, tuple):
        new = tuple(visit(join(i), v) for i, v in enumerate(obj))
        return obj if all(a is b for a, b in zip(new, obj)) else type(obj)(new)
    if isinstance(obj, dict):
        for key, value in list(obj.items()):
            obj[key] = visit(join(key), value)
        return obj
    return obj


def quantize_model(model: nn.Module, group_size: int = 64, bits: int = 4,
                   quant_predicate: Optional[Callable] = None) -> nn.Module:
    """In place: Linear -> QuantizedLinear, Embedding -> QuantizedEmbedding.

    ``quant_predicate(path, module, config)`` may return False (skip), True
    (defaults) or a dict {"group_size": g, "bits": b}; a model may veto
    through its ``model_quant_predicate``.  A module whose input dim the
    final group size does not divide stays as it is."""
    model_pred = getattr(model, "model_quant_predicate",
                         lambda p, m, config: True)

    def decide(path, mod):
        if not isinstance(mod, (Linear, Embedding)) or not model_pred(path, mod, None):
            return None
        params = {"group_size": group_size, "bits": bits}
        if quant_predicate is not None:
            verdict = quant_predicate(path, mod, None)
            if verdict is False:
                return None
            if isinstance(verdict, dict):
                params.update(verdict)
        if mod.weight.shape[1] % params["group_size"]:
            return None
        if isinstance(mod, Linear):
            return QuantizedLinear.from_linear(mod, **params)
        return QuantizedEmbedding.from_embedding(mod, **params)

    _walk_replace(model, decide)
    return model


def dequantize_model(model: nn.Module) -> nn.Module:
    """Inverse of :func:`quantize_model`."""

    def decide(path, mod):
        if isinstance(mod, QuantizedLinear):
            return mod.to_linear().to(mod.scales.device)
        if isinstance(mod, QuantizedEmbedding):
            return mod.to_embedding().to(mod.scales.device)
        return None

    _walk_replace(model, decide)
    return model


def mixed_quant_predicate_builder(recipe: str, model) -> Callable:
    """The predicate of a mixed-bit recipe ``mixed_L_H``: embeddings and LM
    heads get H bits, one in four indexed layers gets H bits, the rest get L
    bits (the JAX package's rule)."""
    import re

    low, high = (int(x) for x in recipe.split("_")[1:])

    def predicate(path, mod, config):
        if "embed" in path or "lm_head" in path or path.endswith("head"):
            return {"bits": high}
        m = re.search(r"\.(\d+)\.", path)
        if m is not None and int(m.group(1)) % 4 == 0:
            return {"bits": high}
        return {"bits": low}

    return predicate
