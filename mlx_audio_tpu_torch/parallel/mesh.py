"""Distribution layer: the ('data', 'model') device grid, placement, and the
tensor-parallel rules (counterpart of ``mlx_audio_tpu/parallel/mesh.py``).

One process drives every device (the JAX package's single controller):

* A ``Mesh`` is a ``dp x tp`` grid of ``torch.device``s.  Row r of the grid
  holds data replica r; its first device is the replica's home, where the
  replica's inputs, caches and unsharded weights live.  A device may appear
  more than once (``[cuda:0] * 4`` runs a dp=2, tp=2 grid on one card).
* Data parallelism hands each row its slice of the batch (``shard_batch``,
  ``pmap_batches``); a replica on the device the module already lives on is
  the module itself, and any other device gets one copy (``place_on``).
* Tensor parallelism is explicit, since no compiler inserts collectives.
  ``shard_module`` copies the module tree (the tensors are shared) and puts
  each Linear, quantized Linear, embedding or Dia ``DenseGeneral`` whose
  rule names an axis into one of three wrappers:

  - ``ColumnParallel`` (an output axis: q/k/v/gate/up, Dia's fused MLP
    input and logits head): every shard computes its slice of the output,
    and the slices are concatenated on the home device in shard order;
  - ``RowParallel`` (an input axis: o/down, Dia's o and wo): every shard
    computes a partial sum over its slice of the input; the partials are
    added on the home device in shard order, then the bias once;
  - ``VocabParallelEmbedding`` (an embedding's vocabulary axis): every
    shard looks up the ids in its range, the others read zero, and the
    shards add; ``as_linear`` (a tied head) is column-parallel.

  A weight whose axis the tp degree does not divide replicates, as in JAX,
  and so does a quantized weight whose input split would cut a
  quantization group or the int4 concat-half packing.  A shard that stays
  on its device is a view of the weight, or one contiguous copy of it;
  a quantized shard keeps its codes and runs ``quantized_matmul`` on them.
"""

from __future__ import annotations

import copy
import re
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from mlx_audio_tpu_torch.nn.layers import Embedding, Linear
from mlx_audio_tpu_torch.nn.quantize import (
    QuantizedEmbedding,
    QuantizedLinear,
    _walk_replace,
)


def canonical_device(device) -> torch.device:
    """``device`` with its index filled in ("cuda" is the current card)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def cuda_devices() -> List[torch.device]:
    """Every visible CUDA device; raises ValueError when there is none (a
    CPU mesh is asked for by passing its devices)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise ValueError("no CUDA device is visible: pass devices= (for "
                         "example [torch.device('cpu')] * n) for a CPU mesh")
    return [torch.device("cuda", i) for i in range(n)]


class Mesh:
    """A ('data', 'model') grid of devices: ``devices`` [dp, tp]."""

    def __init__(self, devices: np.ndarray, axis_names=("data", "model")):
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def row(self, r: int) -> List[torch.device]:
        """The tp devices of data row ``r``."""
        return list(self.devices[r])

    def home(self, r: int) -> torch.device:
        """Data row ``r``'s first device."""
        return self.devices[r][0]


def get_mesh(model_parallel: int = 1, devices: Optional[Sequence] = None,
             axis_names: tuple = ("data", "model")) -> Mesh:
    """The ('data', 'model') grid over ``devices`` (every visible card by
    default): ``model_parallel`` devices a row, the rest the data axis."""
    devs = [canonical_device(d) for d in
            (devices if devices is not None else cuda_devices())]
    n = len(devs)
    if n % model_parallel != 0:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    grid = np.empty((n // model_parallel, model_parallel), dtype=object)
    for i, d in enumerate(devs):
        grid[i // model_parallel, i % model_parallel] = d
    return Mesh(grid, axis_names)


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------


def module_device(module: nn.Module) -> torch.device:
    """The device of a module's first tensor (its ``device`` attribute when
    it holds none)."""
    for t in module.parameters():
        return canonical_device(t.device)
    for t in module.buffers():
        return canonical_device(t.device)
    return canonical_device(getattr(module, "device", "cpu"))


def _copy_tree(module: nn.Module, memo: dict) -> nn.Module:
    """A copy of the module tree: new module objects with their own child,
    parameter and buffer tables, holding the same tensors."""
    if id(module) in memo:
        return memo[id(module)]
    new = copy.copy(module)
    memo[id(module)] = new
    new._parameters = dict(module._parameters)
    new._buffers = dict(module._buffers)
    new._modules = {k: None if c is None else _copy_tree(c, memo)
                    for k, c in module._modules.items()}
    for name, value in vars(module).items():
        if isinstance(value, (list, tuple, dict)) and not name.startswith("_"):
            new.__dict__[name] = _copy_container(value, memo)
    return new


def _copy_container(value, memo):
    if isinstance(value, nn.Module):
        return _copy_tree(value, memo)
    if isinstance(value, list):
        return [_copy_container(v, memo) for v in value]
    if isinstance(value, tuple) and not hasattr(value, "_fields"):
        return tuple(_copy_container(v, memo) for v in value)
    if isinstance(value, dict):
        return {k: _copy_container(v, memo) for k, v in value.items()}
    return value


def _move_tree(module: nn.Module, device: torch.device) -> None:
    """Move a copied tree's tensors to ``device`` in its own tables (the
    tensors of the tree it was copied from stay where they are)."""
    seen = set()
    for mod in module.modules():
        if id(mod) in seen:
            continue
        seen.add(id(mod))
        for key, t in mod._parameters.items():
            if t is not None:
                mod._parameters[key] = nn.Parameter(t.detach().to(device),
                                                    requires_grad=False)
        for key, t in mod._buffers.items():
            if t is not None:
                mod._buffers[key] = t.to(device)
        if hasattr(mod, "device") and not isinstance(getattr(type(mod), "device", None),
                                                     property):
            mod.__dict__["device"] = device


def place_on(module: nn.Module, device) -> nn.Module:
    """``module`` itself when it lives on ``device``, else a copy there."""
    device = canonical_device(device)
    if module_device(module) == device:
        return module
    new = _copy_tree(module, {})
    _move_tree(new, device)
    return new


def replicate(mesh: Mesh, obj):
    """One placement of ``obj`` (a module or a tensor) on every data row's
    home device, as a list over the rows."""
    out = []
    for r in range(mesh.devices.shape[0]):
        home = mesh.home(r)
        out.append(place_on(obj, home) if isinstance(obj, nn.Module) else obj.to(home))
    return out


def shard_batch(mesh: Mesh, tensor: torch.Tensor, axis: str = "data") -> list:
    """The leading axis of ``tensor`` cut into one slice a data row, each on
    its row's home device."""
    n = mesh.shape[axis]
    if tensor.shape[0] % n:
        raise ValueError(f"batch {tensor.shape[0]} not divisible by mesh axis "
                         f"'{axis}'={n}")
    size = tensor.shape[0] // n
    return [tensor[r * size:(r + 1) * size].to(mesh.home(r)) for r in range(n)]


# ---------------------------------------------------------------------------
# Tensor-parallel rules: the JAX package's regexes on the port's names.  A
# spec has one entry a weight axis, "model" on the axis that splits; ()
# replicates.
# ---------------------------------------------------------------------------

# Llama-family column/row split: q/k/v/gate/up shard the output dim
# (weight [out, in] -> ("model", None)); o/down shard the input dim;
# embeddings shard the vocabulary; everything else replicates.
_TP_COL = re.compile(r"\.(q_proj|k_proj|v_proj|gate_proj|up_proj)\.weight$")
_TP_ROW = re.compile(r"\.(o_proj|down_proj)\.weight$")
_TP_EMBED = re.compile(r"(embed_tokens|text_embeddings|audio_embeddings)\.weight$")


def tp_rules_llama(path: str, x) -> tuple:
    """The split of a Llama-model weight under ('data', 'model')."""
    if x.ndim == 2:
        if _TP_COL.search(path):
            return ("model", None)
        if _TP_ROW.search(path):
            return (None, "model")
        if _TP_EMBED.search(path):
            return ("model", None)
    return ()


# Dia's DenseGeneral weights (in_shapes + out_features, the JAX layout the
# port keeps): q/k/v [E, heads, hd] split the heads, o [heads, hd, E] its
# head input axis, the fused MLP input [E, 2, F] and wo [F, E] the hidden
# dim, the logits head [E, C, V] the vocabulary.
_DIA_QKV = re.compile(r"\.(q_proj|k_proj|v_proj)\.weight$")
_DIA_O = re.compile(r"\.o_proj\.weight$")
_DIA_WI = re.compile(r"\.wi_fused\.weight$")
_DIA_WO = re.compile(r"\.wo\.weight$")
_DIA_LOGITS = re.compile(r"logits_dense\.weight$")


def tp_rules_dia(path: str, x) -> tuple:
    """The split of a Dia encoder-decoder weight under ('data', 'model')."""
    if x.ndim == 3:
        if _DIA_QKV.search(path):
            return (None, "model", None)
        if _DIA_O.search(path):
            return ("model", None, None)
        if _DIA_WI.search(path):
            return (None, None, "model")
        if _DIA_LOGITS.search(path):
            return (None, None, "model")
    if x.ndim == 2 and _DIA_WO.search(path):
        return ("model", None)
    return ()


# ---------------------------------------------------------------------------
# Sharded modules
# ---------------------------------------------------------------------------


def _dense_general():
    from mlx_audio_tpu_torch.models.tts.dia.layers import DenseGeneral

    return DenseGeneral


def _logical_shape(module: nn.Module) -> tuple:
    """The weight's shape as the rules see it, unpacked: [out, in] for a
    quantized Linear, [vocab, dim] for a quantized embedding."""
    if isinstance(module, QuantizedLinear):
        return (module.weight.shape[0], module.in_features)
    if isinstance(module, QuantizedEmbedding):
        return (module.weight.shape[0], module.dim)
    return tuple(module.weight.shape)


def _split(module: nn.Module, spec: tuple, tp: int):
    """("col", output dim), ("row", input dim) or ("vocab", None): how
    ``module`` splits by ``spec``, or None when it replicates."""
    if "model" not in spec or tp == 1:
        return None
    axis = spec.index("model")
    if _logical_shape(module)[axis] % tp:
        return None
    if isinstance(module, (Linear, QuantizedLinear)):
        if axis == 0:
            return ("col", -1)
        if isinstance(module, QuantizedLinear) and (
                module.packed or (module.in_features // tp) % module.group_size):
            return None
        return ("row", -1)
    if isinstance(module, (Embedding, QuantizedEmbedding)):
        return ("vocab", None) if axis == 0 else None
    if isinstance(module, _dense_general()):
        n_in = len(module.in_shapes)
        if axis < n_in:
            return ("row", axis - n_in)
        return ("col", axis - module.weight.ndim)
    return None


def _like(module: nn.Module, **tensors) -> nn.Module:
    """A module of ``module``'s type and settings holding ``tensors`` in
    place of its own (None drops one)."""
    new = _copy_tree(module, {})
    for key, t in tensors.items():
        if key in new._parameters:
            new._parameters[key] = (None if t is None else
                                    nn.Parameter(t, requires_grad=False))
        else:
            new._buffers[key] = t
    return new


def _shard_tensors(module: nn.Module, kind: str, axis_dim: int, j: int, tp: int,
                   device) -> dict:
    """Shard ``j`` of ``tp``'s tensors of ``module``, on ``device``."""
    def piece(t, axis):
        size = t.shape[axis] // tp
        return t.narrow(axis, j * size, size).contiguous().to(device)

    if isinstance(module, (Linear, QuantizedLinear)):
        axis = 0 if kind == "col" else 1
        out = {k: piece(getattr(module, k), axis)
               for k in ("weight", "scales", "biases") if k in module._buffers
               or k in module._parameters}
        if module.bias is not None:
            out["bias"] = piece(module.bias, 0) if kind == "col" else None
        return out
    if isinstance(module, (Embedding, QuantizedEmbedding)):
        return {k: piece(getattr(module, k), 0) for k in ("weight", "scales", "biases")
                if k in module._buffers or k in module._parameters}
    # DenseGeneral: the weight alone
    return {"weight": piece(module.weight, module.weight.ndim + axis_dim
                            if kind == "col" else len(module.in_shapes) + axis_dim)}


class _Sharded(nn.Module):
    """A module split into ``shards`` on ``devices``.  The weight and the
    quantization settings read as shard 0's (a caller takes the weight's
    dtype, or a quantized module's scales')."""

    _FROM_SHARD = ("weight", "scales", "biases", "group_size", "bits", "packed")

    def __init__(self, shards: List[nn.Module], devices):
        super().__init__()
        self.shards = nn.ModuleList(shards)
        self.devices = list(devices)

    def __getattr__(self, name):
        if name in self._FROM_SHARD:
            return getattr(self._modules["shards"][0], name)
        return super().__getattr__(name)


class ColumnParallel(_Sharded):
    """Shards that each compute a slice of the output, concatenated on the
    input's device along ``dim`` in shard order."""

    def __init__(self, shards: List[nn.Module], devices, dim: int):
        super().__init__(shards, devices)
        self.dim = dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = [s(x.to(d)) for s, d in zip(self.shards, self.devices)]
        return torch.cat([o.to(x.device) for o in outs], dim=self.dim)


class RowParallel(_Sharded):
    """Shards that each take a slice of the input along ``dim`` and give a
    partial sum; the partials are added on the input's device in shard
    order, then ``bias`` once."""

    def __init__(self, shards: List[nn.Module], devices, dim: int,
                 bias: Optional[torch.Tensor] = None):
        super().__init__(shards, devices)
        self.dim = dim
        self.bias = None if bias is None else nn.Parameter(bias, requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = None
        for s, d, xs in zip(self.shards, self.devices,
                            x.chunk(len(self.shards), dim=self.dim)):
            part = s(xs.to(d)).to(x.device)
            y = part if y is None else y + part
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class VocabParallelEmbedding(_Sharded):
    """An embedding table split over its vocabulary: shard j holds ids
    [j V/tp, (j+1) V/tp)."""

    def __init__(self, shards: List[nn.Module], devices, rows: int):
        super().__init__(shards, devices)
        self.rows = rows

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        out = None
        for j, (s, d) in enumerate(zip(self.shards, self.devices)):
            local = ids - j * self.rows
            inside = (local >= 0) & (local < self.rows)
            e = s(local.clamp(0, self.rows - 1).to(d)).to(ids.device)
            e = torch.where(inside[..., None], e, torch.zeros((), dtype=e.dtype,
                                                               device=e.device))
            out = e if out is None else out + e
        return out

    def as_linear(self, x: torch.Tensor) -> torch.Tensor:
        outs = [s.as_linear(x.to(d)) for s, d in zip(self.shards, self.devices)]
        return torch.cat([o.to(x.device) for o in outs], dim=-1)


def _sharded(module: nn.Module, split, devices) -> nn.Module:
    kind, dim = split
    tp = len(devices)
    shards = [_like(module, **_shard_tensors(module, kind, dim, j, tp, d))
              for j, d in enumerate(devices)]
    if kind == "col":
        return ColumnParallel(shards, devices, dim)
    if kind == "row":
        bias = getattr(module, "bias", None)
        return RowParallel(shards, devices, dim,
                           None if bias is None else bias.detach().to(devices[0]))
    return VocabParallelEmbedding(shards, devices, module.weight.shape[0] // tp)


def _each_split(module: nn.Module, rules, tp: int, fn) -> None:
    """``fn(path, sub, spec, split)`` for every submodule with a weight the
    rules name, as ``_walk_replace`` finds them (its return value replaces
    the submodule)."""
    def visit(path, sub):
        w = sub._parameters.get("weight", sub._buffers.get("weight"))
        if w is None:
            return None
        spec = tuple(rules(f"{path}.weight", w))
        if "model" not in spec:
            return None
        return fn(path, sub, spec, _split(sub, spec, tp))

    _walk_replace(module, visit)


def tp_plan(module: nn.Module, rules: Callable, tp: int) -> dict:
    """{weight path: spec} of every weight the rules split, with () where
    the weight replicates (an axis tp does not divide, or a quantized split
    that would cut a group or the int4 packing)."""
    plan = {}

    def note(path, sub, spec, split):
        plan[f"{path}.weight"] = spec if split is not None else ()
        return None

    _each_split(module, rules, tp, note)
    return plan


def shard_devices(module: nn.Module, rules: Callable, devices) -> nn.Module:
    """A copy of ``module`` whose weights the rules split over ``devices``
    (the other tensors on ``devices[0]``); ``module`` is not changed."""
    devices = [canonical_device(d) for d in devices]
    new = _copy_tree(module, {})
    if module_device(module) != devices[0]:
        _move_tree(new, devices[0])

    def swap(path, sub, spec, split):
        return None if split is None else _sharded(sub, split, devices)

    _each_split(new, rules, len(devices), swap)
    return new


def shard_module(mesh: Mesh, module: nn.Module, rules: Callable, row: int = 0):
    """``module`` with its weights split over data row ``row``'s 'model'
    devices by ``rules``."""
    return shard_devices(module, rules, mesh.row(row))


# ---------------------------------------------------------------------------
# Data-parallel map
# ---------------------------------------------------------------------------


def pmap_batches(mesh: Mesh, fn: Callable, model, *arrays, axis: str = "data"):
    """``fn(model, *batch)`` on each data row's slice of every array, with
    the model replicated; the outputs concatenated on the first row's home
    device.  The batch must divide the axis (callers pad first)."""
    from mlx_audio_tpu_torch.models.sampling import row_offset

    n = mesh.shape[axis]
    for a in arrays:
        if a.shape[0] % n != 0:
            raise ValueError(
                f"batch {a.shape[0]} not divisible by mesh axis '{axis}'={n}")
    models = replicate(mesh, model)
    parts = [shard_batch(mesh, a, axis) for a in arrays]
    size = arrays[0].shape[0] // n if arrays else 0
    outs = []
    for r in range(n):
        with row_offset(r * size), torch.no_grad():
            outs.append(fn(models[r], *(p[r] for p in parts)).to(mesh.home(0)))
    return torch.cat(outs, dim=0)
