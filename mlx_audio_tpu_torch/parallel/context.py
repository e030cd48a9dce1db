"""The active mesh: the product-path entry to the distribution layer
(counterpart of ``mlx_audio_tpu/parallel/context.py``).

A CLI, the server or a test calls ``activate_mesh("dp=4,tp=2")`` once in
its own process, and every batched synthesis or decode path asks
``active_mesh()``: with dp > 1 it pads its batch to a dp multiple, runs
each data row's slice of the rows on that row's replica, and puts the rows
back in order; with tp > 1 the families with rules run weights split by
``parallel.mesh``'s wrappers.  One process drives every device, unless
``parallel.distributed.initialize`` has formed a group before the
activation: the mesh then spans every process's devices, each process runs
the data rows of its own devices and the rows are gathered across the
group.  Kokoro's ``synthesize_batch`` (and ``generate`` and
``generate_batch`` over it) runs a batch so; every other path raises under
such a mesh.

The devices are every visible CUDA device unless ``devices=`` names them
(a device may repeat: ``[cuda:0] * 4`` is a dp=2, tp=2 grid on one card,
``[cpu] * n`` the CPU meshes of the tests).  With no card visible and none
named, activation raises; there is no CPU fallback.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mlx_audio_tpu_torch.parallel import distributed
from mlx_audio_tpu_torch.parallel.mesh import (
    Mesh,
    cuda_devices,
    get_mesh,
    module_device,
    place_on,
    shard_devices,
)

_ACTIVE: Optional["MeshContext"] = None

logger = logging.getLogger(__name__)

# warn once a process when dp padding wastes a large share of a pass (the
# server's batcher flushes in dp multiples to avoid it)
_PAD_WASTE_THRESHOLD = 0.25
_warned_pad_waste = False


def _note_pad_waste(n: int, m: int, dp: int) -> None:
    global _warned_pad_waste
    if m == n or _warned_pad_waste:
        return
    if (m - n) / m > _PAD_WASTE_THRESHOLD:
        _warned_pad_waste = True
        logger.warning(
            "dp=%d padded a batch of %d rows to %d — %d%% of this pass is "
            "duplicated work; size batches to dp multiples to avoid it",
            dp, n, m, round(100 * (m - n) / m),
        )


def parse_mesh_spec(spec: str) -> Tuple[int, int]:
    """'dp=4' | 'tp=2' | 'dp=4,tp=2' | '8' (a bare int is dp) -> (dp, tp).

    dp=0 means "all remaining devices" (resolved at activation)."""
    spec = spec.strip().lower()
    if not spec:
        return 1, 1
    if spec.isdigit():
        return int(spec), 1
    dp, tp = None, 1
    for part in spec.split(","):
        if "=" not in part:
            raise ValueError(f"bad mesh spec segment {part!r} in {spec!r}")
        k, v = part.split("=", 1)
        k, v = k.strip(), int(v)
        if k == "dp":
            dp = v
        elif k == "tp":
            tp = v
        else:
            raise ValueError(f"unknown mesh axis {k!r} (use dp/tp)")
    if dp is None:
        dp = 0  # a tp-only spec: dp covers the remaining devices
    return dp, tp


@dataclass
class MeshContext:
    """An activated ('data', 'model') mesh and its placement caches.

    The caches key on id(model) and keep the model alive, so an id is not
    reused; a serving process holds a handful of models."""

    mesh: Mesh
    dp: int
    tp: int
    _replicated: Dict[int, tuple] = field(default_factory=dict)
    _tp_sharded: Dict[int, tuple] = field(default_factory=dict)

    def pad_rows(self, n: int) -> int:
        """The least multiple of dp >= n."""
        return -(-n // self.dp) * self.dp

    def pad_batch(self, a: torch.Tensor):
        """Pad a tensor's leading axis to a dp multiple by repeating its last
        row (the caller drops the padded rows).  Returns (padded, n)."""
        n = a.shape[0]
        m = self.pad_rows(n)
        if m == n:
            return a, n
        _note_pad_waste(n, m, self.dp)
        return torch.cat([a, a[-1:].expand(m - n, *a.shape[1:])]), n

    def row_slices(self, n: int) -> List[Tuple[int, int]]:
        """Data row r's rows [lo, hi) of a batch of n, a dp multiple."""
        if n % self.dp:
            raise ValueError(f"batch {n} not divisible by dp={self.dp}")
        size = n // self.dp
        return [(r * size, (r + 1) * size) for r in range(self.dp)]

    def home(self, r: int) -> torch.device:
        return self.mesh.home(r)

    @property
    def processes(self) -> int:
        """The processes whose devices the mesh spans (1 without a group)."""
        return int(self.mesh.processes.max()) + 1

    def own_rows(self) -> List[int]:
        """The data rows this process drives: every row in one process."""
        return self.mesh.local_rows(distributed.process_index())

    def gather_rows(self, local: np.ndarray) -> np.ndarray:
        """The rows of this process's data rows (``own_rows``, in order)
        joined with every other process's, in data-row order: ``local``
        itself in one process."""
        if self.processes == 1:
            return local
        return distributed.all_gather_rows(torch.from_numpy(local)).numpy()

    def one_process(self, what: str) -> None:
        """Raise when the mesh spans processes: ``what`` runs its rows in
        one process only."""
        if self.processes > 1:
            raise NotImplementedError(
                f"{what} runs in one process; over a process group only Kokoro's "
                "synthesize_batch splits a batch")

    def shard_batch(self, *tensors):
        """Each tensor's leading axis cut into one slice a data row, on the
        row's home device: a list over the rows for each tensor."""
        self.one_process("shard_batch")
        out = []
        for t in tensors:
            out.append([t[lo:hi].to(self.home(r))
                        for r, (lo, hi) in enumerate(self.row_slices(t.shape[0]))])
        return out[0] if len(out) == 1 else tuple(out)

    def place_replicated(self, model) -> list:
        """The model on every data row's home device (cached per model): the
        model itself where it already lives, else one copy a device; None
        for the rows of another process."""
        hit = self._replicated.get(id(model))
        if hit is not None and hit[0] is model:
            return hit[1]
        by_device = {module_device(model): model}
        placed = []
        own = set(self.own_rows())
        for r in range(self.dp):
            if r not in own:
                placed.append(None)
                continue
            home = self.home(r)
            if home not in by_device:
                by_device[home] = place_on(model, home)
            placed.append(by_device[home])
        self._replicated[id(model)] = (model, placed)
        return placed

    def place_tp(self, model, rules: Callable) -> list:
        """The model with its weights split by ``rules`` over each data
        row's 'model' devices (cached per model); rows over the same devices
        share one copy."""
        self.one_process("a tensor-parallel placement")
        hit = self._tp_sharded.get(id(model))
        if hit is not None and hit[0] is model:
            return hit[1]
        by_row = {}
        placed = []
        for r in range(self.dp):
            devs = tuple(self.mesh.row(r))
            if devs not in by_row:
                by_row[devs] = shard_devices(model, rules, devs)
            placed.append(by_row[devs])
        self._tp_sharded[id(model)] = (model, placed)
        return placed

    def replicas(self, model, rules: Optional[Callable] = None) -> list:
        """A model for each data row: split by ``rules`` when tp > 1 and the
        family has rules, else replicated."""
        if rules is not None and self.tp > 1:
            return self.place_tp(model, rules)
        return self.place_replicated(model)

    def map_rows(self, replicas: list, n: int, fn: Callable) -> list:
        """``fn(replica, lo, hi)`` for each data row's rows [lo, hi) of a
        batch of n (a dp multiple), each under ``row_offset(lo)`` so its rows
        draw as in the whole batch; the results in row order."""
        from mlx_audio_tpu_torch.models.sampling import row_offset

        self.one_process("map_rows")
        out = []
        for r, (lo, hi) in enumerate(self.row_slices(n)):
            with row_offset(lo):
                out.append(fn(replicas[r], lo, hi))
        return out


def activate_mesh(spec: Optional[str] = None, *, dp: Optional[int] = None,
                  tp: Optional[int] = None,
                  devices: Optional[Sequence] = None) -> MeshContext:
    """Build and install the process-wide ('data', 'model') mesh.

    dp=0 (or a tp-only spec) claims all remaining devices for the data
    axis.  dp*tp must not exceed the devices (every visible CUDA device
    unless ``devices`` names them; a device may repeat).  Once
    ``parallel.distributed.initialize`` has formed a group and ``devices``
    is not given, the devices are every process's, and dp*tp must cover
    them all."""
    global _ACTIVE
    if spec is not None:
        s_dp, s_tp = parse_mesh_spec(spec)
        dp = s_dp if dp is None else dp
        tp = s_tp if tp is None else tp
    dp = dp if dp is not None else 0
    tp = tp if tp is not None else 1
    grouped = devices is None and distributed.is_initialized()
    devs = ([d for _, d in distributed.global_devices()] if grouped
            else list(devices if devices is not None else cuda_devices()))
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    if dp < 0:
        raise ValueError(f"dp must be >= 0 (0 = all remaining), got {dp}")
    if dp == 0:
        if len(devs) % tp:
            raise ValueError(f"{len(devs)} devices not divisible by tp={tp}")
        dp = len(devs) // tp
    need = dp * tp
    if need > len(devs):
        raise ValueError(
            f"mesh dp={dp} x tp={tp} needs {need} devices, have {len(devs)}")
    if grouped and need != len(devs):
        raise ValueError(f"a mesh over {distributed.process_count()} processes spans all "
                         f"{len(devs)} of their devices, not dp={dp} x tp={tp}")
    mesh = get_mesh(model_parallel=tp, devices=None if grouped else devs[:need])
    _ACTIVE = MeshContext(mesh=mesh, dp=dp, tp=tp)
    return _ACTIVE


def activate_cli_mesh(spec: str, device="cuda") -> MeshContext:
    """A CLI's or the server's ``--mesh`` on its ``--device``: with ``cpu``
    the CPU repeated dp*tp times (dp=0 resolves to 1 there), else every
    visible card (dp=0 claims them all)."""
    devices = None
    if torch.device(device).type == "cpu":
        dp, tp = parse_mesh_spec(spec)
        devices = [torch.device("cpu")] * (max(dp, 1) * tp)
    return activate_mesh(spec, devices=devices)


def active_mesh() -> Optional[MeshContext]:
    return _ACTIVE


def deactivate_mesh() -> None:
    global _ACTIVE
    _ACTIVE = None


def data_parallel(batch: int = 2) -> Optional[MeshContext]:
    """The active mesh when its data axis can shard a batch of ``batch``
    rows (dp > 1 and more than one row), else None."""
    ctx = _ACTIVE
    return ctx if (ctx is not None and ctx.dp > 1 and batch > 1) else None


def placement(model, batch: int, rules: Optional[Callable] = None):
    """(models, row slices, padded batch) of a ``batch``-row decode under the
    active mesh: a model for each data row that decodes a slice of the
    batch (split by ``rules`` when tp > 1), and each one's rows [lo, hi) of
    the batch padded to a dp multiple.  Without a mesh, or without dp for
    this batch, one model decodes the whole batch."""
    ctx = _ACTIVE
    if ctx is None:
        return [model], [(0, batch)], batch
    ctx.one_process("placement")
    models = ctx.replicas(model, rules)
    dp = data_parallel(batch)
    if dp is None:
        return models[:1], [(0, batch)], batch
    n = dp.pad_rows(batch)
    _note_pad_waste(batch, n, dp.dp)
    return models, dp.row_slices(n), n


def pad_batch_arrays(ctx: MeshContext, *arrays: np.ndarray):
    """Pad the leading axis of host arrays to a dp multiple by repeating the
    last row (shapes and dtypes kept; the caller drops the padded rows).
    Repeating a row, not zeros, keeps the padded work on the same buckets
    and away from degenerate lengths.  Returns (*padded, n)."""
    n = arrays[0].shape[0]
    m = ctx.pad_rows(n)
    if m == n:
        return (*arrays, n)
    _note_pad_waste(n, m, ctx.dp)
    out = []
    for a in arrays:
        pad = np.repeat(a[-1:], m - n, axis=0)
        out.append(np.concatenate([a, pad], axis=0))
    return (*out, n)


def pad_list(ctx: MeshContext, items: list) -> list:
    """A list of rows padded to a dp multiple by repeating its last item."""
    m = ctx.pad_rows(len(items))
    _note_pad_waste(len(items), m, ctx.dp)
    return list(items) + [items[-1]] * (m - len(items))
