"""A mesh over several processes: the port's counterpart of what
``jax.distributed.initialize`` gives the JAX package's mesh
(``mlx_audio_tpu/parallel/mesh.py``).

In the JAX package every process calls ``jax.distributed.initialize``, after
which ``jax.devices()`` lists every process's devices and ``get_mesh`` lays
its ('data', 'model') grid over all of them.  Here every process calls
:func:`initialize` with the world size, its rank and a rendezvous (a
``torch.distributed`` store, such as a ``FileStore`` on a shared path, or an
``init_method`` such as ``tcp://host:port``: nothing is discovered from the
environment), and the devices of its own that it drives.  The processes
exchange their device lists once; ``parallel.mesh.get_mesh`` then lays the
grid over (process, local device) pairs in process order, with the 'model'
axis innermost, so a row of the grid lies within one process.

A process runs the data rows that are its own (:func:`process_rows` gives
its slice of a batch; under ``models.sampling.row_offset`` at that slice's
start its rows draw as in the whole batch), and the collectives below join
the results: :func:`global_sum` (a local sum, then one ``all_reduce``) and
:func:`all_gather_rows` (every process's rows in global order).  An entry
point runs so under ``parallel.context.activate_mesh``, which lays its mesh
over the group (Kokoro's ``synthesize_batch``).

The backend is gloo, over host copies of the buffers; it also serves several
processes that share one card, which NCCL does not allow.  NCCL, with its
buffers on the card, waits for a host with a card a process to test it on.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from mlx_audio_tpu_torch.parallel.mesh import Mesh, canonical_device, cuda_devices


# every process's (rank, device) pairs, once a group is up
_GROUP: Optional[List[Tuple[int, torch.device]]] = None


def initialize(num_processes: int, process_id: int, store=None,
               init_method: Optional[str] = None, backend: str = "gloo",
               local_devices: Optional[Sequence] = None) -> None:
    """Join a group of ``num_processes`` processes as rank ``process_id``,
    meeting through ``store`` or ``init_method`` (one of them is required),
    and exchange each process's ``local_devices`` (every visible card by
    default; a device may repeat, as in a single-process mesh).  Only the
    gloo backend is taken."""
    global _GROUP
    if _GROUP is not None:
        raise RuntimeError("parallel.distributed is already initialized")
    if (store is None) == (init_method is None):
        raise ValueError("pass exactly one of store= or init_method=")
    if backend != "gloo":
        raise ValueError(f"backend {backend!r}: the process mesh runs over gloo only")
    local = [canonical_device(d) for d in
             (local_devices if local_devices is not None else cuda_devices())]
    dist.init_process_group(backend, store=store, init_method=init_method,
                            world_size=num_processes, rank=process_id)
    lists = [None] * num_processes
    dist.all_gather_object(lists, [str(d) for d in local])
    _GROUP = [(p, torch.device(d)) for p, devs in enumerate(lists) for d in devs]


def is_initialized() -> bool:
    return _GROUP is not None


def process_count() -> int:
    """The processes in the group (1 when none was initialized)."""
    return dist.get_world_size() if _GROUP is not None else 1


def process_index() -> int:
    """This process's rank (0 when no group was initialized)."""
    return dist.get_rank() if _GROUP is not None else 0


def global_devices() -> List[Tuple[int, torch.device]]:
    """Every process's (rank, device) pairs, in rank order."""
    if _GROUP is None:
        raise RuntimeError("parallel.distributed is not initialized")
    return list(_GROUP)


def shutdown() -> None:
    """Leave the group."""
    global _GROUP
    if _GROUP is not None:
        dist.destroy_process_group()
        _GROUP = None


def process_rows(mesh: Mesh, n: int) -> Tuple[int, int]:
    """This process's rows [lo, hi) of a batch of ``n`` laid over the
    mesh's data axis (``n`` a multiple of its rows): the slices of the
    data rows that are its own, which are contiguous."""
    dp = mesh.devices.shape[0]
    if n % dp:
        raise ValueError(f"batch {n} not divisible by the {dp} data rows")
    own = mesh.local_rows(process_index())
    size = n // dp
    return own[0] * size, (own[-1] + 1) * size


def global_sum(local: torch.Tensor) -> torch.Tensor:
    """The sum of every process's ``local`` array: a local reduction, then
    one ``all_reduce`` over host copies (0-d, on ``local``'s device)."""
    total = local.sum().cpu()
    dist.all_reduce(total)
    return total.to(local.device)


def all_gather_rows(local: torch.Tensor) -> torch.Tensor:
    """Every process's rows of a batch (its leading axis; the counts may
    differ), concatenated in rank order, on ``local``'s device."""
    world = dist.get_world_size()
    buf = local.detach().cpu()
    count = torch.tensor([buf.shape[0]])
    counts = [torch.zeros_like(count) for _ in range(world)]
    dist.all_gather(counts, count)
    counts = [int(c) for c in counts]
    pad = max(counts) - buf.shape[0]
    if pad:
        buf = torch.cat([buf, buf.new_zeros((pad, *buf.shape[1:]))])
    parts = [torch.empty_like(buf) for _ in range(world)]
    dist.all_gather(parts, buf.contiguous())
    return torch.cat([p[:c] for p, c in zip(parts, counts)]).to(local.device)
