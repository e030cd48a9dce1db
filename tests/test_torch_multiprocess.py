"""A mesh over two processes in the port (``parallel/distributed.py``): the
twin of tests/test_multihost.py on the CPU.

Two subprocesses join a gloo group through a ``torch.distributed.FileStore``
under the test's ``tmp_path`` (no probed port, so no port to lose between
the probe and the bind), each with 4 CPU entries in its local device list,
and lay one 4 x 2 ('data', 'model') mesh over the 8.  Each process sums its
host-local [2, 8] array of pid + 1 into a global sum of 48, as the JAX
test's psum does; then runs its 2 of 4 rows of a data-parallel Kokoro
``duration_stage`` (tests/test_kokoro.py's tiny config) and draws its rows'
samples under ``row_offset``, and all-gathers the rows.  ``pred_dur`` and
the samples must equal the one-process batch's bit for bit, ``d`` within
1e-5.  Then the entry point: ``activate_mesh`` lays its mesh over the group
and Kokoro's ``synthesize_batch`` runs its 4 rows 2 a process; every
process returns every row, bit for bit the rows of a one-process mesh of
the same shape, and, against the unsharded batch, durations equal and
audio past ``HEAD`` within ``FLIP_TAIL_ATOL`` (tests/test_torch_mesh_product.py's
bounds between batch shapes).  A group that meets through an
``init_method`` (a ``file://`` URL) sums to 48 too.  Every worker has a
timeout of its own, so a hung group fails the test and not the suite's
clock.
"""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mlx_audio_tpu_torch.models.sampling import sample_top_k_rows
from mlx_audio_tpu_torch.models.tts.kokoro.model import (
    Model,
    duration_stage,
    load_config,
    pick_phoneme_bucket,
)
from test_kokoro import tiny_config

ROOT = Path(__file__).resolve().parent.parent
WORKER_TIMEOUT_S = 120
ROWS = 4
SAMPLE_SEED = 7
D_ATOL = 1e-5
PHONEMES = ["hello world", "abc", "a longer third phoneme string", "def ghi"]
SPEED = 4.0  # random-weight durations stay short
HEAD = 2400
FLIP_TAIL_ATOL = 2e-3

_WORKER = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
sys.path.insert(0, sys.argv[1])
tmp, pid, rendezvous = sys.argv[2], int(sys.argv[3]), sys.argv[4]
from mlx_audio_tpu_torch.models.sampling import row_offset, sample_top_k_rows
from mlx_audio_tpu_torch.models.tts.kokoro.model import Model, duration_stage, load_config
from mlx_audio_tpu_torch.parallel import distributed
from mlx_audio_tpu_torch.parallel.context import activate_mesh, deactivate_mesh
from mlx_audio_tpu_torch.parallel.mesh import get_mesh

cpu4 = [torch.device("cpu")] * 4
if rendezvous == "store":
    distributed.initialize(2, pid, store=torch.distributed.FileStore(f"{tmp}/store", 2),
                           local_devices=cpu4)
else:
    distributed.initialize(2, pid, init_method=f"file://{tmp}/init", local_devices=cpu4)
assert distributed.process_count() == 2 and distributed.process_index() == pid
mesh = get_mesh(model_parallel=2)
assert mesh.devices.shape == (4, 2), mesh.devices.shape
assert mesh.processes.tolist() == [[0, 0], [0, 0], [1, 1], [1, 1]], mesh.processes

# global sum across the 8 devices of the two processes
total = distributed.global_sum(torch.ones((2, 8)) * (pid + 1))
assert float(total) == 2 * 8 * 1 + 2 * 8 * 2, float(total)
if rendezvous != "store":
    distributed.shutdown()
    print(f"proc {pid} OK: 2 processes, 8 global devices, global sum {float(total)}")
    sys.exit(0)

# this process's rows of the data-parallel duration stage, all-gathered
inputs = np.load(f"{tmp}/inputs.npz")
lo, hi = distributed.process_rows(mesh, inputs["ids"].shape[0])
model = Model(load_config(f"{tmp}/config.json"), device="cpu", seed=0)
d, pred_dur = duration_stage(
    model, torch.as_tensor(inputs["ids"][lo:hi]), torch.as_tensor(inputs["lengths"][lo:hi]),
    torch.as_tensor(inputs["refs"][lo:hi, 128:]), torch.ones(hi - lo))
with row_offset(lo):
    toks = sample_top_k_rows(torch.as_tensor(inputs["logits"][lo:hi]), 1.0, 0,
                             seed=int(inputs["seed"]))
np.savez(f"{tmp}/out{pid}.npz", d=distributed.all_gather_rows(d).numpy(),
         pred_dur=distributed.all_gather_rows(pred_dur).numpy(),
         toks=distributed.all_gather_rows(toks).numpy(), rows=np.array([lo, hi]))

# the entry point over the group, then over a one-process mesh of its shape
phonemes = json.loads(sys.argv[5])
ctx = activate_mesh(tp=2)
assert (ctx.dp, ctx.tp, ctx.processes, ctx.own_rows()) == (4, 2, 2, [2 * pid, 2 * pid + 1])
ran, duration_pass = [], Model._duration_pass
Model._duration_pass = lambda self, toks, *a: ran.append(len(toks)) or duration_pass(self, toks, *a)
group = model.synthesize_batch(phonemes, inputs["refs"], speeds=float(sys.argv[6]))
Model._duration_pass = duration_pass
assert ran == [1, 1] and len(group) == len(phonemes), (ran, len(group))  # its 2 data rows only
distributed.shutdown()
activate_mesh(tp=2, devices=cpu4 * 2)
alone = model.synthesize_batch(phonemes, inputs["refs"], speeds=float(sys.argv[6]))
deactivate_mesh()
for (a0, d0), (a1, d1) in zip(group, alone):
    assert np.array_equal(a0, a1) and np.array_equal(d0, d1)
np.savez(f"{tmp}/entry{pid}.npz", **{f"audio{i}": a for i, (a, _) in enumerate(group)},
         **{f"dur{i}": d for i, (_, d) in enumerate(group)})
print(f"proc {pid} OK: 2 processes, 8 global devices, global sum {float(total)}")
"""


def _run_workers(tmp: Path, pids, timeout: float, rendezvous: str = "store") -> list:
    """Start a worker for each pid, meeting through a FileStore
    (``rendezvous="store"``) or a ``file://`` init_method, wait for each
    within ``timeout`` s (killing it on expiry) and return (returncode,
    output, timed out)."""
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(ROOT), str(tmp), str(pid),
                               rendezvous, json.dumps(PHONEMES), str(SPEED)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for pid in pids]
    results = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
            results.append((p.returncode, out, False))
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            results.append((p.returncode, out, True))
    return results


def _inputs(tmp: Path, config) -> dict:
    rng = np.random.default_rng(0)
    lengths = np.array([17, 9, 30, 2])
    ids = np.zeros((ROWS, pick_phoneme_bucket(int(lengths.max()))), dtype=np.int64)
    for i, n in enumerate(lengths):
        ids[i, :n] = rng.integers(1, config.n_token, n)
    inputs = {"ids": ids, "lengths": lengths,
              "refs": (rng.standard_normal((ROWS, 256)) * 0.1).astype(np.float32),
              "logits": (rng.standard_normal((ROWS, 50)) * 2).astype(np.float32),
              "seed": np.array(SAMPLE_SEED)}
    np.savez(tmp / "inputs.npz", **inputs)
    (tmp / "config.json").write_text(json.dumps(dataclasses.asdict(config)))
    return inputs


def test_two_process_mesh_global_sum_and_kokoro_rows(tmp_path):
    config = tiny_config()
    inputs = _inputs(tmp_path, config)
    results = _run_workers(tmp_path, (0, 1), WORKER_TIMEOUT_S)
    for pid, (rc, out, timed_out) in enumerate(results):
        assert not timed_out and rc == 0, f"proc {pid} failed:\n{out[-3000:]}"
        assert f"proc {pid} OK: 2 processes, 8 global devices, global sum 48.0" in out

    # the one-process batch
    model = Model(load_config(tmp_path / "config.json"), device="cpu", seed=0)
    d, pred_dur = duration_stage(model, torch.as_tensor(inputs["ids"]),
                                 torch.as_tensor(inputs["lengths"]),
                                 torch.as_tensor(inputs["refs"][:, 128:]), torch.ones(ROWS))
    toks = sample_top_k_rows(torch.as_tensor(inputs["logits"]), 1.0, 0, seed=SAMPLE_SEED)
    for pid in (0, 1):
        got = np.load(tmp_path / f"out{pid}.npz")
        assert got["rows"].tolist() == [2 * pid, 2 * pid + 2]
        np.testing.assert_array_equal(got["pred_dur"], pred_dur.numpy())
        np.testing.assert_array_equal(got["toks"], toks.numpy())
        np.testing.assert_allclose(got["d"], d.numpy(), atol=D_ATOL, rtol=0)

    # the entry point: every process holds every row of the batch
    base = model.synthesize_batch(PHONEMES, inputs["refs"], speeds=SPEED)
    for pid in (0, 1):
        got = np.load(tmp_path / f"entry{pid}.npz")
        for i, (a0, d0) in enumerate(base):
            np.testing.assert_array_equal(got[f"dur{i}"], d0)
            assert got[f"audio{i}"].shape == a0.shape
            np.testing.assert_allclose(got[f"audio{i}"][HEAD:], a0[HEAD:],
                                       atol=FLIP_TAIL_ATOL, rtol=0)


def test_two_process_group_meets_through_an_init_method(tmp_path):
    """``initialize(init_method=...)``: a ``file://`` URL under tmp_path in
    place of the store; both processes print a global sum of 48."""
    for pid, (rc, out, timed_out) in enumerate(_run_workers(tmp_path, (0, 1), WORKER_TIMEOUT_S,
                                                            rendezvous="init")):
        assert not timed_out and rc == 0, f"proc {pid} failed:\n{out[-3000:]}"
        assert f"proc {pid} OK: 2 processes, 8 global devices, global sum 48.0" in out


def test_a_worker_without_its_peer_is_stopped_by_its_own_timeout(tmp_path):
    """Process 0 alone waits at the rendezvous for process 1, which never
    comes: the harness kills it at its timeout and the run counts as
    failed, not hung."""
    _inputs(tmp_path, tiny_config())
    ((rc, out, timed_out),) = _run_workers(tmp_path, (0,), timeout=5)
    assert timed_out and rc != 0 and "OK" not in out


def test_process_rows_follow_the_mesh_rows_of_each_process():
    """Without a group the mesh is one process's: it owns every row, and
    ``process_rows`` gives it the whole batch."""
    from mlx_audio_tpu_torch.parallel import distributed
    from mlx_audio_tpu_torch.parallel.mesh import get_mesh

    mesh = get_mesh(model_parallel=2, devices=[torch.device("cpu")] * 8)
    assert distributed.process_count() == 1 and distributed.process_index() == 0
    assert mesh.local_rows(0) == [0, 1, 2, 3] and mesh.local_rows(1) == []
    assert distributed.process_rows(mesh, 8) == (0, 8)
    with pytest.raises(ValueError):
        distributed.process_rows(mesh, 6)


def test_paths_without_a_process_branch_raise_over_a_process_mesh():
    """A mesh whose rows two processes drive (built here as the group would
    lay it): this process owns its rows only, and the paths that run every
    row in one process raise rather than run rows that are not theirs."""
    from mlx_audio_tpu_torch.parallel.context import MeshContext
    from mlx_audio_tpu_torch.parallel.mesh import Mesh

    cpu = torch.device("cpu")
    grid = np.array([[cpu], [cpu]], dtype=object)
    ctx = MeshContext(mesh=Mesh(grid, processes=np.array([[0], [1]])), dp=2, tp=1)
    assert ctx.processes == 2 and ctx.own_rows() == [0]
    model = torch.nn.Linear(2, 2)
    assert ctx.place_replicated(model) == [model, None]
    for call in (lambda: ctx.map_rows([model, None], 2, lambda m, lo, hi: m),
                 lambda: ctx.place_tp(model, lambda *a: None),
                 lambda: ctx.shard_batch(torch.zeros(2, 2))):
        with pytest.raises(NotImplementedError):
            call()


def test_initialize_takes_gloo_only():
    """The process mesh's collectives run over gloo on host copies; another
    backend is refused before any rendezvous."""
    from mlx_audio_tpu_torch.parallel import distributed

    with pytest.raises(ValueError, match="gloo"):
        distributed.initialize(2, 0, store=object(), backend="nccl")
    assert not distributed.is_initialized()
