"""The depth-draft probes in the port (``nn/kernels.py`` probe wrappers and
``mlx_audio_tpu_torch/scripts/probe_depth.py``) on the CPU, at a small
shape: L 2, dm 256, kcols 1, chunk 256, 3 steps.

The JAX probes (``scripts/probe_depth.py``) cannot run here: they place
their buffers in TPU memory spaces and wait on DMA semaphores, and the
script has no interpret switch.  So the port's plain versions are held to
numpy formulas on the script's own draws (``np.random.default_rng(0)``),
and the chunked layout to the script's jnp expression on the same array.
The kernels themselves are held to these plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_audio_tpu_torch.nn import kernels
from mlx_audio_tpu_torch.scripts import probe_depth

L, DM, KCOLS, CHUNK, STEPS = 2, 256, 1, 256, 3
SMALL = dict(iters=1, steps=STEPS, chunk=CHUNK, kcols=KCOLS, device="cpu",
             n_layers=L, dm=DM)


def _draws():
    """The script's draws: w [L, dm, cols], x [1, dm], then x3."""
    rng = np.random.default_rng(0)
    w = rng.integers(-127, 127, size=(L, DM, KCOLS * 1024))
    x = rng.integers(-127, 127, size=(1, DM), dtype=np.int8)
    x3 = rng.integers(-127, 127, size=(DM // 8, 8, 128), dtype=np.int8)
    return w, x, x3


def _np_chunked(w):
    n = w.shape[2] // CHUNK
    return w.reshape(L, DM, n, CHUNK).transpose(0, 2, 1, 3).reshape(L * n, DM, CHUNK)


def _np_stream(w):
    c = _np_chunked(w).astype(np.int64)
    return STEPS * int(sum((i + 1) * c[i].sum() for i in range(c.shape[0])))


def _np_dot(chunk0, xvec, reps):
    return reps * int((xvec.astype(np.int64) @ chunk0.astype(np.int64)).sum())


@pytest.mark.parametrize("dtype", ["int8", "bf16"])
def test_chunked_layout_equals_the_scripts_jnp_expression(dtype):
    w, _, _ = _draws()
    n_chunks = w.shape[2] // CHUNK
    w_np = w.astype(np.int8 if dtype == "int8" else np.float16)
    # scripts/probe_depth.py:52-57
    w_strided = jnp.asarray(w_np)
    if dtype == "bf16":
        w_strided = w_strided.astype(jnp.bfloat16)
    ref = jnp.reshape(jnp.transpose(jnp.reshape(w_strided, (L, DM, n_chunks, CHUNK)),
                                    (0, 2, 1, 3)), (L * n_chunks, DM, CHUNK))
    t = torch.as_tensor(w_np)
    if dtype == "bf16":
        t = t.to(torch.bfloat16)
    got = kernels.chunked_layout(t, CHUNK)
    assert got.is_contiguous() and tuple(got.shape) == ref.shape
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref, np.float32))


@pytest.mark.parametrize("dtype", ["int8", "bf16"])
def test_stream_plain_versions_equal_the_numpy_formula(dtype):
    w, x, _ = _draws()
    t = torch.as_tensor(w.astype(np.int8))
    if dtype == "bf16":
        t = t.to(torch.bfloat16)
    chunked = kernels.chunked_layout(t, CHUNK)
    want = _np_stream(w)
    got = [kernels.probe_depth(t, None, "dma", STEPS, CHUNK),
           kernels.probe_auto(chunked, STEPS)]
    got += [kernels.probe_depth(chunked, None, m, STEPS) for m in ("dmac", "dma8", "dmabig")]
    assert all(g.dtype == torch.int64 and g.shape == () for g in got)
    assert [int(g) for g in got] == [want] * 5


def test_a_misplaced_chunk_changes_the_stream_result():
    w, _, _ = _draws()
    chunked = kernels.chunked_layout(torch.as_tensor(w.astype(np.int8)), CHUNK)
    swapped = chunked[[1, 0, *range(2, chunked.shape[0])]]
    assert int(kernels.probe_stream_plain(swapped, STEPS)) != \
        int(kernels.probe_stream_plain(chunked, STEPS))


def test_dot_plain_versions_equal_the_numpy_formula():
    w, x, x3 = _draws()
    chunked = kernels.chunked_layout(torch.as_tensor(w.astype(np.int8)), CHUNK)
    chunk0 = _np_chunked(w)[0]
    reps = chunked.shape[0]  # L * n_chunks matvecs a step
    mxu = kernels.probe_depth(chunked, torch.as_tensor(x), "mxu", STEPS)
    assert int(mxu) == _np_dot(chunk0, x[0], reps * STEPS)
    w3 = chunked[0].reshape(DM // 8, 8, CHUNK)
    vpu = kernels.probe_vpu(w3, torch.as_tensor(x3), STEPS, reps)
    assert int(vpu) == _np_dot(chunk0, x3[:, :, 0].reshape(-1), reps * STEPS)


@pytest.mark.parametrize("dtype", ["int8", "bf16"])
def test_entry_point_runs_on_the_cpu(dtype, capsys):
    modes = "dma,dmac,dma8,dmabig,vpu,auto" + (",mxu" if dtype == "int8" else "")
    records = probe_depth.run(modes.split(","), dtype=dtype, **SMALL)
    out = capsys.readouterr().out
    assert [r["mode"] for r in records] == modes.split(",")
    w, x, x3 = _draws()
    chunk0 = _np_chunked(w)[0]
    reps = L * KCOLS * 1024 // CHUNK
    want = {"mxu": _np_dot(chunk0, x[0], reps * STEPS),
            "vpu": _np_dot(chunk0, x3[:, :, 0].reshape(-1), reps * STEPS)}
    for r in records:
        assert r["checksum"] == want.get(r["mode"], _np_stream(w)), r["mode"]
        assert r["device"].startswith("cpu")
    assert out.count("on cpu (plain PyTorch versions)") == len(records)
    assert "not measured" in out


def test_command_line_runs_on_the_cpu(capsys):
    """The flags of scripts/probe_depth.py, plus --device; L and dm are the
    draft's (4, 1024)."""
    records = probe_depth.main(["--device", "cpu", "--kcols", "1", "--chunk", "256",
                                "--steps", "2", "--iters", "1", "--modes", "dmac,auto"])
    assert [r["checksum"] for r in records][0] == records[1]["checksum"]
    assert capsys.readouterr().out.count("int8  on cpu") == 2


def test_entry_point_refuses_what_the_probes_do_not_take():
    with pytest.raises(SystemExit, match="use int8"):
        probe_depth.run(["mxu"], dtype="bf16", **SMALL)
    with pytest.raises(SystemExit, match="unknown mode"):
        probe_depth.run(["dmx"], **SMALL)
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            probe_depth.main(["--modes", "dma"])
    with pytest.raises(ValueError, match="mode"):
        kernels.probe_depth(torch.zeros(1, 8, 8, dtype=torch.int8), None, "tma", 1)
