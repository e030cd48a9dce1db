"""Weight-only quantization in the port against the JAX package.

Codes, scales and biases are held equal (both quantize with the same
float32 operations); forward outputs to atol 1e-5; the plain
``quantized_matmul`` to atol/rtol 1e-4 of the JAX package's Pallas kernel in
interpret mode, the tolerance of tests/test_pallas_ops.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mlx_audio_tpu.nn as jnn
from mlx_audio_tpu.nn import quantize as jq
from mlx_audio_tpu.nn.module import named_arrays
from mlx_audio_tpu.nn.pallas_ops import quantized_matmul as jax_quantized_matmul
from mlx_audio_tpu_torch.convert import params_from_jax
from mlx_audio_tpu_torch.nn import kernels
from mlx_audio_tpu_torch.nn import quantize as tq
from mlx_audio_tpu_torch.nn.layers import Embedding, Linear

ATOL = 1e-5
KERNEL_TOL = {"atol": 1e-4, "rtol": 1e-4}


def _linear(i, o, seed=0, bias=True):
    j = jnn.Linear(i, o, bias=bias)
    rng = np.random.default_rng(seed)
    j.weight = jnp.asarray(rng.standard_normal((o, i)) * 0.2, jnp.float32)
    t = Linear(i, o, bias=bias)
    t.load_state_dict(params_from_jax({k: np.asarray(v) for k, v in named_arrays(j)}, t))
    return j, t


def _same_arrays(jax_mod, port_mod):
    ref = {k: np.asarray(v) for k, v in named_arrays(jax_mod)}
    got = {k: v.numpy() for k, v in port_mod.state_dict().items()}
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.mark.parametrize("bits,gs", [(8, 32), (4, 32), (8, 16), (4, 64)])
def test_quantized_linear_matches_jax(bits, gs):
    j, t = _linear(128, 48, seed=bits + gs)
    qj = jq.QuantizedLinear.from_linear(j, group_size=gs, bits=bits)
    qt = tq.QuantizedLinear.from_linear(t, group_size=gs, bits=bits)
    assert qt.packed == qj.packed == (bits <= 4)
    _same_arrays(qj, qt)
    x = np.random.default_rng(1).standard_normal((3, 5, 128)).astype(np.float32)
    np.testing.assert_allclose(qt(torch.as_tensor(x)).numpy(),
                               np.asarray(qj(jnp.asarray(x))), atol=ATOL, rtol=0)
    np.testing.assert_allclose(qt.to_linear().weight.numpy(),
                               np.asarray(qj.to_linear().weight), atol=1e-6, rtol=0)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_embedding_matches_jax(bits):
    j = jnn.Embedding(10, 64)
    t = Embedding(10, 64)
    t.load_state_dict(params_from_jax({k: np.asarray(v) for k, v in named_arrays(j)}, t))
    qj = jq.QuantizedEmbedding.from_embedding(j, group_size=32, bits=bits)
    qt = tq.QuantizedEmbedding.from_embedding(t, group_size=32, bits=bits)
    _same_arrays(qj, qt)
    idx = np.array([[0, 4, 9], [3, 3, 1]])
    np.testing.assert_allclose(qt(torch.as_tensor(idx)).numpy(),
                               np.asarray(qj(jnp.asarray(idx))), atol=ATOL, rtol=0)
    x = np.random.default_rng(2).standard_normal((2, 64)).astype(np.float32)
    np.testing.assert_allclose(qt.as_linear(torch.as_tensor(x)).numpy(),
                               np.asarray(qj.as_linear(jnp.asarray(x))),
                               atol=ATOL, rtol=0)


def test_pack4_layout_matches_jax():
    q = np.random.default_rng(3).integers(0, 16, size=(8, 64), dtype=np.uint8)
    packed = tq._pack4(torch.as_tensor(q))
    np.testing.assert_array_equal(packed.numpy(), jq._pack4(q))
    np.testing.assert_array_equal(tq._unpack4(packed).numpy(), q)


class _JaxNet(jnn.Module):
    def __init__(self):
        self.embed = jnn.Embedding(16, 64)
        self.layers = [jnn.Linear(64, 64) for _ in range(3)]
        self.head = jnn.Linear(64, 16)
        self.odd = jnn.Linear(7, 5)


class _PortNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.embed = Embedding(16, 64)
        self.layers = torch.nn.ModuleList(Linear(64, 64) for _ in range(3))
        self.head = Linear(64, 16)
        self.odd = Linear(7, 5)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_model_matches_jax(bits):
    j, t = _JaxNet(), _PortNet()
    t.load_state_dict(params_from_jax({k: np.asarray(v) for k, v in named_arrays(j)}, t))
    jq.quantize_model(j, group_size=32, bits=bits)
    tq.quantize_model(t, group_size=32, bits=bits)
    assert isinstance(t.embed, tq.QuantizedEmbedding)
    assert all(isinstance(l, tq.QuantizedLinear) for l in t.layers)
    assert isinstance(t.odd, Linear)  # 7 % 32: left as it is
    _same_arrays(j, t)
    tq.dequantize_model(t)
    assert isinstance(t.embed, Embedding) and isinstance(t.head, Linear)


def test_walk_replace_covers_plain_containers():
    class Holder(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.plain_list = [Linear(32, 8)]
            self.plain_tuple = (Linear(32, 8),)
            self.plain_dict = {"a": Linear(32, 8)}

    h = Holder()
    tq.quantize_model(h, group_size=32, bits=8)
    assert isinstance(h.plain_list[0], tq.QuantizedLinear)
    assert isinstance(h.plain_tuple[0], tq.QuantizedLinear)
    assert isinstance(h.plain_dict["a"], tq.QuantizedLinear)


@pytest.mark.parametrize("bits", [8, 4])
def test_plain_quantized_matmul_matches_pallas(bits):
    j, t = _linear(256, 384, seed=5, bias=False)
    qj = jq.QuantizedLinear.from_linear(j, group_size=64, bits=bits)
    qt = tq.QuantizedLinear.from_linear(t, group_size=64, bits=bits)
    x = np.random.default_rng(6).standard_normal((4, 256)).astype(np.float32) * 0.5
    ref = jax_quantized_matmul(jnp.asarray(x), qj.weight, qj.scales, qj.biases,
                               64, packed=qj.packed, interpret=True)
    got = kernels.quantized_matmul(torch.as_tensor(x), qt.weight, qt.scales,
                                   qt.biases, 64, qt.packed)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **KERNEL_TOL)


def test_quantized_linear_routes_decode_sizes_to_the_kernel(monkeypatch):
    """At most KERNEL_MAX_ROWS rows go to quantized_matmul (whatever the
    group size: the JAX package's 128-alignment gate is gone); more rows
    dequantize, and both paths give the dense layer's result."""
    _, t = _linear(48, 20, seed=7)
    qt = tq.QuantizedLinear.from_linear(t, group_size=16, bits=8)
    calls = []
    real = kernels.quantized_matmul
    monkeypatch.setattr(kernels, "quantized_matmul",
                        lambda *a: calls.append(a[0].shape[0]) or real(*a))
    half = tq.KERNEL_MAX_ROWS // 2
    dense = qt.to_linear()
    for x in (torch.randn(2, half, 48), torch.randn(2, half + 1, 48)):
        np.testing.assert_allclose(qt(x).numpy(),
                                   (x @ dense.weight.t() + qt.bias).numpy(),
                                   atol=ATOL)
    assert calls == [2 * half]


@pytest.mark.parametrize("name", ["quantized_matmul", "depth_draft"])
def test_no_plain_fallback_off_the_cpu(name):
    if name == "quantized_matmul":
        args = (torch.empty(2, 64, device="meta"),
                torch.empty(8, 64, dtype=torch.uint8, device="meta"),
                torch.empty(8, 1, device="meta"), torch.empty(8, 1, device="meta"),
                64, False)
    else:
        from mlx_audio_tpu_torch.nn.pallas_depth import PackedDepth

        meta = torch.empty(1, device="meta")
        args = (PackedDepth(*[meta] * 15), meta, meta, meta, meta, 10)
    with pytest.raises(ValueError, match="no kernel for device"):
        getattr(kernels, name)(*args)


def _qmm_shapes():
    from chip_smoke import QMM_SHAPES

    cases = [(i, o, gs, packed) for (i, o), _ in QMM_SHAPES
             for gs in (64, 128) for packed in (False, True)]
    return cases + [(96, 40, 6, False), (96, 40, 6, True)]


@pytest.mark.parametrize("i,o,gs,packed", _qmm_shapes())
def test_quantized_matmul_parts_cover_i_in_groups(i, o, gs, packed):
    """The kernel's split over I: parts x P stored columns cover the stored
    width with a last part that is not empty, P is a multiple of the group
    size, and the choice takes no row count."""
    import inspect

    assert list(inspect.signature(kernels.quantized_matmul_parts).parameters) \
        == ["i", "o", "group_size", "packed"]
    parts, cols = kernels.quantized_matmul_parts(i, o, gs, packed)
    stored = i // 2 if packed else i
    assert (parts - 1) * cols < stored <= parts * cols
    assert cols % gs == 0
    assert cols == min(stored, kernels.QMM_PART_COLS // gs * gs)


def _split_sum(x, w, stored, cols):
    """x [B, I] @ w [O, I]^T as the kernel sums it: one float32 product per
    part of the stored columns (with their high-nibble columns I/2 on when
    packed), the parts added in ascending order."""
    i = x.shape[1]
    y = None
    for p0 in range(0, stored, cols):
        idx = np.arange(p0, min(p0 + cols, stored))
        if stored != i:
            idx = np.concatenate([idx, idx + stored])
        part = x[:, idx] @ w[:, idx].T
        y = part if y is None else (y + part).astype(np.float32)
    return y


@pytest.mark.parametrize("rows", [1, 32])
@pytest.mark.parametrize("bits", [8, 4])
def test_split_sum_matches_plain_and_pallas(rows, bits):
    """The kernel's split over I at CSM's largest I, emulated on the CPU,
    against the plain version and the JAX package's Pallas kernel
    (interpret mode), at the tolerance of
    test_plain_quantized_matmul_matches_pallas."""
    i, o, gs = 8192, 256, 128
    j, t = _linear(i, o, seed=9, bias=False)
    qj = jq.QuantizedLinear.from_linear(j, group_size=gs, bits=bits)
    qt = tq.QuantizedLinear.from_linear(t, group_size=gs, bits=bits)
    parts, cols = kernels.quantized_matmul_parts(i, o, gs, qt.packed)
    assert parts == (2 if qt.packed else 4)
    x = np.random.default_rng(10).standard_normal((rows, i)).astype(np.float32) * 0.5
    w = qt.to_linear().weight.detach().numpy()
    got = _split_sum(x, w, qt.weight.shape[1], cols)
    plain = kernels.quantized_matmul_plain(torch.as_tensor(x), qt.weight,
                                           qt.scales, qt.biases, gs, qt.packed)
    ref = jax_quantized_matmul(jnp.asarray(x), qj.weight, qj.scales, qj.biases,
                               gs, packed=qj.packed, interpret=True)
    np.testing.assert_allclose(got, plain.numpy(), **KERNEL_TOL)
    np.testing.assert_allclose(got, np.asarray(ref), **KERNEL_TOL)
