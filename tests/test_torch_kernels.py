"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper in ``mlx_audio_tpu_torch.nn.kernels`` runs its plain
PyTorch version; here that plain version is held against the Pallas kernel
in interpret mode (as tests/test_pallas_ops.py runs it) and against the JAX
package's plain path, on the same numpy inputs.  The CUDA kernels themselves
are held against these plain versions on the card (tests/test_torch_cuda.py
and chip_smoke.py).
"""

from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mlx_audio_tpu.nn.layers import _dilated_conv1d_residue as jax_residue
from mlx_audio_tpu.nn.pallas_ops import (
    _banded_weight,
    banded_conv1d_pallas,
    dilated_conv1d_pallas,
    lstm_pallas,
)
from mlx_audio_tpu.nn.recurrent import lstm_scan as jax_lstm_scan
from mlx_audio_tpu_torch.nn import kernels, lstm_scan
from mlx_audio_tpu_torch.nn.layers import _dilated_conv1d_residue

LSTM_ATOL = 1e-5
LSTM_KERNEL_TOL = {"atol": 1e-4, "rtol": 1e-4}  # as on the card
CONV_TOL = {"atol": 1e-4, "rtol": 1e-4}


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_plain_matches_pallas_and_scan(reverse):
    rng = np.random.default_rng(0)
    b, t, h = 3, 12, 128  # B not a multiple of 8 on purpose
    x_proj = (rng.standard_normal((b, t, 4 * h)) * 0.3).astype(np.float32)
    w_h = (rng.standard_normal((4 * h, h)) * 0.1).astype(np.float32)
    h0 = (rng.standard_normal((b, h)) * 0.1).astype(np.float32)
    c0 = (rng.standard_normal((b, h)) * 0.1).astype(np.float32)

    hs, cs, (h_t, c_t) = lstm_scan(*map(torch.as_tensor, (x_proj, w_h, h0, c0)),
                                   reverse=reverse, return_cells=True)

    hs_ref, cs_ref, (h_ref, c_ref) = jax_lstm_scan(
        *map(jnp.asarray, (x_proj, w_h, h0, c0)), reverse=reverse,
        return_cells=True)
    for got, ref in [(hs, hs_ref), (cs, cs_ref), (h_t, h_ref), (c_t, c_ref)]:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   atol=LSTM_ATOL)

    xp = jnp.asarray(x_proj[:, ::-1] if reverse else x_proj)
    hs_p, cs_p, (h_p, c_p) = lstm_pallas(xp, jnp.asarray(w_h.T), jnp.asarray(h0),
                                         jnp.asarray(c0), interpret=True)
    if reverse:
        hs_p, cs_p = hs_p[:, ::-1], cs_p[:, ::-1]
    for got, ref in [(hs, hs_p), (cs, cs_p), (h_t, h_p), (c_t, c_p)]:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   atol=LSTM_ATOL)


def _lstm_cluster_emulated(x_proj, wh, h0, c0):
    """csrc/lstm.cu's cluster route in float32: CTA r of a row's cluster owns
    units [r U, (r+1) U) and their i, f, g, o columns; a column's dot is
    four quarter partials over k, each the sum of a thread's four
    interleaved accumulators, added in the kernel's order; after every step
    each CTA gathers h from all the CTAs.

    It checks the partition's arithmetic (which columns a CTA owns, that
    the cell update stays local, that h gathered from every CTA is the
    whole h), not the kernel: its CPU matmuls do not follow the kernel's
    sequential fmaf order.  The kernel's own sum order is held on the card
    by test_torch_cuda.py::test_lstm_kernel_is_deterministic."""
    ctas, split = kernels.LSTM_CLUSTER_SIZE, kernels.LSTM_K_SPLIT
    hdim = h0.shape[-1]
    units, kq = hdim // ctas, hdim // split
    h, c = h0.clone(), c0.clone()
    hs, cs = [], []
    for t in range(x_proj.shape[1]):
        h_parts, c_parts = [], []
        for r in range(ctas):
            cols = torch.tensor([g * hdim + r * units + u
                                 for g in range(4) for u in range(units)])
            w = wh[:, cols]
            partials = []
            for q in range(split):
                acc = [h[:, q * kq + m:(q + 1) * kq:4] @ w[q * kq + m:(q + 1) * kq:4]
                       for m in range(4)]
                partials.append((acc[0] + acc[1]) + (acc[2] + acc[3]))
            dot = ((partials[0] + partials[1]) + partials[2]) + partials[3]
            i, f, g, o = (x_proj[:, t, cols] + dot).split(units, dim=1)
            c_r = (torch.sigmoid(f) * c[:, r * units:(r + 1) * units]
                   + torch.sigmoid(i) * torch.tanh(g))
            h_parts.append(torch.sigmoid(o) * torch.tanh(c_r))
            c_parts.append(c_r)
        h, c = torch.cat(h_parts, 1), torch.cat(c_parts, 1)
        hs.append(h)
        cs.append(c)
    return torch.stack(hs, 1), torch.stack(cs, 1), (h, c)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("b,t,h", [(3, 37, 128), (2, 16, 256)])
def test_lstm_cluster_partition_matches_pallas_and_plain(monkeypatch, b, t, h,
                                                         reverse):
    """The cluster route's partition, run through lstm_scan as the kernel
    would be, against lstm_pallas and lstm_plain."""
    assert kernels.lstm_route(h) == "cluster"
    rng = np.random.default_rng(4)
    x_proj = (rng.standard_normal((b, t, 4 * h)) * 0.3).astype(np.float32)
    w_h = (rng.standard_normal((4 * h, h)) * 0.1).astype(np.float32)
    h0 = (rng.standard_normal((b, h)) * 0.1).astype(np.float32)
    c0 = (rng.standard_normal((b, h)) * 0.1).astype(np.float32)
    args = tuple(map(torch.as_tensor, (x_proj, w_h, h0, c0)))

    plain = lstm_scan(*args, reverse=reverse, return_cells=True)
    monkeypatch.setattr(kernels, "lstm", _lstm_cluster_emulated)
    hs, cs, (h_t, c_t) = lstm_scan(*args, reverse=reverse, return_cells=True)

    xp = jnp.asarray(x_proj[:, ::-1] if reverse else x_proj)
    hs_p, cs_p, (h_p, c_p) = lstm_pallas(xp, jnp.asarray(w_h.T), jnp.asarray(h0),
                                         jnp.asarray(c0), interpret=True)
    if reverse:
        hs_p, cs_p = hs_p[:, ::-1], cs_p[:, ::-1]
    for got, pal, ref in [(hs, hs_p, plain[0]), (cs, cs_p, plain[1]),
                          (h_t, h_p, plain[2][0]), (c_t, c_p, plain[2][1])]:
        np.testing.assert_allclose(got.numpy(), np.asarray(pal),
                                   **LSTM_KERNEL_TOL)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), **LSTM_KERNEL_TOL)


@pytest.mark.parametrize("h,route", [(128, "cluster"), (256, "cluster"),
                                     (100, "row"), (520, "row")])
def test_lstm_route(h, route):
    """Kokoro's H = 256 and the tests' 128 take the cluster route; an H that
    does not split into whole float4 quarters (100) or whose weight slice
    does not fit on chip (520) takes the row kernel."""
    assert kernels.lstm_route(h) == route


@pytest.mark.parametrize("k,dilation", [(3, 1), (7, 3), (11, 5)])
def test_dilated_conv_plain_matches_pallas(k, dilation):
    rng = np.random.default_rng(0)
    b, l, c, c_out = 2, 1111, 128, 128  # L not a tile multiple on purpose
    x = (rng.standard_normal((b, l, c)) * 0.3).astype(np.float32)
    w = (rng.standard_normal((k, c, c_out)) * 0.1).astype(np.float32)
    out = kernels.dilated_conv1d(torch.as_tensor(x), torch.as_tensor(w),
                                 dilation)
    ref = dilated_conv1d_pallas(jnp.asarray(x), jnp.asarray(w), dilation,
                                interpret=True)
    assert tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **CONV_TOL)


@pytest.mark.parametrize("k,c,c_out", [(7, 128, 128), (11, 128, 256)])
def test_banded_conv_plain_matches_pallas(k, c, c_out):
    rng = np.random.default_rng(k + c)
    x = (rng.standard_normal((2, 4096 + 37, c)) * 0.1).astype(np.float32)
    w = (rng.standard_normal((k, c, c_out)) * 0.05).astype(np.float32)
    q = kernels.banded_groups(k)
    np.testing.assert_array_equal(
        kernels.banded_weight(torch.as_tensor(w), q).numpy(),
        np.asarray(_banded_weight(jnp.asarray(w), q)))
    out = kernels.banded_conv1d(torch.as_tensor(x), torch.as_tensor(w))
    ref = banded_conv1d_pallas(jnp.asarray(x), jnp.asarray(w), interpret=True)
    assert tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **CONV_TOL)


def test_banded_residue_fold_matches_pallas():
    k, c, d = 7, 128, 3
    rng = np.random.default_rng(d)
    x = (rng.standard_normal((1, 9000, c)) * 0.1).astype(np.float32)
    w = (rng.standard_normal((k, c, c)) * 0.05).astype(np.float32)
    out = _dilated_conv1d_residue(torch.as_tensor(x), torch.as_tensor(w), d,
                                  kernels.banded_conv1d)
    ref = jax_residue(jnp.asarray(x), jnp.asarray(w), d,
                      partial(banded_conv1d_pallas, interpret=True))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **CONV_TOL)


# The CUDA banded_conv1d and dilated_conv1d kernels compute in 3xTF32 on the
# tensor cores: each float32 operand a is split into a_big = tf32_rna(a) and
# a_small = tf32_rna(a - a_big), and each multiply-add is small*big +
# big*small + big*big, summed in float32, per tap over the window shifted by
# tap * dilation.  The tests below emulate that arithmetic in PyTorch; the
# kernels themselves are held against their plain versions on the card
# (tests/test_torch_cuda.py).
# Tolerances: the emulation drops small*small (2**-22 of a product) and
# rounds small to TF32 (2**-24 of an operand), so its error is near
# float32's, and atol/rtol 1e-5 (ten times tighter than the card's 1e-4)
# hold it to the plain version and to the Pallas kernel.
SCHEME_TOL = {"atol": 1e-5, "rtol": 1e-5}


def _tf32_rna(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, ties away from zero, as
    cvt.rna.tf32.f32 rounds: add half a unit of the 13 dropped bits to the
    magnitude, then clear them."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_conv(x: torch.Tensor, w: torch.Tensor, passes: int = 3,
               dilation: int = 1) -> torch.Tensor:
    """'Same' conv x [B, L, C] * w [K, C, Cout] with taps ``dilation`` rows
    apart, in the kernels' arithmetic: ``passes`` 3 is 3xTF32, 1 one TF32
    product (big*big)."""
    b, l, _ = x.shape
    k = w.shape[0]
    span = (k - 1) * dilation
    pad = span // 2
    xp = F.pad(x, (0, 0, pad, span - pad))
    x_big, w_big = _tf32_rna(xp), _tf32_rna(w)
    x_small, w_small = _tf32_rna(xp - x_big), _tf32_rna(w - w_big)
    out = torch.zeros(b, l, w.shape[2])
    for tap in range(k):
        at = tap * dilation
        xb, xs = x_big[:, at:at + l], x_small[:, at:at + l]
        if passes == 3:
            out += xs @ w_big[tap] + xb @ w_small[tap]
        out += xb @ w_big[tap]
    return out


def _kokoro_conv_inputs(rng, b, l, c, c_out, k):
    """x and w at the scales chip_smoke.py uses: outputs of about 0.5 at
    Kokoro's K = 11, C = 128, as in its resblocks."""
    x = (rng.standard_normal((b, l, c)) * 0.3).astype(np.float32)
    w = (rng.standard_normal((k, c, c_out)) * 0.05).astype(np.float32)
    return x, w


def test_tf32_rna_rounds_as_cvt_rna():
    v = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -11,
                      -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12, 3.0e-39])
    want = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9,
                         -(1.0 + 2.0 ** -10), 1.0, 3.0e-39])
    got = _tf32_rna(v)
    # the tie 1 + 2**-11 rounds away from zero (rna), not to even
    torch.testing.assert_close(got[:5], want[:5], atol=0, rtol=0)
    assert float(got[5]) == pytest.approx(3.0e-39, rel=2.0 ** -10)


@pytest.mark.parametrize("k", [5, 7, 11, 13])
@pytest.mark.parametrize("c_out", [128, 256])
def test_three_tf32_scheme_matches_plain_and_pallas(k, c_out):
    rng = np.random.default_rng(100 + k + c_out)
    x, w = _kokoro_conv_inputs(rng, 2, 4096 + 37, 128, c_out, k)
    got = _tf32_conv(torch.as_tensor(x), torch.as_tensor(w))
    plain = kernels.banded_conv1d_plain(torch.as_tensor(x), torch.as_tensor(w))
    torch.testing.assert_close(got, plain, **SCHEME_TOL)
    ref = banded_conv1d_pallas(jnp.asarray(x), jnp.asarray(w), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **SCHEME_TOL)


@pytest.mark.parametrize("dilation", [1, 3, 5])
@pytest.mark.parametrize("c", [128, 256])
def test_three_tf32_scheme_at_the_dilated_taps(dilation, c):
    """The dilated kernel's arithmetic at Kokoro's K = 3 resblock convs: every
    tap reads the window tap * dilation rows in; L = 2500 is no multiple of
    the 192-sample tile.  Held to the plain version and to the Pallas kernel
    at SCHEME_TOL, for the reason given above."""
    rng = np.random.default_rng(200 + 10 * dilation + c)
    x, w = _kokoro_conv_inputs(rng, 2, 2500, c, 128, 3)
    xt, wt = torch.as_tensor(x), torch.as_tensor(w)
    got = _tf32_conv(xt, wt, dilation=dilation)
    plain = kernels.dilated_conv1d_plain(xt, wt, dilation)
    torch.testing.assert_close(got, plain, **SCHEME_TOL)
    ref = dilated_conv1d_pallas(jnp.asarray(x), jnp.asarray(w), dilation,
                                interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **SCHEME_TOL)


def test_three_tf32_scheme_through_the_residue_fold():
    k, c, d = 11, 128, 3
    rng = np.random.default_rng(d)
    x, w = _kokoro_conv_inputs(rng, 1, 9000, c, c, k)
    xt, wt = torch.as_tensor(x), torch.as_tensor(w)
    got = _dilated_conv1d_residue(xt, wt, d, _tf32_conv)
    plain = _dilated_conv1d_residue(xt, wt, d, kernels.banded_conv1d_plain)
    torch.testing.assert_close(got, plain, **SCHEME_TOL)
    ref = jax_residue(jnp.asarray(x), jnp.asarray(w), d,
                      partial(banded_conv1d_pallas, interpret=True))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **SCHEME_TOL)


def test_one_tf32_pass_misses_the_card_tolerance():
    """Why three products: at Kokoro's K = 11 depth (K C = 1408) one TF32
    pass keeps 10 mantissa bits and lands several 1e-4 off the float32
    conv, outside the atol/rtol 1e-4 the card holds kernels to; 3xTF32
    stays inside it."""
    rng = np.random.default_rng(11)
    x, w = _kokoro_conv_inputs(rng, 2, 4096 + 37, 128, 128, 11)
    xt, wt = torch.as_tensor(x), torch.as_tensor(w)
    plain = kernels.banded_conv1d_plain(xt, wt)
    one = _tf32_conv(xt, wt, passes=1)
    assert float((one - plain).abs().max()) > 3e-4
    assert not torch.allclose(one, plain, atol=1e-4, rtol=1e-4)
    assert torch.allclose(_tf32_conv(xt, wt), plain, atol=1e-4, rtol=1e-4)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.standard_normal((1, 64, 128)), dtype=torch.float32)
    w = torch.as_tensor(rng.standard_normal((3, 128, 128)), dtype=torch.float32)
    xp = torch.as_tensor(rng.standard_normal((1, 5, 512)), dtype=torch.float32)
    wh = torch.as_tensor(rng.standard_normal((128, 512)), dtype=torch.float32)
    h0 = torch.zeros(1, 128)
    before = dict(kernels.LAUNCHES)
    kernels.dilated_conv1d(x, w, 2)
    kernels.banded_conv1d(x, w)
    kernels.lstm(xp, wh, h0, h0)
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("name", ["lstm", "dilated_conv1d", "banded_conv1d"])
def test_no_plain_fallback_off_the_cpu(name):
    """A tensor that is not on the CPU never reaches the plain version: a
    device without a kernel raises."""
    x = torch.empty(1, 64, 512, device="meta")
    w = torch.empty(3, 512, 512, device="meta")
    args = {"lstm": (x, torch.empty(128, 512, device="meta"),
                     torch.empty(1, 128, device="meta"),
                     torch.empty(1, 128, device="meta")),
            "dilated_conv1d": (x, w), "banded_conv1d": (x, w)}[name]
    with pytest.raises(ValueError, match="no kernel for device"):
        getattr(kernels, name)(*args)
