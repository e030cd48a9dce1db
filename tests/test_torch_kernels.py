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
