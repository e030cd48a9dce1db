"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: without a GPU every test here skips.  Imports no JAX, so it
runs on a machine with only PyTorch and the CUDA toolkit:

    python -m pytest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from mlx_audio_tpu_torch.nn import kernels
from mlx_audio_tpu_torch.nn.layers import _dilated_conv1d_residue

pytestmark = pytest.mark.cuda

TOL = {"atol": 1e-4, "rtol": 1e-4}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, shape, scale, device):
    return torch.as_tensor(rng.standard_normal(shape) * scale,
                           dtype=torch.float32, device=device)


@pytest.mark.parametrize("b,t,h", [(3, 37, 128), (8, 64, 256)])
def test_lstm_kernel_matches_plain(cuda, b, t, h):
    rng = np.random.default_rng(0)
    xp = _randn(rng, (b, t, 4 * h), 0.3, cuda)
    wh = _randn(rng, (h, 4 * h), 0.1, cuda)
    h0 = _randn(rng, (b, h), 0.1, cuda)
    c0 = _randn(rng, (b, h), 0.1, cuda)
    before = kernels.LAUNCHES["lstm"]
    got = kernels.lstm(xp, wh, h0, c0)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["lstm"] == before + 1
    ref = kernels.lstm_plain(xp, wh, h0, c0)
    for g, r in zip((got[0], got[1], *got[2]), (ref[0], ref[1], *ref[2])):
        torch.testing.assert_close(g, r, **TOL)


@pytest.mark.parametrize("l,c,c_out,k,d", [(1111, 128, 128, 3, 1),
                                           (2500, 256, 128, 7, 3),
                                           (777, 128, 256, 11, 5)])
def test_dilated_conv_kernel_matches_plain(cuda, l, c, c_out, k, d):
    rng = np.random.default_rng(1)
    x = _randn(rng, (2, l, c), 0.3, cuda)
    w = _randn(rng, (k, c, c_out), 0.1, cuda)
    got = kernels.dilated_conv1d(x, w, d)
    torch.testing.assert_close(got, kernels.dilated_conv1d_plain(x, w, d), **TOL)


@pytest.mark.parametrize("l,c,c_out,k,d", [(4133, 128, 128, 7, 1),
                                           (4133, 128, 256, 11, 1),
                                           (9001, 128, 128, 7, 3)])
def test_banded_conv_kernel_matches_plain(cuda, l, c, c_out, k, d):
    rng = np.random.default_rng(2)
    x = _randn(rng, (2, l, c), 0.1, cuda)
    w = _randn(rng, (k, c, c_out), 0.05, cuda)
    got = _dilated_conv1d_residue(x, w, d, kernels.banded_conv1d)
    ref = _dilated_conv1d_residue(x, w, d, kernels.banded_conv1d_plain)
    torch.testing.assert_close(got, ref, **TOL)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = torch.zeros(1, 64, 128, device=cuda, dtype=torch.float64)
    w = torch.zeros(3, 128, 128, device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError):
        kernels.dilated_conv1d(x, w)
    with pytest.raises(ValueError):
        kernels.banded_conv1d(x.float().transpose(1, 2), w.float())
