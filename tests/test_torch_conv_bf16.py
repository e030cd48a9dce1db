"""The bf16 conv kernel's gate on the CPU: both bf16 conv entry points go to
csrc/conv1d_bf16.cu, whose least shared memory the wrappers count as the
kernel does; every span the earlier mma.sync bf16 variants took still
routes to a kernel; and the CPU still runs the plain versions.  The kernel
itself is held on the card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

from mlx_audio_tpu_torch import build
from mlx_audio_tpu_torch.nn import kernels
from mlx_audio_tpu_torch.nn import layers as tlayers

BF16 = torch.bfloat16


def test_both_bf16_conv_entry_points_launch_one_kernel():
    assert "conv1d_bf16" in build.KERNELS
    for name in ("banded_conv1d_bf16", "dilated_conv1d_bf16"):
        assert kernels._source(name) == "conv1d_bf16"
        assert kernels._SIGNATURES[name][0] == "conv1d_bf16_forward"
        assert name in kernels.LAUNCHES
    # the other bf16 variants stay with their float32 kernels
    assert kernels._source("lstm_bf16") == "lstm"
    assert kernels._source("quantized_matmul_bf16") == "quantized_matmul"
    assert not (build.CSRC / "mma_bf16.cuh").exists()
    source = (build.CSRC / "conv1d_bf16.cu").read_text()
    for what in ("wgmma.mma_async", "cp.async.bulk.tensor.3d", "setmaxnreg",
                 "pallas_ops.py:259", "pallas_ops.py:353"):
        assert what in source, what
    # the float32 kernels' sources hold no bf16 instantiation any more
    for float32_only in ("banded_conv1d.cu", "dilated_conv1d.cu"):
        text = (build.CSRC / float32_only).read_text()
        for gone in ("__nv_bfloat16", "bf16*", "forward_bf16", "mma_bf16"):
            assert gone not in text, (float32_only, gone)


def _window_rows(k, d, tile=128, box=256):
    """Rows of one window stage: tile + (K-1) d cut into boxes of at most
    256 rows, each rounded up to 8, or K boxes of one tile where fewer."""
    rows = tile + (k - 1) * d
    pieces = -(-rows // box)
    per = -(-(-(-rows // pieces)) // 8) * 8
    return min(pieces * per, k * tile)


@pytest.mark.parametrize("k,d,rows", [
    (3, 1, 136),        # one box of 130 rows, rounded up to 136
    (7, 3, 152),
    (11, 5, 184),
    (11, 40, 528),      # 528 rows in three boxes of 176
    (3, 300, 384),      # d past the tile: three 128-row boxes
    (11, 112, 1280),    # five boxes of 256: fewer than 11 x 128
    (11, 123, 1392),    # the widest span at K = 11 the mma.sync variant took
])
def test_bf16_shared_memory_counts_a_window_a_weight_stage_and_the_staging(k, d, rows):
    assert _window_rows(k, d) == rows
    want = 1024 + 128 * rows + 2 * 64 * 128 + 2 * 128 * 128 + 16 * 2
    assert kernels.conv1d_bf16_smem_bytes(k, d) == want
    assert kernels.dilated_conv1d_smem_bytes(k, d, BF16) == want
    assert kernels.banded_conv1d_smem_bytes(k, BF16) == kernels.conv1d_bf16_smem_bytes(k, 1)


def _old_bf16_dilated_smem(k, d):
    """The mma.sync bf16 variant's least figure: two stages of 16 channels,
    2 S (W + 136 s K) bytes with W = (s + 8) (192 + (K-1) d)."""
    return 2 * 2 * (24 * (192 + (k - 1) * d) + 136 * 16 * k)


@pytest.mark.parametrize("k", [3, 5, 7, 9, 11, 13, 15, 17, 19, 21, 23])
def test_bf16_kernel_admits_every_span_the_mma_sync_variant_did(k):
    """The route sends the new kernel every (K, d) that the earlier bf16
    variant's shared memory admitted, up to its widest span."""
    d = 1
    while _old_bf16_dilated_smem(k, d) <= kernels.SMEM_LIMIT_BYTES:
        assert (kernels.dilated_conv1d_smem_bytes(k, d, BF16)
                <= kernels.SMEM_LIMIT_BYTES), (k, d)
        # banded (at d <= 2 here, through the residue fold past 1) or shifted:
        # the same kernel either way
        assert tlayers.conv1d_route(k, 128, 128, 8192, d, 1, 1, (k - 1) * d // 2,
                                    BF16) == ("banded" if k >= 7 and d <= 2 else "shifted"), (k, d)
        d += 1
    assert d > 6, d


@pytest.mark.parametrize("d", [1, 3])
def test_bf16_convs_on_the_cpu_run_the_plain_versions(d):
    rng = np.random.default_rng(7)
    x = torch.as_tensor(rng.standard_normal((2, 300, 72)) * 0.3, dtype=torch.float32).to(BF16)
    w = torch.as_tensor(rng.standard_normal((7, 72, 64)) * 0.05, dtype=torch.float32).to(BF16)
    before = dict(kernels.LAUNCHES)
    got = kernels.dilated_conv1d(x, w, d)
    assert got.dtype == BF16
    assert torch.equal(got, kernels.dilated_conv1d_plain(x, w, d))
    if d == 1:
        assert torch.equal(kernels.banded_conv1d(x, w), kernels.banded_conv1d_plain(x, w))
    assert kernels.LAUNCHES == before
    exact = kernels.dilated_conv1d_plain(x.double(), w.double(), d)
    assert kernels.bf16_steps(got, exact) <= 1.0
