"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: without a GPU every test here skips.  Imports no JAX, so it
runs on a machine with only PyTorch and the CUDA toolkit:

    python -m pytest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from mlx_audio_tpu_torch import build
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


def _lstm_inputs(b, t, h, device, seed=0):
    rng = np.random.default_rng(seed)
    return (_randn(rng, (b, t, 4 * h), 0.3, device),
            _randn(rng, (h, 4 * h), 0.1, device),
            _randn(rng, (b, h), 0.1, device), _randn(rng, (b, h), 0.1, device))


# both routes: H 128 and 256 take the cluster, 100 the row kernel
@pytest.mark.parametrize("b,t,h", [(3, 37, 128)] + [
    (b, t, h) for b in (1, 3, 8, 9) for t in (1, 64, 1300)
    for h in (128, 256, 100)])
def test_lstm_kernel_matches_plain(cuda, b, t, h):
    xp, wh, h0, c0 = _lstm_inputs(b, t, h, cuda)
    route = kernels.lstm_route(h)
    before = kernels.LAUNCHES["lstm"]
    before_route = kernels.LSTM_ROUTE_LAUNCHES[route]
    got = kernels.lstm(xp, wh, h0, c0)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["lstm"] == before + 1
    assert kernels.LSTM_ROUTE_LAUNCHES[route] == before_route + 1
    ref = kernels.lstm_plain(xp, wh, h0, c0)
    for g, r in zip((got[0], got[1], *got[2]), (ref[0], ref[1], *ref[2])):
        torch.testing.assert_close(g, r, **TOL)


@pytest.mark.parametrize("b,t,h", [(8, 1300, 256), (9, 64, 128), (3, 64, 100)])
def test_lstm_kernel_is_deterministic(cuda, b, t, h):
    """Two launches give equal bits, and every row equals a one-row launch
    on it: the sum order depends on H alone."""
    xp, wh, h0, c0 = _lstm_inputs(b, t, h, cuda, seed=1)
    first = kernels.lstm(xp, wh, h0, c0)
    second = kernels.lstm(xp, wh, h0, c0)
    torch.cuda.synchronize()
    for g, r in zip((first[0], first[1], *first[2]),
                    (second[0], second[1], *second[2])):
        assert torch.equal(g, r)
    for row in (0, b - 1):
        one = kernels.lstm(xp[row:row + 1].contiguous(), wh,
                           h0[row:row + 1].contiguous(),
                           c0[row:row + 1].contiguous())
        torch.cuda.synchronize()
        assert torch.equal(one[0][0], first[0][row])
        assert torch.equal(one[2][1][0], first[2][1][row])


# EnCodec-24kHz's LSTMs: H = 512 at 75 frames a second, one clip (B = 1,
# 2 s and 3 s) or Bark's batch of 4 decoded together
@pytest.mark.parametrize("b,t", [(1, 150), (1, 225), (4, 150)])
def test_lstm_row_route_at_encodec_width(cuda, b, t):
    """H = 512 takes the row route: a CUDA tensor launches lstm_row_kernel,
    counted under the row route, and matches the plain version."""
    assert kernels.lstm_route(512) == "row"
    xp, wh, h0, c0 = _lstm_inputs(b, t, 512, cuda, seed=2)
    before = dict(kernels.LSTM_ROUTE_LAUNCHES)
    got = kernels.lstm(xp, wh, h0, c0)
    torch.cuda.synchronize()
    assert kernels.LSTM_ROUTE_LAUNCHES["row"] == before["row"] + 1
    assert kernels.LSTM_ROUTE_LAUNCHES["cluster"] == before["cluster"]
    ref = kernels.lstm_plain(xp, wh, h0, c0)
    for g, r in zip((got[0], got[1], *got[2]), (ref[0], ref[1], *ref[2])):
        torch.testing.assert_close(g, r, **TOL)


def test_lstm_route_agrees_with_the_kernel(cuda):
    lib = build.load("lstm")
    assert lib.lstm_cluster_size() == kernels.LSTM_CLUSTER_SIZE
    for h in range(4, 1100, 4):
        assert (lib.lstm_route(h) == 1) == (kernels.lstm_route(h) == "cluster"), h


@pytest.mark.parametrize("b,l,c,c_out,k,d", [
    (2, 1111, 128, 128, 3, 1),
    (2, 2500, 256, 128, 7, 3),
    (2, 777, 128, 256, 11, 5),
    (2, 100, 128, 128, 3, 1),      # L below one 192-sample tile
    (2, 7, 128, 128, 3, 5),        # L below the span (K-1) d: taps off both ends
    (2, 15601, 128, 128, 3, 1),    # odd L, the tail of 156 001
    (2, 4133, 256, 128, 3, 1),     # C = 256, Cout = 128
    (3, 4133, 128, 128, 3, 1),     # B = 3
    (2, 4133, 128, 128, 3, 3),
    (2, 4133, 256, 256, 3, 5),
    (2, 4133, 128, 128, 15, 1),    # two stages: three do not fit
    (2, 1000, 64, 72, 3, 1),       # Cout not a multiple of the 128 tile
    (2, 1000, 72, 64, 3, 1),       # C not a multiple of the 32-channel slice
])
def test_dilated_conv_kernel_matches_plain(cuda, b, l, c, c_out, k, d):
    rng = np.random.default_rng(1)
    # outputs of about 0.5, as at Kokoro's widths
    x = _randn(rng, (b, l, c), 0.3, cuda)
    w = _randn(rng, (k, c, c_out), 0.05, cuda)
    before = kernels.LAUNCHES["dilated_conv1d"]
    got = kernels.dilated_conv1d(x, w, d)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["dilated_conv1d"] == before + 1
    torch.testing.assert_close(got, kernels.dilated_conv1d_plain(x, w, d), **TOL)


@pytest.mark.parametrize("b,l,c,c_out,k,d", [
    (2, 4133, 128, 128, 7, 1),
    (2, 4133, 128, 256, 11, 1),
    (2, 9001, 128, 128, 7, 3),
    (2, 100, 128, 128, 11, 1),     # L below one 192-sample tile
    (2, 9, 128, 128, 11, 1),       # L below K: every window runs off both ends
    (2, 15601, 128, 128, 11, 1),   # odd L, the tail of 156 001
    (2, 4133, 256, 128, 7, 1),     # C = 256, Cout = 128
    (3, 4133, 128, 128, 11, 1),    # B = 3
    (2, 4133, 128, 128, 5, 1),
    (2, 4133, 128, 128, 13, 1),
    (2, 1000, 64, 72, 7, 1),       # Cout not a multiple of the 128 tile
])
def test_banded_conv_kernel_matches_plain(cuda, b, l, c, c_out, k, d):
    rng = np.random.default_rng(2)
    # outputs of about 0.5, as at Kokoro's widths
    x = _randn(rng, (b, l, c), 0.3, cuda)
    w = _randn(rng, (k, c, c_out), 0.05, cuda)
    before = kernels.LAUNCHES["banded_conv1d"]
    got = _dilated_conv1d_residue(x, w, d, kernels.banded_conv1d)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["banded_conv1d"] == before + 1
    ref = _dilated_conv1d_residue(x, w, d, kernels.banded_conv1d_plain)
    torch.testing.assert_close(got, ref, **TOL)


@pytest.mark.parametrize("k,d", [(3, 1), (3, 5), (7, 3), (11, 5), (13, 1),
                                 (15, 1), (3, 1000)])
def test_conv_shared_memory_agrees_with_the_kernels(cuda, k, d):
    """The wrappers' shared-memory counts, which conv1d_route gates on, are
    the bytes the kernels ask for at launch."""
    dilated = build.load("dilated_conv1d").dilated_conv1d_smem_bytes
    assert dilated(k, d) == kernels.dilated_conv1d_smem_bytes(k, d)
    banded = build.load("banded_conv1d").banded_conv1d_smem_bytes
    assert banded(k) == kernels.banded_conv1d_smem_bytes(k)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = torch.zeros(1, 64, 128, device=cuda, dtype=torch.float64)
    w = torch.zeros(3, 128, 128, device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError):
        kernels.dilated_conv1d(x, w)
    with pytest.raises(ValueError):
        kernels.banded_conv1d(x.float().transpose(1, 2), w.float())
    xf, wf = x.float(), w.float()
    bad = {
        "C not a multiple of 8": (xf[..., :124].contiguous(), wf[:, :124].contiguous()),
        "Cout not a multiple of 8": (xf, wf[..., :124].contiguous()),
        "x not 16-byte aligned": (torch.zeros(64 * 128 + 1, device=cuda)[1:].view(1, 64, 128), wf),
        "w not 16-byte aligned": (xf, torch.zeros(3 * 128 * 128 + 2, device=cuda)[2:].view(3, 128, 128)),
        "K even": (xf, torch.zeros(4, 128, 128, device=cuda)),
    }
    # banded_conv1d: K = 15 overflows three stages; dilated_conv1d: a window
    # of 192 + 2000 rows (K = 3, d = 1000) overflows two
    calls = {"banded_conv1d": lambda xb, wb, d: kernels.banded_conv1d(xb, wb),
             "dilated_conv1d": kernels.dilated_conv1d}
    for name, past_smem, d_past in (("banded_conv1d", 15, 1),
                                    ("dilated_conv1d", 3, 1000)):
        cases = {why: (xb, wb, 1) for why, (xb, wb) in bad.items()}
        cases["past the shared memory"] = (
            xf, torch.zeros(past_smem, 128, 128, device=cuda), d_past)
        before = kernels.LAUNCHES[name]
        for why, (xb, wb, d) in cases.items():
            try:
                calls[name](xb, wb, d)
            except ValueError:
                continue
            pytest.fail(f"{name} took {why}")
        assert kernels.LAUNCHES[name] == before


# ---------------------------------------------------------------------------
# bf16 variants: each output within one bf16 step of a float64 run of the
# plain version (kernels.bf16_steps <= 1), launches counted as <name>_bf16
# ---------------------------------------------------------------------------


def _bf16(rng, shape, scale, device):
    return _randn(rng, shape, scale, device).to(torch.bfloat16)


def _within_a_bf16_step(got, exact):
    assert got.dtype == torch.bfloat16
    steps = kernels.bf16_steps(got, exact)
    assert steps <= 1.0, steps


# the cluster route at Kokoro's H = 256 and the tests' 128, the row route at
# H = 100 and at EnCodec's 512
@pytest.mark.parametrize("b,t,h", [(3, 37, 128), (8, 512, 256), (2, 1300, 256),
                                   (3, 64, 100), (1, 150, 512), (4, 150, 512)])
def test_lstm_bf16_kernel_within_a_bf16_step(cuda, b, t, h):
    rng = np.random.default_rng(3)
    args = (_bf16(rng, (b, t, 4 * h), 0.3, cuda), _bf16(rng, (h, 4 * h), 0.1, cuda),
            _bf16(rng, (b, h), 0.1, cuda), _bf16(rng, (b, h), 0.1, cuda))
    route = kernels.lstm_route(h)
    before = dict(kernels.LAUNCHES)
    before_route = kernels.LSTM_ROUTE_LAUNCHES[route]
    got = kernels.lstm(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["lstm_bf16"] == before["lstm_bf16"] + 1
    assert kernels.LAUNCHES["lstm"] == before["lstm"]
    assert kernels.LSTM_ROUTE_LAUNCHES[route] == before_route + 1
    exact = kernels.lstm_plain(*(a.double() for a in args))
    for g, r in zip((got[0], got[1], *got[2]), (exact[0], exact[1], *exact[2])):
        _within_a_bf16_step(g, r)
    again = kernels.lstm(*args)
    torch.cuda.synchronize()
    assert torch.equal(again[0], got[0]) and torch.equal(again[2][1], got[2][1])


@pytest.mark.parametrize("b,l,c,c_out,k,d", [
    (2, 2600, 256, 256, 3, 1),     # Kokoro's resblocks, K = 3
    (2, 4133, 128, 128, 3, 5),
    (1, 3752, 768, 768, 11, 5),    # BigVGAN-v2's widest: (32, 2) at 225 KB
    (1, 3752, 768, 768, 7, 3),
    (2, 100, 128, 128, 3, 1),      # L below one 192-sample tile
    (2, 7, 128, 128, 3, 5),        # L below the span: taps off both ends
    (2, 4133, 128, 128, 15, 1),    # (16, 3)
    (2, 1000, 64, 72, 3, 1),       # Cout not a multiple of the 128 tile
    (2, 1000, 72, 64, 3, 1),       # C not a multiple of the 16-channel k step
])
def test_dilated_conv_bf16_kernel_within_a_bf16_step(cuda, b, l, c, c_out, k, d):
    rng = np.random.default_rng(4)
    x = _bf16(rng, (b, l, c), 0.3, cuda)
    w = _bf16(rng, (k, c, c_out), 0.05, cuda)
    before = dict(kernels.LAUNCHES)
    got = kernels.dilated_conv1d(x, w, d)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["dilated_conv1d_bf16"] == before["dilated_conv1d_bf16"] + 1
    assert kernels.LAUNCHES["dilated_conv1d"] == before["dilated_conv1d"]
    _within_a_bf16_step(got, kernels.dilated_conv1d_plain(x.double(), w.double(), d))


@pytest.mark.parametrize("b,l,c,c_out,k,d", [
    (2, 5200, 128, 128, 7, 1),     # Kokoro's
    (2, 15601, 128, 128, 11, 1),
    (2, 9001, 128, 128, 11, 5),    # through the residue fold
    (1, 15008, 384, 384, 11, 1),   # BigVGAN-v2's 384-wide resblocks
    (2, 100, 128, 128, 11, 1),     # L below one tile
    (2, 9, 128, 128, 11, 1),       # L below K
    (2, 4133, 128, 128, 15, 1),    # K = 15 fits three bf16 stages
    (2, 1000, 64, 72, 7, 1),       # Cout not a multiple of the 128 tile
    (2, 1000, 72, 64, 7, 1),       # C not a multiple of the 16-channel slice
])
def test_banded_conv_bf16_kernel_within_a_bf16_step(cuda, b, l, c, c_out, k, d):
    rng = np.random.default_rng(5)
    x = _bf16(rng, (b, l, c), 0.3, cuda)
    w = _bf16(rng, (k, c, c_out), 0.05, cuda)
    before = dict(kernels.LAUNCHES)
    got = _dilated_conv1d_residue(x, w, d, kernels.banded_conv1d)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["banded_conv1d_bf16"] == before["banded_conv1d_bf16"] + 1
    assert kernels.LAUNCHES["banded_conv1d"] == before["banded_conv1d"]
    exact = _dilated_conv1d_residue(x.double(), w.double(), d,
                                    kernels.banded_conv1d_plain)
    _within_a_bf16_step(got, exact)


@pytest.mark.parametrize("k,d", [(3, 1), (3, 5), (7, 3), (11, 5), (13, 1),
                                 (15, 1), (3, 1000)])
def test_conv_bf16_shared_memory_agrees_with_the_kernels(cuda, k, d):
    dilated = build.load("dilated_conv1d").dilated_conv1d_smem_bytes_bf16
    assert dilated(k, d) == kernels.dilated_conv1d_smem_bytes(k, d, torch.bfloat16)
    banded = build.load("banded_conv1d").banded_conv1d_smem_bytes_bf16
    assert banded(k) == kernels.banded_conv1d_smem_bytes(k, torch.bfloat16)


def test_wrappers_reject_f16_and_mixed_dtypes(cuda):
    """bf16 launches the bf16 variant; f16, and bf16 mixed with float32,
    raise TypeError on the card."""
    x = torch.zeros(1, 64, 128, device=cuda)
    w = torch.zeros(3, 128, 128, device=cuda)
    for xb, wb in ((x.half(), w.half()), (x.bfloat16(), w), (x, w.bfloat16())):
        for call in (lambda: kernels.dilated_conv1d(xb, wb),
                     lambda: kernels.banded_conv1d(xb, torch.zeros_like(wb[:1]).repeat(7, 1, 1))):
            with pytest.raises(TypeError):
                call()
    xp, wh = torch.zeros(1, 4, 512, device=cuda), torch.zeros(128, 512, device=cuda)
    h0 = torch.zeros(1, 128, device=cuda)
    with pytest.raises(TypeError):
        kernels.lstm(xp.half(), wh.half(), h0.half(), h0.half())
    with pytest.raises(TypeError):
        kernels.lstm(xp.bfloat16(), wh, h0, h0)


def _quantized(rng, i, o, gs, bits, device):
    from mlx_audio_tpu_torch.nn.layers import Linear
    from mlx_audio_tpu_torch.nn.quantize import QuantizedLinear

    lin = Linear(i, o, bias=False)
    lin.weight.data = _randn(rng, (o, i), 0.2, "cpu")
    return QuantizedLinear.from_linear(lin, group_size=gs, bits=bits).to(device)


@pytest.mark.parametrize("rows,i,o,gs,bits", [
    (1, 2048, 384, 128, 8),
    (3, 1024, 200, 64, 4),
    (37, 512, 130, 16, 8),
    (9, 96, 40, 6, 4),
    (1, 8192, 1024, 128, 8),    # 4 parts
    (1, 8192 + 128, 1024, 128, 8),  # the last part short
    (32, 1024, 8192, 128, 8),   # CSM's verify
    (1, 2048, 2048, 128, 4),    # int4, 1 part
    (1, 2048, 2051, 128, 8),    # the codebook-0 head: O not a multiple of a tile
    (5, 96, 72, 12, 8),         # 4-code loads (group of 12)
    (4, 5760, 40, 12, 4),       # 4-code loads, packed, 2 parts
    (2, 8192, 64, 4096, 8),     # a group longer than a part
])
def test_quantized_matmul_kernel_matches_plain(cuda, rows, i, o, gs, bits):
    rng = np.random.default_rng(3)
    q = _quantized(rng, i, o, gs, bits, cuda)
    x = _randn(rng, (rows, i), 0.5, cuda)
    args = (x, q.weight, q.scales, q.biases, gs, q.packed)
    before = kernels.LAUNCHES["quantized_matmul"]
    got = kernels.quantized_matmul(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["quantized_matmul"] == before + 1
    torch.testing.assert_close(got, kernels.quantized_matmul_plain(*args), **TOL)


def test_quantized_matmul_kernel_takes_unaligned_codes(cuda):
    """Codes 4 bytes past a 16-byte boundary take the 4-code loads."""
    rng = np.random.default_rng(7)
    q = _quantized(rng, 2048, 96, 128, 8, cuda)
    buf = torch.zeros(q.weight.numel() + 4, dtype=torch.uint8, device=cuda)
    codes = buf[4:].view(q.weight.shape)
    codes.copy_(q.weight)
    assert codes.data_ptr() % 16 == 4
    x = _randn(rng, (3, 2048), 0.5, cuda)
    got = kernels.quantized_matmul(x, codes, q.scales, q.biases, 128, False)
    ref = kernels.quantized_matmul_plain(x, q.weight, q.scales, q.biases, 128)
    torch.testing.assert_close(got, ref, **TOL)


@pytest.mark.parametrize("i,o,bits", [(8192, 1024, 8), (1024, 8192, 8),
                                      (2048, 2048, 4)])
def test_quantized_matmul_rows_are_independent(cuda, i, o, bits):
    """Each row of a 2-, 8-, 9- or 32-row call equals, bit for bit, the
    1-row call on that row: CSM's 32-row verify must give a decode step's
    logits."""
    rng = np.random.default_rng(8)
    q = _quantized(rng, i, o, 128, bits, cuda)
    w = (q.weight, q.scales, q.biases, 128, q.packed)
    x = _randn(rng, (32, i), 0.5, cuda)
    ones = [kernels.quantized_matmul(x[r:r + 1], *w)[0] for r in range(32)]
    for rows in (2, 8, 9, 32):
        got = kernels.quantized_matmul(x[:rows], *w)
        for r in range(rows):
            assert torch.equal(got[r], ones[r]), (rows, r)


@pytest.mark.parametrize("i,o,gs,bits", [(8192, 1024, 128, 8),
                                         (8192 + 128, 1024, 128, 8),
                                         (2048, 2048, 128, 4), (96, 40, 6, 4),
                                         (8192, 64, 4096, 8)])
def test_quantized_matmul_parts_agree_with_the_kernel(cuda, i, o, gs, bits):
    """The wrapper sizes the workspace with the kernel's count of parts."""
    lib = build.load("quantized_matmul")
    packed = bits == 4
    assert (lib.quantized_matmul_parts(i, o, gs, int(packed))
            == kernels.quantized_matmul_parts(i, o, gs, packed)[0])


# bf16 x, with bf16 scales (a quantized model cast to bf16) and with float32
# ones (a bf16 model quantized after its cast): int8 and packed int4, one
# part and several, 16-, 4- and 1-code loads, CSM's verify and a head whose O
# is no multiple of a tile
QMM_BF16_CASES = [
    (1, 2048, 384, 128, 8), (3, 1024, 200, 64, 4), (1, 8192, 1024, 128, 8),
    (32, 1024, 8192, 128, 8), (1, 2048, 2051, 128, 8), (5, 96, 72, 12, 8),
    (4, 5760, 40, 12, 4), (9, 96, 40, 6, 4), (4, 3072, 2051, 64, 8)]


@pytest.mark.parametrize("scale_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,i,o,gs,bits", QMM_BF16_CASES)
def test_quantized_matmul_bf16_kernel_within_a_bf16_step(cuda, rows, i, o, gs,
                                                         bits, scale_dtype):
    rng = np.random.default_rng(3)
    q = _quantized(rng, i, o, gs, bits, cuda)
    x = _randn(rng, (rows, i), 0.5, cuda).bfloat16()
    args = (x, q.weight, q.scales.to(scale_dtype), q.biases.to(scale_dtype),
            gs, q.packed)
    before = dict(kernels.LAUNCHES)
    got = kernels.quantized_matmul(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["quantized_matmul_bf16"] == before["quantized_matmul_bf16"] + 1
    assert kernels.LAUNCHES["quantized_matmul"] == before["quantized_matmul"]
    assert got.dtype == torch.bfloat16
    exact = kernels.quantized_matmul_plain(x.double(), *args[1:])
    assert kernels.bf16_steps(got, exact) <= 1.0
    plain = kernels.quantized_matmul_plain(*args)
    assert plain.dtype == torch.bfloat16
    assert kernels.bf16_steps(plain, exact) <= 1.0


@pytest.mark.parametrize("scale_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("i,o,bits", [(8192, 1024, 8), (1024, 8192, 8),
                                      (2048, 2048, 4)])
def test_quantized_matmul_bf16_rows_are_independent(cuda, i, o, bits, scale_dtype):
    """The order contract in bf16: each row of a 2-, 8- or 32-row call equals
    the 1-row call on it bit for bit (one rounding after the same sums)."""
    rng = np.random.default_rng(8)
    q = _quantized(rng, i, o, 128, bits, cuda)
    w = (q.weight, q.scales.to(scale_dtype), q.biases.to(scale_dtype), 128, q.packed)
    x = _randn(rng, (32, i), 0.5, cuda).bfloat16()
    ones = [kernels.quantized_matmul(x[r:r + 1], *w)[0] for r in range(32)]
    for rows in (2, 8, 32):
        got = kernels.quantized_matmul(x[:rows], *w)
        for r in range(rows):
            assert torch.equal(got[r], ones[r]), (rows, r)


def test_quantized_matmul_rejects_other_dtype_mixes(cuda):
    """bf16 x takes bf16 or float32 scales and biases of one dtype; float32
    x takes float32 ones; every other mix and f16 raise TypeError."""
    rng = np.random.default_rng(9)
    q = _quantized(rng, 256, 64, 64, 8, cuda)
    x = _randn(rng, (2, 256), 0.5, cuda)
    s, z = q.scales, q.biases
    bad = ((x, s.bfloat16(), z.bfloat16()), (x.half(), s.half(), z.half()),
           (x.bfloat16(), s.bfloat16(), z), (x.bfloat16(), s.half(), z.half()),
           (x.half(), s, z))
    for xb, sb, zb in bad:
        with pytest.raises(TypeError):
            kernels.quantized_matmul(xb, q.weight, sb, zb, 64, False)


def _draft_inputs(device, temp=0.0, layers=2, dm=256, heads=(4, 2), f=512,
                  nc=8, vocab=200):
    """A depth pack of a small llama (head_dim 128, seeded), its caches with
    positions 0 and 1 filled, c1 and noise for nc - 2 steps."""
    from mlx_audio_tpu_torch.models.lm.llama import LlamaConfig, LlamaModel
    from mlx_audio_tpu_torch.nn.pallas_depth import pack_depth

    db = 192
    cfg = LlamaConfig(num_hidden_layers=layers, num_attention_heads=heads[0],
                      num_key_value_heads=heads[1], head_dim=128,
                      hidden_size=dm, intermediate_size=f, rms_norm_eps=1e-5,
                      vocab_size=vocab, max_position_embeddings=64,
                      rope_theta=500_000)
    gen = torch.Generator().manual_seed(0)
    dec = LlamaModel(cfg, use_embed_tokens=False)
    for m in dec.modules():
        if m is not dec and hasattr(m, "init_weights"):
            m.init_weights(gen)
    dec = dec.to(device)
    rng = np.random.default_rng(4)
    packed = pack_depth(dec, _randn(rng, (db, dm), 0.05, device),
                        _randn(rng, (nc - 1, dm, vocab), 0.1, device),
                        _randn(rng, (nc * vocab, db), 0.1, device), vocab)
    kc = torch.zeros(layers, heads[1], 40, 128, device=device)
    vc = torch.zeros_like(kc)
    kc[:, :, :2] = _randn(rng, (layers, heads[1], 2, 128), 0.3, device)
    vc[:, :, :2] = _randn(rng, (layers, heads[1], 2, 128), 0.3, device)
    vpad = packed.heads.shape[1]
    noise = (torch.as_tensor(rng.gumbel(size=(nc - 2, vpad)), dtype=torch.float32,
                             device=device) if temp > 0
             else torch.zeros(nc - 2, vpad, device=device))
    return packed, kc, vc, torch.tensor(3, device=device), noise, vocab


# (temp, top_k, CTAs (0: one a SM), shapes): where the kernel's static
# partition of each matrix over the CTAs and its ring of 16 KB stages meet
# their edges
_DRAFT_CASES = {
    "greedy": (0.0, 0, 0, {}),
    "top-k": (0.9, 20, 0, {}),
    "temperature": (0.9, 0, 0, {}),
    # o and down have 128 columns, fewer than the CTAs of an H100 (132)
    "fewer-columns-than-ctas": (0.0, 0, 0, dict(dm=128, heads=(1, 1), f=256)),
    # 3 and 7 CTAs: no matrix splits evenly, and a CTA's gate/up share
    # (87 KB) is many stages, so the ring wraps within a phase
    "three-ctas": (0.0, 0, 3, {}),
    "three-ctas-sampled": (0.9, 20, 3, {}),
    "seven-ctas": (0.9, 20, 7, {}),
    "one-step": (0.0, 0, 0, dict(nc=3)),
    "thirty-steps": (0.9, 20, 0, dict(nc=32)),
    "thirty-steps-three-ctas": (0.0, 0, 3, dict(nc=32)),
    # Vp = DRAFT_MAX_VPAD, with and without padded lanes
    "vpad-at-the-limit": (0.9, 50, 0, dict(vocab=4096, nc=4)),
    "vpad-at-the-limit-padded": (0.0, 0, 0, dict(vocab=4000, nc=4)),
    # llama-100M widths: 8 KB down columns (two a stage), 2 KB gate/up pairs
    "llama-100m-widths": (0.9, 50, 0, dict(layers=1, dm=1024, heads=(8, 2),
                                            f=8192, nc=4, vocab=2051)),
    "llama-100m-widths-seven-ctas": (0.0, 0, 7, dict(layers=1, dm=1024,
                                                     heads=(8, 2), f=8192,
                                                     nc=4, vocab=2051)),
}


@pytest.mark.parametrize("case", list(_DRAFT_CASES))
def test_depth_draft_kernel_gives_the_plain_tokens(cuda, case):
    from mlx_audio_tpu_torch.nn.pallas_depth import depth_draft_plain

    temp, top_k, ctas, shapes = _DRAFT_CASES[case]
    packed, kc, vc, c1, noise, vocab = _draft_inputs(cuda, temp, **shapes)
    if case.startswith("vpad"):
        assert noise.shape[1] == kernels.DRAFT_MAX_VPAD
    before = kernels.LAUNCHES["depth_draft"]
    got = kernels._depth_draft(packed, kc, vc, c1, noise, vocab, temp, top_k, ctas)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["depth_draft"] == before + 1
    ref = depth_draft_plain(packed, kc, vc, c1, noise, vocab, temp, top_k)
    assert torch.equal(got.cpu(), ref.cpu())


def test_depth_draft_kernel_launches_are_bitwise_equal(cuda):
    packed, kc, vc, c1, noise, vocab = _draft_inputs(cuda, 0.9, nc=32)
    first = kernels.depth_draft(packed, kc, vc, c1, noise, vocab, 0.9, 20)
    second = kernels.depth_draft(packed, kc, vc, c1, noise, vocab, 0.9, 20)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    # the wrapper works on copies: the caller's caches are untouched
    assert not kc[:, :, 2:].any() and not vc[:, :, 2:].any()


def test_depth_draft_reads_only_its_own_launchs_words(cuda):
    """Launches of two shapes in turn share one exchange, which is not
    zeroed between them: each gives the plain tokens, also when every word
    it finds carries the last launch's last tag, when its own tags reach
    2**32 - 1, and when they would wrap (the wrapper then zeroes the
    exchange and starts the tags again)."""
    from mlx_audio_tpu_torch.nn.pallas_depth import depth_draft_plain

    cases = [(_draft_inputs(cuda, 0.9, nc=32), 0.9),
             (_draft_inputs(cuda, 0.0, layers=1, nc=4), 0.0)]
    refs = [depth_draft_plain(*a, temp, 20) for a, temp in cases]
    key = (cases[0][0][1].device, torch.cuda.current_stream(cuda).cuda_stream)
    for i in range(5):
        (a, temp), ref = cases[i % 2], refs[i % 2]
        if i == 2:  # every word stale: other values, the last launch's last tag
            xch, base = kernels._DRAFT_EXCHANGES[key]
            xch.copy_((base << 32) | (xch & 0xffffffff))
        if i == 3:  # this launch's tags end at 2**32 - 1
            xch, _ = kernels._DRAFT_EXCHANGES[key]
            kernels._DRAFT_EXCHANGES[key] = (xch, kernels.DRAFT_TAG_LIMIT - 2)
        got = kernels.depth_draft(*a, temp, 20)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), ref.cpu()), i
    # the fifth launch's 30 tags would have wrapped: they start again from 1
    assert kernels._DRAFT_EXCHANGES[key][1] == 30


@pytest.mark.parametrize("mode", list(kernels.DRAFT_SYNC_MODES))
def test_depth_draft_sync_only_probe_runs(cuda, mode):
    kernels.depth_draft_sync_only(510, mode, cuda)
    torch.cuda.synchronize()


def _probe_weights(dtype, device, n_layers=4, dm=1024, cols=28 * 1024):
    rng = np.random.default_rng(5)
    w = torch.as_tensor(rng.integers(-127, 127, size=(n_layers, dm, cols)).astype(np.int8))
    if dtype == "bf16":
        w = w.to(torch.bfloat16)
    x = torch.as_tensor(rng.integers(-127, 127, size=(1, dm), dtype=np.int8))
    return w.to(device), x.to(device)


@pytest.mark.parametrize("mode,dtype", [
    (m, d) for m in ("dma", "dmac", "dma8", "dmabig") for d in ("int8", "bf16")
] + [("mxu", "int8")])
def test_probe_depth_kernel_equals_plain(cuda, mode, dtype):
    w, x = _probe_weights(dtype, cuda)
    chunked = kernels.chunked_layout(w, 4096)
    before = kernels.LAUNCHES["probe_depth"]
    if mode == "dma":
        got = kernels.probe_depth(w, x, mode, 3, 4096)
    else:
        got = kernels.probe_depth(chunked, x, mode, 3)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["probe_depth"] == before + 1
    ref = (kernels.probe_dot_plain(chunked[0], x, 3 * chunked.shape[0])
           if mode == "mxu" else kernels.probe_stream_plain(chunked, 3))
    assert int(got) == int(ref)


def test_probe_vpu_kernel_equals_plain(cuda):
    w, _ = _probe_weights("int8", cuda)
    chunk0 = kernels.chunked_layout(w, 4096)[0]
    x3 = torch.as_tensor(np.random.default_rng(6).integers(
        -127, 127, size=(128, 8, 128), dtype=np.int8), device=cuda)
    got = kernels.probe_vpu(chunk0.reshape(128, 8, 4096), x3, 3, 28)
    torch.cuda.synchronize()
    ref = kernels.probe_dot_plain(chunk0, x3[:, :, 0].reshape(-1), 3 * 28)
    assert int(got) == int(ref)


@pytest.mark.parametrize("dtype", ["int8", "bf16"])
def test_probe_auto_kernel_equals_plain(cuda, dtype):
    w, _ = _probe_weights(dtype, cuda, dm=256, cols=3 * 1024)
    chunked = kernels.chunked_layout(w, 1024)
    got = kernels.probe_auto(chunked, 2)
    torch.cuda.synchronize()
    assert int(got) == int(kernels.probe_stream_plain(chunked, 2))
