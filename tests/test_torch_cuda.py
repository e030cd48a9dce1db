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


@pytest.mark.parametrize("temp,top_k", [(0.0, 0), (0.9, 20)])
def test_depth_draft_kernel_gives_the_plain_tokens(cuda, temp, top_k):
    from mlx_audio_tpu_torch.models.lm.llama import LlamaConfig, LlamaModel
    from mlx_audio_tpu_torch.nn.pallas_depth import depth_draft_plain, pack_depth

    nc, vocab, db = 8, 200, 192
    cfg = LlamaConfig(num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, head_dim=128, hidden_size=256,
                      intermediate_size=512, rms_norm_eps=1e-5,
                      vocab_size=vocab, max_position_embeddings=64,
                      rope_theta=500_000)
    gen = torch.Generator().manual_seed(0)
    dec = LlamaModel(cfg, use_embed_tokens=False)
    for m in dec.modules():
        if m is not dec and hasattr(m, "init_weights"):
            m.init_weights(gen)
    dec = dec.to(cuda)
    rng = np.random.default_rng(4)
    packed = pack_depth(dec, _randn(rng, (db, 256), 0.05, cuda),
                        _randn(rng, (nc - 1, 256, vocab), 0.1, cuda),
                        _randn(rng, (nc * vocab, db), 0.1, cuda), vocab)
    kc = torch.zeros(2, 2, 40, 128, device=cuda)
    vc = torch.zeros_like(kc)
    kc[:, :, :2] = _randn(rng, (2, 2, 2, 128), 0.3, cuda)
    vc[:, :, :2] = _randn(rng, (2, 2, 2, 128), 0.3, cuda)
    vpad = packed.heads.shape[1]
    noise = (torch.as_tensor(rng.gumbel(size=(nc - 2, vpad)), dtype=torch.float32,
                             device=cuda) if temp > 0
             else torch.zeros(nc - 2, vpad, device=cuda))
    c1 = torch.tensor(3, device=cuda)
    got = kernels.depth_draft(packed, kc, vc, c1, noise, vocab, temp, top_k)
    torch.cuda.synchronize()
    ref = depth_draft_plain(packed, kc, vc, c1, noise, vocab, temp, top_k)
    assert torch.equal(got.cpu(), ref.cpu())


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
