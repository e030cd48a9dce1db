"""The port's hand-written CUDA kernels: wrappers, plain versions, counters.

Counterpart of ``mlx_audio_tpu/nn/pallas_ops.py`` and of the kernel in
``mlx_audio_tpu/nn/pallas_depth.py``.  Three kernels carry the Kokoro-82M
main path:

* ``lstm`` (``csrc/lstm.cu``) replaces ``lstm_pallas``: one cluster of 8
  CTAs a batch row, each with its slice of the recurrent weight on chip,
  ``h`` exchanged through distributed shared memory (``lstm_route`` sends
  the hidden sizes it does not take to a one-block-a-row kernel);
* ``dilated_conv1d`` (``csrc/dilated_conv1d.cu``) replaces
  ``dilated_conv1d_pallas``: an implicit-GEMM conv on the tensor cores
  whose taps read one staged window ``d`` rows apart;
* ``banded_conv1d`` (``csrc/banded_conv1d.cu``) replaces
  ``banded_conv1d_pallas``: the same implicit GEMM at dilation 1 that
  forms no band; its plain version keeps the banded formulation, with
  ``banded_weight`` the port of ``_banded_weight``.

Two carry CSM-1B's quantized, speculative decode:

* ``quantized_matmul`` (``csrc/quantized_matmul.cu``) replaces
  ``quantized_matmul``;
* ``depth_draft`` (``csrc/depth_draft.cu``) replaces
  ``depth_draft_pallas``: on every SM a producer warp streams the CTA's
  share of every matrix through a ring of shared-memory stages with bulk
  copies, consumer warps compute from it, and each product's outputs pass
  between SMs as tagged words; its plain version is
  ``nn.pallas_depth.depth_draft_plain``.

Three are the depth-draft probes of ``scripts/probe_depth.py``, which time
one draft step's weight stream and its batch-1 int8 arithmetic apart
(entry point: ``mlx_audio_tpu_torch.scripts.probe_depth``):

* ``probe_depth`` (``csrc/probe_depth.cu``) replaces ``make(mode)``: the
  stream modes ``dma``, ``dmac``, ``dma8``, ``dmabig`` and the tensor-core
  ``mxu`` mode;
* ``probe_vpu`` (``csrc/probe_vpu.cu``) replaces ``make_vpu()``;
* ``probe_auto`` (``csrc/probe_auto.cu``) replaces ``make_auto()``.

The TPU probes return no defined value; each port probe returns an exact
int64 that depends on every byte it streams or every product it computes
(``probe_stream_plain``, ``probe_dot_plain``).

Each wrapper takes its plain PyTorch version for a tensor that lies on the
CPU, and only then.  For a CUDA tensor it launches the kernel or raises:
there is no fallback.  Every launch adds one to the kernel's entry in
``LAUNCHES``, so a run can show that it went through the kernels.

The three Kokoro kernels and ``quantized_matmul`` take float32 or bf16
(``BF16_KERNELS``): a bf16 launch runs the kernel's bf16 variant, built from
the same source, and counts under ``<name>_bf16``; it accumulates in float32
and rounds each output to bf16 once, as the plain version does (float32
compute, one rounding).  ``quantized_matmul``'s bf16 variant takes bf16
activations with bf16 or float32 scales and biases, as the TPU kernel does.
Every other dtype raises ``TypeError`` on the card, and so does bf16 for
the depth draft, whose caches are float32 in the JAX package too.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch
import torch.nn.functional as F

from mlx_audio_tpu_torch import build
from mlx_audio_tpu_torch.nn.pallas_depth import PackedDepth, depth_draft_plain

LAUNCHES = {"lstm": 0, "dilated_conv1d": 0, "banded_conv1d": 0,
            "lstm_bf16": 0, "dilated_conv1d_bf16": 0, "banded_conv1d_bf16": 0,
            "quantized_matmul": 0, "quantized_matmul_bf16": 0, "depth_draft": 0, "probe_depth": 0,
            "probe_vpu": 0, "probe_auto": 0}
# the kernels with a bf16 variant, counted in LAUNCHES as "<name>_bf16"
BF16_KERNELS = ("lstm", "dilated_conv1d", "banded_conv1d", "quantized_matmul")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "lstm": ("lstm_forward", [_P] * 8 + [_I] * 4 + [_P]),
    "dilated_conv1d": ("dilated_conv1d_forward", [_P] * 3 + [_I] * 6 + [_P]),
    "banded_conv1d": ("banded_conv1d_forward", [_P] * 3 + [_I] * 5 + [_P]),
    "lstm_bf16": ("lstm_forward_bf16", [_P] * 8 + [_I] * 4 + [_P]),
    "dilated_conv1d_bf16": ("dilated_conv1d_forward_bf16",
                            [_P] * 3 + [_I] * 6 + [_P]),
    "banded_conv1d_bf16": ("banded_conv1d_forward_bf16",
                           [_P] * 3 + [_I] * 5 + [_P]),
    "quantized_matmul": ("quantized_matmul_forward", [_P] * 6 + [_I] * 5 + [_P]),
    "quantized_matmul_bf16": ("quantized_matmul_forward_bf16",
                              [_P] * 6 + [_I] * 6 + [_P]),
    "depth_draft": ("depth_draft_forward",
                    [_P] * 21 + [ctypes.c_uint] + [_I] * 13 + [_F] * 2 + [_P]),
    "probe_depth": ("probe_depth_forward", [_P] * 3 + [_I] * 7 + [_P]),
    "probe_vpu": ("probe_vpu_forward", [_P] * 3 + [_I] * 4 + [_P]),
    "probe_auto": ("probe_auto_forward", [_P] * 2 + [_I] * 5 + [_P]),
}

# shared memory one Hopper block may use (227 KB)
SMEM_LIMIT_BYTES = 232448
# csrc/banded_conv1d.cu and csrc/dilated_conv1d.cu: kTileM, kTileN; window
# rows padded by 16 bytes, weight rows by 8 values
_MMA_TILE_M, _MMA_TILE_N = 192, 128
# csrc/dilated_conv1d.cu kConfigs and kConfigsBf16: (channel slice, stages),
# in the order tried
_DILATED_CONFIGS = {torch.float32: ((32, 2), (8, 3), (8, 2)),
                    torch.bfloat16: ((32, 2), (16, 3), (16, 2))}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    for route in LSTM_ROUTE_LAUNCHES:
        LSTM_ROUTE_LAUNCHES[route] = 0


# entry points that are not launches: name -> (argument types, result type)
_QUERIES = {
    "depth_draft": {"depth_draft_exchange_words": ([_I] * 7, ctypes.c_longlong)},
}


def _source(name: str) -> str:
    """The kernel whose source (and library) holds ``name``: a bf16 variant
    lives with its float32 kernel."""
    return name.removesuffix("_bf16")


def _library(name: str, variant=None):
    """The port's build of kernel ``name``, or ``variant``, a library built
    from the same source with other flags (the tune scripts), with the
    types of its C entry points declared."""
    lib = build.load(_source(name)) if variant is None else variant
    fn_name, argtypes = _SIGNATURES[name]
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        err = getattr(lib, f"{_source(name)}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        for query, (types, result) in _QUERIES.get(name, {}).items():
            getattr(lib, query).argtypes = types
            getattr(lib, query).restype = result
    return lib


def _launch(name: str, device: torch.device, *args, variant=None) -> None:
    """Launches kernel ``name`` on the current stream of ``device`` and
    counts it in ``LAUNCHES``; a ``variant``'s launches are not counted."""
    lib = _library(name, variant)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = getattr(lib, _SIGNATURES[name][0])(*args, stream)
    if code != 0:
        msg = getattr(lib, f"{_source(name)}_error_string")(code)
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {code} "
                           f"({msg.decode()})")
    if variant is None:
        LAUNCHES[name] += 1


def _on_cpu(name: str, *tensors: torch.Tensor, other=()) -> bool:
    """True when the plain version serves the call; checks what the kernel
    takes when it does not: ``tensors`` float32 (or all bf16 where the
    kernel has a bf16 variant), ``other`` any dtype, all contiguous and on
    one device."""
    dev = (*tensors, *other)[0].device
    if any(t.device != dev for t in (*tensors, *other)):
        raise ValueError(f"{name}: tensors on different devices")
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    dtypes = {t.dtype for t in tensors}
    if tensors and dtypes != {torch.float32} and not (
            name in BF16_KERNELS and dtypes == {torch.bfloat16}):
        kinds = "float32 or bf16" if name in BF16_KERNELS else "float32"
        raise TypeError(f"{name} kernel takes {kinds} (one dtype), got "
                        f"{sorted(map(str, dtypes))}")
    if not all(t.is_contiguous() for t in (*tensors, *other)):
        raise ValueError(f"{name} kernel takes contiguous tensors")
    return False


# bf16_steps: the step of an output below this share of the largest one is
# taken at that share
BF16_STEP_FLOOR = 2.0 ** -10


def bf16_steps(got: torch.Tensor, exact: torch.Tensor) -> float:
    """The largest error of ``got`` against ``exact`` in bf16 steps: each
    |got - exact| over the spacing of bf16 values at |exact| (2^(e - 7) for
    2^e <= |exact| < 2^(e + 1)), |exact| floored at BF16_STEP_FLOOR times
    the largest |exact|.  A bf16 output within one step of a float64 result
    gives at most 1."""
    got, exact = got.double(), exact.double()
    mag = exact.abs()
    top = float(mag.max()) if mag.numel() else 0.0
    mag = mag.clamp(min=max(top * BF16_STEP_FLOOR, 1e-30))
    step = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(((got - exact).abs() / step).max()) if mag.numel() else 0.0


def _kernel_name(name: str, t: torch.Tensor) -> str:
    """The LAUNCHES and _SIGNATURES name of ``name``'s launch on ``t``."""
    return f"{name}_bf16" if t.dtype == torch.bfloat16 else name


def _compute_dtype(dt: torch.dtype) -> torch.dtype:
    """What a plain version computes in: float32 for bf16 (one rounding of
    the result), the input's own dtype for float32 and float64."""
    return torch.promote_types(dt, torch.float32)


# ---------------------------------------------------------------------------
# LSTM recurrence
# ---------------------------------------------------------------------------

# csrc/lstm.cu: CTAs of a cluster (one cluster a batch row), threads a gate
# column (each sums a quarter of k), and the most of k one thread holds in
# registers (so H <= 256 on the cluster route)
LSTM_CLUSTER_SIZE = 8
LSTM_K_SPLIT = 4
LSTM_MAX_K = 64
# LAUNCHES["lstm"] split by the route each launch took
LSTM_ROUTE_LAUNCHES = {"cluster": 0, "row": 0}


def lstm_route(h: int) -> str:
    """The LSTM kernel that takes hidden size ``h`` (``lstm_route`` in
    csrc/lstm.cu): "cluster" where a thread's quarter of k is whole float4s
    (h % 16 == 0), a CTA's units are whole (h % 8 == 0) and its weight
    slice fits in registers (h <= 256: 64 floats a thread at 2 h threads a
    CTA); "row", the one-block-a-row kernel, for every other h."""
    threads = 4 * LSTM_K_SPLIT * h // LSTM_CLUSTER_SIZE
    fits = (16 <= h <= LSTM_K_SPLIT * LSTM_MAX_K and h % 16 == 0
            and h % LSTM_CLUSTER_SIZE == 0 and threads % 32 == 0
            and threads <= 1024)
    return "cluster" if fits else "row"


def lstm_max_active_clusters(h: int) -> int:
    """``cudaOccupancyMaxActiveClusters`` of the cluster route's launch at
    hidden size ``h`` on the current card: how many batch rows run at once."""
    lib = build.load("lstm")
    lib.lstm_max_active_clusters.argtypes = [_I, ctypes.POINTER(_I)]
    n = _I(0)
    code = lib.lstm_max_active_clusters(h, ctypes.byref(n))
    if code:
        raise RuntimeError(f"lstm: cudaOccupancyMaxActiveClusters failed: "
                           f"CUDA error {code}")
    return n.value


def lstm_plain(x_proj, wh, h0, c0):
    """Plain version of the LSTM kernel: gates = x_proj[:, t] + h @ wh in
    torch gate order i, f, g, o, state carried in float32 (float64 for a
    float64 input), outputs rounded to x_proj's dtype once."""
    hdim = h0.shape[-1]
    ct = _compute_dtype(x_proj.dtype)
    h, c = h0.to(ct), c0.to(ct)
    w = wh.to(ct)
    hs, cs = [], []
    for t in range(x_proj.shape[1]):
        gates = x_proj[:, t].to(ct) + h @ w
        i = torch.sigmoid(gates[:, :hdim])
        f = torch.sigmoid(gates[:, hdim:2 * hdim])
        g = torch.tanh(gates[:, 2 * hdim:3 * hdim])
        o = torch.sigmoid(gates[:, 3 * hdim:])
        c = f * c + i * g
        h = o * torch.tanh(c)
        hs.append(h)
        cs.append(c)
    dt = x_proj.dtype
    return (torch.stack(hs, 1).to(dt), torch.stack(cs, 1).to(dt),
            (h.to(dt), c.to(dt)))


def lstm(x_proj: torch.Tensor, wh: torch.Tensor, h0: torch.Tensor,
         c0: torch.Tensor):
    """Fused LSTM recurrence, the signature of ``lstm_pallas``.

    x_proj: [B, T, 4H] input projections (x @ Wx^T + b_ih + b_hh),
    wh:     [H, 4H] recurrent weight (transposed torch W_hh),
    h0/c0:  [B, H] initial state.
    Returns (hidden states [B, T, H], cell states [B, T, H], (h_T, c_T)),
    in the inputs' dtype (float32 or bf16; the state is float32 either way).
    On the card it launches the kernel ``lstm_route(H)`` names, or its bf16
    variant.
    """
    if _on_cpu("lstm", x_proj, wh, h0, c0):
        return lstm_plain(x_proj, wh, h0, c0)
    b, t, h4 = x_proj.shape
    h = h4 // 4
    if h4 != 4 * h or wh.shape != (h, h4) or h0.shape != (b, h) or c0.shape != (b, h):
        raise ValueError(f"lstm: shapes x_proj {tuple(x_proj.shape)}, wh "
                         f"{tuple(wh.shape)}, h0 {tuple(h0.shape)}")
    hs = torch.empty((b, t, h), device=x_proj.device, dtype=x_proj.dtype)
    cs = torch.empty_like(hs)
    h_last = torch.empty((b, h), device=x_proj.device, dtype=x_proj.dtype)
    c_last = torch.empty_like(h_last)
    route = lstm_route(h)
    _launch(_kernel_name("lstm", x_proj), x_proj.device, x_proj.data_ptr(), wh.data_ptr(),
            h0.data_ptr(), c0.data_ptr(), hs.data_ptr(), cs.data_ptr(),
            h_last.data_ptr(), c_last.data_ptr(), b, t, h,
            int(route == "cluster"))
    LSTM_ROUTE_LAUNCHES[route] += 1
    return hs, cs, (h_last, c_last)


# ---------------------------------------------------------------------------
# The two 3xTF32 implicit-GEMM convolutions: dilated, and dense (banded in
# its plain version)
# ---------------------------------------------------------------------------


def _mma_conv_smem_bytes(k: int, span: int, channels: int, stages: int,
                         dtype: torch.dtype = torch.float32) -> int:
    """Shared memory of one block of the conv kernels: ``stages`` stages of
    the halo window (192 + span rows of ``channels``, padded by 16 bytes)
    and K [channels, 128] weight slices (padded by 8 values); float32 keeps
    the split remainder of one window besides, bf16 splits nothing."""
    size = torch.empty((), dtype=dtype).element_size()
    window = (_MMA_TILE_M + span) * (channels + 16 // size)
    weights = k * channels * (_MMA_TILE_N + 8)
    split = window if dtype == torch.float32 else 0
    return size * (stages * (window + weights) + split)


def _check_mma_conv(name: str, x: torch.Tensor, w: torch.Tensor,
                    smem: int) -> None:
    """What the 3xTF32 conv kernels take: K odd, C and Cout multiples of 8,
    16-byte aligned x and w, a block's shared memory within the limit."""
    b, l, c = x.shape
    k, c_w, c_out = w.shape
    if (c_w != c or k % 2 == 0 or b < 1 or l < 1 or c % 8 or c_out % 8
            or x.data_ptr() % 16 or w.data_ptr() % 16):
        raise ValueError(f"{name}: x {tuple(x.shape)}, w {tuple(w.shape)}: "
                         "the kernel takes K odd, C and Cout multiples of 8, "
                         "16-byte aligned tensors")
    if smem > SMEM_LIMIT_BYTES:
        raise ValueError(f"{name}: w {tuple(w.shape)} needs {smem} bytes of "
                         "shared memory, more than a block has")


def dilated_conv1d_smem_bytes(k: int, dilation: int,
                              dtype: torch.dtype = torch.float32) -> int:
    """Shared memory of one dilated_conv1d block (csrc/dilated_conv1d.cu),
    or of its bf16 variant: that of the first (slice, stages) in
    ``_DILATED_CONFIGS`` that fits a block, or of the last when none does."""
    span = (k - 1) * dilation
    for channels, stages in _DILATED_CONFIGS[dtype]:
        smem = _mma_conv_smem_bytes(k, span, channels, stages, dtype)
        if smem <= SMEM_LIMIT_BYTES:
            break
    return smem


def dilated_conv1d_plain(x, w, dilation: int = 1):
    """Plain version: sum over taps of the shifted input times w[k], in
    float32 for bf16 operands, rounded to their dtype once."""
    dt = x.dtype
    x, w = x.to(_compute_dtype(dt)), w.to(_compute_dtype(dt))
    _, l, _ = x.shape
    k = w.shape[0]
    span = (k - 1) * dilation
    pad = span // 2
    xp = F.pad(x, (0, 0, pad, span - pad))
    out = xp[:, :l] @ w[0]
    for tap in range(1, k):
        out = out + xp[:, tap * dilation:tap * dilation + l] @ w[tap]
    return out.to(dt)


def dilated_conv1d(x: torch.Tensor, w: torch.Tensor,
                   dilation: int = 1) -> torch.Tensor:
    """'Same'-padded dilated conv, NLC: x [B, L, C] * w [K, C, Cout] ->
    [B, L, Cout].  K odd.  The kernel computes 3xTF32 products on the
    tensor cores (bf16 products for bf16 operands, into float32 sums), every
    tap reading one staged window at row offset tap * dilation; it takes C
    and Cout multiples of 8, 16-byte aligned x and w, and a window whose
    stages fit a block's shared memory.  The output has x's dtype."""
    if _on_cpu("dilated_conv1d", x, w):
        return dilated_conv1d_plain(x, w, dilation)
    if dilation < 1:
        raise ValueError(f"dilated_conv1d: dilation {dilation}")
    k = w.shape[0]
    _check_mma_conv("dilated_conv1d", x, w,
                    dilated_conv1d_smem_bytes(k, dilation, x.dtype))
    b, l, c = x.shape
    c_out = w.shape[2]
    out = torch.empty((b, l, c_out), device=x.device, dtype=x.dtype)
    _launch(_kernel_name("dilated_conv1d", x), x.device, x.data_ptr(), w.data_ptr(),
            out.data_ptr(), b, l, c, c_out, k, dilation)
    return out


def banded_conv1d_smem_bytes(k: int, dtype: torch.dtype = torch.float32) -> int:
    """Shared memory of one banded_conv1d block (csrc/banded_conv1d.cu):
    three stages of a window of 192 + K - 1 rows, of 8 channels (16 in the
    bf16 variant)."""
    return _mma_conv_smem_bytes(k, k - 1, 8 if dtype == torch.float32 else 16,
                                3, dtype)


def banded_groups(k: int) -> int:
    """Q: the 8-row groups a window spans, 1 + ceil((K-1)/8)."""
    return 1 + -(-(k - 1) // 8)


def banded_weight(w: torch.Tensor, q_groups: int) -> torch.Tensor:
    """w [K, C, Cout] -> W_band [(8*q_groups)*C, 8*Cout] with
    W_band[(j+tap)*C + c, j*Cout + o] = w[tap, c, o]."""
    k, c, c_out = w.shape
    w8 = 8 * q_groups
    wb = w.new_zeros((w8, 8, c, c_out))
    for j in range(8):
        wb[j:j + k, j] = w
    return wb.permute(0, 2, 1, 3).reshape(w8 * c, 8 * c_out)


def banded_conv1d_plain(x, w):
    """Plain version: one matmul per window group against W_band, summed
    over the Q groups, on the [L/8, 8C] view of the padded signal; in
    float32 for bf16 operands, rounded to their dtype once."""
    dt = x.dtype
    x, w = x.to(_compute_dtype(dt)), w.to(_compute_dtype(dt))
    b, l, c = x.shape
    k, _, c_out = w.shape
    q_groups = banded_groups(k)
    groups = -(-l // 8)
    pad = (k - 1) // 2
    rows = 8 * (groups + q_groups - 1)
    xr = F.pad(x, (0, 0, pad, rows - l - pad)).reshape(b, rows // 8, 8 * c)
    wb = banded_weight(w, q_groups)
    eight_c = 8 * c
    out = xr[:, :groups] @ wb[:eight_c]
    for q in range(1, q_groups):
        out = out + xr[:, q:q + groups] @ wb[q * eight_c:(q + 1) * eight_c]
    return out.reshape(b, 8 * groups, c_out)[:, :l].to(dt)


def banded_conv1d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Dense (dilation-1) 'same'-padded conv, NLC: x [B, L, C] * w
    [K, C, Cout] -> [B, L, Cout].  K odd.  The kernel reads w as it is and
    forms no banded weight (3xTF32 products on the tensor cores, bf16 ones
    for bf16 operands); the plain version still goes through W_band.  The
    kernel takes C and Cout multiples of 8, 16-byte aligned x and w, and K
    up to 13.  The output has x's dtype."""
    if _on_cpu("banded_conv1d", x, w):
        return banded_conv1d_plain(x, w)
    k = w.shape[0]
    _check_mma_conv("banded_conv1d", x, w, banded_conv1d_smem_bytes(k, x.dtype))
    b, l, c = x.shape
    c_out = w.shape[2]
    out = torch.empty((b, l, c_out), device=x.device, dtype=x.dtype)
    _launch(_kernel_name("banded_conv1d", x), x.device, x.data_ptr(), w.data_ptr(),
            out.data_ptr(), b, l, c, c_out, k)
    return out


# ---------------------------------------------------------------------------
# Weight-only dequantize-matmul
# ---------------------------------------------------------------------------


def quantized_matmul_plain(x, codes, scales, biases, group_size: int,
                           packed: bool = False):
    """Plain version: dequantize the whole weight, then one matmul, both in
    float32 for bf16 x (the output rounded to bf16 once) and in x's dtype
    for float32 and float64."""
    ct = _compute_dtype(x.dtype)
    q = torch.cat([codes & 0xF, codes >> 4], dim=-1) if packed else codes
    o, i = q.shape
    w = (q.reshape(o, i // group_size, group_size).to(ct)
         * scales.to(ct)[..., None] + biases.to(ct)[..., None]).reshape(o, i)
    return (x.to(ct) @ w.t()).to(x.dtype)


# csrc/quantized_matmul.cu kPartCols: stored columns a part, at most
QMM_PART_COLS = 2048


def quantized_matmul_parts(i: int, o: int, group_size: int,
                           packed: bool) -> tuple[int, int]:
    """(parts, P): the kernel cuts the I (or I/2 packed) stored columns into
    ``parts`` pieces of P columns, the last one possibly shorter.  P is the
    most columns up to ``QMM_PART_COLS`` that are a multiple of the group
    size (``QMM_PART_COLS`` itself, a multiple of 16, when a group is
    longer), or all of them when they fit.  It depends on these arguments
    alone, never on the row count, so every row count sums in one order;
    ``o`` does not change it today.  Mirrors ``quantized_matmul_parts`` of
    csrc/quantized_matmul.cu, which returns the count."""
    stored = i // 2 if packed else i
    if group_size <= QMM_PART_COLS:
        cols = QMM_PART_COLS // group_size * group_size
    else:
        cols = QMM_PART_COLS
    cols = min(cols, stored)
    return -(-stored // cols), cols


def quantized_matmul(x: torch.Tensor, codes: torch.Tensor,
                     scales: torch.Tensor, biases: torch.Tensor,
                     group_size: int, packed: bool = False) -> torch.Tensor:
    """y [B, O] = x [B, I] @ (q * scale + bias)^T with grouped affine uint8
    codes [O, I], or two 4-bit codes a byte [O, I/2] in the concat-half
    layout when ``packed``; scales and biases [O, I / group_size].  The
    dense weight is never formed.  The kernel sums each of
    ``quantized_matmul_parts`` pieces of I apart and adds the parts in
    ascending order (a second launch, into y, where there is more than one),
    so a row's result does not depend on the rows batched with it.

    x is float32 or bf16, and the output takes its dtype; scales and
    biases share one dtype, x's or float32 (bf16 x with float32 scales, as
    a bf16 model quantized after its cast holds them).  A bf16 launch runs
    the bf16 variant (``LAUNCHES["quantized_matmul_bf16"]``): x and the
    scales converted to float32 on load, float32 sums, one rounding."""
    if _on_cpu("quantized_matmul", x, other=(codes, scales, biases)):
        return quantized_matmul_plain(x, codes, scales, biases, group_size,
                                      packed)
    if scales.dtype != biases.dtype or scales.dtype not in (x.dtype, torch.float32):
        raise TypeError(f"quantized_matmul kernel takes scales and biases of "
                        f"x's dtype {x.dtype} or float32 (one dtype), got "
                        f"{scales.dtype} and {biases.dtype}")
    rows, i = x.shape
    o, stored = codes.shape
    groups = i // group_size if group_size > 0 else 0
    if (codes.dtype != torch.uint8 or group_size <= 0 or i % group_size
            or stored != (i // 2 if packed else i) or (packed and i % 2)
            or scales.shape != (o, groups) or biases.shape != (o, groups)
            or rows < 1):
        raise ValueError(
            f"quantized_matmul: x {tuple(x.shape)}, codes {tuple(codes.shape)} "
            f"{codes.dtype}, scales {tuple(scales.shape)}, group_size "
            f"{group_size}, packed {packed}")
    y = torch.empty((rows, o), device=x.device, dtype=x.dtype)
    parts, _ = quantized_matmul_parts(i, o, group_size, packed)
    ws = (torch.empty((parts, rows, o), device=x.device, dtype=torch.float32)
          if parts > 1 else None)
    extra = (int(scales.dtype == torch.bfloat16),) if x.dtype == torch.bfloat16 else ()
    _launch(_kernel_name("quantized_matmul", x), x.device, x.data_ptr(),
            codes.data_ptr(), scales.data_ptr(), biases.data_ptr(), y.data_ptr(),
            None if ws is None else ws.data_ptr(), rows, i, o, group_size,
            int(packed), *extra)
    return y


# ---------------------------------------------------------------------------
# CSM depth-decoder draft (30 sequential int8 steps in one launch)
# ---------------------------------------------------------------------------

# depth_draft.cu reads a token's logits into registers, 16 per thread of its
# 256 consumer threads, and h (the MLP's hidden row), 32 per thread
DRAFT_MAX_VPAD = 16 * 256
DRAFT_MAX_F = 32 * 256
# query heads a key/value head (kMaxRep), layers (kMaxLayers)
DRAFT_MAX_REP = 8
DRAFT_MAX_LAYERS = 8
# csrc/depth_draft.cu kStageW: weight bytes of a ring stage; a gate/up pair
# (2 Dm bytes), an o column (Hq Dh) and a kv head's k (or v) slots must
# each fit one.  How many stages fit beside the rest of shared memory the
# kernel counts itself, and its launch fails when the attention's 2 Hkv + 1
# do not.
DRAFT_STAGE_BYTES = 16384
# depth_draft_sync_only's modes and its scratch (int64 words)
DRAFT_SYNC_MODES = {"grid.sync": 0, "barrier": 1, "exchange": 2}
_DRAFT_SYNC_WORDS = 512
# the tags of the draft's exchange are 32-bit
DRAFT_TAG_LIMIT = 2 ** 32 - 1
# (device, stream) -> [exchange, tag base]
_DRAFT_EXCHANGES: dict = {}


def depth_draft_supported(n_layers: int, dm: int, f_inter: int, hq: int,
                          hkv: int, dh: int, n_steps: int, vpad: int) -> bool:
    """Whether csrc/depth_draft.cu takes these shapes: whole 128-groups,
    the logits and h in its consumer threads' registers, every gate/up
    pair, o column and kv head's slots within one ring stage."""
    return (0 < n_layers <= DRAFT_MAX_LAYERS
            and not (dm % 128 or (hq * dh) % 128 or f_inter % 128 or dh % 8)
            and 0 < hkv <= hq and hq % hkv == 0 and hq <= DRAFT_MAX_REP * hkv
            and vpad <= DRAFT_MAX_VPAD and f_inter <= DRAFT_MAX_F
            and max(2 * dm, hq * dh, (n_steps + 1) * dh * 4) <= DRAFT_STAGE_BYTES)


def draft_exchange(device: torch.device, stream: int, words: int,
                   n_steps: int, limit: int = DRAFT_TAG_LIMIT):
    """(exchange, tag base) for one draft launch of ``n_steps`` on
    ``stream``: one int64 exchange a stream, kept across launches.  The
    launch tags its words base + 1 .. base + n_steps, above every tag an
    earlier launch left, so the exchange is zeroed only when it is
    allocated (or grown) and when the tags would pass ``limit``."""
    key = (device, stream)
    xch, base = _DRAFT_EXCHANGES.get(key, (None, 0))
    if xch is None or xch.numel() < words:
        xch = torch.zeros(words, device=device, dtype=torch.int64)
    if base + n_steps > limit:
        xch.zero_()
        base = 0
    _DRAFT_EXCHANGES[key] = (xch, base + n_steps)
    return xch, base


def depth_draft(packed: PackedDepth, cache_k0: torch.Tensor,
                cache_v0: torch.Tensor, c1: torch.Tensor, noise: torch.Tensor,
                vocab: int, temp: float = 0.0, top_k: int = 0) -> torch.Tensor:
    """Draft c2..c31 of one CSM frame, the signature of
    ``depth_draft_pallas``: caches [L, Hkv, Cap, Dh] float32 with positions
    0 and 1 filled, c1 a 0-dim (or [1]) integer tensor, noise [S, Vp]
    Gumbel rows (zeros when greedy).  Returns int32 tokens [S]."""
    return _depth_draft(packed, cache_k0, cache_v0, c1, noise, vocab, temp,
                        top_k)


def _depth_draft(packed: PackedDepth, cache_k0: torch.Tensor,
                 cache_v0: torch.Tensor, c1: torch.Tensor, noise: torch.Tensor,
                 vocab: int, temp: float = 0.0, top_k: int = 0,
                 ctas: int = 0, variant=None) -> torch.Tensor:
    """``depth_draft`` on ``ctas`` CTAs of the cooperative launch (one a SM
    when 0 or more than the SMs), so that a test can give every CTA a long
    share of each matrix; ``variant``: a build variant's library in place of
    the port's build (scripts/tune_depth.py), its launches not counted."""
    tensors = (cache_k0, cache_v0, noise, packed.sqkv, packed.so, packed.sgu,
               packed.sdown, packed.norms, packed.final_norm, packed.sheads,
               packed.rope_cos, packed.rope_sin)
    other = (packed.wqkv, packed.wo, packed.wgu, packed.wdown, packed.heads,
             packed.emb_proj)
    if _on_cpu("depth_draft", *tensors, other=other):
        return depth_draft_plain(packed, cache_k0, cache_v0, c1, noise, vocab,
                                 temp, top_k)
    n_layers, hkv, cap, dh = cache_k0.shape
    cqkv, dm = packed.wqkv.shape[1:]
    f_inter = packed.wdown.shape[2]
    n_steps, vpad = noise.shape
    hq = cqkv // dh - 2 * hkv
    if (any(t.dtype != torch.int8 for t in other[:5])
            or packed.emb_proj.dtype != torch.bfloat16
            or not depth_draft_supported(n_layers, dm, f_inter, hq, hkv, dh,
                                         n_steps, vpad)
            or not 0 < vocab <= vpad or packed.heads.shape[:2] != (n_steps, vpad)
            or not 0 < n_steps <= min(cap, packed.rope_cos.shape[0]) - 2
            or cache_v0.shape != cache_k0.shape
            # bulk copies and 16-byte loads of the int8 rows
            or any(t.data_ptr() % 16 for t in other[:5])):
        raise ValueError(
            f"depth_draft: pack {tuple(packed.wqkv.shape)}, heads "
            f"{tuple(packed.heads.shape)}, cache {tuple(cache_k0.shape)}, "
            f"noise {tuple(noise.shape)}, vocab {vocab}")
    dev = cache_k0.device
    kc, vc = cache_k0.clone(), cache_v0.clone()
    c1 = c1.reshape(1).to(device=dev, dtype=torch.int32)
    tokens = torch.empty(n_steps, device=dev, dtype=torch.int32)
    words = _library("depth_draft", variant).depth_draft_exchange_words(
        n_layers, dm, hq, hkv, dh, f_inter, vpad)
    xch, tag_base = draft_exchange(
        dev, torch.cuda.current_stream(dev).cuda_stream, words, n_steps)
    operands = (
        packed.wqkv, packed.sqkv, packed.wo, packed.so, packed.wgu,
        packed.sgu, packed.wdown, packed.sdown, packed.norms,
        packed.final_norm, packed.heads, packed.sheads, packed.emb_proj,
        packed.rope_cos, packed.rope_sin, kc, vc, noise, c1, tokens, xch)
    _launch("depth_draft", dev, *[t.data_ptr() for t in operands], tag_base,
            n_layers, dm, f_inter, hq, hkv, dh, cap, vocab, vpad, n_steps,
            top_k, packed.rope_cos.shape[0], ctas, float(temp),
            1.0 / math.sqrt(dh), variant=variant)
    return tokens


def depth_draft_sync_only(rounds: int, mode: str, device: torch.device) -> None:
    """The floor of the draft's synchronisation: one launch at the draft's
    shape (one CTA of 288 threads a SM, cooperative) that passes ``rounds``
    synchronisations of every CTA and does no work.  ``mode``:
    ``"exchange"``, the draft's own (every CTA puts one tagged word and
    polls every CTA's); ``"barrier"``, a grid barrier of one counter;
    ``"grid.sync"``, ``cooperative_groups``'.  A measurement probe: it
    computes nothing and is not counted in ``LAUNCHES``."""
    lib = _library("depth_draft")
    fn = lib.depth_draft_sync_only
    fn.argtypes = [_P, _I, _I, _I, _P]
    fn.restype = ctypes.c_int
    scratch = torch.zeros(_DRAFT_SYNC_WORDS, device=device, dtype=torch.int64)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = fn(scratch.data_ptr(), rounds, DRAFT_SYNC_MODES[mode], 0, stream)
    if code:
        msg = lib.depth_draft_error_string(code)
        raise RuntimeError(f"depth_draft_sync_only: CUDA error {code} ({msg.decode()})")


# ---------------------------------------------------------------------------
# Depth-draft probes: one draft step's weight stream and batch-1 s8 dots
# ---------------------------------------------------------------------------

PROBE_MODES = {"dma": 0, "dmac": 1, "dma8": 2, "dmabig": 3, "mxu": 4}
# largest |product| of two values in [-127, 127): a step's int32 sums stay
# below 2**31 when they hold fewer products than this bound allows
_MAX_PRODUCT = 127 * 127


def chunked_layout(w: torch.Tensor, chunk: int) -> torch.Tensor:
    """[L, dm, cols] -> [L * cols / chunk, dm, chunk]: block l * n + j is
    columns [j * chunk, (j + 1) * chunk) of w[l] (the probes' pre-chunked
    layout)."""
    n_layers, dm, cols = w.shape
    n = cols // chunk
    return (w.reshape(n_layers, dm, n, chunk).permute(0, 2, 1, 3)
            .reshape(n_layers * n, dm, chunk).contiguous())


def probe_stream_plain(w_chunked: torch.Tensor, steps: int) -> torch.Tensor:
    """Plain version of the stream probes: steps * sum over chunks c of
    (c + 1) * sum(chunk c), in int64 (the values are integers in int8 or
    bf16)."""
    c = w_chunked.shape[0]
    flat = w_chunked.reshape(c, -1)
    if flat.dtype != torch.int8:
        flat = flat.to(torch.int32)
    sums = flat.sum(1, dtype=torch.int64)
    weights = torch.arange(1, c + 1, device=flat.device, dtype=torch.int64)
    return (sums * weights).sum() * steps


def probe_dot_plain(chunk: torch.Tensor, x: torch.Tensor, reps: int) -> torch.Tensor:
    """Plain version of the dot probes: reps * sum(x @ chunk) in int64, for
    chunk [dm, cw] and x [dm] int8."""
    return (chunk.to(torch.int64) * x.reshape(-1, 1).to(torch.int64)).sum() * reps


def _probe_out(name: str, w: torch.Tensor, *others: torch.Tensor) -> torch.Tensor:
    if any(t.dtype != torch.int8 for t in others):
        raise TypeError(f"{name}: x must be int8")
    if not all(t.is_contiguous() for t in (w, *others)):
        raise ValueError(f"{name} kernel takes contiguous tensors")
    if w.data_ptr() % 16:  # bulk copies and 16-byte loads
        raise ValueError(f"{name} kernel takes 16-byte aligned weights")
    return torch.zeros((), device=w.device, dtype=torch.int64)


def probe_depth(w: torch.Tensor, x: Optional[torch.Tensor], mode: str,
                steps: int, chunk: Optional[int] = None) -> torch.Tensor:
    """The ``make(mode)`` probes over ``steps`` draft steps; an int64 0-dim
    result.  ``dma`` takes the strided weights w [L, dm, cols] and the chunk
    width; the other modes the chunked layout [L * cols / chunk, dm, chunk].
    The stream modes take int8 or bf16 and ignore x; ``mxu`` takes int8 w
    and x [1, dm], and computes on block 0."""
    if mode not in PROBE_MODES:
        raise ValueError(f"probe_depth: mode {mode!r} not in {sorted(PROBE_MODES)}")
    if w.dtype not in (torch.int8, torch.bfloat16) or (
            mode == "mxu" and (w.dtype != torch.int8 or x is None)):
        raise TypeError(f"probe_depth {mode}: w {w.dtype}, x "
                        f"{None if x is None else x.dtype}")
    if mode == "dma":
        n_layers, dm, cols = w.shape
        if chunk is None or chunk < 1 or cols % chunk:
            raise ValueError(f"probe_depth dma: chunk {chunk} must divide {cols}")
    else:
        n_layers, dm, chunk = w.shape
        cols = chunk
    others = (x,) if mode == "mxu" else ()
    if _on_cpu("probe_depth", other=(w, *others)):
        if mode == "mxu":
            return probe_dot_plain(w[0], x, n_layers * steps)
        return probe_stream_plain(chunked_layout(w, chunk) if mode == "dma" else w,
                                  steps)
    if mode == "mxu" and (x.numel() != dm or n_layers * dm * _MAX_PRODUCT >= 2 ** 31):
        raise ValueError(f"probe_depth mxu: x {tuple(x.shape)}, {n_layers} "
                         f"matvecs of dm {dm} a step overflow int32")
    out = _probe_out("probe_depth", w, *others)
    _launch("probe_depth", w.device, w.data_ptr(),
            x.data_ptr() if mode == "mxu" else None, out.data_ptr(),
            PROBE_MODES[mode], w.element_size(), n_layers, dm, cols, chunk,
            steps)
    return out


def probe_vpu(w3: torch.Tensor, x3: torch.Tensor, steps: int,
              reps: int) -> torch.Tensor:
    """The ``make_vpu()`` probe: ``reps`` int8 matvecs a step of x (the first
    column of x3 [dm/8, 8, 128]) with the resident chunk w3 [dm/8, 8, cw]
    read as [dm, cw]; an int64 0-dim result."""
    g, eight, cw = w3.shape
    dm = g * eight
    if w3.dtype != torch.int8 or x3.shape[:2] != (g, eight):
        raise ValueError(f"probe_vpu: w3 {tuple(w3.shape)} {w3.dtype}, x3 "
                         f"{tuple(x3.shape)}")
    x = x3[:, :, 0].reshape(dm).contiguous()
    if _on_cpu("probe_vpu", other=(w3, x)):
        return probe_dot_plain(w3.reshape(dm, cw), x, reps * steps)
    if reps * (dm // 8) * _MAX_PRODUCT >= 2 ** 31:
        raise ValueError(f"probe_vpu: {reps} matvecs of dm {dm} a step "
                         "overflow int32")
    out = _probe_out("probe_vpu", w3, x)
    _launch("probe_vpu", w3.device, w3.data_ptr(), x.data_ptr(),
            out.data_ptr(), dm, cw, reps, steps)
    return out


def probe_auto(w_chunked: torch.Tensor, steps: int) -> torch.Tensor:
    """The ``make_auto()`` probe: stream the chunked weights [C, dm, cw]
    (int8 or bf16) once a step; the stream probes' int64 result."""
    if w_chunked.dtype not in (torch.int8, torch.bfloat16):
        raise TypeError(f"probe_auto: {w_chunked.dtype}")
    if _on_cpu("probe_auto", other=(w_chunked,)):
        return probe_stream_plain(w_chunked, steps)
    c, dm, cw = w_chunked.shape
    out = _probe_out("probe_auto", w_chunked)
    _launch("probe_auto", w_chunked.device, w_chunked.data_ptr(),
            out.data_ptr(), w_chunked.element_size(), c, dm, cw, steps)
    return out
