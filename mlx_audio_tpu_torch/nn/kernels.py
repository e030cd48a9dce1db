"""The port's hand-written CUDA kernels: wrappers, plain versions, counters.

Counterpart of ``mlx_audio_tpu/nn/pallas_ops.py``.  Three kernels carry the
Kokoro-82M main path:

* ``lstm`` (``csrc/lstm.cu``) replaces ``lstm_pallas``;
* ``dilated_conv1d`` (``csrc/dilated_conv1d.cu``) replaces
  ``dilated_conv1d_pallas``;
* ``banded_conv1d`` (``csrc/banded_conv1d.cu``) replaces
  ``banded_conv1d_pallas``, with ``banded_weight`` the port of
  ``_banded_weight``.

Each wrapper takes its plain PyTorch version for a tensor that lies on the
CPU, and only then.  For a CUDA tensor it launches the kernel or raises:
there is no fallback.  Every launch adds one to the kernel's entry in
``LAUNCHES``, so a run can show that it went through the kernels.  The
kernels take float32 only (bf16 is a later slice).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from mlx_audio_tpu_torch import build

LAUNCHES = {"lstm": 0, "dilated_conv1d": 0, "banded_conv1d": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "lstm": ("lstm_forward", [_P] * 8 + [_I] * 3 + [_P]),
    "dilated_conv1d": ("dilated_conv1d_forward", [_P] * 3 + [_I] * 6 + [_P]),
    "banded_conv1d": ("banded_conv1d_forward", [_P] * 3 + [_I] * 5 + [_P]),
}

# shared memory one Hopper block may use (227 KB)
SMEM_LIMIT_BYTES = 232448
_CONV_TILE = 64      # csrc/tile_fma.cuh kTile
_CONV_CHANNELS = 16  # csrc/dilated_conv1d.cu kChannels


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _kernel(name: str):
    """The kernel's C entry point with its argument types declared."""
    lib = build.load(name)
    fn_name, argtypes = _SIGNATURES[name]
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    return fn


def _launch(name: str, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = _kernel(name)(*args, stream)
    if code != 0:
        msg = getattr(build.load(name), f"{name}_error_string")(code)
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {code} "
                           f"({msg.decode()})")
    LAUNCHES[name] += 1


def _on_cpu(name: str, *tensors: torch.Tensor) -> bool:
    """True when the plain version serves the call; checks what the kernel
    takes when it does not."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: tensors on different devices")
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} kernel takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} kernel takes contiguous tensors")
    return False


# ---------------------------------------------------------------------------
# LSTM recurrence
# ---------------------------------------------------------------------------


def lstm_plain(x_proj, wh, h0, c0):
    """Plain version of the LSTM kernel: gates = x_proj[:, t] + h @ wh in
    torch gate order i, f, g, o, state carried in float32."""
    hdim = h0.shape[-1]
    h, c = h0.float(), c0.float()
    hs, cs = [], []
    for t in range(x_proj.shape[1]):
        gates = x_proj[:, t].float() + h @ wh.float()
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
    Returns (hidden states [B, T, H], cell states [B, T, H], (h_T, c_T)).
    """
    if _on_cpu("lstm", x_proj, wh, h0, c0):
        return lstm_plain(x_proj, wh, h0, c0)
    b, t, h4 = x_proj.shape
    h = h4 // 4
    if h4 != 4 * h or wh.shape != (h, h4) or h0.shape != (b, h) or c0.shape != (b, h):
        raise ValueError(f"lstm: shapes x_proj {tuple(x_proj.shape)}, wh "
                         f"{tuple(wh.shape)}, h0 {tuple(h0.shape)}")
    hs = torch.empty((b, t, h), device=x_proj.device, dtype=torch.float32)
    cs = torch.empty_like(hs)
    h_last = torch.empty((b, h), device=x_proj.device, dtype=torch.float32)
    c_last = torch.empty_like(h_last)
    _launch("lstm", x_proj.device, x_proj.data_ptr(), wh.data_ptr(),
            h0.data_ptr(), c0.data_ptr(), hs.data_ptr(), cs.data_ptr(),
            h_last.data_ptr(), c_last.data_ptr(), b, t, h)
    return hs, cs, (h_last, c_last)


# ---------------------------------------------------------------------------
# Dilated conv1d as K shifted matmuls over a halo window
# ---------------------------------------------------------------------------


def dilated_conv1d_smem_bytes(k: int, dilation: int) -> int:
    """Shared memory of one dilated_conv1d block (csrc/dilated_conv1d.cu):
    the halo window of 16 channels plus K [16, 64] weight slices."""
    window = (_CONV_TILE + (k - 1) * dilation) | 1
    return 4 * (_CONV_CHANNELS * window + k * _CONV_CHANNELS * _CONV_TILE)


def dilated_conv1d_plain(x, w, dilation: int = 1):
    """Plain version: sum over taps of the shifted input times w[k]."""
    _, l, _ = x.shape
    k = w.shape[0]
    span = (k - 1) * dilation
    pad = span // 2
    xp = F.pad(x, (0, 0, pad, span - pad))
    out = xp[:, :l] @ w[0]
    for tap in range(1, k):
        out = out + xp[:, tap * dilation:tap * dilation + l] @ w[tap]
    return out


def dilated_conv1d(x: torch.Tensor, w: torch.Tensor,
                   dilation: int = 1) -> torch.Tensor:
    """'Same'-padded dilated conv, NLC: x [B, L, C] * w [K, C, Cout] ->
    [B, L, Cout].  K odd."""
    if _on_cpu("dilated_conv1d", x, w):
        return dilated_conv1d_plain(x, w, dilation)
    b, l, c = x.shape
    k, c_w, c_out = w.shape
    if c_w != c or k % 2 == 0 or dilation < 1:
        raise ValueError(f"dilated_conv1d: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, dilation {dilation}")
    if dilated_conv1d_smem_bytes(k, dilation) > SMEM_LIMIT_BYTES:
        raise ValueError(f"dilated_conv1d: K={k}, d={dilation} needs more "
                         "shared memory than a block has")
    out = torch.empty((b, l, c_out), device=x.device, dtype=torch.float32)
    _launch("dilated_conv1d", x.device, x.data_ptr(), w.data_ptr(),
            out.data_ptr(), b, l, c, c_out, k, dilation)
    return out


# ---------------------------------------------------------------------------
# Banded-matmul dense conv1d
# ---------------------------------------------------------------------------


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
    over the Q groups, on the [L/8, 8C] view of the padded signal."""
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
    return out.reshape(b, 8 * groups, c_out)[:, :l]


def banded_conv1d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Dense (dilation-1) 'same'-padded conv, NLC: x [B, L, C] * w
    [K, C, Cout] -> [B, L, Cout], through the banded weight.  K odd."""
    if _on_cpu("banded_conv1d", x, w):
        return banded_conv1d_plain(x, w)
    b, l, c = x.shape
    k, c_w, c_out = w.shape
    if c_w != c or k % 2 == 0:
        raise ValueError(f"banded_conv1d: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}")
    wb = banded_weight(w, banded_groups(k))
    out = torch.empty((b, l, c_out), device=x.device, dtype=torch.float32)
    _launch("banded_conv1d", x.device, x.data_ptr(), wb.data_ptr(),
            out.data_ptr(), b, l, c, c_out, k)
    return out
