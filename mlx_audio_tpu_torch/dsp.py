"""DSP core for the port: windows, STFT/ISTFT as matmul-DFT, overlap-add, and
the mel filterbank.

Counterpart of ``mlx_audio_tpu/dsp.py``: the same windows (symmetric, or
DFT-even as ``<name>_periodic``), the same STFT, a matmul against a
windowed real-DFT basis (built in float64 numpy, applied in float32), and
the ISTFT the same window-sum normalised overlap-add with the same trims,
so the port rounds where the reference does.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F


@lru_cache(maxsize=None)
def _window_np(name: str, size: int) -> np.ndarray:
    if size == 1:
        return np.ones(1)
    # "<name>_periodic" = DFT-even windows (torch.hann_window's default)
    if name.endswith("_periodic"):
        return _window_np(name[: -len("_periodic")], size + 1)[:-1]
    n = np.arange(size, dtype=np.float64)
    if name in ("hann", "hanning"):
        return 0.5 * (1 - np.cos(2 * np.pi * n / (size - 1)))
    if name == "hamming":
        return 0.54 - 0.46 * np.cos(2 * np.pi * n / (size - 1))
    if name == "blackman":
        return (0.42 - 0.5 * np.cos(2 * np.pi * n / (size - 1))
                + 0.08 * np.cos(4 * np.pi * n / (size - 1)))
    if name == "bartlett":
        return 1 - 2 * np.abs(n - (size - 1) / 2) / (size - 1)
    raise ValueError(f"Unknown window function: {name}")


def _window(name: str, size: int, device) -> torch.Tensor:
    return torch.tensor(_window_np(name, size), dtype=torch.float32, device=device)


def hanning(size: int, device=None) -> torch.Tensor:
    """The symmetric Hann window, float32 on ``device``."""
    return _window("hann", size, device)


def hamming(size: int, device=None) -> torch.Tensor:
    return _window("hamming", size, device)


def blackman(size: int, device=None) -> torch.Tensor:
    return _window("blackman", size, device)


def bartlett(size: int, device=None) -> torch.Tensor:
    return _window("bartlett", size, device)


def get_window(window: Union[str, np.ndarray], size: int) -> np.ndarray:
    """Resolve a window spec to a float64 array of length ``size``
    (shorter windows are zero-padded on the right)."""
    if isinstance(window, str):
        w = _window_np(window.lower(), size)
    else:
        w = np.asarray(window, dtype=np.float64)
    if w.shape[0] < size:
        w = np.concatenate([w, np.zeros(size - w.shape[0])])
    elif w.shape[0] > size:
        raise ValueError(f"window length {w.shape[0]} > target size {size}")
    return w


@lru_cache(maxsize=None)
def _rdft_basis(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """(cos, -sin) [n_fft, n_bins]: real = frames @ cos, imag = frames @ msin."""
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_fft // 2 + 1)[None, :]
    ang = 2 * np.pi * n * k / n_fft
    return np.cos(ang), -np.sin(ang)


@lru_cache(maxsize=None)
def _irdft_basis(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """x = Re(X) @ A + Im(X) @ B, conjugate-symmetric factors folded in."""
    n_bins = n_fft // 2 + 1
    k = np.arange(n_bins)[:, None]
    n = np.arange(n_fft)[None, :]
    ang = 2 * np.pi * k * n / n_fft
    c = np.full((n_bins, 1), 2.0)
    c[0] = 1.0
    if n_fft % 2 == 0:
        c[-1] = 1.0
    return c * np.cos(ang) / n_fft, -c * np.sin(ang) / n_fft


def _f32(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)


def _center_pad(x: torch.Tensor, padding: int, pad_mode: str) -> torch.Tensor:
    """Pad the last axis; 'reflect' excludes the edge sample."""
    if padding == 0:
        return x
    if pad_mode == "constant":
        return F.pad(x, (padding, padding))
    if pad_mode == "reflect":
        prefix = x[..., 1:padding + 1].flip(-1)
        suffix = x[..., -(padding + 1):-1].flip(-1)
        return torch.cat([prefix, x, suffix], dim=-1)
    raise ValueError(f"Invalid pad_mode {pad_mode}")


def frame_signal(x: torch.Tensor, frame_length: int, hop: int) -> torch.Tensor:
    """[..., T] -> [..., num_frames, frame_length]."""
    t = x.shape[-1]
    num_frames = 1 + (t - frame_length) // hop
    if num_frames <= 0:
        raise ValueError(f"Input is too short (length={t}) for "
                         f"frame_length={frame_length} with hop_length={hop}.")
    if frame_length % hop == 0:
        # hop-strided reshape + frame_length/hop contiguous row slices
        k = frame_length // hop
        xr = x[..., :(num_frames - 1 + k) * hop].reshape(
            *x.shape[:-1], num_frames - 1 + k, hop)
        return torch.cat([xr[..., j:j + num_frames, :] for j in range(k)], dim=-1)
    return x.unfold(-1, frame_length, hop)


def stft_realimag(x: torch.Tensor, n_fft: int = 800,
                  hop_length: Optional[int] = None,
                  win_length: Optional[int] = None,
                  window: Union[str, np.ndarray] = "hann", center: bool = True,
                  pad_mode: str = "reflect") -> tuple[torch.Tensor, torch.Tensor]:
    """STFT as (real, imag), each [..., num_frames, n_fft//2 + 1], with
    ``num_frames = 1 + (T_padded - n_fft)//hop``."""
    hop_length = hop_length or n_fft // 4
    win_length = win_length or n_fft
    w = get_window(window, win_length)
    if w.shape[0] < n_fft:
        w = np.concatenate([w, np.zeros(n_fft - w.shape[0])])
    cos_b, msin_b = _rdft_basis(n_fft)
    # the window folded into the basis: one matmul does window + DFT
    wc = _f32(w[:, None] * cos_b, x.device)
    ws = _f32(w[:, None] * msin_b, x.device)
    if center:
        x = _center_pad(x, n_fft // 2, pad_mode)
    frames = frame_signal(x, n_fft, hop_length).float()
    return frames @ wc, frames @ ws


def stft(x: torch.Tensor, n_fft: int = 800, hop_length: Optional[int] = None,
         win_length: Optional[int] = None,
         window: Union[str, np.ndarray] = "hann", center: bool = True,
         pad_mode: str = "reflect") -> torch.Tensor:
    """Complex STFT: complex64 ``[..., num_frames, n_fft//2 + 1]``, the
    real and imaginary parts of :func:`stft_realimag`."""
    return torch.complex(*stft_realimag(x, n_fft, hop_length, win_length,
                                        window, center, pad_mode))


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """Fold [..., num_frames, frame_len] -> [..., (num_frames-1)*hop + frame_len]
    as K = ceil(frame_len/hop) shifted adds of contiguous slices."""
    *lead, num_frames, frame_len = frames.shape
    out_len = (num_frames - 1) * hop + frame_len
    k = -(-frame_len // hop)
    pad = k * hop - frame_len
    if pad:
        frames = F.pad(frames, (0, pad))
    segs = frames.reshape(*lead, num_frames, k, hop)
    out = None
    for j in range(k):
        contrib = segs[..., :, j, :].reshape(*lead, num_frames * hop)
        contrib = F.pad(contrib, (j * hop, (k - 1 - j) * hop))
        out = contrib if out is None else out + contrib
    return out[..., :out_len]


def istft(x: torch.Tensor, hop_length: Optional[int] = None,
          win_length: Optional[int] = None,
          window: Union[str, np.ndarray] = "hann", center: bool = True,
          length: Optional[int] = None) -> torch.Tensor:
    """Inverse STFT with window-sum normalisation.  ``x`` is
    ``[..., n_freqs, num_frames]`` (frequency first), complex or real; the
    window is periodic, ``window_fn(win_length + 1)[:-1]``."""
    n_freqs, num_frames = x.shape[-2], x.shape[-1]
    n_fft = (n_freqs - 1) * 2
    win_length = win_length or n_fft
    hop_length = hop_length or win_length // 4
    if isinstance(window, str):
        w = _window_np(window.lower(), win_length + 1)[:-1]
    else:
        w = np.asarray(window, dtype=np.float64)
    if w.shape[0] < win_length:
        w = np.concatenate([w, np.zeros(win_length - w.shape[0])])

    if torch.is_complex(x):
        re, im = x.real, x.imag
    else:
        re, im = x, torch.zeros_like(x)
    a, b = _irdft_basis(n_fft)
    a, b = _f32(a, x.device), _f32(b, x.device)
    frames_time = re.transpose(-1, -2).float() @ a + im.transpose(-1, -2).float() @ b
    w_t = _f32(w, x.device)
    frames_time = frames_time[..., :win_length] * w_t
    recon = overlap_add(frames_time, hop_length)

    window_sum = overlap_add(w_t.expand(num_frames, win_length), hop_length)
    nonzero = window_sum != 0
    recon = torch.where(nonzero, recon / torch.where(nonzero, window_sum, 1.0),
                        recon)
    if center and length is None:
        # trailing trim is floor(-win/2): odd windows trim one more sample
        recon = recon[..., win_length // 2:-win_length // 2]
    if length is not None:
        recon = recon[..., :length]
    return recon


# ---------------------------------------------------------------------------
# Mel filterbank (host-side, cached)
# ---------------------------------------------------------------------------


def _hz_to_mel(freq: float, mel_scale: str) -> float:
    if mel_scale == "htk":
        return 2595.0 * math.log10(1.0 + freq / 700.0)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (freq - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = math.log(6.4) / 27.0
    if freq >= min_log_hz:
        mels = min_log_mel + math.log(freq / min_log_hz) / logstep
    return mels


def _mel_to_hz(mels: np.ndarray, mel_scale: str) -> np.ndarray:
    if mel_scale == "htk":
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = math.log(6.4) / 27.0
    return np.where(mels >= min_log_mel,
                    min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs)


@lru_cache(maxsize=None)
def _mel_filters_np(sample_rate: int, n_fft: int, n_mels: int, f_min: float,
                    f_max: Optional[float], norm: Optional[str],
                    mel_scale: str) -> np.ndarray:
    f_max = f_max or sample_rate / 2
    n_freqs = n_fft // 2 + 1
    # the integer floor of Nyquist, as torchaudio's melscale_fbanks
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(_hz_to_mel(f_min, mel_scale),
                        _hz_to_mel(f_max, mel_scale), n_mels + 2)
    f_pts = _mel_to_hz(m_pts, mel_scale)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down_slopes = (-slopes[:, :-2]) / f_diff[:-1]
    up_slopes = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down_slopes, up_slopes))
    if norm == "slaney":
        fb = fb * (2.0 / (f_pts[2:n_mels + 2] - f_pts[:n_mels]))[None, :]
    return fb.T  # [n_mels, n_freqs]


def mel_filters(sample_rate: int, n_fft: int, n_mels: int, f_min: float = 0,
                f_max: Optional[float] = None, norm: Optional[str] = None,
                mel_scale: str = "htk", dtype=torch.float32,
                device=None) -> torch.Tensor:
    """[n_mels, n_fft//2+1] triangular filterbank (HTK or Slaney scale),
    built in float64 numpy and cast to ``dtype``."""
    fb = _mel_filters_np(sample_rate, n_fft, n_mels, float(f_min), f_max,
                         norm, mel_scale)
    return torch.as_tensor(fb, dtype=dtype, device=device)
