"""Host-side audio I/O: wav read/write and polyphase resampling (the
port's copy of ``mlx_audio_tpu/utils/audio_io.py``, which imports no JAX).

wav reads and writes through scipy with float conversion; other containers
(flac, ogg, ...) go through the optional ``soundfile`` package, with a clear
error when it is absent.  Resampling is ``scipy.signal.resample_poly`` with
edge padding.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Union

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly


def resample_audio(audio: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling (reference sesame.py:51-56 semantics)."""
    if orig_sr == target_sr:
        return audio
    gcd = np.gcd(int(orig_sr), int(target_sr))
    up = target_sr // gcd
    down = orig_sr // gcd
    return resample_poly(audio, up, down, padtype="edge").astype(np.float32)


def _to_float(data: np.ndarray) -> np.ndarray:
    if data.dtype == np.float32 or data.dtype == np.float64:
        return data.astype(np.float32)
    if data.dtype == np.int16:
        return (data / 32768.0).astype(np.float32)
    if data.dtype == np.int32:
        return (data / 2147483648.0).astype(np.float32)
    if data.dtype == np.uint8:
        return ((data.astype(np.float32) - 128.0) / 128.0)
    return data.astype(np.float32)


def _read_via_soundfile(path: str):
    """Non-wav container read, gated on the optional soundfile package
    (the reference hard-depends on it, stt/utils.py:19-51)."""
    try:
        import soundfile as sf
    except ImportError as e:
        raise RuntimeError(
            f"reading {Path(path).suffix or 'this'} audio needs the optional "
            "'soundfile' package; wav is supported natively"
        ) from e
    data, sr = sf.read(path, dtype="float32", always_2d=False)
    return sr, np.asarray(data)


def load_audio(path: Union[str, Path], sample_rate: Optional[int] = None,
               mono: bool = True) -> np.ndarray:
    """Read an audio file -> float32 waveform [-1, 1], optionally resampled.

    wav reads natively (scipy); other containers (flac/ogg/...) go through
    the optional soundfile package with a clear error when it is absent.
    """
    path = str(path)
    if Path(path).suffix.lower() in ("", ".wav", ".wave"):
        sr, data = wavfile.read(path)
    else:
        sr, data = _read_via_soundfile(path)
    audio = _to_float(np.asarray(data))
    if mono and audio.ndim > 1:
        audio = audio.mean(axis=1)
    if sample_rate is not None and sr != sample_rate:
        audio = resample_audio(audio, sr, sample_rate)
    return audio.astype(np.float32)


def save_audio(path: Union[str, Path], audio: np.ndarray, sample_rate: int):
    """Write a float32 waveform: 16-bit PCM wav natively; other extensions
    (.flac/.ogg/...) through the optional soundfile package rather than
    silently writing wav bytes under a mislabeled extension."""
    path = str(path)
    audio = np.asarray(audio)
    if audio.ndim > 1:
        audio = audio.squeeze()
    clipped = np.clip(audio, -1.0, 1.0)
    suffix = Path(path).suffix.lower()
    if suffix in ("", ".wav", ".wave"):
        wavfile.write(path, int(sample_rate),
                      (clipped * 32767).astype(np.int16))
        return path
    try:
        import soundfile as sf
    except ImportError as e:
        raise RuntimeError(
            f"writing {suffix} audio needs the optional 'soundfile' package; "
            "use --audio_format wav (supported natively)"
        ) from e
    sf.write(path, clipped.astype(np.float32), int(sample_rate))
    return path
