"""Whisper's audio front end: its constants and the log-mel spectrogram
(counterpart of ``mlx_audio_tpu/models/stt/whisper/audio.py``), on the port's
matmul-DFT STFT and Slaney mel filterbank."""

from __future__ import annotations

from typing import Union

import numpy as np
import torch
import torch.nn.functional as F

from mlx_audio_tpu_torch import dsp

SAMPLE_RATE = 16000
N_FFT = 400
HOP_LENGTH = 160
CHUNK_LENGTH = 30
N_SAMPLES = CHUNK_LENGTH * SAMPLE_RATE  # 480000
N_FRAMES = N_SAMPLES // HOP_LENGTH      # 3000

N_SAMPLES_PER_TOKEN = HOP_LENGTH * 2
FRAMES_PER_SECOND = SAMPLE_RATE // HOP_LENGTH     # 100
TOKENS_PER_SECOND = SAMPLE_RATE // N_SAMPLES_PER_TOKEN  # 50


def pad_or_trim(array: torch.Tensor, length: int = N_SAMPLES, *,
                axis: int = -1) -> torch.Tensor:
    """Trim or zero-pad ``axis`` to ``length``."""
    axis = axis % array.ndim
    if array.shape[axis] > length:
        array = array.narrow(axis, 0, length)
    if array.shape[axis] < length:
        pad = [0, 0] * (array.ndim - axis - 1) + [0, length - array.shape[axis]]
        array = F.pad(array, pad)
    return array


def log_mel_spectrogram(audio: Union[np.ndarray, torch.Tensor], n_mels: int = 80,
                        padding: int = 0, device=None) -> torch.Tensor:
    """[T] 16 kHz waveform -> [frames, n_mels] log-mel: periodic Hann, Slaney
    mel scale and norm, log10, a floor 8 below the maximum of the whole
    array, then (x + 4) / 4."""
    audio = torch.as_tensor(np.asarray(audio, dtype=np.float32)
                            if not isinstance(audio, torch.Tensor) else audio,
                            dtype=torch.float32, device=device)
    if padding > 0:
        audio = F.pad(audio, (0, padding))
    re, im = dsp.stft_realimag(audio, N_FFT, HOP_LENGTH, window="hann_periodic",
                               center=True)
    mag2 = (re * re + im * im)[..., :-1, :]  # the last frame dropped
    fb = dsp.mel_filters(SAMPLE_RATE, N_FFT, n_mels, norm="slaney",
                         mel_scale="slaney", device=audio.device)
    mel = mag2 @ fb.T
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    log_spec = torch.maximum(log_spec, log_spec.max() - 8.0)
    return (log_spec + 4.0) / 4.0
