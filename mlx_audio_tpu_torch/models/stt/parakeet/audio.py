"""Parakeet's NeMo mel frontend (counterpart of
``mlx_audio_tpu/models/stt/parakeet/audio.py``).

The STFT is the port's matmul DFT (``dsp.stft_realimag``) with NeMo's
symmetric "hann" window, the power spectrum goes through a Slaney-scale
filterbank (``dsp.mel_filters``), and the log-mel is normalised per
feature (or over the whole spectrogram) as the JAX package does.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from mlx_audio_tpu_torch import dsp


@dataclass
class PreprocessArgs:
    sample_rate: int
    normalize: str
    window_size: float
    window_stride: float
    window: str
    features: int
    n_fft: int
    dither: float = 0.0
    pad_to: int = 0
    pad_value: float = 0

    @property
    def win_length(self) -> int:
        return int(self.window_size * self.sample_rate)

    @property
    def hop_length(self) -> int:
        return int(self.window_stride * self.sample_rate)

    @classmethod
    def from_dict(cls, d: dict) -> "PreprocessArgs":
        return cls(**{k: v for k, v in d.items() if k in cls.__dataclass_fields__})


def log_mel_spectrogram(x, args: PreprocessArgs, device=None) -> torch.Tensor:
    """[T] waveform (array or tensor) -> [1, frames, features] normalised
    log-mel, on ``device`` (default: the tensor's own, else the CPU)."""
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    if args.pad_to > 0 and x.shape[-1] < args.pad_to:
        x = torch.nn.functional.pad(x, (0, args.pad_to - x.shape[-1]),
                                    value=args.pad_value)
    # NeMo's FilterbankFeatures builds its window with periodic=False
    # (symmetric), unlike the Whisper and torchaudio frontends
    re, im = dsp.stft_realimag(x, args.n_fft, args.hop_length, args.win_length,
                               args.window, center=True)
    power = re * re + im * im  # [frames, bins]
    fb = dsp.mel_filters(args.sample_rate, args.n_fft, args.features,
                         norm=args.normalize if args.normalize == "slaney" else None,
                         mel_scale="slaney", device=x.device)
    mel = torch.log(power @ fb.t() + 1e-5)  # [frames, features]
    if args.normalize == "per_feature":
        mean = mel.mean(0, keepdim=True)
        std = mel.std(0, keepdim=True, correction=0)
        mel = (mel - mean) / (std + 1e-5)
    else:
        mel = (mel - mel.mean()) / (mel.std(correction=0) + 1e-5)
    return mel[None]
