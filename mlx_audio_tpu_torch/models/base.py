"""Shared model contracts (counterpart of ``mlx_audio_tpu/models/base.py``).

Every TTS model yields :class:`GenerationResult` records with the same
metrics schema as the JAX package.
"""

from __future__ import annotations

import inspect
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch


@dataclass
class BaseModelArgs:
    @classmethod
    def from_dict(cls, params: dict):
        """Construct, silently dropping unknown keys."""
        names = inspect.signature(cls).parameters
        return cls(**{k: v for k, v in params.items() if k in names})


class DictConfig(dict):
    """The config of a family whose ``Model`` takes a plain dict (CSM's,
    Parakeet's NeMo config): the registry's ``ModelConfig.from_dict``
    passes it on as it is."""

    @classmethod
    def from_dict(cls, params: dict) -> dict:
        return dict(params)


def model_device(device, who: str) -> torch.device:
    """The device a model is built on.  "cuda" raises without a card, and
    turns TF32 off: float32 matmuls and, by default, cuDNN convolutions
    would otherwise run in TF32 (about three digits)."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"{who}: no CUDA device; pass device='cpu' "
                               "to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


def init_weights(root: torch.nn.Module, generator: torch.Generator) -> None:
    """Draw every submodule's weights with its ``init_weights``, in module
    order."""
    for module in root.modules():
        if hasattr(module, "init_weights"):
            module.init_weights(generator)


def check_array_shape(arr) -> bool:
    """Heuristic: True if a 3-D conv weight looks like MLX's
    [out_channels, k, in] layout rather than torch's [out, in, k]."""
    if len(arr.shape) != 3:
        return False
    out_channels, kh, kw = arr.shape
    return (out_channels >= kh) and (out_channels >= kw) and (kh == kw)


def adjust_speed(audio: torch.Tensor, speed_factor: float) -> torch.Tensor:
    """Speed change by linear resampling along the first axis: ``audio``
    [T, ...] -> [int(T / speed_factor), ...] (the JAX package's
    ``adjust_speed``; the positions and weights computed in float64 numpy
    as there, the weights applied in float32)."""
    audio = torch.as_tensor(audio)
    old_length = audio.shape[0]
    new_idx = np.linspace(0, old_length - 1, int(old_length / speed_factor))
    lo = np.floor(new_idx).astype(np.int64)
    hi = np.minimum(lo + 1, old_length - 1)
    shape = (-1,) + (1,) * (audio.ndim - 1)
    w_hi = torch.tensor((new_idx - lo).astype(np.float32),
                        device=audio.device).reshape(shape)
    lo, hi = torch.as_tensor(lo, device=audio.device), torch.as_tensor(hi, device=audio.device)
    return (1.0 - w_hi) * audio[lo] + w_hi * audio[hi]


@dataclass
class GenerationResult:
    """Per-segment TTS output + metrics."""

    audio: Any
    samples: int
    sample_rate: int
    segment_idx: int
    token_count: int
    audio_duration: str
    real_time_factor: float
    prompt: dict
    audio_samples: dict
    processing_time_seconds: float
    peak_memory_usage: float


def format_duration(seconds: float) -> str:
    hours = int(seconds // 3600)
    mins = int((seconds % 3600) // 60)
    secs = int(seconds % 60)
    ms = int((seconds % 1) * 1000)
    return f"{hours:02d}:{mins:02d}:{secs:02d}.{ms:03d}"


def peak_memory_gb(device: torch.device) -> float:
    """Peak device memory in GB on a CUDA device; 0.0 for the CPU."""
    if device.type != "cuda":
        return 0.0
    return torch.cuda.max_memory_allocated(device) / 1e9


def make_generation_result(audio: Any, sample_rate: int, segment_idx: int,
                           token_count: int, segment_time: float,
                           device: torch.device = torch.device("cpu")
                           ) -> GenerationResult:
    """Assemble the standard metrics record for one generated segment."""
    audio = np.asarray(audio)
    samples = int(audio.shape[-1])
    audio_secs = samples / sample_rate
    rtf = segment_time / audio_secs if audio_secs > 0 else 0.0
    return GenerationResult(
        audio=audio,
        samples=samples,
        sample_rate=sample_rate,
        segment_idx=segment_idx,
        token_count=token_count,
        audio_duration=format_duration(audio_secs),
        real_time_factor=round(rtf, 2),
        prompt={
            "tokens": token_count,
            "tokens-per-sec": (round(token_count / segment_time, 2)
                               if segment_time > 0 else 0),
        },
        audio_samples={
            "samples": samples,
            "samples-per-sec": (round(samples / segment_time, 2)
                                if segment_time > 0 else 0),
        },
        processing_time_seconds=segment_time,
        peak_memory_usage=peak_memory_gb(device),
    )
