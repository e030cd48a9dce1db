from mlx_audio_tpu_torch.models.stt.whisper.decoding import (
    DecodingOptions,
    DecodingResult,
)
from mlx_audio_tpu_torch.models.stt.whisper.model import ModelDimensions, WhisperModel
from mlx_audio_tpu_torch.models.stt.whisper.transcribe import Model, STTOutput

# the generic loaders look for ModelConfig
ModelConfig = ModelDimensions

__all__ = [
    "Model",
    "ModelConfig",
    "WhisperModel",
    "ModelDimensions",
    "STTOutput",
    "DecodingOptions",
    "DecodingResult",
]
