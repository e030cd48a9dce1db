from mlx_audio_tpu_torch.models.tts.kokoro.model import (
    Model,
    ModelConfig,
    duration_stage,
    sanitize,
    synthesis_stage,
)
from mlx_audio_tpu_torch.models.tts.kokoro.pipeline import KokoroPipeline

__all__ = ["Model", "ModelConfig", "sanitize", "duration_stage",
           "synthesis_stage", "KokoroPipeline"]
