from mlx_audio_tpu_torch.models.base import DictConfig as ModelConfig
from mlx_audio_tpu_torch.models.tts.sesame.model import (
    Model,
    Segment,
    SesameModel,
    sanitize,
)

__all__ = ["Model", "ModelConfig", "Segment", "SesameModel", "sanitize"]
