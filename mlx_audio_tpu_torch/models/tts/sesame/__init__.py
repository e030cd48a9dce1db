from mlx_audio_tpu_torch.models.tts.sesame.model import (
    Model,
    Segment,
    SesameModel,
    sanitize,
)

__all__ = ["Model", "Segment", "SesameModel", "sanitize"]
