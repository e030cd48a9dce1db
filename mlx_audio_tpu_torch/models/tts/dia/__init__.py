from mlx_audio_tpu_torch.models.tts.dia.config import DiaConfig
from mlx_audio_tpu_torch.models.tts.dia.model import DiaModel, Model

__all__ = ["Model", "DiaModel", "DiaConfig"]
