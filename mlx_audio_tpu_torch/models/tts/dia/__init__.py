from mlx_audio_tpu_torch.models.tts.dia.config import DiaConfig
from mlx_audio_tpu_torch.models.tts.dia.model import DiaModel, Model

# the registry (utils.loader) builds Model(ModelConfig.from_dict(config))
ModelConfig = DiaConfig

__all__ = ["Model", "ModelConfig", "DiaModel", "DiaConfig"]
