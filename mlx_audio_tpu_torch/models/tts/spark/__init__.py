from mlx_audio_tpu_torch.models.tts.spark.bicodec import BiCodec
from mlx_audio_tpu_torch.models.tts.spark.spark import Model, ModelConfig

__all__ = ["BiCodec", "Model", "ModelConfig"]
