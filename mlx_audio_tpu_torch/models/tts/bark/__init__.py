from mlx_audio_tpu_torch.models.tts.bark.bark import Model, ModelConfig, bark_config
from mlx_audio_tpu_torch.models.tts.bark.gpt import GPT, FineGPT, GPTConfig

__all__ = ["Model", "ModelConfig", "bark_config", "GPT", "FineGPT", "GPTConfig"]
