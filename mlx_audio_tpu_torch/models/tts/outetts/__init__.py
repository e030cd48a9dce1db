from mlx_audio_tpu_torch.models.tts.outetts.audio_processor import AudioProcessor
from mlx_audio_tpu_torch.models.tts.outetts.outetts import Model, ModelConfig
from mlx_audio_tpu_torch.models.tts.outetts.prompt_processor import PromptProcessor

__all__ = ["Model", "ModelConfig", "PromptProcessor", "AudioProcessor"]
