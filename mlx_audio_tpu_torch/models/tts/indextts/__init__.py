from mlx_audio_tpu_torch.models.tts.indextts.indextts import Model, ModelConfig

__all__ = ["Model", "ModelConfig"]
