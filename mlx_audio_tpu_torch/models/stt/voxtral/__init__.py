from mlx_audio_tpu_torch.models.stt.voxtral.voxtral import Model, ModelConfig

__all__ = ["Model", "ModelConfig"]
