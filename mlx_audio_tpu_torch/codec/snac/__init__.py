from mlx_audio_tpu_torch.codec.snac.snac import SNAC, SNACConfig

__all__ = ["SNAC", "SNACConfig"]
