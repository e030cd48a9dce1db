from mlx_audio_tpu_torch.codec.bigvgan.bigvgan import BigVGAN, BigVGANConfig

__all__ = ["BigVGAN", "BigVGANConfig"]
