"""Host-side utilities of the port (counterpart of ``mlx_audio_tpu.utils``)."""

from mlx_audio_tpu_torch.utils.audio_io import load_audio, resample_audio, save_audio

__all__ = ["load_audio", "save_audio", "resample_audio"]
