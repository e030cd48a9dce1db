"""Host-side utilities of the port (counterpart of ``mlx_audio_tpu.utils``)."""
