"""Command-line entry points of the port (``python -m
mlx_audio_tpu_torch.scripts.<name>``)."""
