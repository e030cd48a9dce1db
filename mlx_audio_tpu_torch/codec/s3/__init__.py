from mlx_audio_tpu_torch.codec.s3.s3 import (
    S3Config,
    S3Tokenizer,
    S3TokenizerV2,
    log_mel_spectrogram,
)

__all__ = ["S3Tokenizer", "S3TokenizerV2", "S3Config", "log_mel_spectrogram"]
