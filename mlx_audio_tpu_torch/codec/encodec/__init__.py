from mlx_audio_tpu_torch.codec.encodec.encodec import (
    Encodec,
    EncodecConfig,
    encodec_24khz_config,
    preprocess_audio,
    sanitize_hf_encodec,
)

__all__ = ["Encodec", "EncodecConfig", "encodec_24khz_config",
           "preprocess_audio", "sanitize_hf_encodec"]
