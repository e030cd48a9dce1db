from mlx_audio_tpu_torch.models.tts.llama.llama import (
    Model,
    ModelConfig,
    decode_audio_from_codes,
    encode_audio_to_codes,
    snac_24khz_config,
)

__all__ = ["Model", "ModelConfig", "decode_audio_from_codes",
           "encode_audio_to_codes", "snac_24khz_config"]
