from mlx_audio_tpu_torch.codec.vocos.vocos import (
    EncodecFeatures,
    ISTFTHead,
    MelSpectrogramFeatures,
    Vocos,
    VocosBackbone,
    log_mel_spectrogram,
    vocos_mel_24khz_config,
)

__all__ = ["Vocos", "VocosBackbone", "ISTFTHead", "MelSpectrogramFeatures",
           "EncodecFeatures", "log_mel_spectrogram", "vocos_mel_24khz_config"]
