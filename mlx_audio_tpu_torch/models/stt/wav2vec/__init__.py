from mlx_audio_tpu_torch.models.stt.wav2vec.feature_extractor import (
    BatchFeature,
    Wav2Vec2FeatureExtractor,
)
from mlx_audio_tpu_torch.models.stt.wav2vec.wav2vec import (
    Model,
    ModelConfig,
    Wav2Vec2Model,
)

__all__ = [
    "BatchFeature",
    "Model",
    "ModelConfig",
    "Wav2Vec2FeatureExtractor",
    "Wav2Vec2Model",
]
