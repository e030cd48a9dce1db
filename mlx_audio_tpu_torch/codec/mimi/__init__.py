from mlx_audio_tpu_torch.codec.mimi.mimi import (
    Mimi,
    MimiConfig,
    MimiState,
    mimi_202407,
    mimi_from_hf_config,
)

__all__ = ["Mimi", "MimiConfig", "MimiState", "mimi_202407", "mimi_from_hf_config"]
