from mlx_audio_tpu_torch.models.lm.llama import (
    LLAMA_FLAVORS,
    LlamaConfig,
    LlamaModel,
    lm_dtype,
)

__all__ = ["LLAMA_FLAVORS", "LlamaConfig", "LlamaModel", "lm_dtype"]
