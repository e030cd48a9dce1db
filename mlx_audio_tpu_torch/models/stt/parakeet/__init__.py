from mlx_audio_tpu_torch.models.base import DictConfig as ModelConfig
from mlx_audio_tpu_torch.models.stt.parakeet.parakeet import (
    BaseParakeet,
    Model,
    ParakeetCTC,
    ParakeetRNNT,
    ParakeetTDT,
    sanitize_hf_parakeet,
    transducer_greedy_loop,
)

__all__ = ["Model", "ModelConfig", "BaseParakeet", "ParakeetTDT", "ParakeetRNNT",
           "ParakeetCTC", "sanitize_hf_parakeet", "transducer_greedy_loop"]
