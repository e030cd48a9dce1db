from mlx_audio_tpu_torch.models.stt.parakeet.parakeet import (
    BaseParakeet,
    Model,
    ParakeetCTC,
    ParakeetRNNT,
    ParakeetTDT,
    sanitize_hf_parakeet,
    transducer_greedy_loop,
)

__all__ = ["Model", "BaseParakeet", "ParakeetTDT", "ParakeetRNNT", "ParakeetCTC",
           "sanitize_hf_parakeet", "transducer_greedy_loop"]
