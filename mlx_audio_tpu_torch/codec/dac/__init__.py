from mlx_audio_tpu_torch.codec.dac.chunked import DACFile
from mlx_audio_tpu_torch.codec.dac.dac import DAC, DACConfig, dac_44khz_config

__all__ = ["DAC", "DACConfig", "DACFile", "dac_44khz_config"]
