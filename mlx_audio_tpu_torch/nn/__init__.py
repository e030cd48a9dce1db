"""Building blocks of the PyTorch port (counterpart of ``mlx_audio_tpu.nn``)."""

from mlx_audio_tpu_torch.nn.attention import (
    KVCache,
    MultiHeadAttention,
    apply_rope,
    cached_attention,
    causal_mask,
    rope_table,
    scaled_dot_product_attention,
)
from mlx_audio_tpu_torch.nn.interpolate import interpolate, interpolate1d
from mlx_audio_tpu_torch.nn.layers import (
    AdaIN1d,
    AdaLayerNorm,
    BatchNorm,
    Conv1d,
    Conv2d,
    ConvTranspose1d,
    Embedding,
    Identity,
    InstanceNorm1d,
    LayerNorm,
    Linear,
    RMSNorm,
    WNConv1d,
    WNConvTranspose1d,
    conv1d,
    conv1d_route,
    conv_transpose1d,
    depthwise_conv_transpose1d,
    get_padding,
    leaky_relu,
    promote_operands,
    snake,
    snake_beta,
    weight_norm,
)
from mlx_audio_tpu_torch.nn.recurrent import LSTM, lstm_scan, masked_flip

__all__ = [
    "Linear", "Embedding", "LayerNorm", "RMSNorm", "InstanceNorm1d", "AdaIN1d",
    "AdaLayerNorm", "BatchNorm", "Conv1d", "Conv2d", "ConvTranspose1d", "WNConv1d",
    "WNConvTranspose1d", "Identity",
    "conv1d", "conv1d_route", "conv_transpose1d",
    "depthwise_conv_transpose1d", "weight_norm", "get_padding", "leaky_relu",
    "promote_operands", "snake", "snake_beta",
    "LSTM", "lstm_scan", "masked_flip",
    "KVCache", "MultiHeadAttention", "apply_rope", "cached_attention",
    "causal_mask", "rope_table", "scaled_dot_product_attention",
    "interpolate", "interpolate1d",
]
