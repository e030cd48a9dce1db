"""Wav2Vec2, self-supervised speech representations (counterpart of
``mlx_audio_tpu/models/stt/wav2vec/wav2vec.py``): the conv feature encoder
(group- or layer-norm variant), the weight-normed positional conv
embedding, and the transformer encoder (post-LN, or the stable pre-LN
variant).  Spark-TTS's BiCodec tokenizer mixes its hidden states.

Sequences are channels last, ``[batch, frames, channels]``.  Every conv
takes the library route of ``nn.layers.conv1d``: the feature encoder's are
strided, the positional conv is grouped.  The positional conv keeps torch's
``weight_norm(dim=2)`` layout: ``weight_v [D, D/groups, K]`` and one ``g`` a
tap, ``weight_g [1, 1, K]``.

``Wav2Vec2Model(config, device="cuda", seed=0)`` draws its weights from
``seed`` on ``device``.  ``sanitize`` maps an HF checkpoint's keys and
layouts to the JAX package's, from which ``convert.params_from_jax`` takes
them on to the port's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mlx_audio_tpu_torch.models.base import BaseModelArgs, init_weights, model_device
from mlx_audio_tpu_torch.nn.layers import (
    Conv1d,
    LayerNorm,
    Linear,
    _param,
    _uniform_,
    conv1d,
)


@dataclass
class ModelConfig(BaseModelArgs):
    model_type: str = "wav2vec2"
    vocab_size: int = 32
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    layer_norm_eps: float = 1e-5
    feat_extract_norm: str = "group"
    conv_dim: Tuple[int, ...] = (512, 512, 512, 512, 512, 512, 512)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_bias: bool = False
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    num_feat_extract_layers: int = 7
    do_stable_layer_norm: bool = False
    output_hidden_states: bool = False


class GroupNormPerChannel(nn.Module):
    """GroupNorm with one group a channel: per-channel statistics over time,
    the population variance."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = _param(channels)
        self.bias = _param(channels)

    def init_weights(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        mean = x.mean(-2, keepdim=True)
        var = x.var(-2, keepdim=True, correction=0)
        return (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias


class ConvLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, layer_id: int = 0, norm: str = "none"):
        super().__init__()
        in_dim = cfg.conv_dim[layer_id - 1] if layer_id > 0 else 1
        out_dim = cfg.conv_dim[layer_id]
        self.conv = Conv1d(in_dim, out_dim, cfg.conv_kernel[layer_id],
                           stride=cfg.conv_stride[layer_id], bias=cfg.conv_bias)
        if norm == "group":
            self.layer_norm = GroupNormPerChannel(out_dim)
        elif norm == "layer":
            self.layer_norm = LayerNorm(out_dim)
        else:
            self.layer_norm = None

    def forward(self, x):
        x = self.conv(x)
        if self.layer_norm is not None:
            x = self.layer_norm(x)
        return F.gelu(x)


class PositionalConvEmbedding(nn.Module):
    """Weight-normed grouped conv over positions; the norm and ``g`` are
    per tap (torch's ``weight_norm(dim=2)``), the last frame dropped for an
    even K."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        k = cfg.num_conv_pos_embeddings
        g = cfg.num_conv_pos_embedding_groups
        d = cfg.hidden_size
        self.groups = g
        self.kernel = k
        self.fan_in = d * k / g
        self.weight_v = _param(d, d // g, k)
        self.weight_g = _param(1, 1, k)
        self.bias = _param(d)
        self.num_pad_remove = 1 if k % 2 == 0 else 0

    def init_weights(self, generator: torch.Generator) -> None:
        _uniform_(self.weight_v, 1.0 / math.sqrt(self.fan_in), generator)
        with torch.no_grad():
            self.weight_g.copy_(self._tap_norm())
            self.bias.zero_()

    def _tap_norm(self):
        return torch.sqrt((self.weight_v * self.weight_v).sum(dim=(0, 1), keepdim=True))

    def forward(self, x):
        w = self.weight_v / (self._tap_norm() + 1e-7) * self.weight_g
        y = conv1d(x, w, stride=1, padding=self.kernel // 2, groups=self.groups)
        y = y + self.bias
        if self.num_pad_remove > 0:
            y = y[:, :-self.num_pad_remove, :]
        return F.gelu(y)


class FeatureEncoder(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.feat_extract_norm == "group":
            layers = [ConvLayer(cfg, 0, norm="group")]
            layers += [ConvLayer(cfg, i) for i in range(1, cfg.num_feat_extract_layers)]
        else:
            layers = [ConvLayer(cfg, i, norm="layer")
                      for i in range(cfg.num_feat_extract_layers)]
        self.conv_layers = nn.ModuleList(layers)

    def forward(self, input_values):
        """[B, T] waveform -> [B, T', conv_dim[-1]]."""
        x = input_values[..., None]
        for layer in self.conv_layers:
            x = layer(x)
        return x


class FeatureProjection(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.layer_norm = LayerNorm(cfg.conv_dim[-1], eps=cfg.layer_norm_eps)
        self.projection = Linear(cfg.conv_dim[-1], cfg.hidden_size)

    def forward(self, x):
        norm = self.layer_norm(x)
        return self.projection(norm), norm


class W2VAttention(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        d = cfg.hidden_size
        self.n_head = cfg.num_attention_heads
        self.head_dim = d // self.n_head
        self.q_proj = Linear(d, d)
        self.k_proj = Linear(d, d)
        self.v_proj = Linear(d, d)
        self.out_proj = Linear(d, d)

    def forward(self, x, mask=None):
        b, t, d = x.shape

        def split(z):
            return z.reshape(b, t, self.n_head, self.head_dim).transpose(1, 2)

        q, k, v = split(self.q_proj(x)), split(self.k_proj(x)), split(self.v_proj(x))
        scores = (q @ k.transpose(-1, -2)).float() * self.head_dim ** -0.5
        if mask is not None:
            scores = scores + mask
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        return self.out_proj((probs @ v).transpose(1, 2).reshape(b, t, d))


class FeedForward(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.intermediate_dense = Linear(cfg.hidden_size, cfg.intermediate_size)
        self.output_dense = Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        return self.output_dense(F.gelu(self.intermediate_dense(x)))


class EncoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, stable: bool = False):
        super().__init__()
        self.stable = stable
        self.attention = W2VAttention(cfg)
        self.layer_norm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.feed_forward = FeedForward(cfg)
        self.final_layer_norm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, x, mask=None):
        if self.stable:
            x = x + self.attention(self.layer_norm(x), mask)
            return x + self.feed_forward(self.final_layer_norm(x))
        x = self.layer_norm(x + self.attention(x, mask))
        return self.final_layer_norm(x + self.feed_forward(x))


class Encoder(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.stable = cfg.do_stable_layer_norm
        self.pos_conv_embed = PositionalConvEmbedding(cfg)
        self.layer_norm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList(EncoderLayer(cfg, stable=self.stable)
                                    for _ in range(cfg.num_hidden_layers))

    def forward(self, x, mask=None, output_hidden_states: bool = False):
        x = x + self.pos_conv_embed(x)
        if not self.stable:
            x = self.layer_norm(x)
        hidden_states = [x] if output_hidden_states else None
        for layer in self.layers:
            x = layer(x, mask)
            if output_hidden_states:
                hidden_states.append(x)
        if self.stable:
            x = self.layer_norm(x)
        return x, hidden_states


class Wav2Vec2Model(nn.Module):
    def __init__(self, config, device: str = "cuda", seed: int = 0):
        super().__init__()
        if isinstance(config, dict):
            config = ModelConfig.from_dict(config)
        device = model_device(device, "Wav2Vec2Model")
        self.config = config
        with torch.device(device):
            self.feature_extractor = FeatureEncoder(config)
            self.feature_projection = FeatureProjection(config)
            self.encoder = Encoder(config)
        init_weights(self, torch.Generator(device).manual_seed(seed))
        self.device = device

    def forward(self, input_values: torch.Tensor,
                output_hidden_states: bool = False):
        """[B, T] waveform -> (last_hidden [B, T', D], the normed extracted
        features, the hidden states or None)."""
        x = torch.as_tensor(input_values, dtype=torch.float32, device=self.device)
        extract = self.feature_extractor(x)
        hidden, norm_features = self.feature_projection(extract)
        last, hiddens = self.encoder(hidden, output_hidden_states=output_hidden_states)
        return last, norm_features, hiddens

    @staticmethod
    def sanitize(weights: dict) -> dict:
        """HF torch checkpoint -> the JAX package's layout: conv [O, I, K] ->
        [K, I, O]; the positional conv's per-tap g [1, 1, K] -> [K, 1, 1].
        Takes the legacy (``weight_g``/``weight_v``) and the
        parametrizations (``parametrizations.weight.original0/1``) key
        styles."""
        out = {}
        for k, v in weights.items():
            v = np.asarray(v)
            if "pos_conv_embed" in k:
                k = (k.replace(".conv.parametrizations.weight.original0", ".weight_g")
                     .replace(".conv.parametrizations.weight.original1", ".weight_v")
                     .replace(".conv.weight_g", ".weight_g")
                     .replace(".conv.weight_v", ".weight_v")
                     .replace(".conv.bias", ".bias"))
            pos_wn = "pos_conv_embed" in k and k.endswith(("weight_v", "weight_g"))
            if v.ndim == 3 and (pos_wn or k.endswith("conv.weight")):
                v = v.transpose(2, 1, 0)
            out[k] = v
        return out


# registry alias
Model = Wav2Vec2Model
