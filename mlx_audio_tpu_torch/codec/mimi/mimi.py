"""Mimi neural codec (Kyutai): 24 kHz audio, 12.5 Hz frames, residual
codebooks (counterpart of ``mlx_audio_tpu/codec/mimi/mimi.py``): batch
``encode`` and ``decode``, and the stateful frame-by-frame path
(``init_state``, ``encode_step``, ``decode_step``, ``decode_frames``,
``decode_frames_stateful``) that CSM's streaming generate decodes through.

Contracts: 5 s of 24 kHz audio -> codes [B, nq, 63] -> audio
[B, 1, 120960].  The checkpoint sanitizers are a later slice; weights load
from the JAX package through ``convert.params_from_jax``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch
from torch import nn

from mlx_audio_tpu_torch.codec.mimi.quantization import SplitResidualVectorQuantizer
from mlx_audio_tpu_torch.codec.mimi.seanet import (
    SeanetConfig,
    SeanetDecoder,
    SeanetEncoder,
)
from mlx_audio_tpu_torch.codec.mimi.transformer import (
    ProjectedTransformer,
    TransformerConfig,
)
from mlx_audio_tpu_torch.nn.streaming import (
    StreamableConv1d,
    StreamableConvTranspose1d,
)


@dataclass
class MimiConfig:
    channels: int
    sample_rate: float
    frame_rate: float
    renormalize: bool
    seanet: SeanetConfig
    transformer: TransformerConfig
    quantizer_nq: int
    quantizer_bins: int
    quantizer_dim: int


def mimi_202407(num_codebooks: int) -> MimiConfig:
    """The published Mimi architecture."""
    seanet = SeanetConfig(
        dimension=512, channels=1, causal=True, nfilters=64,
        nresidual_layers=1, ratios=[8, 6, 5, 4], ksize=7, residual_ksize=3,
        last_ksize=3, dilation_base=2, pad_mode="constant", true_skip=True,
        compress=2)
    transformer = TransformerConfig(
        d_model=seanet.dimension, num_heads=8, num_layers=8, causal=True,
        norm_first=True, bias_ff=False, bias_attn=False, layer_scale=0.01,
        positional_embedding="rope", use_conv_bias=True, gating=False,
        norm="layer_norm", context=250, max_period=10000, max_seq_len=8192,
        kv_repeat=1, dim_feedforward=2048, conv_layout=True)
    return MimiConfig(
        channels=1, sample_rate=24000, frame_rate=12.5, renormalize=True,
        seanet=seanet, transformer=transformer, quantizer_nq=num_codebooks,
        quantizer_bins=2048, quantizer_dim=256)


def mimi_from_hf_config(d: dict) -> MimiConfig:
    """MimiConfig from an HF-transformers ``MimiConfig`` dict (the
    ``codec_config`` of a CSM checkpoint)."""
    seanet = SeanetConfig(
        dimension=d.get("hidden_size", 512), channels=d.get("audio_channels", 1),
        causal=d.get("use_causal_conv", True), nfilters=d.get("num_filters", 64),
        nresidual_layers=d.get("num_residual_layers", 1),
        ratios=list(d.get("upsampling_ratios", [8, 6, 5, 4])),
        ksize=d.get("kernel_size", 7),
        residual_ksize=d.get("residual_kernel_size", 3),
        last_ksize=d.get("last_kernel_size", 3),
        dilation_base=d.get("dilation_growth_rate", 2), pad_mode="constant",
        true_skip=True, compress=d.get("compress", 2))
    transformer = TransformerConfig(
        d_model=seanet.dimension, num_heads=d.get("num_attention_heads", 8),
        num_layers=d.get("num_hidden_layers", 8), causal=True,
        norm_first=True, bias_ff=False, bias_attn=False,
        layer_scale=d.get("layer_scale_initial_scale", 0.01),
        positional_embedding="rope", use_conv_bias=True, gating=False,
        norm="layer_norm", context=d.get("sliding_window", 250),
        max_period=int(d.get("rope_theta", 10000)), max_seq_len=8192,
        kv_repeat=1, dim_feedforward=d.get("intermediate_size", 2048),
        conv_layout=True)
    return MimiConfig(
        channels=d.get("audio_channels", 1),
        sample_rate=d.get("sampling_rate", 24000),
        frame_rate=d.get("frame_rate", 12.5),
        renormalize=d.get("normalize", False), seanet=seanet,
        transformer=transformer, quantizer_nq=d.get("num_quantizers", 32),
        quantizer_bins=d.get("codebook_size", 2048),
        quantizer_dim=d.get("vector_quantization_hidden_dimension", 256))


class MimiState(NamedTuple):
    """Streaming carry: conv states and the transformers' rotating caches."""

    encoder: dict
    encoder_tf: list
    downsample: object
    decoder: dict
    decoder_tf: list
    upsample: object


class Mimi(nn.Module):
    def __init__(self, cfg: MimiConfig):
        super().__init__()
        dim = cfg.seanet.dimension
        self.cfg = cfg
        encoder_frame_rate = cfg.sample_rate / math.prod(cfg.seanet.ratios)
        stride = int(encoder_frame_rate / cfg.frame_rate)
        self.samples_per_frame = int(cfg.sample_rate / cfg.frame_rate)
        self.encoder = SeanetEncoder(cfg.seanet)
        self.decoder = SeanetDecoder(cfg.seanet)
        self.quantizer = SplitResidualVectorQuantizer(
            dim=cfg.quantizer_dim, input_dim=dim, output_dim=dim,
            nq=cfg.quantizer_nq, bins=cfg.quantizer_bins)
        self.encoder_transformer = ProjectedTransformer(cfg.transformer, dim, [dim])
        self.decoder_transformer = ProjectedTransformer(cfg.transformer, dim, [dim])
        self.downsample = StreamableConv1d(dim, dim, 2 * stride, stride=stride,
                                           bias=False, causal=True,
                                           pad_mode="edge")
        self.upsample = StreamableConvTranspose1d(dim, dim, 2 * stride,
                                                  stride=stride, groups=dim,
                                                  bias=False, causal=True)

    @property
    def frame_rate(self) -> float:
        return self.cfg.frame_rate

    @property
    def sample_rate(self) -> float:
        return self.cfg.sample_rate

    @torch.no_grad()
    def encode(self, audio: torch.Tensor) -> torch.Tensor:
        """[B, 1, T] (or NLC [B, T, 1]) -> codes [B, nq, frames]."""
        if audio.shape[1] == self.cfg.channels and audio.shape[1] < audio.shape[2]:
            audio = audio.transpose(1, 2)
        x = self.encoder(audio)
        x = self.encoder_transformer(x)[0]
        return self.quantizer.encode(self.downsample(x))

    @torch.no_grad()
    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """codes [B, nq, frames] -> audio [B, 1, frames * 1920]."""
        x = self.upsample(self.quantizer.decode(codes))
        x = self.decoder_transformer(x)[0]
        return self.decoder(x).transpose(1, 2)

    # -- streaming ---------------------------------------------------------

    def init_state(self, batch: int, dtype=torch.float32) -> MimiState:
        return MimiState(
            encoder=self.encoder.init_state(batch, dtype),
            encoder_tf=self.encoder_transformer.init_cache(batch, dtype),
            downsample=self.downsample.init_state(batch, dtype),
            decoder=self.decoder.init_state(batch, dtype),
            decoder_tf=self.decoder_transformer.init_cache(batch, dtype),
            upsample=self.upsample.init_state(batch, dtype))

    @torch.no_grad()
    def encode_step(self, state: MimiState, audio: torch.Tensor):
        """One frame of audio [B, 1920, 1] -> (codes [B, nq, 1], state)."""
        x, enc = self.encoder.step(state.encoder, audio)
        outs, tf = self.encoder_transformer.step(state.encoder_tf, x)
        x, ds = self.downsample.step(state.downsample, outs[0])
        return self.quantizer.encode(x), state._replace(
            encoder=enc, encoder_tf=tf, downsample=ds)

    @torch.no_grad()
    def decode_step(self, state: MimiState, codes: torch.Tensor):
        """codes [B, nq, 1] -> (audio [B, 1920, 1], state)."""
        x, up = self.upsample.step(state.upsample, self.quantizer.decode(codes))
        outs, tf = self.decoder_transformer.step(state.decoder_tf, x)
        audio, dec = self.decoder.step(state.decoder, outs[0])
        return audio, state._replace(upsample=up, decoder_tf=tf, decoder=dec)

    def decode_frames(self, codes: torch.Tensor,
                      state: Optional[MimiState] = None) -> torch.Tensor:
        """Frame-by-frame decode of codes [B, nq, T] -> audio
        [B, 1, T * 1920], from a fresh state unless one is given."""
        if state is None:
            state = self.init_state(codes.shape[0])
        return self.decode_frames_stateful(codes, state)[0]

    def decode_frames_stateful(self, codes: torch.Tensor, state: MimiState):
        """Like ``decode_frames``, but takes and returns the state, so that
        successive chunks continue one stream (CSM's streaming yields)."""
        frames = []
        for t in range(codes.shape[-1]):
            audio, state = self.decode_step(state, codes[..., t:t + 1])
            frames.append(audio[..., 0])
        return torch.cat(frames, dim=1)[:, None, :], state
