"""Mimi neural codec (Kyutai): 24 kHz audio, 12.5 Hz frames, residual
codebooks (counterpart of ``mlx_audio_tpu/codec/mimi/mimi.py``): batch
``encode`` and ``decode``, and the stateful frame-by-frame path
(``init_state``, ``encode_step``, ``decode_step``, ``decode_frames``,
``decode_frames_stateful``) that CSM's streaming generate decodes through.

Contracts: 5 s of 24 kHz audio -> codes [B, nq, 63] -> audio
[B, 1, 120960].  ``Mimi.from_pretrained`` reads a local HF-transformers
``MimiModel`` directory (``kyutai/mimi``'s layout) or a single Kyutai
``.safetensors`` file; ``sanitize_hf_mimi`` and ``sanitize_mimi`` map those
layouts to the JAX package's, and ``convert.params_from_jax`` takes them on
to the port's, as for every other family.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
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
from mlx_audio_tpu_torch.models.base import init_weights, model_device
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

    def warmup(self) -> None:
        """Encode, then decode, 4 frames of silence on the model's device,
        and wait for the device: the first use of its kernels and library
        handles before a stream starts."""
        device = next(self.parameters()).device
        pcm = torch.zeros((1, 1, self.samples_per_frame * 4), device=device)
        self.decode(self.encode(pcm))
        if device.type == "cuda":
            torch.cuda.synchronize(device)

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

    # -- checkpoint loading ------------------------------------------------

    def sanitize(self, weights: dict) -> dict:
        """An HF-transformers (``..._transformer.layers.*.self_attn.q_proj``)
        or Kyutai checkpoint -> the JAX package's paths and layouts."""
        if any("_transformer.layers." in k and ".self_attn.q_proj." in k
               for k in weights):
            return sanitize_hf_mimi(weights, n_heads=self.cfg.transformer.num_heads,
                                    n_ratios=len(self.cfg.seanet.ratios))
        return sanitize_mimi(weights)

    def load_weights(self, weights: dict) -> "Mimi":
        """Load JAX-layout ``weights`` (a sanitizer's output) into this
        model; paths it does not have are ignored and arrays it lacks keep
        their values, as the JAX package's ``update_arrays(strict=False)``."""
        from mlx_audio_tpu_torch.convert import params_from_jax

        self.load_state_dict(params_from_jax(weights, self), strict=False)
        return self

    def load_pytorch_weights(self, path: str) -> "Mimi":
        """A Kyutai-layout ``.safetensors`` file into this model."""
        from safetensors.numpy import load_file

        return self.load_weights(sanitize_mimi(load_file(str(path))))

    @classmethod
    def from_pretrained(cls, path_or_repo: str = "kyutai/mimi",
                        filename: Optional[str] = None,
                        device: str = "cuda") -> "Mimi":
        """A local HF-transformers ``MimiModel`` directory (config.json and
        model.safetensors), or a single Kyutai ``.safetensors`` file (or
        ``filename`` in a directory), at ``mimi_202407(32)``'s widths,
        on ``device``.  Nothing is fetched: a path that does not exist
        raises ``FileNotFoundError`` naming it."""
        from mlx_audio_tpu_torch.codec.loading import (
            checkpoint_dir,
            load_config,
            load_weights_files,
        )

        p = Path(path_or_repo)
        if p.is_file() and p.suffix == ".safetensors":
            return cls.build(mimi_202407(32), device).load_pytorch_weights(p)
        path = checkpoint_dir(path_or_repo)
        if filename is not None:
            return cls.build(mimi_202407(32), device).load_pytorch_weights(
                path / filename)
        model = cls.build(mimi_from_hf_config(load_config(path)), device)
        return model.load_weights(model.sanitize(load_weights_files(path)))

    @classmethod
    def build(cls, cfg: MimiConfig, device: str = "cuda", seed: int = 0) -> "Mimi":
        """A Mimi on ``device`` with weights drawn from ``seed``."""
        device = model_device(device, "Mimi")
        with torch.device(device):
            model = cls(cfg)
        init_weights(model, torch.Generator(device).manual_seed(seed))
        return model


def sanitize_mimi(weights: dict) -> dict:
    """The Kyutai torch checkpoint's keys and layouts -> the JAX package's
    paths: conv [O, I, K] -> [K, I, O]; transposed conv [I, O, K] ->
    [K, I, O]; the quantizer's 1x1 projections -> Linear [O, I]."""
    out = {}
    for k, v in weights.items():
        v = np.asarray(v)
        k = ".".join(s.removeprefix("_") for s in k.split("."))
        k = k.replace("encoder.model.", "encoder.")
        k = k.replace("decoder.model.", "decoder.")
        k = k.replace(".in_proj_weight", ".in_proj.weight")
        k = k.replace(".linear1.weight", ".gating.linear1.weight")
        k = k.replace(".linear2.weight", ".gating.linear2.weight")
        for layer_idx, dec_idx in enumerate([2, 5, 8, 11]):
            k = k.replace(f"decoder.{dec_idx}.", f"decoder.layers.{layer_idx}.upsample.")
            k = k.replace(f"decoder.{dec_idx + 1}.", f"decoder.layers.{layer_idx}.residuals.0.")
        for layer_idx, enc_idx in enumerate([1, 4, 7, 10]):
            k = k.replace(f"encoder.{enc_idx}.", f"encoder.layers.{layer_idx}.residuals.0.")
            k = k.replace(f"encoder.{enc_idx + 2}.", f"encoder.layers.{layer_idx}.downsample.")
        k = k.replace("decoder.0.", "decoder.init_conv1d.")
        k = k.replace("decoder.14.", "decoder.final_conv1d.")
        k = k.replace("encoder.0.", "encoder.init_conv1d.")
        k = k.replace("encoder.14.", "encoder.final_conv1d.")
        k = k.replace(".block.1.", ".block.0.")
        k = k.replace(".block.3.", ".block.1.")
        # the streaming convs hold their weights directly
        k = k.replace(".conv.conv.", ".").replace(".convtr.convtr.", ".")
        k = k.replace(".conv.weight", ".weight").replace(".conv.bias", ".bias")
        k = k.replace(".convtr.weight", ".weight").replace(".convtr.bias", ".bias")

        if (k.endswith("input_proj.weight") or k.endswith("output_proj.weight")) and v.ndim == 3:
            v = v[..., 0]  # 1x1 conv [O, I, 1] -> Linear [O, I]
        elif k.endswith(".weight") and v.ndim == 3:
            if ".upsample." in k or k.startswith("upsample."):
                v = v.transpose(2, 0, 1)  # convT [I, O/g, K] -> [K, I, O/g]
            else:
                v = v.transpose(2, 1, 0)  # conv [O, I, K] -> [K, I, O]
        out[k] = v
    return out


def _unpermute_rope(w: np.ndarray, n_heads: int) -> np.ndarray:
    """HF's rotate-half q/k rows -> the interleaved pairs of Kyutai's RoPE
    (the inverse of the permutation the transformers conversion applies)."""
    o, i = w.shape
    hd = o // n_heads
    return w.reshape(n_heads, 2, hd // 2, i).swapaxes(1, 2).reshape(o, i)


def sanitize_hf_mimi(weights: dict, n_heads: int = 8, n_ratios: int = 4) -> dict:
    """An HF-transformers ``MimiModel`` checkpoint (``kyutai/mimi``) -> the
    JAX package's paths and layouts.

    HF's SEANet indices: encoder 0 = init, 3i+1 = residual block, 3i+3 =
    downsample, 3 nr + 2 = final; decoder 0 = init, 3i+2 = upsample, 3i+3
    = residual block, 3 nr + 2 = final (ELUs fill the gaps).  q, k and v
    join into ``in_proj`` after q's and k's rows leave HF's rotate-half
    order."""
    out = {}
    qkv: dict[str, np.ndarray] = {}
    for k, v in weights.items():
        v = np.asarray(v)
        if "_transformer.layers." in k and ".self_attn." in k and any(
                p in k for p in ("q_proj", "k_proj", "v_proj")):
            qkv[k] = v
            continue
        for side in ("encoder", "decoder"):
            if not k.startswith(side + ".layers."):
                continue
            parts = k.split(".")
            idx = int(parts[2])
            rest = ".".join(parts[3:])
            if rest.startswith("conv."):
                rest = rest[len("conv."):]
            rest = rest.replace("block.1.conv.", "block.0.")
            rest = rest.replace("block.3.conv.", "block.1.")
            if idx == 0:
                k = f"{side}.init_conv1d.{rest}"
            elif idx == 3 * n_ratios + 2:
                k = f"{side}.final_conv1d.{rest}"
            elif side == "encoder" and (idx - 1) % 3 == 0:
                k = f"encoder.layers.{(idx - 1) // 3}.residuals.0.{rest}"
            elif side == "encoder":
                k = f"encoder.layers.{(idx - 3) // 3}.downsample.{rest}"
            elif (idx - 2) % 3 == 0:
                k = f"decoder.layers.{(idx - 2) // 3}.upsample.{rest}"
            else:
                k = f"decoder.layers.{(idx - 3) // 3}.residuals.0.{rest}"
            break
        k = k.replace(".self_attn.o_proj.", ".self_attn.out_proj.")
        k = k.replace(".mlp.fc1.", ".gating.linear1.")
        k = k.replace(".mlp.fc2.", ".gating.linear2.")
        k = k.replace(".input_layernorm.", ".norm1.")
        k = k.replace(".post_attention_layernorm.", ".norm2.")
        k = k.replace(".self_attn_layer_scale.scale", ".layer_scale_1.scale")
        k = k.replace(".mlp_layer_scale.scale", ".layer_scale_2.scale")
        k = k.replace("semantic_residual_vector_quantizer", "rvq_first")
        k = k.replace("acoustic_residual_vector_quantizer", "rvq_rest")
        k = k.replace(".codebook.embed_sum", ".codebook.embedding_sum")
        k = k.replace(".rvq_first.layers.", ".rvq_first.vq.layers.")
        k = k.replace(".rvq_rest.layers.", ".rvq_rest.vq.layers.")
        if k == "downsample.conv.weight":
            k = "downsample.weight"
        if k == "upsample.conv.weight":
            k = "upsample.weight"
        if ("rvq" in k and v.ndim == 3
                and (k.endswith("input_proj.weight") or k.endswith("output_proj.weight"))):
            v = v[..., 0]  # 1x1 conv -> Linear [O, I]
        elif k.endswith(".weight") and v.ndim == 3:
            if ".upsample." in k or k == "upsample.weight":
                v = v.transpose(2, 0, 1)  # convT [I, O/g, K] -> [K, I, O/g]
            else:
                v = v.transpose(2, 1, 0)  # conv [O, I, K] -> [K, I, O]
        out[k] = v
    for k, q in qkv.items():
        if "q_proj" not in k:
            continue
        pre = k[: -len("q_proj.weight")]
        out[pre + "in_proj.weight"] = np.concatenate(
            [_unpermute_rope(q, n_heads), _unpermute_rope(qkv[pre + "k_proj.weight"], n_heads),
             qkv[pre + "v_proj.weight"]], axis=0)
    return out
