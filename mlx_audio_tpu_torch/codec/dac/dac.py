"""Descript Audio Codec (DAC), the RVQ-GAN codec at 16/24/44.1 kHz
(counterpart of ``mlx_audio_tpu/codec/dac/dac.py``).

Sequences are channels last, ``[batch, length, channels]``, between blocks,
as in the JAX package; ``encode`` takes and ``decode`` returns NCL audio
``[B, 1, T]``.  The resblock convs go through ``nn.layers.conv1d``, whose
route sends the 'same' float32 convs of 128-multiple widths to the
``banded_conv1d`` and ``dilated_conv1d`` kernels (at 44.1 kHz: the C = 128,
256 and 384 resblocks to the banded kernel, C = 512 and 768 and the
dilation-9 convs at C = 256 and 384 to the dilated one, for a 3 s clip);
every other conv takes the library.

``DAC(config, device="cuda", seed=0)`` builds its weights on ``device``
from ``seed``; real ones load with ``from_pretrained`` (a local checkpoint
directory) or ``load_state_dict``.  ``sanitize`` maps checkpoint keys and
layouts to the JAX package's; ``convert.params_from_jax`` takes them on to
the port's.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import List, Optional, Union

import numpy as np
import torch
from torch import nn

from mlx_audio_tpu_torch.models.base import BaseModelArgs, init_weights, model_device
from mlx_audio_tpu_torch.nn.layers import (
    Embedding,
    WNConv1d,
    WNConvTranspose1d,
    _param,
    promote_operands,
    snake,
)


@dataclass
class DACConfig(BaseModelArgs):
    encoder_dim: int = 64
    encoder_rates: List[int] = field(default_factory=lambda: [2, 4, 5, 8])
    latent_dim: Optional[int] = None
    decoder_dim: int = 1536
    decoder_rates: List[int] = field(default_factory=lambda: [8, 5, 4, 2])
    n_codebooks: int = 32
    codebook_size: int = 1024
    codebook_dim: Union[int, list] = 8
    sample_rate: int = 44100


def dac_44khz_config() -> DACConfig:
    """The published 44.1 kHz codec (``descript/dac_44khz``, as
    ``mlx-community/descript-audio-codec-44khz`` converts it)."""
    return DACConfig(encoder_dim=64, encoder_rates=[2, 4, 8, 8],
                     decoder_dim=1536, decoder_rates=[8, 8, 4, 2],
                     n_codebooks=9, codebook_size=1024, codebook_dim=8,
                     sample_rate=44100)


class Snake1d(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.alpha = _param(channels)

    def init_weights(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.alpha.fill_(1.0)

    def forward(self, x):
        return snake(x, self.alpha)


class ResidualUnit(nn.Module):
    def __init__(self, dim: int = 16, dilation: int = 1, kernel: int = 7,
                 groups: int = 1):
        super().__init__()
        pad = ((kernel - 1) * dilation) // 2
        self.block = nn.ModuleList([
            Snake1d(dim),
            WNConv1d(dim, dim, kernel, dilation=dilation, padding=pad,
                     groups=groups),
            Snake1d(dim),
            WNConv1d(dim, dim, 1),
        ])

    def forward(self, x):
        y = x
        for layer in self.block:
            y = layer(y)
        # valid convs (compress's unpadded twin) shorten y: centre-crop x
        pad = (x.shape[-2] - y.shape[-2]) // 2
        if pad > 0:
            x = x[..., pad:-pad, :]
        return x + y


class EncoderBlock(nn.Module):
    def __init__(self, dim: int = 16, stride: int = 1, groups: int = 1):
        super().__init__()
        self.block = nn.ModuleList([
            ResidualUnit(dim // 2, dilation=1, groups=groups),
            ResidualUnit(dim // 2, dilation=3, groups=groups),
            ResidualUnit(dim // 2, dilation=9, groups=groups),
            Snake1d(dim // 2),
            WNConv1d(dim // 2, dim, kernel_size=2 * stride, stride=stride,
                     padding=math.ceil(stride / 2)),
        ])

    def forward(self, x):
        for layer in self.block:
            x = layer(x)
        return x


class Encoder(nn.Module):
    def __init__(self, d_model: int = 64, strides=(2, 4, 8, 8),
                 d_latent: int = 64):
        super().__init__()
        block = [WNConv1d(1, d_model, kernel_size=7, padding=3)]
        for stride in strides:
            d_model *= 2
            block.append(EncoderBlock(d_model, stride=stride))
        block += [Snake1d(d_model), WNConv1d(d_model, d_latent, 3, padding=1)]
        self.block = nn.ModuleList(block)
        self.enc_dim = d_model

    def forward(self, x):
        """[B, T, 1] -> [B, T / hop, d_latent]."""
        for layer in self.block:
            x = layer(x)
        return x


class DecoderBlock(nn.Module):
    def __init__(self, input_dim: int = 16, output_dim: int = 8,
                 stride: int = 1):
        super().__init__()
        self.block = nn.ModuleList([
            Snake1d(input_dim),
            WNConvTranspose1d(input_dim, output_dim, kernel_size=2 * stride,
                              stride=stride, padding=math.ceil(stride / 2)),
            ResidualUnit(output_dim, dilation=1),
            ResidualUnit(output_dim, dilation=3),
            ResidualUnit(output_dim, dilation=9),
        ])

    def forward(self, x):
        for layer in self.block:
            x = layer(x)
        return x


class Decoder(nn.Module):
    def __init__(self, input_channel, channels, rates, d_out: int = 1):
        super().__init__()
        layers = [WNConv1d(input_channel, channels, kernel_size=7, padding=3)]
        output_dim = channels
        for i, stride in enumerate(rates):
            input_dim = channels // 2 ** i
            output_dim = channels // 2 ** (i + 1)
            layers.append(DecoderBlock(input_dim, output_dim, stride))
        layers += [Snake1d(output_dim),
                   WNConv1d(output_dim, d_out, 7, padding=3)]
        self.model = nn.ModuleList(layers)

    def forward(self, x):
        for layer in self.model:
            x = layer(x)
        return torch.tanh(x)


def _l2_normalize(x, dim: int = -1, eps: float = 1e-12):
    norm = torch.sqrt((x * x).sum(dim, keepdim=True))
    return x / torch.clamp(norm, min=eps)


def nearest_code(z_e: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Index [B, T] of the L2-normalised codebook row nearest to each
    L2-normalised z_e [B, T, D] (squared distances, argmin)."""
    enc = _l2_normalize(z_e)
    cb = _l2_normalize(codebook)
    # each norm in its own dtype, the product promoted, as in the JAX package
    e, c = promote_operands(enc, cb)
    dist = ((enc * enc).sum(-1, keepdim=True) - 2 * e @ c.t()
            + (cb * cb).sum(-1)[None, None, :])
    return torch.argmin(dist, dim=-1)


class VectorQuantize(nn.Module):
    """Factorized VQ with an L2-normalised lookup."""

    def __init__(self, input_dim: int, codebook_size: int, codebook_dim: int):
        super().__init__()
        self.codebook_size = codebook_size
        self.in_proj = WNConv1d(input_dim, codebook_dim, kernel_size=1)
        self.out_proj = WNConv1d(codebook_dim, input_dim, kernel_size=1)
        self.codebook = Embedding(codebook_size, codebook_dim)

    def decode_latents(self, z_e):
        """z_e [B, T, D] -> (z_q [B, T, D], indices [B, T]): the nearest
        codebook rows after L2 normalisation."""
        indices = nearest_code(z_e, self.codebook.weight)
        return self.codebook(indices), indices

    def forward(self, z):
        """z [B, T, input_dim] -> (z_q, indices [B, T], z_e)."""
        z_e = self.in_proj(z)
        z_q, indices = self.decode_latents(z_e)
        return self.out_proj(z_q), indices, z_e

    def decode_code(self, indices):
        """A code outside the codebook decodes to NaN, as the JAX package's
        ``jnp.take`` fills it."""
        emb = self.codebook.weight
        valid = (indices >= 0) & (indices < emb.shape[0])
        rows = emb[indices.clamp(0, emb.shape[0] - 1)]
        return self.out_proj(torch.where(valid[..., None], rows, float("nan")))


class ResidualVectorQuantize(nn.Module):
    def __init__(self, input_dim: int = 512, n_codebooks: int = 9,
                 codebook_size: int = 1024,
                 codebook_dim: Union[int, list] = 8):
        super().__init__()
        if isinstance(codebook_dim, int):
            codebook_dim = [codebook_dim] * n_codebooks
        self.n_codebooks = n_codebooks
        self.quantizers = nn.ModuleList(
            VectorQuantize(input_dim, codebook_size, codebook_dim[i])
            for i in range(n_codebooks))

    def forward(self, z, n_quantizers: Optional[int] = None):
        """z [B, T, D] -> (z_q, codes [B, nq, T], latents [B, T, sum dims])."""
        n_quantizers = n_quantizers or self.n_codebooks
        z_q = 0
        residual = z
        codes, latents = [], []
        for quantizer in self.quantizers[:n_quantizers]:
            z_q_i, indices_i, z_e_i = quantizer(residual)
            z_q = z_q + z_q_i
            residual = residual - z_q_i
            codes.append(indices_i)
            latents.append(z_e_i)
        return z_q, torch.stack(codes, dim=1), torch.cat(latents, dim=-1)

    def from_codes(self, codes):
        """codes [B, nq, T] -> z_q [B, T, D]."""
        z_q = 0
        for i in range(codes.shape[1]):
            z_q = z_q + self.quantizers[i].decode_code(codes[:, i])
        return z_q


class DAC(nn.Module):
    def __init__(self, config: Union[DACConfig, dict, None] = None,
                 device: str = "cuda", seed: int = 0):
        super().__init__()
        if isinstance(config, dict):
            config = DACConfig.from_dict(config)
        config = config or DACConfig()
        device = model_device(device, "DAC")
        self.config = config
        latent_dim = config.latent_dim or config.encoder_dim * (
            2 ** len(config.encoder_rates))
        self.latent_dim = latent_dim
        self.hop_length = int(np.prod(config.encoder_rates))
        self.sample_rate = config.sample_rate
        self.n_codebooks = config.n_codebooks
        self.codebook_size = config.codebook_size
        with torch.device(device):
            self.encoder = Encoder(config.encoder_dim, config.encoder_rates,
                                   latent_dim)
            self.quantizer = ResidualVectorQuantize(
                input_dim=latent_dim, n_codebooks=config.n_codebooks,
                codebook_size=config.codebook_size,
                codebook_dim=config.codebook_dim)
            self.decoder = Decoder(latent_dim, config.decoder_dim,
                                   config.decoder_rates)
        init_weights(self, torch.Generator(device).manual_seed(seed))
        self.device = device

    def preprocess(self, audio: torch.Tensor) -> torch.Tensor:
        """[B, 1, T] NCL -> [B, T_pad, 1] NLC padded to whole hops."""
        if audio.ndim == 3 and audio.shape[1] == 1:
            audio = audio.transpose(1, 2)
        length = audio.shape[-2]
        right_pad = math.ceil(length / self.hop_length) * self.hop_length - length
        if right_pad:
            audio = torch.nn.functional.pad(audio, (0, 0, 0, right_pad))
        return audio

    def encode(self, audio: torch.Tensor, n_quantizers: Optional[int] = None):
        """[B, 1, T] -> (z [B, T', D], codes [B, nq, T'], latents)."""
        z = self.encoder(self.preprocess(audio.to(self.device)))
        return self.quantizer(z, n_quantizers)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """z [B, T', D] -> audio [B, 1, T] (NCL)."""
        return self.decoder(z).transpose(1, 2)

    def decode_codes(self, codes: torch.Tensor) -> torch.Tensor:
        return self.decode(self.quantizer.from_codes(codes.to(self.device)))

    # -- chunked compression ------------------------------------------------

    @property
    def delay(self) -> int:
        from mlx_audio_tpu_torch.codec.dac.chunked import get_delay

        return get_delay(self)

    def get_output_length(self, input_length: int) -> int:
        from mlx_audio_tpu_torch.codec.dac.chunked import get_output_length

        return get_output_length(self, input_length)

    def compress(self, audio, win_duration: float = 1.0,
                 normalize_db: Optional[float] = -16,
                 n_quantizers: Optional[int] = None):
        """audio (a 1-D array) -> DACFile: windowed valid-conv encode, all
        windows as one batch."""
        from mlx_audio_tpu_torch.codec.dac.chunked import compress

        return compress(self, audio, win_duration=win_duration,
                        normalize_db=normalize_db, n_quantizers=n_quantizers)

    def decompress(self, obj, normalize_db: Optional[float] = -16):
        """DACFile (or .dac path) -> waveform [1, T] (numpy)."""
        from mlx_audio_tpu_torch.codec.dac.chunked import decompress

        return decompress(self, obj, normalize_db=normalize_db)

    def forward(self, audio: torch.Tensor, n_quantizers: Optional[int] = None):
        length = audio.shape[-1]
        z, codes, latents = self.encode(audio, n_quantizers)
        out = self.decode(z)
        return {"audio": out[..., :length], "z": z, "codes": codes,
                "latents": latents}

    # -- weights ------------------------------------------------------------

    def sanitize(self, weights: dict) -> dict:
        """Checkpoint keys and layouts -> the JAX package's: MLX conversions
        through ``sanitize_mlx``, HF-transformers ``DacModel`` checkpoints
        (``res_unit`` naming) through ``sanitize_hf_dac``."""
        if any(".res_unit" in k for k in weights):
            return sanitize_hf_dac(weights)
        return sanitize_mlx(weights)

    # HF-transformers DacConfig field names -> DACConfig
    _HF_CFG_MAP = {
        "encoder_hidden_size": "encoder_dim",
        "downsampling_ratios": "encoder_rates",
        "decoder_hidden_size": "decoder_dim",
        "upsampling_ratios": "decoder_rates",
        "hidden_size": "latent_dim",
        "sampling_rate": "sample_rate",
    }

    @classmethod
    def from_pretrained(cls, path: str, device: str = "cuda") -> "DAC":
        """Load a local checkpoint directory: the HF-transformers
        ``descript/dac_*`` layout or an mlx-community conversion."""
        from mlx_audio_tpu_torch.codec.loading import (
            checkpoint_dir,
            load_config,
            load_weights_files,
        )
        from mlx_audio_tpu_torch.convert import params_from_jax

        path = checkpoint_dir(path)
        config = load_config(path)
        for hf_k, our_k in cls._HF_CFG_MAP.items():
            if hf_k in config and our_k not in config:
                config[our_k] = config[hf_k]
        model = cls(DACConfig.from_dict(config), device=device)
        state = params_from_jax(model.sanitize(load_weights_files(path)), model)
        model.load_state_dict(state, strict=False)
        return model


def sanitize_mlx(weights: dict) -> dict:
    """MLX-converted DAC and SNAC checkpoints -> the JAX package's layouts:
    conv and transposed-conv v and g are [O, K, I]-major, and one (1, 2, 0)
    transpose maps each to [K, I, O]; snake alphas [1, C, 1] flatten."""
    out = {}
    for k, v in weights.items():
        v = np.asarray(v)
        if k.endswith("alpha") and v.ndim == 3:
            v = v.reshape(-1)
        elif k.endswith(("weight_v", "weight_g")) and v.ndim == 3:
            v = v.transpose(1, 2, 0)
        out[k] = v
    return out


def _wn_split_conv(w: np.ndarray):
    """Folded torch conv weight [O, I, K] -> (weight_v [K, I, O],
    weight_g [1, 1, O]) with g = ||w|| over (I, K), so g v / ||v|| == w."""
    g = np.sqrt((w ** 2).sum(axis=(1, 2), keepdims=True))
    return w.transpose(2, 1, 0), g.transpose(2, 1, 0)


def _wn_split_convt(w: np.ndarray):
    """Folded torch convT weight [I, O, K] -> (weight_v [K, I, O],
    weight_g [1, I, 1]); torch's weight_norm puts g on the input axis."""
    g = np.sqrt((w ** 2).sum(axis=(1, 2), keepdims=True))
    return w.transpose(2, 0, 1), g.transpose(1, 0, 2)


_RES_SLOTS = {"snake1": 0, "conv1": 1, "snake2": 2, "conv2": 3}


def sanitize_hf_dac(weights: dict) -> dict:
    """HF-transformers ``DacModel`` checkpoints (descript/dac_* format) ->
    the JAX package's paths and layouts.  HF stores folded (weight-norm
    removed) weights with ``res_unit`` naming; each is split again into
    (g, v) with g = ||w|| and v = w, which gives w back exactly."""
    n_enc = 1 + max((int(m.group(1)) for k in weights
                     if (m := re.match(r"encoder\.block\.(\d+)\.", k))),
                    default=-1)
    n_dec = 1 + max((int(m.group(1)) for k in weights
                     if (m := re.match(r"decoder\.block\.(\d+)\.", k))),
                    default=-1)

    def remap(k: str) -> tuple[str, bool]:
        """-> (JAX path, is a transposed conv)."""
        for part, base, first_unit in (("encoder", "encoder.block", 0),
                                       ("decoder", "decoder.model", 2)):
            m = re.match(part + r"\.block\.(\d+)\.(.*)$", k)
            if not m:
                continue
            i, rest = int(m.group(1)), m.group(2)
            ru = re.match(r"res_unit(\d)\.(snake1|conv1|snake2|conv2)\.(.*)$", rest)
            if ru:
                unit = int(ru.group(1)) - 1 + first_unit
                return (f"{base}.{i + 1}.block.{unit}.block."
                        f"{_RES_SLOTS[ru.group(2)]}.{ru.group(3)}"), False
            if part == "encoder":
                if rest.startswith("snake1."):
                    return f"{base}.{i + 1}.block.3.{rest[7:]}", False
                return f"{base}.{i + 1}.block.4.{rest[6:]}", False  # conv1.
            if rest.startswith("snake1."):
                return f"{base}.{i + 1}.block.0.{rest[7:]}", False
            return f"{base}.{i + 1}.block.1.{rest[8:]}", True  # conv_t1.
        fixed = {
            "encoder.conv1": "encoder.block.0",
            "encoder.snake1": f"encoder.block.{n_enc + 1}",
            "encoder.conv2": f"encoder.block.{n_enc + 2}",
            "decoder.conv1": "decoder.model.0",
            "decoder.snake1": f"decoder.model.{n_dec + 1}",
            "decoder.conv2": f"decoder.model.{n_dec + 2}",
        }
        for pre, target in fixed.items():
            if k.startswith(pre + "."):
                return target + k[len(pre):], False
        return k, False  # quantizer.* paths already match

    out = {}
    for k, v in weights.items():
        v = np.asarray(v)
        k, is_convt = remap(k)
        if k.endswith(".alpha"):
            out[k] = v.reshape(-1)
        elif k.endswith(".weight") and v.ndim == 3:
            base = k[: -len(".weight")]
            vv, g = _wn_split_convt(v) if is_convt else _wn_split_conv(v)
            out[base + ".weight_v"] = vv
            out[base + ".weight_g"] = g
        else:
            out[k] = v
    return out
