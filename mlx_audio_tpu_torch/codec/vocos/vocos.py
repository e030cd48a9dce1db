"""Vocos, the mel (or EnCodec-token) to waveform vocoder: a ConvNeXt
backbone and an ISTFT head (counterpart of
``mlx_audio_tpu/codec/vocos/vocos.py``).

Sequences are channels last, ``[batch, frames, channels]``.  The mel
features are the JAX package's: a reflect-centred periodic-Hann STFT as a
matmul DFT (``dsp.stft_realimag``), its last frame dropped, an HTK
filterbank with no norm, the natural log floored at 1e-5.  The backbone's
``embed`` conv (C = 100) and depthwise ``dwconv`` take the library route of
``nn.layers.conv1d``; the head's ISTFT is ``dsp.istft``.  Only
``padding="center"`` exists, as in the JAX package: "same" raises.

``Vocos.from_hparams(config, device="cuda", seed=0)`` builds a model from
a ``config.yaml``'s dictionary with seeded weights; ``from_pretrained``
loads a local checkpoint directory.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
from torch import nn

from mlx_audio_tpu_torch import dsp
from mlx_audio_tpu_torch.models.base import init_weights, model_device
from mlx_audio_tpu_torch.nn.layers import Conv1d, LayerNorm, Linear, _param


def vocos_mel_24khz_config() -> dict:
    """``charactr/vocos-mel-24khz``'s ``config.yaml``: 100 mels, n_fft 1024,
    hop 256, a 512-wide backbone of 8 ConvNeXt blocks (1536 intermediate),
    the ISTFT head with centre padding."""
    mel = dict(sample_rate=24000, n_fft=1024, hop_length=256, n_mels=100,
               padding="center")
    return {
        "feature_extractor": {
            "class_path": "vocos.feature_extractors.MelSpectrogramFeatures",
            "init_args": mel},
        "backbone": {"class_path": "vocos.models.VocosBackbone",
                     "init_args": dict(input_channels=100, dim=512,
                                       intermediate_dim=1536, num_layers=8)},
        "head": {"class_path": "vocos.heads.ISTFTHead",
                 "init_args": dict(dim=512, n_fft=1024, hop_length=256,
                                   padding="center")},
    }


def log_mel_spectrogram(audio: torch.Tensor, sample_rate: int = 24_000,
                        n_mels: int = 100, n_fft: int = 1024,
                        hop_length: int = 256, padding: int = 0) -> torch.Tensor:
    """[T] or [B, T] -> [B, frames, n_mels]."""
    audio = torch.as_tensor(audio, dtype=torch.float32)
    if audio.ndim == 1:
        audio = audio[None]
    if padding > 0:
        audio = torch.nn.functional.pad(audio, (0, padding))
    re, im = dsp.stft_realimag(audio, n_fft, hop_length, n_fft,
                               "hann_periodic", center=True)
    mag = torch.sqrt(re * re + im * im)[..., :-1, :]
    fb = dsp.mel_filters(sample_rate, n_fft, n_mels, norm=None,
                         mel_scale="htk", device=audio.device)
    return torch.log(torch.clamp(mag @ fb.t(), min=1e-5))


class MelSpectrogramFeatures(nn.Module):
    def __init__(self, sample_rate=24_000, n_fft=1024, hop_length=256,
                 n_mels=100, padding="center"):
        super().__init__()
        if padding != "center":
            raise NotImplementedError(
                "MelSpectrogramFeatures supports padding='center' only")
        self.sample_rate = sample_rate
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.n_mels = n_mels

    def forward(self, audio: torch.Tensor, **kwargs) -> torch.Tensor:
        return log_mel_spectrogram(audio, sample_rate=self.sample_rate,
                                   n_mels=self.n_mels, n_fft=self.n_fft,
                                   hop_length=self.hop_length)


class EncodecFeatures(nn.Module):
    """EnCodec-token features: the codebook embeddings of the quantizer
    levels, summed.  ``codebook_weights`` is the concatenation of the first
    levels' codebooks, copied from ``encodec`` when built."""

    def __init__(self, encodec, bandwidths: List[float] = (1.5, 3.0, 6.0, 12.0)):
        super().__init__()
        self.encodec = encodec
        self.bandwidths = list(bandwidths)
        num_q = encodec.quantizer.get_num_quantizers_for_bandwidth(max(bandwidths))
        with torch.no_grad():
            self.codebook_weights = nn.Parameter(torch.cat(
                [vq.codebook.embed for vq in encodec.quantizer.layers[:num_q]]),
                requires_grad=False)
        self.codebook_size = encodec.quantizer.codebook_size

    def get_encodec_codes(self, audio, bandwidth_id: int):
        return self.encodec.encode(
            audio, bandwidth=self.bandwidths[int(bandwidth_id)])[0]

    def get_features_from_codes(self, codes: torch.Tensor) -> torch.Tensor:
        """codes [nq, B, T] -> features [B, T, D]."""
        codes = torch.as_tensor(codes, device=self.codebook_weights.device)
        offsets = torch.arange(codes.shape[0], device=codes.device) * self.codebook_size
        idx = codes.long() + offsets[:, None, None]
        return torch.nn.functional.embedding(idx, self.codebook_weights).sum(0)

    def forward(self, audio, **kwargs):
        bandwidth_id = kwargs.get("bandwidth_id")
        if bandwidth_id is None:
            raise ValueError("The 'bandwidth_id' argument is required")
        return self.get_features_from_codes(
            self.get_encodec_codes(audio, bandwidth_id))


class AdaLayerNorm(nn.Module):
    """Layer norm whose scale and shift a conditioning vector selects: an
    integer bandwidth id becomes a one-hot, which through the Linear is the
    original Embedding lookup."""

    def __init__(self, num_embeddings: int, embedding_dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = Linear(num_embeddings, embedding_dim)
        self.shift = Linear(num_embeddings, embedding_dim)

    def forward(self, x, cond_embedding):
        cond = torch.as_tensor(cond_embedding, device=x.device)
        if not torch.is_floating_point(cond):
            n_emb = self.scale.weight.shape[1]
            cond = torch.nn.functional.one_hot(cond.reshape(-1).long(),
                                               n_emb).to(x.dtype)
        scale, shift = self.scale(cond), self.shift(cond)
        mean = x.mean(-1, keepdim=True)
        var = x.var(-1, keepdim=True, correction=0)
        x = (x - mean) * torch.rsqrt(var + self.eps)
        return x * scale[:, None, :] + shift[:, None, :]


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, intermediate_dim: int,
                 layer_scale_init_value: float,
                 adanorm_num_embeddings: Optional[int] = None):
        super().__init__()
        self.dwconv = Conv1d(dim, dim, kernel_size=7, padding=3, groups=dim)
        self.adanorm = adanorm_num_embeddings is not None
        if adanorm_num_embeddings:
            self.norm = AdaLayerNorm(adanorm_num_embeddings, dim, eps=1e-6)
        else:
            self.norm = LayerNorm(dim, eps=1e-6)
        self.pwconv1 = Linear(dim, intermediate_dim)
        self.pwconv2 = Linear(intermediate_dim, dim)
        self.layer_scale = layer_scale_init_value
        self.gamma = _param(dim) if layer_scale_init_value > 0 else None

    def init_weights(self, generator: torch.Generator) -> None:
        if self.gamma is not None:
            with torch.no_grad():
                self.gamma.fill_(self.layer_scale)

    def forward(self, x, cond_embedding_id=None):
        residual = x
        x = self.dwconv(x)
        x = self.norm(x, cond_embedding_id) if self.adanorm else self.norm(x)
        x = self.pwconv2(torch.nn.functional.gelu(self.pwconv1(x)))
        if self.gamma is not None:
            x = self.gamma * x
        return residual + x


class VocosBackbone(nn.Module):
    def __init__(self, input_channels: int, dim: int, intermediate_dim: int,
                 num_layers: int, layer_scale_init_value: Optional[float] = None,
                 adanorm_num_embeddings: Optional[int] = None, bias: bool = True):
        super().__init__()
        self.input_channels = input_channels
        self.embed = Conv1d(input_channels, dim, kernel_size=7, padding=3)
        self.adanorm = adanorm_num_embeddings is not None
        if adanorm_num_embeddings:
            self.norm = AdaLayerNorm(adanorm_num_embeddings, dim, eps=1e-6)
        else:
            self.norm = LayerNorm(dim, eps=1e-6)
        lsiv = layer_scale_init_value or 1 / num_layers
        self.convnext = nn.ModuleList(
            ConvNeXtBlock(dim, intermediate_dim, lsiv, adanorm_num_embeddings)
            for _ in range(num_layers))
        self.final_layer_norm = LayerNorm(dim, eps=1e-6)

    def forward(self, x: torch.Tensor, **kwargs) -> torch.Tensor:
        """x: [B, T, input_channels] (or [B, input_channels, T])."""
        bandwidth_id = kwargs.get("bandwidth_id")
        if x.shape[-1] != self.input_channels:
            x = x.transpose(-1, -2)
        x = self.embed(x)
        x = self.norm(x, bandwidth_id) if self.adanorm else self.norm(x)
        for block in self.convnext:
            x = block(x, cond_embedding_id=bandwidth_id)
        return self.final_layer_norm(x)


class ISTFTHead(nn.Module):
    def __init__(self, dim: int, n_fft: int, hop_length: int,
                 padding: str = "center"):
        super().__init__()
        if padding != "center":
            raise NotImplementedError("ISTFTHead supports padding='center' only")
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.out = Linear(dim, n_fft + 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, T, dim] -> audio [B, samples]."""
        mag, p = self.out(x).chunk(2, dim=-1)
        mag = torch.clamp(torch.exp(mag), max=1e2)
        spec = torch.complex(mag * torch.cos(p), mag * torch.sin(p))
        return dsp.istft(spec.transpose(-1, -2), self.hop_length, self.n_fft,
                         "hann_periodic", center=True)


class Vocos(nn.Module):
    """Feature extractor, backbone and head.  The backbone's and the head's
    weights are drawn from ``seed`` on their device when built; an
    ``EncodecFeatures`` keeps the weights of its EnCodec."""

    def __init__(self, feature_extractor, backbone: VocosBackbone,
                 head: ISTFTHead, seed: int = 0):
        super().__init__()
        self.feature_extractor = feature_extractor
        self.backbone = backbone
        self.head = head
        self.device = backbone.final_layer_norm.weight.device
        gen = torch.Generator(self.device).manual_seed(seed)
        init_weights(backbone, gen)
        init_weights(head, gen)

    @classmethod
    def from_hparams(cls, config: dict, device: str = "cuda", seed: int = 0) -> "Vocos":
        device = model_device(device, "Vocos")
        fe_cfg = config["feature_extractor"]
        if "MelSpectrogramFeatures" in fe_cfg["class_path"]:
            feature_extractor = MelSpectrogramFeatures(**fe_cfg["init_args"])
        elif "EncodecFeatures" in fe_cfg["class_path"]:
            raise NotImplementedError(
                "EncodecFeatures from_hparams requires an EnCodec checkpoint; "
                "construct EncodecFeatures directly")
        with torch.device(device):
            backbone = VocosBackbone(**config["backbone"]["init_args"])
            head = ISTFTHead(**config["head"]["init_args"])
        return cls(feature_extractor, backbone, head, seed=seed)

    @classmethod
    def from_pretrained(cls, path: str, device: str = "cuda") -> "Vocos":
        """A local checkpoint directory with ``config.yaml`` and
        ``model.safetensors``."""
        import yaml
        from safetensors.numpy import load_file

        from mlx_audio_tpu_torch.codec.loading import checkpoint_dir
        from mlx_audio_tpu_torch.convert import params_from_jax

        path = checkpoint_dir(path)
        weights = load_file(str(path / "model.safetensors"))
        with open(path / "config.yaml") as f:
            config = yaml.safe_load(f)
        model = cls.from_hparams(config, device=device)
        model.load_state_dict(params_from_jax(model.sanitize(weights), model),
                              strict=False)
        return model

    def sanitize(self, weights: dict) -> dict:
        """MLX-vocos checkpoints -> the JAX package's layouts: conv weights
        [O, K, I] -> [K, I, O]; the torch AdaLayerNorm's Embedding tables
        [num_embeddings, dim] -> Linear weights [dim, num_embeddings]."""
        out = {}
        for k, v in weights.items():
            v = np.asarray(v)
            if "window" in k:
                continue
            if k.endswith(".weight") and v.ndim == 3:
                out[k] = v.transpose(1, 2, 0)
            elif (v.ndim == 2 and v.shape[0] < v.shape[1]
                    and (k.endswith("norm.scale.weight")
                         or k.endswith("norm.shift.weight"))):
                out[k] = v.T
            else:
                out[k] = v
        return out

    @torch.no_grad()
    def forward(self, audio, **kwargs) -> torch.Tensor:
        audio = torch.as_tensor(audio, dtype=torch.float32, device=self.device)
        return self.decode(self.feature_extractor(audio, **kwargs), **kwargs)

    @torch.no_grad()
    def decode(self, features, **kwargs) -> torch.Tensor:
        """Features [B, frames, C] -> audio [B, samples]."""
        features = torch.as_tensor(features, dtype=torch.float32, device=self.device)
        return self.head(self.backbone(features, **kwargs))

    def decode_from_codes(self, codes, **kwargs) -> torch.Tensor:
        return self.decode(self.feature_extractor.get_features_from_codes(codes),
                           **kwargs)
