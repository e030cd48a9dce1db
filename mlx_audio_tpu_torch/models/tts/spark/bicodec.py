"""Spark-TTS's BiCodec: semantic (factorized VQ) and global (speaker FSQ)
tokens, decoded by a DAC-style wave generator (counterpart of
``mlx_audio_tpu/models/tts/spark/bicodec.py``).

Sequences are channels last, ``[batch, length, channels]``.  The mel front
end is the port's ``dsp.stft_realimag`` (the window of ``win_length``
zero-padded on the right to ``n_fft``, as the JAX package pads it) and a
Slaney filterbank.  The wave generator's resblocks reuse DAC's
``ResidualUnit``: at ``DEFAULT_BICODEC_CONFIG`` its second block runs
``[1, 40 S, 384]`` for S semantic tokens, which ``nn.layers.conv1d`` sends
to ``banded_conv1d`` at dilation 1 once 40 S >= 4096 and to
``dilated_conv1d`` at the other dilations, and below that, once
40 S >= 2048; every other conv takes the library.  The prenet's speaker condition is a float vector, which
Vocos's ``AdaLayerNorm`` takes as it is.

``BiCodec(config=None, device="cuda", seed=0)`` draws its weights from
``seed`` on ``device``; ``sanitize`` maps a torch BiCodec checkpoint to the
JAX package's layout, from which ``convert.params_from_jax`` takes it on.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from mlx_audio_tpu_torch import dsp
from mlx_audio_tpu_torch.codec.dac.dac import ResidualUnit, Snake1d
from mlx_audio_tpu_torch.codec.vocos.vocos import VocosBackbone
from mlx_audio_tpu_torch.models.base import init_weights, model_device
from mlx_audio_tpu_torch.models.tts.spark.modules import (
    FactorizedVectorQuantize,
    SamplingBlock,
    SpeakerEncoder,
)
from mlx_audio_tpu_torch.nn.layers import Linear, WNConv1d, WNConvTranspose1d


def mel_spectrogram(audio: torch.Tensor, sample_rate: int = 16_000,
                    n_mels: int = 128, n_fft: int = 1024, f_min: int = 10,
                    f_max: Optional[int] = None, hop_length: int = 320,
                    win_length: int = 640) -> torch.Tensor:
    """audio [B, T] -> mel [B, frames, n_mels]: a periodic Hann of
    ``win_length``, a reflect-centred STFT, Slaney mels on the Slaney
    scale, the magnitude floored at 1e-12 under the root."""
    audio = torch.as_tensor(audio, dtype=torch.float32)
    if audio.ndim == 1:
        audio = audio[None]
    re_, im = dsp.stft_realimag(audio, n_fft=n_fft, hop_length=hop_length,
                                win_length=win_length, window="hann_periodic",
                                center=True)
    mag = torch.sqrt(re_ * re_ + im * im + 1e-12)
    filters = dsp.mel_filters(sample_rate, n_fft, n_mels, f_min=f_min, f_max=f_max,
                              norm="slaney", mel_scale="slaney", device=audio.device)
    return mag @ filters.t()


def _resamplers(dim: int, intermediate_dim: int, ratios, up: bool) -> nn.ModuleList:
    return nn.ModuleList(
        nn.ModuleList([
            SamplingBlock(dim=dim, groups=dim, upsample_scale=r if up else 1,
                          downsample_scale=1 if up else r),
            VocosBackbone(input_channels=dim, dim=dim, intermediate_dim=intermediate_dim,
                          num_layers=2)])
        for r in ratios)


class Encoder(nn.Module):
    """Vocos backbone and downsampling feature encoder."""

    def __init__(self, input_channels: int, vocos_dim: int,
                 vocos_intermediate_dim: int, vocos_num_layers: int,
                 out_channels: int, sample_ratios: List[int] = (1, 1)):
        super().__init__()
        self.encoder = VocosBackbone(input_channels=input_channels, dim=vocos_dim,
                                     intermediate_dim=vocos_intermediate_dim,
                                     num_layers=vocos_num_layers)
        self.downsample = _resamplers(vocos_dim, vocos_intermediate_dim,
                                      sample_ratios, up=False)
        self.project = Linear(vocos_dim, out_channels)

    def forward(self, x):
        """feat [B, T, input_channels] -> z [B, T', out_channels]."""
        x = self.encoder(x)
        for block, backbone in self.downsample:
            x = backbone(block(x))
        return self.project(x)


class Decoder(nn.Module):
    """Upsampling Vocos feature decoder, optionally speaker-conditioned."""

    def __init__(self, input_channels: int, vocos_dim: int,
                 vocos_intermediate_dim: int, vocos_num_layers: int,
                 out_channels: int, condition_dim: Optional[int] = None,
                 sample_ratios: List[int] = (1, 1),
                 use_tanh_at_final: bool = False):
        super().__init__()
        self.linear_pre = Linear(input_channels, vocos_dim)
        self.downsample = _resamplers(vocos_dim, vocos_intermediate_dim,
                                      sample_ratios, up=True)
        self.vocos_backbone = VocosBackbone(
            input_channels=vocos_dim, dim=vocos_dim,
            intermediate_dim=vocos_intermediate_dim, num_layers=vocos_num_layers,
            adanorm_num_embeddings=condition_dim)
        self.linear = Linear(vocos_dim, out_channels)
        self.use_tanh_at_final = use_tanh_at_final

    def forward(self, x, c=None):
        """z [B, T, input_channels] (and a condition [B, condition_dim]) ->
        [B, T * prod(ratios), out_channels]."""
        x = self.linear_pre(x)
        for block, backbone in self.downsample:
            x = backbone(block(x))
        x = self.linear(self.vocos_backbone(x, bandwidth_id=c))
        return torch.tanh(x) if self.use_tanh_at_final else x


class DecoderBlock(nn.Module):
    def __init__(self, input_dim: int, output_dim: int, kernel_size: int,
                 stride: int):
        super().__init__()
        self.block = nn.ModuleList([
            Snake1d(input_dim),
            WNConvTranspose1d(input_dim, output_dim, kernel_size=kernel_size,
                              stride=stride, padding=(kernel_size - stride) // 2),
            ResidualUnit(output_dim, dilation=1),
            ResidualUnit(output_dim, dilation=3),
            ResidualUnit(output_dim, dilation=9),
        ])

    def forward(self, x):
        for m in self.block:
            x = m(x)
        return x


class WaveGenerator(nn.Module):
    """DAC-style upsampling vocoder with explicit kernel sizes."""

    def __init__(self, input_channel: int, channels: int, rates: List[int],
                 kernel_sizes: List[int], d_out: int = 1):
        super().__init__()
        layers = [WNConv1d(input_channel, channels, kernel_size=7, padding=3)]
        output_dim = channels
        for i, (kernel_size, stride) in enumerate(zip(kernel_sizes, rates)):
            input_dim = channels // 2 ** i
            output_dim = channels // 2 ** (i + 1)
            layers.append(DecoderBlock(input_dim, output_dim, kernel_size, stride))
        layers += [Snake1d(output_dim),
                   WNConv1d(output_dim, d_out, kernel_size=7, padding=3)]
        self.model = nn.ModuleList(layers)

    def forward(self, x):
        """[B, T, C] -> [B, T * prod(rates), d_out], tanh-squashed."""
        for m in self.model:
            x = m(x)
        return torch.tanh(x)


DEFAULT_BICODEC_CONFIG: Dict[str, Any] = {
    # SparkAudio/Spark-TTS-0.5B BiCodec/config.yaml (audio_tokenizer section)
    "mel_params": {
        "sample_rate": 16000, "n_fft": 1024, "win_length": 640,
        "hop_length": 320, "mel_fmin": 10, "mel_fmax": None, "num_mels": 128,
    },
    "encoder": {
        "input_channels": 1024, "vocos_dim": 384,
        "vocos_intermediate_dim": 2048, "vocos_num_layers": 12,
        "out_channels": 1024, "sample_ratios": [1, 1],
    },
    "decoder": {
        "input_channel": 1024, "channels": 1536, "rates": [8, 5, 4, 2],
        "kernel_sizes": [16, 11, 8, 4],
    },
    "quantizer": {
        "input_dim": 1024, "codebook_size": 8192, "codebook_dim": 8,
    },
    "speaker_encoder": {
        "input_dim": 128, "out_dim": 1024, "latent_dim": 128, "token_num": 32,
        "fsq_levels": [4, 4, 4, 4, 4, 4], "fsq_num_quantizers": 1,
    },
    "prenet": {
        "input_channels": 1024, "vocos_dim": 384,
        "vocos_intermediate_dim": 2048, "vocos_num_layers": 12,
        "out_channels": 1024, "condition_dim": 1024,
        "sample_ratios": [1, 1], "use_tanh_at_final": False,
    },
    "postnet": {
        "input_channels": 1024, "vocos_dim": 384,
        "vocos_intermediate_dim": 2048, "vocos_num_layers": 6,
        "out_channels": 1024, "sample_ratios": [1, 1],
        "use_tanh_at_final": False,
    },
}


class BiCodec(nn.Module):
    """The speaker-conditioned two-stream codec."""

    def __init__(self, config: Optional[Dict[str, Any]] = None,
                 device: str = "cuda", seed: int = 0):
        super().__init__()
        config = config or DEFAULT_BICODEC_CONFIG
        device = model_device(device, "BiCodec")
        self.config = {**DEFAULT_BICODEC_CONFIG, **config}
        self.mel_params = self.config["mel_params"]
        with torch.device(device):
            self.encoder = Encoder(**self.config["encoder"])
            self.quantizer = FactorizedVectorQuantize(**self.config["quantizer"])
            self.prenet = Decoder(**self.config["prenet"])
            self.postnet = Decoder(**self.config["postnet"])
            self.decoder = WaveGenerator(**self.config["decoder"])
            self.speaker_encoder = SpeakerEncoder(**self.config["speaker_encoder"])
        init_weights(self, torch.Generator(device).manual_seed(seed))
        self.device = device

    def _on(self, x, dtype=None):
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    def get_mel_spectrogram(self, wav):
        """ref wav [B, T] -> mel [B, frames, n_mels]."""
        p = self.mel_params
        return mel_spectrogram(
            self._on(wav, torch.float32), sample_rate=p["sample_rate"],
            n_mels=p["num_mels"], n_fft=p["n_fft"], f_min=p["mel_fmin"],
            f_max=p.get("mel_fmax"), hop_length=p["hop_length"],
            win_length=p["win_length"])

    @torch.no_grad()
    def tokenize(self, feat, ref_wav):
        """(wav2vec2 features [B, T, 1024], ref wav [B, S]) ->
        (semantic tokens [B, T'], global tokens [B, 32])."""
        mel = self.get_mel_spectrogram(ref_wav)
        semantic = self.quantizer.tokenize(self.encoder(self._on(feat, torch.float32)))
        return semantic, self.speaker_encoder.tokenize(mel)

    @torch.no_grad()
    def detokenize(self, semantic_tokens, global_tokens) -> torch.Tensor:
        """(semantic [B, T], global [B, 32] or [B, 1, 32]) -> wav [B, S]."""
        semantic_tokens = self._on(semantic_tokens, torch.long)
        global_tokens = self._on(global_tokens, torch.long)
        if global_tokens.ndim == 3:
            global_tokens = global_tokens.reshape(global_tokens.shape[0], -1)
        z_q = self.quantizer.detokenize(semantic_tokens)
        d_vector = self.speaker_encoder.detokenize(global_tokens)
        x = self.prenet(z_q, d_vector) + d_vector[:, None, :]
        return self.decoder(x)[..., 0]

    @staticmethod
    def _is_conv_transpose_key(k: str) -> bool:
        # the SamplingBlock upsampler, and the transposed conv inside each
        # wave-generator DecoderBlock (index 1 of its Sequential)
        return "de_conv_upsampler" in k or ("decoder.model" in k and ".block.1." in k)

    def sanitize(self, weights: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Torch BiCodec checkpoint -> the JAX package's naming and layout.

        Torch: conv weight/v [O, I, K], transposed conv [I, O, K], conv g
        [O, 1, 1], transposed conv g [I, 1, 1], snake alpha [1, C, 1].  JAX:
        conv and transposed conv [K, I, O], conv g [1, 1, O], transposed
        conv g [1, I, 1], alpha [C].
        """
        out = {}
        for k, v in weights.items():
            v = np.asarray(v)
            if "num_batches_tracked" in k:
                continue
            # the samplers are torch Sequential(LeakyReLU, conv)
            k = k.replace("de_conv_upsampler.1.", "de_conv_upsampler.")
            k = k.replace("conv_downsampler.1.", "conv_downsampler.")
            # the perceiver feed-forward is a Sequential [Linear, GEGLU, Linear]
            k = re.sub(r"(perceiver_sampler\.layers\.\d+\.1)\.0\.", r"\1.w_in.", k)
            k = re.sub(r"(perceiver_sampler\.layers\.\d+\.1)\.2\.", r"\1.w_out.", k)
            is_t = self._is_conv_transpose_key(k)
            if k.endswith("weight_g") and v.ndim == 3:
                v = v.transpose((1, 0, 2)) if is_t else v.transpose((1, 2, 0))
            elif k.endswith(("weight_v", "weight")) and v.ndim == 3:
                v = v.transpose((2, 0, 1)) if is_t else v.transpose((2, 1, 0))
            elif k.endswith(".alpha") and v.ndim == 3:
                v = v.reshape(-1)
            out[k] = v
        return out

    @torch.no_grad()
    def forward(self, feat, ref_wav) -> Dict[str, Any]:
        """The training-style forward: reconstruction, predicted features,
        x- and d-vectors, semantic indices."""
        mel = self.get_mel_spectrogram(ref_wav)
        vq = self.quantizer(self.encoder(self._on(feat, torch.float32)))
        x_vector, d_vector = self.speaker_encoder(mel)
        x = self.prenet(vq["z_q"], d_vector)
        pred_feat = self.postnet(x)
        wav = self.decoder(x + d_vector[:, None, :])
        return {"recons": wav[..., 0], "pred_feat": pred_feat,
                "x_vector": x_vector, "d_vector": d_vector,
                "indices": vq["indices"]}
