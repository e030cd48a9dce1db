"""IndexTTS's speaker-conditioned BigVGAN and its log-mel (counterpart of
``mlx_audio_tpu/models/tts/indextts/vocoder.py``).

The GPT's latent stream takes the place of BigVGAN's mel input
(``conv_pre`` reads ``gpt_dim`` channels), and an ECAPA d-vector of the
reference mel is added before the stack (``cond_layer``) and after each
upsampling (``conds``).  The stack is the port's BigVGAN
(``codec/bigvgan``): its AMP resblocks' 'same' convs route by shape
through ``nn.layers.conv1d``, and at IndexTTS-1.5's widths (1536 channels,
8 x 8 x 4 x 2 x 2 upsampling) the 384-channel stage takes this
repository's ``dilated_conv1d`` and ``banded_conv1d`` kernels, the
768-channel stage ``dilated_conv1d`` from 256 latents on (8 T rows >=
2048; below that cuDNN).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from mlx_audio_tpu_torch import dsp
from mlx_audio_tpu_torch.codec.bigvgan.bigvgan import BigVGAN, BigVGANConfig
from mlx_audio_tpu_torch.models.base import init_weights
from mlx_audio_tpu_torch.models.tts.indextts.ecapa import ECPATDNN, ECPATDNNArgs
from mlx_audio_tpu_torch.nn.layers import Conv1d, WNConv1d


@dataclass
class BigVGANConditioningConfig(BigVGANConfig):
    gpt_dim: int = 1
    speaker_embedding_dim: int = 1
    cond_d_vector_in_each_upsampling_layer: bool = True


def log_mel_spectrogram(audio: torch.Tensor, sample_rate: int = 24_000,
                        n_mels: int = 100, n_fft: int = 1024,
                        hop_length: int = 256) -> torch.Tensor:
    """audio [T] or [B, T] -> log-mel [B, frames, n_mels]: periodic Hann
    (torch.hann_window-trained), centred reflect-padded frames, magnitude
    sqrt(re^2 + im^2 + 1e-12), HTK mels without norm, log floor 1e-5."""
    audio = torch.atleast_2d(torch.as_tensor(audio, dtype=torch.float32))
    re, im = dsp.stft_realimag(audio, n_fft=n_fft, hop_length=hop_length,
                               win_length=n_fft, window="hann_periodic", center=True)
    mag = torch.sqrt(re * re + im * im + 1e-12)  # [B, frames, bins]
    filters = dsp.mel_filters(sample_rate, n_fft, n_mels, norm=None, mel_scale="htk",
                              device=audio.device)
    return torch.log(torch.clamp(mag @ filters.t(), min=1e-5))


class BigVGANConditioning(BigVGAN):
    def __init__(self, config, device: str = "cuda", seed: int = 0):
        if isinstance(config, dict):
            config = BigVGANConditioningConfig.from_dict(config)
        super().__init__(config, device=device, seed=seed)
        ch0 = config.upsample_initial_channel
        self.cond_in_each_up_layer = config.cond_d_vector_in_each_upsampling_layer
        with torch.device(self.device):
            self.conv_pre = WNConv1d(config.gpt_dim, ch0, 7, 1, 3)
            self.speaker_encoder = ECPATDNN(ECPATDNNArgs(
                config.num_mels, lin_neurons=config.speaker_embedding_dim))
            self.cond_layer = Conv1d(config.speaker_embedding_dim, ch0, 1)
            self.conds = nn.ModuleList(
                Conv1d(config.speaker_embedding_dim, ch0 // (2 ** (i + 1)), 1)
                for i in range(len(self.ups))) if self.cond_in_each_up_layer else None
        init_weights(self, torch.Generator(self.device).manual_seed(seed))

    @torch.no_grad()
    def forward(self, latents: torch.Tensor, mel_refer: torch.Tensor) -> torch.Tensor:
        """(GPT latents [B, T, gpt_dim], reference log-mel [B or 1, Tr,
        num_mels]) -> audio [B, T * prod(upsample_rates)].  One reference
        mel's speaker embedding broadcasts over the B rows."""
        speaker = self.speaker_encoder(mel_refer)  # [B or 1, 1, spk]
        x = self.conv_pre(latents) + self.cond_layer(speaker)
        for step in range(self.num_upsamples):
            for up in self.ups[step]:
                x = up(x)
            if self.cond_in_each_up_layer:
                x = x + self.conds[step](speaker)
            blocks = self.resblocks[step * self.num_kernels:(step + 1) * self.num_kernels]
            xs = blocks[0](x)
            for block in blocks[1:]:
                xs = xs + block(x)
            x = xs / self.num_kernels
        x = self.conv_post(self.activation_post(x))
        if self.use_tanh_at_final:
            x = torch.tanh(x)
        else:
            x = torch.clamp(x, -1.0, 1.0)
        return x[..., 0]
