"""S3 speech tokenizers v1 and v2 (CosyVoice lineage; counterpart of
``mlx_audio_tpu/codec/s3/s3.py``).

A Whisper-style encoder (two convs, then transformer blocks) over 128-mel
features; v1 quantizes with an L2-normalised Euclidean codebook, v2 with
FSQ (3^8 levels), FSMN memory convs in its attention and rotary
positions.  Channels last (NLC) throughout.

The convs go through ``nn.layers.conv1d``: v1 at 50 Hz (``conv1`` at stride
1, 'same', C = 128) takes the ``dilated_conv1d`` kernel on a card once a
window of 2048 frames or more, as Whisper's conv1 does; the strided convs
and the depthwise FSMN conv take the library, as in the JAX package.
Eager PyTorch stands in for the JAX package's jitted ``_s3_quantize_jit``.
``from_pretrained`` reads a local directory only.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mlx_audio_tpu_torch import dsp
from mlx_audio_tpu_torch.models.base import init_weights, model_device
from mlx_audio_tpu_torch.nn.layers import Conv1d, LayerNorm, Linear, _param


@dataclass
class S3Config:
    n_mels: int = 128
    n_audio_ctx: int = 1500
    n_audio_state: int = 1280
    n_audio_head: int = 20
    n_audio_layer: int = 6
    n_codebook_size: int = 4096


def log_mel_spectrogram(audio, sample_rate: int = 16_000, n_mels: int = 128,
                        n_fft: int = 400, hop_length: int = 160,
                        padding: int = 0) -> torch.Tensor:
    """[T] -> [n_mels, frames]: periodic Hann, Slaney mel, Whisper's log
    compression, on the device of ``audio`` (an array: the CPU)."""
    audio = torch.as_tensor(audio, dtype=torch.float32)
    if padding > 0:
        audio = F.pad(audio, (0, padding))
    # the window in float32, as the JAX package hands it to its STFT
    window = dsp._window_np("hann", n_fft + 1)[:-1].astype(np.float32)
    re, im = dsp.stft_realimag(audio, n_fft, hop_length, n_fft, window, center=True)
    fb = dsp.mel_filters(sample_rate, n_fft, n_mels, norm="slaney",
                         mel_scale="slaney", device=audio.device)
    mel = (re * re + im * im) @ fb.t()  # [frames, n_mels]
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    log_spec = torch.maximum(log_spec, log_spec.max() - 8.0)
    return ((log_spec + 4.0) / 4.0).t()


def make_non_pad_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    return torch.arange(max_len, device=lengths.device)[None, :] < lengths[:, None]


def sinusoids(length: int, channels: int, max_timescale: float = 10000) -> np.ndarray:
    log_inc = np.log(max_timescale) / (channels // 2 - 1)
    inv = np.exp(-log_inc * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1)


class S3Attention(nn.Module):
    """Whisper-layout attention, with rotary positions and an FSMN memory
    conv on the values (depthwise, ``fsmn_kernel`` taps) in v2."""

    def __init__(self, n_state: int, n_head: int, fsmn_kernel: Optional[int] = None):
        super().__init__()
        self.n_head = n_head
        self.head_dim = n_state // n_head
        self.query = Linear(n_state, n_state)
        self.key = Linear(n_state, n_state, bias=False)
        self.value = Linear(n_state, n_state)
        self.out = Linear(n_state, n_state)
        if fsmn_kernel is not None:
            self.fsmn_block = Conv1d(n_state, n_state, fsmn_kernel, stride=1,
                                     padding=0, groups=n_state, bias=False)
            self.fsmn_left = (fsmn_kernel - 1) // 2
            self.fsmn_right = fsmn_kernel - 1 - self.fsmn_left
        else:
            self.fsmn_block = None

    def _fsmn(self, v_flat, mask_pad):
        x = v_flat if mask_pad is None else v_flat * mask_pad
        xp = F.pad(x, (0, 0, self.fsmn_left, self.fsmn_right))
        y = self.fsmn_block(xp) + x
        return y if mask_pad is None else y * mask_pad

    def forward(self, x, mask=None, mask_pad=None, rope=None):
        b, t, d = x.shape

        def split(z):
            return z.reshape(b, t, self.n_head, self.head_dim)

        qh, kh, vh = split(self.query(x)), split(self.key(x)), split(self.value(x))
        if rope is not None:
            cos, sin = rope
            c = cos[:t][None, :, None, :]
            s = sin[:t][None, :, None, :]

            def rot(z):
                z1, z2 = z.chunk(2, dim=-1)
                return z * c + torch.cat([-z2, z1], dim=-1) * s

            qh, kh = rot(qh), rot(kh)
        fsm_memory = 0.0
        if self.fsmn_block is not None:
            fsm_memory = self._fsmn(vh.reshape(b, t, d), mask_pad)
        qh, kh, vh = (z.transpose(1, 2) for z in (qh, kh, vh))
        scores = (qh @ kh.transpose(-1, -2)).float() * self.head_dim ** -0.5
        if mask is not None:
            scores = scores + mask
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        out = (probs @ vh).transpose(1, 2).reshape(b, t, d)
        return self.out(out) + fsm_memory


class S3Block(nn.Module):
    def __init__(self, n_state: int, n_head: int, fsmn_kernel: Optional[int] = None,
                 ln_eps: float = 1e-5):
        super().__init__()
        self.attn = S3Attention(n_state, n_head, fsmn_kernel)
        self.attn_ln = LayerNorm(n_state, eps=1e-6 if fsmn_kernel else ln_eps)
        self.mlp1 = Linear(n_state, n_state * 4)
        self.mlp2 = Linear(n_state * 4, n_state)
        self.mlp_ln = LayerNorm(n_state)

    def forward(self, x, mask=None, mask_pad=None, rope=None):
        x = x + self.attn(self.attn_ln(x), mask, mask_pad, rope)
        return x + self.mlp2(F.gelu(self.mlp1(self.mlp_ln(x))))


class S3Encoder(nn.Module):
    """The position tables are buffers, so a checkpoint carries them as
    the JAX package's arrays do."""

    def __init__(self, cfg: S3Config, stride: int, v2: bool = False):
        super().__init__()
        self.stride = stride
        self.v2 = v2
        self.conv1 = Conv1d(cfg.n_mels, cfg.n_audio_state, 3, stride=stride, padding=1)
        self.conv2 = Conv1d(cfg.n_audio_state, cfg.n_audio_state, 3, stride=2, padding=1)
        if v2:
            # 64 for the published 1280-wide, 20-head model
            head_dim = cfg.n_audio_state // cfg.n_audio_head
            inv = 1.0 / (10000 ** (np.arange(0, head_dim, 2) / head_dim))
            fr = np.outer(np.arange(2048), inv)
            self.register_buffer("rope_cos", torch.as_tensor(
                np.concatenate([np.cos(fr)] * 2, axis=-1), dtype=torch.float32))
            self.register_buffer("rope_sin", torch.as_tensor(
                np.concatenate([np.sin(fr)] * 2, axis=-1), dtype=torch.float32))
            self.positional_embedding = None
        else:
            self.register_buffer("positional_embedding", torch.as_tensor(
                sinusoids(cfg.n_audio_ctx, cfg.n_audio_state), dtype=torch.float32))
        self.blocks = nn.ModuleList(
            S3Block(cfg.n_audio_state, cfg.n_audio_head, fsmn_kernel=31 if v2 else None)
            for _ in range(cfg.n_audio_layer))

    def forward(self, mel: torch.Tensor, mel_len: torch.Tensor):
        """mel [B, n_mels, T] -> (hidden [B, T', D], T' lengths [B])."""
        x = mel.transpose(1, 2)
        mask = make_non_pad_mask(mel_len, x.shape[1])[..., None]
        x = F.gelu(self.conv1(x * mask))
        x_len = (mel_len + 2 - 2 - 1) // self.stride + 1
        mask = make_non_pad_mask(x_len, x.shape[1])[..., None]
        x = F.gelu(self.conv2(x * mask))
        x_len = (x_len + 2 - 2 - 1) // 2 + 1
        mask_pad = make_non_pad_mask(x_len, x.shape[1])[..., None]
        attn_mask = torch.where(mask_pad[:, None, None, :, 0], 0.0, -1e9)
        if self.positional_embedding is not None:
            x = x + self.positional_embedding[:x.shape[1]].to(x.dtype)
            rope = None
        else:
            rope = (self.rope_cos, self.rope_sin)
        for block in self.blocks:
            x = block(x, attn_mask, mask_pad.to(x.dtype), rope)
        return x, x_len


class EuclideanVQ(nn.Module):
    """The v1 codebook; the nearest entry to the L2-normalised feature."""

    def __init__(self, dim: int, codebook_size: int):
        super().__init__()
        self.codebook_size = codebook_size
        self.embed = _param(codebook_size, dim)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        # the JAX package starts the codebook at zero for loading; random
        # weights need distinct entries: Gaussian rows on the unit sphere,
        # where the normalised features lie
        self.embed.normal_(generator=generator)
        self.embed /= self.embed.norm(dim=-1, keepdim=True)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        x = x / torch.sqrt((x ** 2).sum(-1, keepdim=True) + 1e-8)
        flat = x.reshape(-1, x.shape[-1]).float()
        emb = self.embed
        dist = ((flat ** 2).sum(1, keepdim=True) - 2 * flat @ emb.t()
                + (emb.float() ** 2).sum(1)[None, :])
        return torch.argmin(dist, dim=-1).reshape(x.shape[:-1])

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        return self.embed[codes]


class FSQCodebook(nn.Module):
    """Finite scalar quantization: project to 8 dims, tanh, round to
    {0, 1, 2}, read the 8 digits in base 3."""

    def __init__(self, dim: int, level: int = 3):
        super().__init__()
        self.project_down = Linear(dim, 8)
        self.level = level

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        shape = x.shape
        h = torch.tanh(self.project_down(x.reshape(-1, shape[-1])).float())
        h = torch.round(h * 0.9990000128746033) + 1
        powers = float(self.level) ** torch.arange(2 ** self.level, dtype=h.dtype,
                                                   device=h.device)
        return (h * powers[None, :]).sum(-1).reshape(shape[0], shape[1]).long()


class _S3Base(nn.Module):
    """An encoder and a quantizer on ``device`` ("cuda" unless the caller
    asks for "cpu"), weights drawn from ``seed``."""

    def _build(self, config: S3Config, stride: int, v2: bool, device, seed: int):
        device = model_device(device, type(self).__name__)
        self.config = config
        with torch.device(device):
            self.encoder = S3Encoder(config, stride, v2=v2)
            self.quantizer = (FSQCodebook(config.n_audio_state, level=3) if v2
                              else EuclideanVQ(config.n_audio_state,
                                               config.n_codebook_size))
        self.to(device)
        init_weights(self, torch.Generator(device).manual_seed(seed))
        self.device = device

    def forward(self, mel, mel_len):
        return self.quantize(mel, mel_len)

    @torch.no_grad()
    def quantize(self, mel, mel_len):
        """mel [B, n_mels, T] and lengths [B] -> (codes [B, T'], lengths
        [B]) on the model's device."""
        mel = torch.as_tensor(mel, dtype=torch.float32, device=self.device)
        mel_len = torch.as_tensor(mel_len, device=self.device).long()
        hidden, code_len = self.encoder(mel, mel_len)
        return self.quantizer.encode(hidden), code_len

    @classmethod
    def from_pretrained(cls, name: Optional[str] = None,
                        repo_id: str = "mlx-community/CosyVoice2-0.5B-S3Tokenizer",
                        config: Optional[S3Config] = None, device: str = "cuda"):
        """The named tokenizer's weights (``{name}.safetensors``, else every
        safetensors file) from the local directory ``repo_id``, in the MLX
        community layout.  Nothing is fetched: a path that does not exist
        raises ``FileNotFoundError`` naming it."""
        from mlx_audio_tpu_torch.codec.loading import checkpoint_dir, load_weights_files
        from mlx_audio_tpu_torch.convert import params_from_jax

        name = name or cls.default_name
        path = checkpoint_dir(repo_id)
        model = cls(name, config=config, device=device)
        f = path / f"{name}.safetensors"
        if f.exists():
            from safetensors.numpy import load_file

            weights = load_file(str(f))
        else:
            weights = load_weights_files(path)
        model.load_state_dict(params_from_jax(_s3_sanitize(weights), model), strict=False)
        return model


class S3Tokenizer(_S3Base):
    """v1: Euclidean VQ over the encoder's features; 50 Hz codes, or 25 Hz
    for ``speech_tokenizer_v1_25hz`` (conv1 at stride 2)."""

    default_name = "speech_tokenizer_v1"

    def __init__(self, name: str = "speech_tokenizer_v1",
                 config: Optional[S3Config] = None, device: str = "cuda", seed: int = 0):
        super().__init__()
        stride = 2 if name == "speech_tokenizer_v1_25hz" else 1
        self._build(config or S3Config(), stride, False, device, seed)


class S3TokenizerV2(_S3Base):
    """v2: FSQ codes (3^8) and FSMN attention with rotary positions, 25 Hz."""

    default_name = "speech_tokenizer_v2_25hz"

    def __init__(self, name: str = "speech_tokenizer_v2_25hz",
                 config: Optional[S3Config] = None, device: str = "cuda", seed: int = 0):
        super().__init__()
        config = dataclasses.replace(config) if config else S3Config()
        if "v1" not in name:
            config.n_codebook_size = 3 ** 8
        self._build(config, 2, True, device, seed)


def _s3_sanitize(weights: dict) -> dict:
    """MLX community S3 safetensors -> the JAX package's layout: conv
    weights [O, K, I] -> [K, I, O]."""
    out = {}
    for k, v in weights.items():
        v = np.asarray(v)
        if k.endswith(".weight") and v.ndim == 3:
            v = v.transpose(1, 2, 0)
        out[k] = v
    return out
