"""SilentCipher deep audio watermark: the encoder/decoder architecture
(counterpart of ``mlx_audio_tpu/models/tts/sesame/silentcipher.py``).

The message is embedded in the STFT magnitude's low band as an additive,
SDR-constrained perturbation made by a conv2d carrier encoder; a conv2d
message decoder reads per-frame logits back, trying several phase shifts.
The convolutions are 2-d and go through ``torch.nn.functional.conv2d``
(``nn.layers.Conv2d``), as the JAX package's go through
``lax.conv_general_dilated``: no kernel of this repository is on this path.

API of the silentcipher server model: ``encode_wav(audio, sr, message,
message_sdr)`` -> watermarked audio, and ``decode_wav(audio, sr,
phase_shift_decoding)`` -> ``{"status", "messages", "confidence"}``.
``load_silentcipher(dir)`` reads a checkpoint directory: torch layouts go
through ``sanitize`` (``module.`` prefixes stripped, conv2d [O, I, kh, kw]
to the JAX package's [kh, kw, I, O], the unused ``dec_c.*`` dropped), a
``native_format`` one is already in the JAX layout; both then go through
``convert.params_from_jax``.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch
from torch import nn

from mlx_audio_tpu_torch.dsp import _irdft_basis, _window_np, overlap_add, stft
from mlx_audio_tpu_torch.models.base import init_weights, model_device
from mlx_audio_tpu_torch.nn.layers import Conv2d


@dataclass
class SilentCipherConfig:
    sample_rate: int = 44100
    n_fft: int = 2048
    hop_length: int = 512
    msg_len: int = 5            # bytes in the watermark key
    msg_vocab: int = 256
    hidden: int = 64            # conv channel width
    enc_layers: int = 3
    dec_layers: int = 6
    message_band: int = 512     # low-frequency STFT bins carrying the mark


class GatedConvBlock(nn.Module):
    """conv -> x + tanh(a) * sigmoid(b), channel-preserving, NHWC."""

    def __init__(self, channels: int, kernel: int = 3):
        super().__init__()
        self.conv = Conv2d(channels, 2 * channels, kernel, padding=kernel // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, b = self.conv(x).chunk(2, dim=-1)
        return x + torch.tanh(a) * torch.sigmoid(b)


class _EmbedTable(nn.Module):
    """A message slot's table; its init is the JAX package's deterministic
    numpy draw seeded with ``vocab + dim`` (kept by ``init_weights``)."""

    def __init__(self, vocab: int, dim: int):
        super().__init__()
        rng = np.random.default_rng(vocab + dim)
        table = (rng.standard_normal((vocab, dim)) * 0.02).astype(np.float32)
        self.weight = nn.Parameter(torch.from_numpy(table), requires_grad=False)

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        return self.weight[idx]


class MsgEncoder(nn.Module):
    """Message bytes -> per-slot embeddings."""

    def __init__(self, cfg: SilentCipherConfig):
        super().__init__()
        self.cfg = cfg
        self.embeds = nn.ModuleList(_EmbedTable(cfg.msg_vocab, cfg.message_band)
                                    for _ in range(cfg.msg_len))

    def forward(self, message: torch.Tensor) -> torch.Tensor:
        """message int [L] -> [1, 1, message_band, L]."""
        cols = [emb(message[i]) for i, emb in enumerate(self.embeds)]
        return torch.stack(cols, dim=-1)[None, None]


class CarrierEncoder(nn.Module):
    """[carrier magnitude, tiled message] -> additive perturbation in the
    message band (``enc_c`` of the silentcipher checkpoint)."""

    def __init__(self, cfg: SilentCipherConfig):
        super().__init__()
        self.cfg = cfg
        self.conv_in = Conv2d(1 + cfg.msg_len, cfg.hidden, 3, padding=1)
        self.blocks = nn.ModuleList(GatedConvBlock(cfg.hidden)
                                    for _ in range(cfg.enc_layers))
        self.conv_out = Conv2d(cfg.hidden, 1, 3, padding=1)

    def forward(self, mag_band: torch.Tensor, msg_feat: torch.Tensor) -> torch.Tensor:
        """mag_band [1, T, band, 1]; msg_feat [1, 1, band, L] ->
        perturbation [1, T, band, 1]."""
        t = mag_band.shape[1]
        msg = msg_feat.expand(1, t, self.cfg.message_band, self.cfg.msg_len)
        h = torch.relu(self.conv_in(torch.cat([mag_band, msg], dim=-1)))
        for blk in self.blocks:
            h = blk(h)
        return self.conv_out(h)


class MsgDecoder(nn.Module):
    """Magnitude STFT -> per-frame logits over the message vocabulary for
    each slot (``dec_m`` of the silentcipher checkpoint)."""

    def __init__(self, cfg: SilentCipherConfig):
        super().__init__()
        self.cfg = cfg
        self.conv_in = Conv2d(1, cfg.hidden, 3, padding=1)
        self.blocks = nn.ModuleList(GatedConvBlock(cfg.hidden)
                                    for _ in range(cfg.dec_layers))
        # the frequency axis projected to each slot's vocabulary logits
        self.conv_out = Conv2d(cfg.hidden, cfg.msg_len * cfg.msg_vocab,
                               (1, cfg.message_band), padding=0)

    def forward(self, mag_band: torch.Tensor) -> torch.Tensor:
        """mag_band [1, T, band, 1] -> logits [T, msg_len, vocab]."""
        h = torch.relu(self.conv_in(mag_band))
        for blk in self.blocks:
            h = blk(h)
        out = self.conv_out(h)  # [1, T, 1, L*V]
        return out.reshape(out.shape[1], self.cfg.msg_len, self.cfg.msg_vocab)


def _stft(x: torch.Tensor, cfg: SilentCipherConfig) -> torch.Tensor:
    """[T] -> complex [frames, bins]; periodic Hann, as torch-trained
    checkpoints window."""
    return stft(x, n_fft=cfg.n_fft, hop_length=cfg.hop_length,
                window="hann_periodic", center=True)


def _istft(spec_tf: torch.Tensor, length: int, cfg: SilentCipherConfig) -> torch.Tensor:
    """The exact inverse of ``_stft`` (torch.istft's windowed overlap-add
    normalised by the overlap-add of w^2): spec [frames, bins] -> [length].
    ``dsp.istft`` keeps the window-sum normalisation, which is no true
    inverse; the watermark needs one, so that the embedded perturbation is
    the only change."""
    n_fft, hop = cfg.n_fft, cfg.hop_length
    dev = spec_tf.device
    a, b = (torch.as_tensor(m, dtype=torch.float32, device=dev) for m in _irdft_basis(n_fft))
    frames = spec_tf.real @ a + spec_tf.imag @ b
    w = torch.as_tensor(_window_np("hann_periodic", n_fft), dtype=torch.float32, device=dev)
    recon = overlap_add(frames * w, hop)
    wsq = overlap_add((w * w).expand(spec_tf.shape[0], n_fft), hop)
    recon = recon / torch.where(wsq > 1e-8, wsq, 1.0)
    return recon[n_fft // 2: n_fft // 2 + length]


class SilentCipherModel(nn.Module):
    """The 44.1 kHz silentcipher server model: ``enc_c``, ``dec_m`` and the
    message embeddings, on ``device`` ("cuda" unless the caller asks for
    "cpu"), its conv weights drawn from ``seed``."""

    def __init__(self, config: Optional[SilentCipherConfig] = None,
                 device: str = "cuda", seed: int = 0):
        super().__init__()
        device = model_device(device, "SilentCipherModel")
        self.cfg = config or SilentCipherConfig()
        with torch.device(device):
            self.msg_encoder = MsgEncoder(self.cfg)
            self.enc_c = CarrierEncoder(self.cfg)
            self.dec_m = MsgDecoder(self.cfg)
        self.to(device)  # the message tables start as numpy draws on the host
        init_weights(self, torch.Generator(device).manual_seed(seed))
        self.device = device

    def _audio(self, audio) -> torch.Tensor:
        return torch.as_tensor(np.asarray(audio, dtype=np.float32).reshape(-1),
                               device=self.device)

    # -- silentcipher server API ------------------------------------------

    @torch.no_grad()
    def encode_wav(self, audio: np.ndarray, sample_rate: int,
                   message: List[int], calc_sdr: bool = False,
                   message_sdr: float = 36.0):
        """Embed ``message``; returns (watermarked audio, None, None)."""
        cfg = self.cfg
        assert sample_rate == cfg.sample_rate, (sample_rate, cfg.sample_rate)
        x = self._audio(audio)
        spec = _stft(x, cfg)
        mag = spec.abs()
        band = mag[:, :cfg.message_band][None, :, :, None]
        msg = torch.as_tensor(list(message), dtype=torch.long, device=self.device)
        pert = self.enc_c(band, self.msg_encoder(msg))[0, :, :, 0]
        # the SDR constraint: 20 log10(|carrier| / |delta|) >= message_sdr
        target = 10.0 ** (-message_sdr / 20.0)
        c_rms = torch.sqrt((mag ** 2).mean() + 1e-9)
        p_rms = torch.sqrt((pert ** 2).mean() + 1e-9)
        pert = pert * (target * c_rms / p_rms)
        new_mag = mag.clone()
        new_mag[:, :cfg.message_band] += pert
        new_mag = torch.clamp(new_mag, min=0.0)
        out = _istft(torch.polar(new_mag, spec.angle()), x.shape[0], cfg)
        return out.cpu().numpy(), None, None

    @torch.no_grad()
    def decode_wav(self, audio: np.ndarray, sample_rate: int,
                   phase_shift_decoding: bool = True) -> dict:
        """The message of the best phase shift: ``{"status": detected,
        "messages": [[bytes]], "confidence": mean winning probability}``;
        a detection is a confidence above 8 / vocab."""
        cfg = self.cfg
        assert sample_rate == cfg.sample_rate
        x = self._audio(audio)
        shifts = (range(0, cfg.hop_length, cfg.hop_length // 4)
                  if phase_shift_decoding else (0,))
        best = None
        for shift in shifts:
            band = _stft(x[shift:], cfg).abs()[:, :cfg.message_band][None, :, :, None]
            probs = torch.softmax(self.dec_m(band), dim=-1).mean(dim=0)  # [L, V]
            conf = float(probs.max(dim=-1).values.mean())
            msg = [int(i) for i in probs.argmax(dim=-1).cpu()]
            if best is None or conf > best[0]:
                best = (conf, msg)
        conf, msg = best
        return {"status": conf > 8.0 / cfg.msg_vocab, "messages": [msg],
                "confidence": conf}

    # -- checkpoint loading ------------------------------------------------

    def sanitize(self, weights: dict) -> dict:
        """A torch checkpoint whose parameter paths match these modules ->
        the JAX package's layout: ``module.`` wrappers stripped, conv2d
        [O, I, kh, kw] -> [kh, kw, I, O], and ``dec_c.*`` (the carrier-SDR
        estimator, unused by encode and decode) dropped."""
        out = {}
        for key, w in weights.items():
            k = key.replace("module.", "")
            if k.startswith("dec_c."):
                continue
            w = np.asarray(w)
            if w.ndim == 4:
                w = w.transpose(2, 3, 1, 0)
            out[k] = w
        return out


def load_silentcipher(checkpoint_dir: str, device: str = "cuda") -> SilentCipherModel:
    """The model of a silentcipher checkpoint directory (``config.json``
    optional, ``*.safetensors``) on ``device``."""
    from mlx_audio_tpu_torch.codec.loading import checkpoint_dir as local_dir
    from mlx_audio_tpu_torch.codec.loading import load_weights_files
    from mlx_audio_tpu_torch.convert import params_from_jax

    path = local_dir(checkpoint_dir)
    cfg = SilentCipherConfig()
    native = False
    if (path / "config.json").exists():
        with open(path / "config.json") as f:
            raw = json.load(f)
        native = bool(raw.get("native_format"))
        cfg = SilentCipherConfig(**{k: v for k, v in raw.items()
                                    if k in SilentCipherConfig.__dataclass_fields__})
    model = SilentCipherModel(cfg, device=device)
    weights = load_weights_files(path)
    if not native:  # torch checkpoints need the conv-layout transposes
        weights = model.sanitize(weights)
    try:
        state = params_from_jax(weights, model)
        own = model.state_dict()
        unknown = sorted(set(state) - set(own))
        if unknown:
            raise KeyError(f"unknown parameter paths: {unknown[:10]}")
        for k, t in state.items():
            if tuple(t.shape) != tuple(own[k].shape):
                raise ValueError(f"shape mismatch for {k}: expected "
                                 f"{tuple(own[k].shape)}, got {tuple(t.shape)}")
        model.load_state_dict(state, strict=False)
    except (KeyError, ValueError) as e:
        raise ValueError(
            f"silentcipher checkpoint at {checkpoint_dir} does not match "
            "this architecture (hidden/layer/band sizes come from "
            "config.json; parameter paths must line up with "
            "SilentCipherModel — msg_encoder.embeds.N.weight, "
            "enc_c.conv_in/blocks.N.conv/conv_out, dec_m.*).  Convert the "
            "published checkpoint to this layout (native_format: true in "
            f"config.json skips the torch transposes).  Detail: {e}"
        ) from e
    return model
