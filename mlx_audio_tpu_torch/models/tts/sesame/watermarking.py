"""AI-audio watermark on CSM outputs: a copy of the JAX package's numpy
direct-sequence spread-spectrum watermark
(``mlx_audio_tpu/models/tts/sesame/watermarking.py``), without its
silentcipher branch (a later slice).

The key's bytes become a bit message; each bit sets the sign of a seeded
pseudo-noise chip sequence over a 1024-sample frame at 44.1 kHz, scaled to
the frame's RMS (30 dB below it); decoding is a matched filter and a
majority vote over repetitions, searching a few sample shifts.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from mlx_audio_tpu_torch.utils.audio_io import resample_audio

# This watermark key is public; it is not secure.
CSM_1B_GH_WATERMARK = [212, 211, 146, 56, 201]

_WM_SR = 44_100
_FRAME = 1024
_PN_SEED = 0x5EED
_ALPHA = 10 ** (-30 / 20)


class Watermarker:
    """Stateless DSSS codec; one PN sequence, band-limited to about 8 kHz so
    that the mark survives 44.1 kHz <-> 24 kHz resampling."""

    def __init__(self, frame: int = _FRAME, seed: int = _PN_SEED):
        self.frame = frame
        rng = np.random.default_rng(seed)
        chips = rng.choice([-1.0, 1.0], size=frame)
        taps = 63
        t = np.arange(taps) - (taps - 1) / 2
        h = np.sinc(2 * 0.18 * t) * np.hamming(taps)
        h /= h.sum()
        pn = np.convolve(chips, h, mode="same")
        self.pn = (pn / np.sqrt(np.mean(pn ** 2))).astype(np.float32)

    @staticmethod
    def _key_bits(key: List[int]) -> np.ndarray:
        bits = np.unpackbits(np.asarray(key, dtype=np.uint8))
        return bits.astype(np.float32) * 2 - 1

    def embed(self, audio: np.ndarray, key: List[int]) -> np.ndarray:
        audio = np.asarray(audio, dtype=np.float32).reshape(-1)
        bits = self._key_bits(key)
        out = audio.copy()
        for i in range(len(audio) // self.frame):
            seg = slice(i * self.frame, (i + 1) * self.frame)
            rms = float(np.sqrt(np.mean(audio[seg] ** 2)) + 1e-8)
            out[seg] = out[seg] + bits[i % len(bits)] * self.pn * (rms * _ALPHA)
        return out

    def _decode_at(self, audio: np.ndarray, n_bits: int, shift: int):
        usable = audio[shift:] if shift >= 0 else audio[:shift]
        n_frames = len(usable) // self.frame
        if n_frames < n_bits:
            return None, 0.0
        corr = usable[:n_frames * self.frame].reshape(n_frames, self.frame) @ self.pn
        votes = np.zeros(n_bits)
        for i in range(n_frames):
            votes[i % n_bits] += corr[i]
        return (votes > 0).astype(np.uint8), float(np.mean(np.abs(votes)))

    def decode(self, audio: np.ndarray, n_bits: int) -> Optional[np.ndarray]:
        audio = np.asarray(audio, dtype=np.float32).reshape(-1)
        best, best_conf = None, -1.0
        for shift in range(-3, 4):
            bits, conf = self._decode_at(audio, n_bits, shift)
            if bits is not None and conf > best_conf:
                best, best_conf = bits, conf
        return best


def load_watermarker() -> Watermarker:
    return Watermarker()


def watermark(watermarker: Watermarker, audio_array, sample_rate: int,
              watermark_key: List[int]) -> np.ndarray:
    """Embed at 44.1 kHz and resample back to ``sample_rate``."""
    audio = np.asarray(audio_array, dtype=np.float32)
    encoded = watermarker.embed(resample_audio(audio, sample_rate, _WM_SR),
                                watermark_key)
    if sample_rate != _WM_SR:
        encoded = resample_audio(encoded, _WM_SR, sample_rate)[:len(audio)]
    return encoded.astype(np.float32)


def verify(watermarker: Watermarker, watermarked_audio, sample_rate: int,
           watermark_key: List[int]) -> bool:
    """True iff the payload decodes to the given key."""
    audio = resample_audio(np.asarray(watermarked_audio, dtype=np.float32),
                           sample_rate, _WM_SR)
    expect = Watermarker._key_bits(watermark_key) > 0
    got = watermarker.decode(audio, len(expect))
    return got is not None and bool(np.mean(got == expect.astype(np.uint8)) > 0.9)
