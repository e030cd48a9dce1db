"""OuteTTS audio features and speaker profiles (counterpart of
``mlx_audio_tpu/models/tts/outetts/audio_processor.py``).

The pitch tracker, the loudness normalization and ``Features`` are numpy,
copied as they are.  ``DacInterface`` runs the port's ``codec.dac.DAC``:
by default the 24 kHz speech codec at 2 codebooks of 1024, built on the
model's device.  Loudness normalization uses RMS-based gain toward the
target (ITU-R BS.1770 gating is approximated by energy-weighted RMS).

A speaker from reference audio, given as samples or as a file path read
through ``utils.audio_io``, takes the word timestamps of a Whisper model
(``create_speaker_from_whisper``): the one the caller passes, else
whisper-large-v3-turbo loaded through ``utils.loader`` from a local
directory.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from mlx_audio_tpu_torch.codec.dac import DAC, DACConfig
from mlx_audio_tpu_torch.models.tts.outetts.prompt_processor import normalize_text
from mlx_audio_tpu_torch.utils.audio_io import load_audio, resample_audio


def calculate_pitch(audio: np.ndarray, sr: int, min_freq: float = 75.0,
                    max_freq: float = 600.0, frame_length: int = 400,
                    hop_length: int = 160, threshold: float = 0.3) -> np.ndarray:
    """Autocorrelation pitch tracker."""
    audio = np.asarray(audio)
    if audio.ndim > 1:
        audio = audio.mean(axis=0)
    audio = np.squeeze(audio)
    pad = (frame_length - (len(audio) % hop_length)) % hop_length
    audio = np.pad(audio, (0, pad))
    num_frames = (len(audio) - frame_length) // hop_length + 1
    if num_frames <= 0:
        return np.zeros(0)
    idx = np.arange(num_frames)[:, None] * hop_length + np.arange(frame_length)
    frames = audio[idx] * np.hanning(frame_length)
    fft = np.fft.rfft(frames, n=2 * frame_length, axis=1)
    autocorr = np.fft.irfft(fft.real ** 2 + fft.imag ** 2, axis=1)[:, :frame_length]
    min_idx = max(1, int(sr / max_freq))
    max_idx = min(frame_length, int(sr / min_freq))
    peak_indices = np.argmax(autocorr[:, min_idx:max_idx], axis=1) + min_idx
    rows = np.arange(num_frames)
    peak_values = autocorr[rows, peak_indices]
    ind = np.clip(peak_indices, 1, frame_length - 2)
    alpha = autocorr[rows, ind - 1]
    beta = autocorr[rows, ind]
    gamma = autocorr[rows, ind + 1]
    delta = 0.5 * (alpha - gamma) / (alpha - 2 * beta + gamma + 1e-8)
    delta = np.where((peak_indices > 0) & (peak_indices < frame_length - 1), delta, 0.0)
    period = (peak_indices + delta) / sr
    pitch = np.where(period > 0, 1.0 / period, 0.0)
    voiced = (peak_values / (autocorr[:, 0] + 1e-8)) > threshold
    pitch = np.where(voiced, pitch, 0.0)
    return np.clip(pitch, min_freq, max_freq)


def extract_single_pitch_value(audio: np.ndarray, sr: int, min_freq=75.0,
                               max_freq=600.0, **kw) -> float:
    pitch = calculate_pitch(audio, sr, min_freq, max_freq, **kw)
    avg = float(pitch.mean()) if pitch.size else 0.0
    return min(max((avg - min_freq) / (max_freq - min_freq), 0.0), 1.0)


def process_audio_array(audio: np.ndarray, sample_rate: int = 24000,
                        target_loudness: float = -18.0,
                        peak_limit: float = -1.0) -> np.ndarray:
    """Loudness-normalize to ~target LUFS (RMS approximation) + peak limit."""
    audio = np.asarray(audio, dtype=np.float32)
    if audio.ndim > 1:
        audio = audio.mean(axis=-1) if audio.shape[-1] <= 2 else np.squeeze(audio)
    rms = np.sqrt(np.mean(audio ** 2) + 1e-12)
    current_db = 20 * np.log10(rms + 1e-12)
    gain = 10 ** ((target_loudness - current_db) / 20)
    out = audio * gain
    peak = np.abs(out).max()
    limit = 10 ** (peak_limit / 20)
    if peak > limit:
        out = out * (limit / peak)
    return out.reshape(1, 1, -1)


class Features:
    def __init__(self):
        self.eps = 1e-10

    def scale_values(self, value: float) -> int:
        return round(value * 100)

    def get_default_features(self) -> dict:
        return {"energy": 0, "spectral_centroid": 0, "pitch": 0}

    def extract_audio_features(self, audio, sr: int) -> dict:
        audio = np.asarray(audio)
        if audio.size == 0 or not np.isfinite(audio).all():
            return self.get_default_features()
        if audio.ndim == 2 and audio.shape[0] > 1:
            audio = audio.mean(axis=0, keepdims=True)
        features = {}
        features["energy"] = float(np.sqrt(np.mean(audio ** 2)))
        spec = np.abs(np.fft.rfft(audio))
        freqs = np.linspace(0, sr / 2, spec.shape[-1])
        centroid = np.sum(freqs * spec.squeeze()) / (np.sum(spec) + self.eps)
        features["spectral_centroid"] = float(centroid / (sr / 2))
        features["pitch"] = extract_single_pitch_value(audio, sr)
        return {k: self.scale_values(v) for k, v in features.items()}


def dac_24khz_speech_config() -> DACConfig:
    """The 24 kHz speech DAC OuteTTS speaks: 2 codebooks of 1024."""
    return DACConfig(encoder_rates=[2, 4, 5, 8], decoder_rates=[8, 5, 4, 2],
                     n_codebooks=2, codebook_size=1024, sample_rate=24000)


class DacInterface:
    """Encode and decode through the 24 kHz speech DAC at 2 codebooks.  With
    no ``dac_model``, one is built on ``device`` with weights drawn from
    ``seed``."""

    def __init__(self, dac_model=None, device="cuda", seed: int = 0):
        if dac_model is None:
            dac_model = DAC(dac_24khz_speech_config(), device=device, seed=seed)
        self.model = dac_model
        self.sr = 24000

    def load_audio(self, path) -> np.ndarray:
        """A file at the codec's rate, loudness-normalised: [1, 1, T]."""
        return process_audio_array(load_audio(path, self.sr), self.sr)

    def encode(self, audio: np.ndarray) -> np.ndarray:
        """[1, 1, T] -> codes [1, 2, T']."""
        x = torch.as_tensor(np.asarray(audio, dtype=np.float32),
                            device=self.model.device)
        _, codes, _ = self.model.encode(x, n_quantizers=2)
        return codes.cpu().numpy()

    def decode(self, codes) -> np.ndarray:
        """codes [1, 2, T'] -> audio [1, 1, T]."""
        codes = torch.as_tensor(np.asarray(codes), dtype=torch.long,
                                device=self.model.device)
        # a bf16 DAC's audio leaves as float32 (numpy holds no bf16)
        return self.model.decode_codes(codes).float().cpu().numpy()


# the Whisper a speaker is transcribed with when none is given
DEFAULT_WHISPER = "mlx-community/whisper-large-v3-turbo"


class AudioProcessor:
    def __init__(self, dac_model=None, device="cuda", seed: int = 0):
        self.features = Features()
        self.audio_codec = DacInterface(dac_model, device, seed)

    def create_speaker_from_whisper(self, audio, whisper_model=None):
        """A speaker profile from ``whisper_model``'s word timestamps on
        ``audio`` (24 kHz samples); ``whisper_model`` is a
        ``models.stt.whisper.Model``, or anything whose
        ``generate(audio_16khz, word_timestamps=True)`` returns text and
        segments with words.  Without one, ``DEFAULT_WHISPER`` loads from
        that local directory on the codec's device (nothing is fetched: a
        missing directory raises ``FileNotFoundError``)."""
        if isinstance(audio, str):
            audio = self.audio_codec.load_audio(audio)
        else:
            audio = process_audio_array(np.asarray(audio), self.audio_codec.sr)
        if whisper_model is None:
            from mlx_audio_tpu_torch.utils.loader import load_model

            whisper_model = load_model(DEFAULT_WHISPER, domain="stt",
                                       device=self.audio_codec.model.device)
        wav16 = resample_audio(audio.reshape(-1), self.audio_codec.sr, 16000)
        data = whisper_model.generate(wav16, word_timestamps=True)
        words = []
        for s in data.segments or []:
            words.extend(
                {"word": w["word"].strip(), "start": float(w["start"]),
                 "end": float(w["end"])}
                for w in s.get("words", [])
            )
        return self.create_speaker_from_dict(
            {"audio": {"bytes": audio}, "text": normalize_text(data.text),
             "words": words})

    def create_speaker_from_dict(self, data: dict) -> dict:
        audio = np.asarray(data["audio"]["bytes"])
        full_codes = self.audio_codec.encode(audio).tolist()[0]
        c1, c2 = full_codes[0], full_codes[1]
        sr = self.audio_codec.sr
        audio = audio.reshape(1, -1)
        global_features = self.features.extract_audio_features(audio, sr)
        tps = 75
        start = None
        word_codes = []
        max_extension = 20
        words = data["words"]
        for idx, w in enumerate(words):
            if start is None:
                start = max(0, int(w["start"] * tps) - max_extension)
            end = (min(len(c1), int(w["end"] * tps) + max_extension)
                   if idx == len(words) - 1 else int(w["end"] * tps))
            word_c1, word_c2 = c1[start:end], c2[start:end]
            seg = audio[:, int(w["start"] * sr): int(w["end"] * sr)]
            features = self.features.extract_audio_features(seg, sr)
            start = end
            word_codes.append({
                "word": w["word"].strip(),
                "duration": round(len(word_c1) / tps, 2),
                "c1": word_c1, "c2": word_c2, "features": features,
            })
        return {"text": data["text"], "words": word_codes,
                "global_features": global_features}

    def save_speaker(self, speaker: dict, path: str):
        path = os.path.expanduser(path)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(speaker, f)

    def load_speaker(self, path: str) -> dict:
        path = os.path.expanduser(path)
        if not os.path.exists(path):
            raise FileNotFoundError(f"Speaker file not found: {path}")
        with open(path) as f:
            return json.load(f)
