"""BiCodec tokenizer: raw audio <-> (global, semantic) token streams
(counterpart of ``mlx_audio_tpu/models/tts/spark/audio_tokenizer.py``).

The semantic features come from a frozen wav2vec2-large-xlsr-53, whose
hidden states 11, 14 and 16 are averaged; the speaker reference clip is
tiled or cut to ``ref_segment_duration`` seconds.  The default wav2vec2 is
built, at those widths with weights drawn from ``seed``, the first time
features are asked for.  Audio comes in as samples or as a file path,
read through ``utils.audio_io`` at the tokenizer's sample rate.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from mlx_audio_tpu_torch.models.stt.wav2vec.wav2vec import ModelConfig as W2VConfig
from mlx_audio_tpu_torch.models.stt.wav2vec.wav2vec import Wav2Vec2Model
from mlx_audio_tpu_torch.models.tts.spark.bicodec import BiCodec
from mlx_audio_tpu_torch.utils.audio_io import load_audio

DEFAULT_TOKENIZER_CONFIG: Dict[str, Any] = {
    # Spark-TTS-0.5B audio_tokenizer_config.yaml
    "sample_rate": 16000,
    "ref_segment_duration": 6,
    "latent_hop_length": 320,
    "volume_normalize": True,
}

# the hidden states of wav2vec2 that BiCodec's semantic features average
FEATURE_LAYERS = (11, 14, 16)


def wav2vec2_xlsr_config() -> W2VConfig:
    """facebook/wav2vec2-large-xlsr-53's widths, as the JAX package's
    tokenizer builds it (``conv_bias`` at the config's default, False)."""
    return W2VConfig(vocab_size=32, hidden_size=1024, num_hidden_layers=24,
                     num_attention_heads=16, intermediate_size=4096,
                     do_stable_layer_norm=True, feat_extract_norm="layer")


def _zero_mean_unit_var(wav: np.ndarray) -> np.ndarray:
    """Wav2Vec2FeatureExtractor's normalization (do_normalize=True)."""
    wav = np.asarray(wav, dtype=np.float32)
    return (wav - wav.mean()) / np.sqrt(wav.var() + 1e-7)


def audio_volume_normalize(audio: np.ndarray, coeff: float = 0.2) -> np.ndarray:
    """Percentile loudness normalization: scale so that the mean of the top
    10% to 1% absolute samples is ``coeff``, by 0.1x to 10x, peak <= 1."""
    audio = np.asarray(audio, dtype=np.float32)
    temp = np.sort(np.abs(audio))
    if temp.size == 0:
        return audio
    if temp[-1] < 0.1:
        audio = audio / max(float(temp[-1]), 1e-3) * 0.1
    temp = temp[temp > 0.01]
    if temp.shape[0] <= 10:
        return audio
    volume = np.mean(temp[int(0.9 * len(temp)):int(0.99 * len(temp))])
    audio = audio * np.clip(coeff / volume, 0.1, 10)
    max_value = np.max(np.abs(audio))
    if max_value > 1:
        audio = audio / max_value
    return audio


class BiCodecTokenizer:
    def __init__(self, bicodec: Optional[BiCodec] = None,
                 wav2vec2: Optional[Wav2Vec2Model] = None,
                 config: Optional[Dict[str, Any]] = None,
                 device: str = "cuda", seed: int = 0):
        self.config = {**DEFAULT_TOKENIZER_CONFIG, **(config or {})}
        self.model = bicodec if bicodec is not None else BiCodec(device=device, seed=seed)
        self.device = self.model.device
        self.seed = seed
        self._wav2vec2 = wav2vec2

    @property
    def feature_extractor(self) -> Wav2Vec2Model:
        if self._wav2vec2 is None:
            self._wav2vec2 = Wav2Vec2Model(wav2vec2_xlsr_config(), device=self.device,
                                           seed=self.seed)
        return self._wav2vec2

    def get_ref_clip(self, wav: np.ndarray) -> np.ndarray:
        """Tile or cut to a whole number of latent hops of
        ``ref_segment_duration`` seconds."""
        hop = self.config["latent_hop_length"]
        ref_segment_length = (int(self.config["sample_rate"]
                                  * self.config["ref_segment_duration"]) // hop * hop)
        if ref_segment_length > len(wav):
            wav = np.tile(wav, ref_segment_length // len(wav) + 1)
        return wav[:ref_segment_length]

    def process_audio(self, wav) -> Tuple[np.ndarray, np.ndarray]:
        """samples or a file path -> (the volume-normalized wav [T], the
        reference clip [1, S])."""
        if isinstance(wav, (str, Path)):
            wav = load_audio(wav, sample_rate=self.config["sample_rate"])
        wav = np.asarray(wav, dtype=np.float32).reshape(-1)
        if self.config["volume_normalize"]:
            wav = audio_volume_normalize(wav)
        return wav, self.get_ref_clip(wav)[None]

    @torch.no_grad()
    def extract_wav2vec2_features(self, wavs: np.ndarray) -> torch.Tensor:
        """wav [B, T] -> the mixed hidden states [B, T', hidden]."""
        wavs = np.atleast_2d(np.asarray(wavs, dtype=np.float32))
        wavs = np.stack([_zero_mean_unit_var(w) for w in wavs])
        _, _, hidden = self.feature_extractor(torch.as_tensor(wavs, device=self.device),
                                              output_hidden_states=True)
        a, b, c = (hidden[i] for i in FEATURE_LAYERS)
        return (a + b + c) / 3

    def tokenize(self, audio) -> Tuple[torch.Tensor, torch.Tensor]:
        """audio samples -> (global tokens [1, 32], semantic tokens [1, T])."""
        wav, ref_wav = self.process_audio(audio)
        feat = self.extract_wav2vec2_features(wav[None])
        semantic_tokens, global_tokens = self.model.tokenize(feat, ref_wav)
        return global_tokens, semantic_tokens

    def detokenize(self, global_tokens, semantic_tokens) -> np.ndarray:
        wav = self.model.detokenize(semantic_tokens, global_tokens)
        # a bf16 BiCodec's audio leaves as float32 (numpy holds no bf16)
        return wav.float().cpu().numpy().squeeze()
