"""Wav2Vec2 feature extractor, the HF-compatible preprocessing surface (a
copy of ``mlx_audio_tpu/models/stt/wav2vec/feature_extractor.py``): raw
mono waveforms -> padded or truncated batches with optional zero-mean
unit-variance normalization and attention masks.  Host-side numpy.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np


class BatchFeature(dict):
    """Dict with attribute access (mirrors the HF return type)."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:  # pragma: no cover
            raise AttributeError(name) from e


def _zero_mean_unit_var(values: List[np.ndarray],
                        lengths: Sequence[int]) -> List[np.ndarray]:
    out = []
    for x, n in zip(values, lengths):
        valid = x[:n]
        mean = valid.mean() if n else 0.0
        var = valid.var() if n else 1.0
        y = x.copy()
        y[:n] = (valid - mean) / np.sqrt(var + 1e-7)
        out.append(y)
    return out


class Wav2Vec2FeatureExtractor:
    """`extractor(raw_speech, ...) -> {"input_values", "attention_mask"}`."""

    def __init__(self, feature_size: int = 1, sampling_rate: int = 16000,
                 padding_value: float = 0.0, do_normalize: bool = True,
                 return_attention_mask: bool = False, **kwargs):
        self.feature_size = feature_size
        self.sampling_rate = sampling_rate
        self.padding_value = padding_value
        self.do_normalize = do_normalize
        self.return_attention_mask = return_attention_mask

    def __call__(
        self,
        raw_speech: Union[np.ndarray, Sequence[np.ndarray], Sequence[float]],
        sampling_rate: Optional[int] = None,
        padding: Union[bool, str] = False,
        max_length: Optional[int] = None,
        truncation: bool = False,
        pad_to_multiple_of: Optional[int] = None,
        return_attention_mask: Optional[bool] = None,
        **kwargs,
    ) -> BatchFeature:
        if sampling_rate is not None and sampling_rate != self.sampling_rate:
            raise ValueError(
                f"sampling_rate {sampling_rate} != extractor's "
                f"{self.sampling_rate}; resample first"
            )
        is_batched = bool(
            isinstance(raw_speech, (list, tuple))
            and raw_speech
            and isinstance(raw_speech[0], (np.ndarray, list, tuple))
        ) or (isinstance(raw_speech, np.ndarray) and raw_speech.ndim > 1)
        if not is_batched:
            raw_speech = [raw_speech]
        speech = [np.asarray(s, dtype=np.float32).reshape(-1)
                  for s in raw_speech]

        lengths = [len(s) for s in speech]
        if truncation and max_length is not None:
            speech = [s[:max_length] for s in speech]
            lengths = [len(s) for s in speech]

        if padding is True or padding == "longest":
            target = max(lengths)
        elif padding == "max_length":
            target = max_length if max_length is not None else max(lengths)
        else:
            target = None

        if target is not None:
            if pad_to_multiple_of:
                target = -(-target // pad_to_multiple_of) * pad_to_multiple_of
            # without truncation a longer input must not produce a negative
            # pad width — pad the batch out to the longest instead
            target = max(target, max(lengths))
            speech = [
                np.pad(s, (0, target - len(s)),
                       constant_values=self.padding_value)
                for s in speech
            ]
        elif len(set(lengths)) > 1:
            raise ValueError(
                "ragged inputs need padding=True/'longest'/'max_length'"
            )

        if self.do_normalize:
            speech = _zero_mean_unit_var(speech, lengths)

        out = BatchFeature(input_values=np.stack(speech))
        want_mask = (return_attention_mask
                     if return_attention_mask is not None
                     else self.return_attention_mask)
        if want_mask:
            mask = np.zeros_like(out["input_values"], dtype=np.int32)
            for i, n in enumerate(lengths):
                mask[i, :n] = 1
            out["attention_mask"] = mask
        return out
