"""Chunked DAC compression: windowed encode and decode, and the ``.dac``
file (counterpart of ``mlx_audio_tpu/codec/dac/chunked.py``).

Long audio is delay-padded and cut into windows of one length, which encode
as one batch through the unpadded ("valid conv") twin of the model: the same
parameters, every conv's padding 0.  ``get_delay`` and ``get_output_length``
walk the conv chain with the reference's formulas.  The ``.dac`` file is the
reference's ``np.save`` dict (uint16 codes and metadata), with
``original_length`` in samples; a file that stores seconds (a float) still
loads.
"""

from __future__ import annotations

import copy
import math
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

from mlx_audio_tpu_torch.nn.layers import WNConv1d, WNConvTranspose1d
from mlx_audio_tpu_torch.utils.audio_io import load_audio

SUPPORTED_VERSIONS = ["1.0.0"]


@dataclass
class DACFile:
    codes: np.ndarray  # [1, n_codebooks, T]
    chunk_length: int
    original_length: int  # samples (the reference stores seconds)
    input_db: float
    channels: int
    sample_rate: int
    padding: bool
    dac_version: str = SUPPORTED_VERSIONS[-1]

    def save(self, path) -> Path:
        artifacts = {
            "codes": np.asarray(self.codes).astype(np.uint16),
            "metadata": {
                "input_db": float(self.input_db),
                "original_length": self.original_length,
                "sample_rate": self.sample_rate,
                "chunk_length": self.chunk_length,
                "channels": self.channels,
                "padding": self.padding,
                "dac_version": SUPPORTED_VERSIONS[-1],
            },
        }
        path = Path(path).with_suffix(".dac")
        with open(path, "wb") as f:
            np.save(f, artifacts)
        return path

    @classmethod
    def load(cls, path) -> "DACFile":
        artifacts = np.load(path, allow_pickle=True)[()]
        meta = dict(artifacts["metadata"])
        if meta.get("dac_version") not in SUPPORTED_VERSIONS:
            raise RuntimeError(
                f"{path} can't be loaded with this version of the codec")
        codes = np.asarray(artifacts["codes"], dtype=np.int32)
        return cls(codes=codes, **meta)


def _conv_chain(dac) -> list:
    """Every weight-normalised conv and transposed conv of the encoder, then
    the decoder, in forward order (the quantizer's kernel-1 projections
    change no length and are left out)."""
    return [m for part in (dac.encoder, dac.decoder) for m in part.modules()
            if isinstance(m, (WNConv1d, WNConvTranspose1d))]


def _layer_kds(layer) -> tuple[int, int, int, bool]:
    """(kernel, stride, dilation, is_transpose) of a conv layer."""
    return (layer.weight_v.shape[-1], layer.stride,
            getattr(layer, "dilation", 1),
            isinstance(layer, WNConvTranspose1d))


def get_output_length(dac, input_length: int) -> int:
    """Output length of the valid-conv encode and decode chain."""
    n = input_length
    for layer in _conv_chain(dac):
        k, s, d, is_t = _layer_kds(layer)
        if is_t:
            n = (n - 1) * s + d * (k - 1) + 1
        else:
            n = ((n - d * (k - 1) - 1) / s) + 1
        n = math.floor(n)
    return n


def get_delay(dac) -> int:
    """Samples of context the valid convs consume at each end."""
    l_out = get_output_length(dac, 0)
    n = l_out
    for layer in reversed(_conv_chain(dac)):
        k, s, d, is_t = _layer_kds(layer)
        if is_t:
            n = ((n - d * (k - 1) - 1) / s) + 1
        else:
            n = (n - 1) * s + d * (k - 1) + 1
        n = math.ceil(n)
    return (n - l_out) // 2


def unpadded_twin(dac):
    """A copy of ``dac`` whose convs run in valid mode.  It holds the same
    parameter tensors (no copy of any weight); only its modules are new, so
    the caller's model keeps its padding."""
    memo = {id(t): t for t in (*dac.parameters(), *dac.buffers())}
    twin = copy.deepcopy(dac, memo)
    for conv in _conv_chain(twin):
        conv.padding = 0
    return twin


def compress(dac, audio, win_duration: float = 1.0,
             normalize_db: Optional[float] = -16,
             n_quantizers: Optional[int] = None) -> DACFile:
    """Audio (a 1-D array or a file path) -> DACFile.  A clip of at most
    ``win_duration`` takes one padded encode; longer audio is delay-padded,
    windowed, and every window encodes in one batch."""
    if isinstance(audio, (str, Path)):
        audio = load_audio(str(audio), dac.sample_rate)
    audio = np.asarray(audio, dtype=np.float32).reshape(-1)
    nt = audio.shape[-1]
    rms = float(np.sqrt(np.mean(audio ** 2) + 1e-12))
    input_db = 20 * math.log10(rms + 1e-12)
    if normalize_db is not None:
        audio = audio * (10 ** ((normalize_db - input_db) / 20))
    meta = dict(original_length=nt, input_db=input_db, channels=1,
                sample_rate=dac.sample_rate)

    if nt / dac.sample_rate <= win_duration:
        x = torch.as_tensor(audio, device=dac.device)[None, None, :]
        codes = dac.encode(x, n_quantizers)[1].cpu().numpy()
        return DACFile(codes=codes, chunk_length=codes.shape[-1],
                       padding=True, **meta)

    delay = get_delay(dac)
    n_samples = int(win_duration * dac.sample_rate)
    n_samples = int(math.ceil(n_samples / dac.hop_length) * dac.hop_length)
    hop = get_output_length(dac, n_samples)
    padded = np.pad(audio, (delay, delay))
    starts = list(range(0, nt, hop))
    windows = np.zeros((len(starts), 1, n_samples), dtype=np.float32)
    for w, start in enumerate(starts):
        piece = padded[start: start + n_samples]
        windows[w, 0, : piece.shape[-1]] = piece
    codes_w = unpadded_twin(dac).encode(
        torch.as_tensor(windows, device=dac.device), n_quantizers)[1]
    codes_w = codes_w.cpu().numpy()  # [W, nq, Tc]
    codes = codes_w.transpose(1, 0, 2).reshape(1, codes_w.shape[1], -1)
    return DACFile(codes=codes, chunk_length=codes_w.shape[-1],
                   padding=False, **meta)


def decompress(dac, obj: Union[str, Path, DACFile],
               normalize_db: Optional[float] = -16) -> np.ndarray:
    """DACFile (or a .dac path) -> waveform [1, T], numpy.  Whole chunks
    decode as one batch; a ragged tail chunk (only in files written
    elsewhere) decodes alone."""
    if isinstance(obj, (str, Path)):
        obj = DACFile.load(obj)
    if dac.sample_rate != obj.sample_rate:
        raise ValueError(f"sample rate mismatch: file {obj.sample_rate} vs "
                         f"model {dac.sample_rate}")
    model = dac if obj.padding else unpadded_twin(dac)
    codes = torch.as_tensor(np.asarray(obj.codes, dtype=np.int64),
                            device=dac.device)
    nq, t, chunk = codes.shape[1], codes.shape[-1], obj.chunk_length
    n_full = t // chunk
    pieces = []
    if n_full:
        stacked = codes[..., : n_full * chunk].reshape(nq, n_full, chunk)
        pieces.append(model.decode_codes(stacked.transpose(0, 1)).reshape(-1))
    if t % chunk:
        pieces.append(model.decode_codes(codes[..., n_full * chunk:]).reshape(-1))
    audio = torch.cat(pieces).cpu().numpy()

    if normalize_db is not None:
        audio = audio * (10 ** ((obj.input_db - normalize_db) / 20))
    length = obj.original_length
    if isinstance(length, float):  # a reference-written file: seconds
        length = int(round(length * obj.sample_rate))
    if length:
        audio = audio[:length]
        if audio.shape[-1] < length:
            # 'same'-padded chains can come up a few samples short of the
            # hop-rounded input (odd strides pad asymmetrically)
            audio = np.pad(audio, (0, length - audio.shape[-1]))
    return audio[None, :].astype(np.float32)
