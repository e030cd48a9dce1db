"""Dia's delay pattern and its DAC round trip (counterpart of
``mlx_audio_tpu/models/tts/dia/audio.py``): the delay and its revert are
one gather each."""

from __future__ import annotations

from typing import List

import numpy as np
import torch

# DAC sub-batch: its upsampled conv activations grow with the rows
# (about 1 GB float32 per 16 rows of 4 s), so larger groups decode in parts
DAC_SUB_BATCH = 16
# frames dropped from the end of every decode: the delay revert's tail
TAIL_DROP = 30


def apply_audio_delay(audio_btc: torch.Tensor, pad_value: int, bos_value: int,
                      delay_pattern: List[int]) -> torch.Tensor:
    """out[b, t, c] = in[b, t - delay[c], c]; BOS where t < delay, PAD where
    t - delay >= T."""
    b, t, c = audio_btc.shape
    dev = audio_btc.device
    delay = torch.as_tensor(delay_pattern, device=dev)[None, None, :]
    t_idx = torch.arange(t, device=dev)[None, :, None] - delay     # [1, T, C]
    clamped = torch.clamp(t_idx, 0, t - 1).expand(b, t, c)
    gathered = torch.gather(audio_btc, 1, clamped)
    out = torch.where(t_idx < 0, bos_value, gathered)
    return torch.where(t_idx >= t, pad_value, out)


def revert_audio_delay(audio_btc: torch.Tensor, pad_value: int,
                       delay_pattern: List[int], t_orig: int) -> torch.Tensor:
    """out[b, t, c] = in[b, t + delay[c], c]; PAD beyond the original length."""
    b, t, c = audio_btc.shape
    dev = audio_btc.device
    delay = torch.as_tensor(delay_pattern, device=dev)[None, None, :]
    t_idx = torch.arange(t, device=dev)[None, :, None] + delay
    clamped = torch.clamp(t_idx, max=t - 1).expand(b, t, c)
    gathered = torch.gather(audio_btc, 1, clamped)
    return torch.where(t_idx >= t_orig, pad_value, gathered)


def audio_to_codebook(dac_model, audio, data_config) -> torch.Tensor:
    """Encode audio with DAC and apply the per-channel delay.
    audio: [B, 1, T] -> delayed codes [B, T', C]."""
    _, codes, _ = dac_model.encode(audio)  # [B, C, T']
    return apply_audio_delay(
        codes.transpose(1, 2), data_config.audio_pad_value,
        data_config.audio_bos_value, data_config.delay_pattern)


def codebook_to_audio(generated_codes, dac_model, delay_pattern,
                      c: int = 9) -> np.ndarray:
    """[C, T] delayed codes (BOS column first) -> waveform [S]."""
    return codebook_to_audio_batch([generated_codes], dac_model,
                                   delay_pattern, c)[0]


def codebook_to_audio_batch(codes_list, dac_model, delay_pattern,
                            c: int = 9) -> list:
    """Delay revert and DAC synthesis of [C, T] code arrays: rows of equal
    length decode through one ``decode_codes`` call, in sub-batches of at
    most ``DAC_SUB_BATCH`` rows.  Each row: the BOS column dropped, the
    delay reverted, the last ``TAIL_DROP`` frames dropped, and codes outside
    0..1023 set to 0."""
    out = [None] * len(codes_list)
    groups = {}
    for i, g in enumerate(codes_list):
        groups.setdefault(g.shape[1], []).append(i)
    groups = {
        (t, j): idxs[j * DAC_SUB_BATCH: (j + 1) * DAC_SUB_BATCH]
        for t, idxs in groups.items()
        for j in range(-(-len(idxs) // DAC_SUB_BATCH))
    }
    for idxs in groups.values():
        batch = np.stack([np.asarray(codes_list[i]) for i in idxs])
        codes = torch.as_tensor(batch[:, :, 1:], dtype=torch.long,
                                device=dac_model.device)  # BOS column dropped
        t = codes.shape[2]
        reverted = revert_audio_delay(codes.transpose(1, 2), pad_value=0,
                                      delay_pattern=delay_pattern, t_orig=t)
        if reverted.shape[1] > TAIL_DROP:
            reverted = reverted[:, :-TAIL_DROP, :]
        codebook = reverted.transpose(1, 2)                  # [G, C, T]
        codebook = torch.where((codebook < 0) | (codebook > 1023), 0, codebook)
        # a bf16 DAC's audio leaves as float32 (numpy holds no bf16)
        audio = dac_model.decode_codes(codebook).float().cpu().numpy()  # [G, 1, S]
        for j, i in enumerate(idxs):
            out[i] = audio[j, 0]
    return out
