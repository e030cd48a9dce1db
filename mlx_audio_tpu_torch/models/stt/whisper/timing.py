"""Word timestamps by DTW over the decoder's cross-attention (counterpart of
``mlx_audio_tpu/models/stt/whisper/timing.py``).  The teacher-forced
decoder pass runs on the model's device; the median filter and the DTW run
in numpy on the host, as in the JAX package.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from mlx_audio_tpu_torch.models.stt.whisper.audio import (
    HOP_LENGTH,
    SAMPLE_RATE,
    TOKENS_PER_SECOND,
)


def median_filter(x: np.ndarray, filter_width: int) -> np.ndarray:
    """Median filter along the last axis with edge padding."""
    if filter_width <= 1 or x.shape[-1] <= filter_width:
        return x
    pad = filter_width // 2
    xp = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, pad)], mode="reflect")
    windows = np.lib.stride_tricks.sliding_window_view(xp, filter_width, axis=-1)
    return np.median(windows, axis=-1)


def dtw(costs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Dynamic time warping over a cost matrix [N, M] -> alignment path
    (text_indices, time_indices)."""
    n, m = costs.shape
    cost = np.full((n + 1, m + 1), np.inf)
    trace = np.full((n + 1, m + 1), -1, dtype=np.int32)
    cost[0, 0] = 0
    for i in range(1, n + 1):
        prev_row = cost[i - 1]
        cur_row = cost[i]
        for j in range(1, m + 1):
            c0 = cost[i - 1, j - 1]
            c1 = prev_row[j]
            c2 = cur_row[j - 1]
            if c0 <= c1 and c0 <= c2:
                c, t = c0, 0
            elif c1 <= c0 and c1 <= c2:
                c, t = c1, 1
            else:
                c, t = c2, 2
            cur_row[j] = costs[i - 1, j - 1] + c
            trace[i, j] = t
    # backtrace
    i, j = n, m
    text_indices, time_indices = [], []
    while i > 0 and j > 0:
        text_indices.append(i - 1)
        time_indices.append(j - 1)
        t = trace[i, j]
        if t == 0:
            i -= 1
            j -= 1
        elif t == 1:
            i -= 1
        else:
            j -= 1
    return np.array(text_indices[::-1]), np.array(time_indices[::-1])


@dataclass
class WordTiming:
    word: str
    tokens: List[int]
    start: float
    end: float
    probability: float


def find_alignment(model, tokenizer, text_tokens: List[int], mel,
                   num_frames: int, *, medfilt_width: int = 7,
                   qk_scale: float = 1.0, features=None):
    """Cross-attention DTW alignment of one window.  ``features``: the
    window's audio features [T, D], which the transcription loop already
    has from its decode (the encoder does not run twice)."""
    if len(text_tokens) == 0:
        return []
    row = [*tokenizer.sot_sequence, tokenizer.no_timestamps, *text_tokens,
           tokenizer.eot]
    n_real = len(row)
    with torch.no_grad():
        if features is None:
            features = model.encoder(torch.as_tensor(mel, dtype=torch.float32,
                                                     device=model.device)[None])
        else:
            features = torch.as_tensor(features, device=model.device)[None]
        tokens = torch.tensor([row], dtype=torch.int64, device=features.device)
        logits, cross_qks = model.decoder.full_forward(tokens, features,
                                                       return_cross_qk=True)
        heads = model.alignment_heads.cpu().numpy()
        qk = torch.stack([cross_qks[l][0, h] for l, h in heads]).cpu().numpy()
    logits = logits[0, :n_real].float().cpu().numpy()
    sample_begin = len(tokenizer.sot_sequence) + 1

    probs = _softmax(logits, axis=-1)
    text_token_probs = probs[np.arange(sample_begin - 1, sample_begin - 1 + len(text_tokens)),
                             list(text_tokens)]

    # the selected alignment heads [H_sel, T_text_total, audio_ctx]
    qk = qk[:, :n_real, : num_frames // 2]
    qk = _softmax(qk * qk_scale, axis=-1)
    mean = qk.mean(axis=-2, keepdims=True)
    std = qk.std(axis=-2, keepdims=True) + 1e-9
    qk = (qk - mean) / std
    qk = median_filter(qk, medfilt_width)
    matrix = qk.mean(axis=0)
    # rows [no_timestamps, text_0 .. text_{n-1}]: the last one keeps the
    # final word's end time
    matrix = matrix[sample_begin - 1: sample_begin + len(text_tokens)]
    text_indices, time_indices = dtw(-matrix)

    words, word_tokens = tokenizer.split_to_word_tokens(
        list(text_tokens) + [tokenizer.eot]
    )
    if len(word_tokens) <= 1:
        return []
    word_boundaries = np.pad(
        np.cumsum([len(t) for t in word_tokens[:-1]]), (1, 0)
    )

    jumps = np.pad(np.diff(text_indices), (1, 0), constant_values=1).astype(bool)
    jump_times = time_indices[jumps] / TOKENS_PER_SECOND
    start_times = jump_times[word_boundaries[:-1]]
    end_times = jump_times[np.minimum(word_boundaries[1:], len(jump_times) - 1)]
    word_probs = [
        float(np.mean(text_token_probs[i:j]))
        for i, j in zip(word_boundaries[:-1], word_boundaries[1:])
    ]
    return [
        WordTiming(word, tokens_, float(start), float(end), prob)
        for word, tokens_, start, end, prob in zip(
            words, word_tokens, start_times, end_times, word_probs
        )
    ]


def _softmax(x, axis=-1):
    x = x - x.max(axis=axis, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=axis, keepdims=True)


def merge_punctuations(alignment: List[WordTiming], prepended: str, appended: str):
    # merge prepended punctuations
    i = len(alignment) - 2
    j = len(alignment) - 1
    while i >= 0:
        previous = alignment[i]
        following = alignment[j]
        if previous.word.startswith(" ") and previous.word.strip() in prepended:
            following.word = previous.word + following.word
            following.tokens = previous.tokens + following.tokens
            previous.word = ""
            previous.tokens = []
        else:
            j = i
        i -= 1
    # merge appended punctuations
    i = 0
    j = 1
    while j < len(alignment):
        previous = alignment[i]
        following = alignment[j]
        if not previous.word.endswith(" ") and following.word in appended:
            previous.word = previous.word + following.word
            previous.tokens = previous.tokens + following.tokens
            following.word = ""
            following.tokens = []
        else:
            i = j
        j += 1


def add_word_timestamps(
    *,
    segments: List[dict],
    model,
    tokenizer,
    mel,
    num_frames: int,
    prepend_punctuations: str = "\"'“¿([{-",
    append_punctuations: str = "\"'.。,，!！?？:：”)]}、",
    last_speech_timestamp: float = 0.0,
    audio_features=None,
):
    """Attach per-word timing dicts to segments."""
    if len(segments) == 0:
        return
    text_tokens_per_segment = [
        [t for t in segment["tokens"] if t < tokenizer.eot] for segment in segments
    ]
    text_tokens = list(itertools.chain.from_iterable(text_tokens_per_segment))
    alignment = find_alignment(model, tokenizer, text_tokens, mel, num_frames,
                               features=audio_features)
    word_durations = np.array([t.end - t.start for t in alignment])
    word_durations = word_durations[word_durations.nonzero()]
    median_duration = float(np.median(word_durations)) if len(word_durations) else 0.0
    median_duration = min(0.7, median_duration)
    max_duration = median_duration * 2

    if len(word_durations) > 0:
        sentence_end_marks = ".。!！?？"
        for i in range(1, len(alignment)):
            if alignment[i].end - alignment[i].start > max_duration:
                if alignment[i].word in sentence_end_marks:
                    alignment[i].end = alignment[i].start + max_duration
                elif alignment[i - 1].word in sentence_end_marks:
                    alignment[i].start = alignment[i].end - max_duration

    merge_punctuations(alignment, prepend_punctuations, append_punctuations)

    time_offset = segments[0]["seek"] * HOP_LENGTH / SAMPLE_RATE
    word_index = 0

    for segment, text_tokens_seg in zip(segments, text_tokens_per_segment):
        saved_tokens = 0
        words = []
        while word_index < len(alignment) and saved_tokens < len(text_tokens_seg):
            timing = alignment[word_index]
            if timing.word:
                words.append(
                    dict(
                        word=timing.word,
                        start=round(time_offset + timing.start, 2),
                        end=round(time_offset + timing.end, 2),
                        probability=timing.probability,
                    )
                )
            saved_tokens += len(timing.tokens)
            word_index += 1

        if len(words) > 0:
            # hallucination and boundary adjustments
            if (
                words[0]["end"] - last_speech_timestamp > median_duration * 4
                and (
                    words[0]["end"] - words[0]["start"] > max_duration
                    or (
                        len(words) > 1
                        and words[1]["end"] - words[0]["start"] > max_duration * 2
                    )
                )
            ):
                if (
                    len(words) > 1
                    and words[1]["end"] - words[1]["start"] > max_duration
                ):
                    boundary = max(words[1]["end"] / 2, words[1]["end"] - max_duration)
                    words[0]["end"] = words[1]["start"] = boundary
                words[0]["start"] = max(0, words[0]["end"] - max_duration)

            if segment["start"] < words[0]["end"] and segment["start"] - 0.5 > words[0]["start"]:
                words[0]["start"] = max(
                    0, min(words[0]["end"] - median_duration, segment["start"])
                )
            else:
                segment["start"] = words[0]["start"]

            if segment["end"] > words[-1]["start"] and segment["end"] + 0.5 < words[-1]["end"]:
                words[-1]["end"] = max(
                    words[-1]["start"] + median_duration, segment["end"]
                )
            else:
                segment["end"] = words[-1]["end"]

        segment["words"] = words
