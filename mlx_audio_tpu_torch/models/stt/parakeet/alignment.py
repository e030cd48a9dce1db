"""Token alignment records and the merging of long audio's chunks (the
port's own copy of ``mlx_audio_tpu/models/stt/parakeet/alignment.py``, which
imports no JAX): the longest contiguous agreeing run of the overlap, with
the longest common subsequence as its fallback.  Host logic.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List


@dataclass
class AlignedToken:
    id: int
    text: str
    start: float
    duration: float
    end: float = 0.0

    def __post_init__(self):
        self.end = self.start + self.duration


@dataclass
class AlignedSentence:
    text: str
    tokens: List[AlignedToken]
    start: float = 0.0
    end: float = 0.0
    duration: float = 0.0

    def __post_init__(self):
        self.tokens = sorted(self.tokens, key=lambda t: t.start)
        self.start = self.tokens[0].start
        self.end = self.tokens[-1].end
        self.duration = self.end - self.start


@dataclass
class AlignedResult:
    text: str
    sentences: List[AlignedSentence]

    def __post_init__(self):
        self.text = self.text.strip()


def tokens_to_sentences(tokens: List[AlignedToken]) -> List[AlignedSentence]:
    sentences, current = [], []
    for idx, token in enumerate(tokens):
        current.append(token)
        end_mark = any(m in token.text for m in "!?。？！") or (
            "." in token.text
            and (idx == len(tokens) - 1 or " " in tokens[idx + 1].text)
        )
        if end_mark:
            sentences.append(AlignedSentence(
                text="".join(t.text for t in current), tokens=current))
            current = []
    if current:
        sentences.append(AlignedSentence(
            text="".join(t.text for t in current), tokens=current))
    return sentences


def sentences_to_result(sentences: List[AlignedSentence]) -> AlignedResult:
    return AlignedResult("".join(s.text for s in sentences), sentences)


def _overlaps(a, b, overlap_duration):
    a_end = a[-1].end
    b_start = b[0].start
    overlap_a = [t for t in a if t.end > b_start - overlap_duration]
    overlap_b = [t for t in b if t.start < a_end + overlap_duration]
    return a_end, b_start, overlap_a, overlap_b


def _splice(a, b, overlap_a, pairs):
    a_start_idx = len(a) - len(overlap_a)
    ia = [a_start_idx + p[0] for p in pairs]
    ib = [p[1] for p in pairs]
    result = list(a[: ia[0]])
    for i in range(len(pairs)):
        result.append(a[ia[i]])
        if i < len(pairs) - 1:
            gap_a = a[ia[i] + 1: ia[i + 1]]
            gap_b = b[ib[i] + 1: ib[i + 1]]
            result.extend(gap_b if len(gap_b) > len(gap_a) else gap_a)
    result.extend(b[ib[-1] + 1:])
    return result


def _cutoff_merge(a, b, a_end, b_start):
    cutoff = (a_end + b_start) / 2
    return [t for t in a if t.end <= cutoff] + [t for t in b if t.start >= cutoff]


def merge_longest_contiguous(a, b, *, overlap_duration: float):
    """Merge overlapping chunk hypotheses on the longest run of agreeing
    tokens (alignment.py:77-155); raises if no long-enough run exists."""
    if not a or not b:
        return b if not a else a
    a_end, b_start, overlap_a, overlap_b = _overlaps(a, b, overlap_duration)
    if a_end <= b_start:
        return a + b
    if len(overlap_a) < 2 or len(overlap_b) < 2:
        return _cutoff_merge(a, b, a_end, b_start)
    enough = len(overlap_a) // 2
    best = []
    for i in range(len(overlap_a)):
        for j in range(len(overlap_b)):
            if (overlap_a[i].id == overlap_b[j].id
                    and abs(overlap_a[i].start - overlap_b[j].start) < overlap_duration / 2):
                cur = []
                k, l = i, j
                while (k < len(overlap_a) and l < len(overlap_b)
                       and overlap_a[k].id == overlap_b[l].id
                       and abs(overlap_a[k].start - overlap_b[l].start) < overlap_duration / 2):
                    cur.append((k, l))
                    k += 1
                    l += 1
                if len(cur) > len(best):
                    best = cur
    if len(best) >= enough:
        return _splice(a, b, overlap_a, best)
    raise RuntimeError(f"No pairs exceeding {enough}")


def merge_longest_common_subsequence(a, b, *, overlap_duration: float):
    """LCS fallback merge (alignment.py:158-248)."""
    if not a or not b:
        return b if not a else a
    a_end, b_start, overlap_a, overlap_b = _overlaps(a, b, overlap_duration)
    if a_end <= b_start:
        return a + b
    if len(overlap_a) < 2 or len(overlap_b) < 2:
        return _cutoff_merge(a, b, a_end, b_start)
    na, nb = len(overlap_a), len(overlap_b)
    dp = [[0] * (nb + 1) for _ in range(na + 1)]
    for i in range(1, na + 1):
        for j in range(1, nb + 1):
            if (overlap_a[i - 1].id == overlap_b[j - 1].id
                    and abs(overlap_a[i - 1].start - overlap_b[j - 1].start) < overlap_duration / 2):
                dp[i][j] = dp[i - 1][j - 1] + 1
            else:
                dp[i][j] = max(dp[i - 1][j], dp[i][j - 1])
    pairs = []
    i, j = na, nb
    while i > 0 and j > 0:
        if (overlap_a[i - 1].id == overlap_b[j - 1].id
                and abs(overlap_a[i - 1].start - overlap_b[j - 1].start) < overlap_duration / 2):
            pairs.append((i - 1, j - 1))
            i -= 1
            j -= 1
        elif dp[i - 1][j] > dp[i][j - 1]:
            i -= 1
        else:
            j -= 1
    pairs.reverse()
    if not pairs:
        return _cutoff_merge(a, b, a_end, b_start)
    return _splice(a, b, overlap_a, pairs)


def decode_tokens(tokens: List[int], vocabulary: List[str]) -> str:
    """SentencePiece-style detokenization (reference tokenizer.py:1-2)."""
    return "".join(vocabulary[t].replace("▁", " ") for t in tokens)
