"""OuteTTS prompt serialization, expressed as declarative data: a copy of
``mlx_audio_tpu/models/tts/outetts/prompt_processor.py`` (pure Python).

The OuteTTS checkpoint was trained on a fixed byte format for its prompts
— that format is a serialization contract, not an algorithm.  This module
states it as data: a prompt grammar, a word-block field order, a
normalization rule table, and token id tables; a handful of pure renderers
walk the tables.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

from mlx_audio_tpu_torch.models.tts.outetts.tokens import SpecialTokens

_T = SpecialTokens()

# ---------------------------------------------------------------------------
# Declarative format tables
# ---------------------------------------------------------------------------

# The completion prompt: header, then (voiced prompts only) the speaker's
# word blocks and an opened word tag for the model to continue.
PROMPT_HEADER = "{bos}\n{text_start}{text}{text_end}\n{audio_start}\n"

# Per-word acoustic feature fields, in serialization order, with the token
# pattern each renders to.  Missing features serialize as 0.
WORD_FEATURE_FIELDS: Tuple[Tuple[str, str], ...] = (
    ("energy", "<|energy_{}|>"),
    ("spectral_centroid", "<|spectral_centroid_{}|>"),
    ("pitch", "<|pitch_{}|>"),
)

# One speaker word block:
#   word_start  word-text  features  t_{duration:.2f}  feature-tokens
#   code  (c1 c2) code pairs  word_end
WORD_BLOCK = ("{ws}{word}{features}{time}{feature_tokens}{code}{pairs}{we}")

# Character normalization, applied in order ("strip" is a step, not a
# regex — its position matters for inputs ending in control characters).
NORMALIZATION_RULES: Tuple = (
    (r"\s+", " "),
    ("…", "..."),
    "strip",
    (r"[“”]", '"'),
    (r"[‘’]", "'"),
    (r"[–—]", "-"),
    (r"[\x00-\x1F\x7F-\x9F]", ""),
)

# Sentence joining when a speaker transcript is prepended: CJK text closes
# with 。 and takes no space; otherwise close with ". ".
CJK_RANGES = (("぀", "ヿ"), ("一", "鿿"))
SENTENCE_ENDS = {"。": ["。", "？", "！", "?", "!"], ". ": [".", "?", "!"]}

# Audio code streams: token pattern and codebook size per stream.
CODE_STREAMS = {"c1": ("<|c1_{}|>", 1025), "c2": ("<|c2_{}|>", 1025)}


# ---------------------------------------------------------------------------
# Table-driven renderers
# ---------------------------------------------------------------------------


def normalize_text(text: str) -> str:
    """Apply NORMALIZATION_RULES in order."""
    for rule in NORMALIZATION_RULES:
        if rule == "strip":
            text = text.strip()
        else:
            text = re.sub(rule[0], rule[1], text)
    return text


def token_id_table(tokenizer, pattern: str, n: int) -> Dict[int, int]:
    """{token id of pattern.format(i): i} for i in [0, n) — the inverse
    lookup used to read code streams back out of generated token ids."""
    return {
        tokenizer.encode(pattern.format(i), add_special_tokens=False)[0]: i
        for i in range(n)
    }


def _feature_tokens(features: Optional[dict]) -> str:
    f = features or {}
    return "".join(pat.format(f.get(name, 0))
                   for name, pat in WORD_FEATURE_FIELDS)


def render_word_block(word: dict, extra_text: str = "") -> str:
    """Serialize one speaker word per WORD_BLOCK."""
    pairs = "".join(
        CODE_STREAMS["c1"][0].format(a) + CODE_STREAMS["c2"][0].format(b)
        for a, b in zip(word["c1"], word["c2"])
    )
    return WORD_BLOCK.format(
        ws=_T.word_start,
        word=word["word"] + extra_text,
        features=_T.features,
        time=_T.time.format(word["duration"]),
        feature_tokens=_feature_tokens(word.get("features")),
        code=_T.code,
        pairs=pairs,
        we=_T.word_end,
    )


def render_global_features(features: dict) -> str:
    return (_T.global_features_start + _feature_tokens(features)
            + _T.global_features_end + "\n")


def sentence_separator(text: str) -> str:
    is_cjk = any(lo <= c <= hi for c in text for lo, hi in CJK_RANGES)
    return "。" if is_cjk else ". "


def join_speaker_text(new_text: str, speaker_text: str) -> Tuple[str, str]:
    """Prepend the speaker transcript to the new text, closing its final
    sentence per SENTENCE_ENDS.  Returns (joined, punctuation added)."""
    speaker_text = speaker_text.strip()
    sep = sentence_separator(speaker_text)
    added = ""
    if speaker_text:
        if speaker_text[-1] not in SENTENCE_ENDS[sep]:
            added = sep
        elif sep != "。":
            added = " "
    return speaker_text + added + new_text.strip(), added.strip()


def build_prompt(text: str, speaker: Optional[dict] = None) -> str:
    """The full completion prompt for `text`, with the speaker's audio
    word blocks prepended when voice-cloning."""
    text = normalize_text(text)
    header_kwargs = dict(bos=_T.bos, text_start=_T.text_start,
                         text_end=_T.text_end, audio_start=_T.audio_start)
    if speaker is None:
        return PROMPT_HEADER.format(text=text, **header_kwargs)
    joined, added = join_speaker_text(text, speaker["text"])
    words = speaker["words"]
    blocks = [
        render_word_block(w, extra_text=added if i == len(words) - 1 else "")
        for i, w in enumerate(words)
    ]
    return (PROMPT_HEADER.format(text=joined, **header_kwargs)
            + "\n".join(blocks) + "\n" + _T.word_start)


def decode_audio_tokens(tokens, c1_table: Dict[int, int],
                        c2_table: Dict[int, int]) -> List[List[int]]:
    """Generated token ids -> [c1 codes, c2 codes], trimmed to equal
    length (streams interleave pairwise; a truncated tail drops)."""
    c1 = [c1_table[t] for t in tokens if t in c1_table]
    c2 = [c2_table[t] for t in tokens if t in c2_table]
    t = min(len(c1), len(c2))
    return [c1[:t], c2[:t]]


# ---------------------------------------------------------------------------
# Facade (API used by outetts.py)
# ---------------------------------------------------------------------------


class PromptProcessor:
    def __init__(self, tokenizer):
        self.special_tokens = _T
        self.tokenizer = tokenizer
        if tokenizer is not None:
            self.c1 = token_id_table(tokenizer, *CODE_STREAMS["c1"])
            self.c2 = token_id_table(tokenizer, *CODE_STREAMS["c2"])
        else:
            self.c1, self.c2 = {}, {}

    def get_completion_prompt(self, text: str, speaker: dict = None) -> str:
        return build_prompt(text, speaker)

    def get_global_features(self, features: dict) -> str:
        return render_global_features(features)

    def extract_audio_from_tokens(self, tokens) -> list:
        return decode_audio_tokens(tokens, self.c1, self.c2)
