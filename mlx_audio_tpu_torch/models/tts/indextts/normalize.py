"""IndexTTS text normalization (a copy of
``mlx_audio_tpu/models/tts/indextts/normalize.py``, which imports no JAX;
the port keeps its own so that it imports nothing of the JAX package):
CJK/English routing, punctuation folding, pinyin protection, contraction
expansion, number/currency verbalization, and CJK-char spacing for the
SentencePiece tokenizer.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

# punctuation folding table (reference CHAR_MAP, normalize.py:4-38)
_PUNCT = {
    "：": ",", "；": ",", ";": ",", "，": ",", "。": ".", "！": "!",
    "？": "?", "\n": " ", "·": "-", "、": ",", "...": "…", ",,,": "…",
    "，，，": "…", "……": "…", "“": "'", "”": "'", '"': "'", "‘": "'",
    "’": "'", "（": "'", "）": "'", "(": "'", ")": "'", "《": "'",
    "》": "'", "【": "'", "】": "'", "[": "'", "]": "'", "—": "-",
    "～": "-", "~": "-", "「": "'", "」": "'", ":": ",",
}
_PUNCT_ZH = {"$": ".", **_PUNCT}

PINYIN_RE = re.compile(
    r"(?<![a-z])((?:[bpmfdtnlgkhjqxzcsryw]|[zcs]h)?"
    r"(?:[aeiouüv]|[ae]i|u[aio]|ao|ou|i[aue]|[uüv]e|[uvü]ang?|uai|"
    r"[aeiuv]n|[aeio]ng|ia[no]|i[ao]ng)|ng|er)([1-5])",
    re.IGNORECASE,
)
NAME_RE = re.compile("[\\u4e00-\\u9fff]+(?:[-·—][\\u4e00-\\u9fff]+){1,2}")
CONTRACTION_RE = re.compile(
    r"(what|where|who|which|how|t?here|it|s?he|that|this)'s", re.IGNORECASE
)
EMAIL_RE = re.compile(r"^[a-zA-Z0-9]+@[a-zA-Z0-9]+\.[a-zA-Z]+$")
_CJK_SPLIT_RE = re.compile(
    # nltk tokenize.util CJK ranges (cf. reference normalize.py:289-290)
    "([\u1100-\u11ff\u2e80-\ua4cf\ua840-\uD7AF\uF900-\uFAFF"
    "\uFE30-\uFE4F\uFF65-\uFFDC\U00020000-\U0002FFFF])"
)


def has_chinese(text: str) -> bool:
    return re.search("[\\u4e00-\\u9fff]", text) is not None


def use_chinese(text: str) -> bool:
    """Language routing (reference normalize.py:64-67)."""
    has_alpha = re.search(r"[a-zA-Z]", text) is not None
    return (
        has_chinese(text)
        or not has_alpha
        or EMAIL_RE.match(text) is not None
        or PINYIN_RE.search(text) is not None
    )


def _fold_chars(text: str, table: Dict[str, str]) -> str:
    pat = re.compile("|".join(re.escape(p) for p in table))
    return pat.sub(lambda m: table[m.group()], text)


def expand_contractions(text: str) -> str:
    return CONTRACTION_RE.sub(r"\1 is", text)


def number_to_words(n: int) -> str:
    """English verbalization up to trillions (reference :128-191)."""
    ones = ["", "one", "two", "three", "four", "five", "six", "seven",
            "eight", "nine"]
    teens = ["ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
             "sixteen", "seventeen", "eighteen", "nineteen"]
    tens = ["", "", "twenty", "thirty", "forty", "fifty", "sixty",
            "seventy", "eighty", "ninety"]
    scales = ["", "thousand", "million", "billion", "trillion"]

    def under_thousand(num: int) -> str:
        if num < 10:
            return ones[num]
        if num < 20:
            return teens[num - 10]
        if num < 100:
            return tens[num // 10] + (" " + ones[num % 10] if num % 10 else "")
        return (ones[num // 100] + " hundred"
                + (" " + under_thousand(num % 100) if num % 100 else ""))

    if n == 0:
        return "zero"
    words: List[str] = []
    scale = 0
    while n > 0:
        group = n % 1000
        if group:
            w = under_thousand(group)
            if scales[scale]:
                w += " " + scales[scale]
            words.append(w)
        n //= 1000
        scale += 1
    return " ".join(reversed(words))


def correct_pinyin(py: str) -> str:
    """j/q/x + u -> v respelling, uppercased (reference :83-88)."""
    if py[0] not in "jqxJQX":
        return py
    return re.sub(r"([jqx])[uü](n|e|an)*(\d)", r"\g<1>v\g<2>\g<3>", py,
                  flags=re.IGNORECASE).upper()


def _protect(text: str, pattern: re.Pattern, prefix: str
             ) -> Tuple[str, Dict[str, str]]:
    found = list({
        "".join(m) if isinstance(m, tuple) else m
        for m in pattern.findall(text)
    })
    table = {
        item: f"<{prefix}_{chr(ord('a') + i)}>" for i, item in enumerate(found)
    }
    for original, ph in table.items():
        text = text.replace(original, ph)
    return text, table


def _restore(text: str, table: Dict[str, str], fn=None) -> str:
    for original, ph in table.items():
        text = text.replace(ph, fn(original) if fn else original)
    return text


def normalize_chinese(text: str) -> str:
    text = expand_contractions(text.rstrip())
    text, pinyin_map = _protect(text, PINYIN_RE, "pinyin")
    text, name_map = _protect(text, NAME_RE, "n")
    text = _restore(text, name_map)
    text = _restore(text, pinyin_map, correct_pinyin)
    return _fold_chars(text, _PUNCT_ZH)


def normalize_english(text: str) -> str:
    text = expand_contractions(text)

    def currency(m: re.Match) -> str:
        digits = "".join(filter(str.isdigit, m.group(0)))
        if not digits:
            return m.group(0)
        num = int(digits)
        return f"{number_to_words(num)} dollar{'s' if num != 1 else ''} "

    text = re.sub(r"\$\s*[0-9,.\s]+", currency, text).rstrip()

    def spaced_digits(m: re.Match) -> str:
        parts = m.group(0).split()
        if all(len(p) == 1 and p.isdigit() for p in parts):
            return " ".join(number_to_words(int(d)) for d in parts)
        return number_to_words(int("".join(filter(str.isdigit, m.group(0)))))

    text = re.sub(r"\b\d(\s+\d)+\b", spaced_digits, text)

    def plain_number(m: re.Match) -> str:
        digits = "".join(filter(str.isdigit, m.group(0)))
        return number_to_words(int(digits)) if digits else m.group(0)

    text = re.sub(r"\b\d+(?:,\d+)*\b", plain_number, text)
    text = re.sub(r"\s+", " ", text).strip()
    return _fold_chars(text, _PUNCT)


def normalize(text: str) -> str:
    return (normalize_chinese if use_chinese(text) else normalize_english)(text)


def tokenize_by_CJK_char(line: str, do_upper_case: bool = True) -> str:
    """Space-separate CJK chars, uppercase latin (reference :272-294)."""
    chars = _CJK_SPLIT_RE.split(line.strip())
    return " ".join(
        w.strip().upper() if do_upper_case else w.strip()
        for w in chars if w.strip()
    )
