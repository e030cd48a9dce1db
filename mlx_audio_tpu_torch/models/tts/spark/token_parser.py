"""Spark-TTS prompt and token vocabulary helpers (a copy of
``mlx_audio_tpu/models/tts/spark/token_parser.py``): task tokens, attribute
level maps, and the prompt builders of controllable and voice-cloning TTS.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

TASK_TOKEN_MAP = {
    "vc": "<|task_vc|>",
    "tts": "<|task_tts|>",
    "asr": "<|task_asr|>",
    "s2s": "<|task_s2s|>",
    "t2s": "<|task_t2s|>",
    "understand": "<|task_understand|>",
    "caption": "<|task_cap|>",
    "controllable_tts": "<|task_controllable_tts|>",
    "prompt_tts": "<|task_prompt_tts|>",
    "speech_edit": "<|task_edit|>",
}

LEVELS_MAP = {"very_low": 0, "low": 1, "moderate": 2, "high": 3, "very_high": 4}
LEVELS_MAP_UI = {1: "very_low", 2: "low", 3: "moderate", 4: "high", 5: "very_high"}
GENDER_MAP = {"female": 0, "male": 1}


class TokenParser:
    """Prompt builders (reference token_parser.py:46-181)."""

    @staticmethod
    def age_token(age: int) -> str:
        return f"<|age_{age}|>"

    @staticmethod
    def gender_token(gender: str) -> str:
        return f"<|gender_{GENDER_MAP[gender]}|>"

    @staticmethod
    def mel_value(mel: int) -> str:
        mel = max(min(mel, 250), 0)
        return f"<|pitch_value_{mel}|>"

    @staticmethod
    def mel_level(level: str) -> str:
        return f"<|pitch_label_{LEVELS_MAP[level]}|>"

    @staticmethod
    def pitch_var_value(pitch_std: int) -> str:
        pitch_std = max(min(pitch_std, 10), 0)
        return f"<|pitch_var_value_{pitch_std}|>"

    @staticmethod
    def pitch_var_level(level: str) -> str:
        return f"<|pitch_var_label_{LEVELS_MAP[level]}|>"

    @staticmethod
    def loudness_value(loudness: float) -> str:
        loudness = max(min(int(loudness * 10), 30), 0)
        return f"<|loudness_value_{loudness}|>"

    @staticmethod
    def loudness_level(level: str) -> str:
        return f"<|loudness_label_{LEVELS_MAP[level]}|>"

    @staticmethod
    def speed_value(speed: int) -> str:
        speed = max(min(speed, 10), 0)
        return f"<|speed_value_{speed}|>"

    @staticmethod
    def speed_level(level: str) -> str:
        return f"<|speed_label_{LEVELS_MAP[level]}|>"


def global_token_str(global_tokens) -> str:
    return "".join(f"<|bicodec_global_{int(i)}|>" for i in global_tokens)


def semantic_token_str(semantic_tokens) -> str:
    return "".join(f"<|bicodec_semantic_{int(i)}|>" for i in semantic_tokens)


def build_clone_prompt(text: str, transcript: Optional[str],
                       global_tokens, semantic_tokens) -> str:
    """Voice-clone prompt (reference spark.py process_prompt)."""
    gt = global_token_str(global_tokens)
    if transcript:
        inputs = [
            TASK_TOKEN_MAP["tts"], "<|start_content|>", transcript, text,
            "<|end_content|>", "<|start_global_token|>", gt,
            "<|end_global_token|>", "<|start_semantic_token|>",
            semantic_token_str(semantic_tokens),
        ]
    else:
        inputs = [
            TASK_TOKEN_MAP["tts"], "<|start_content|>", text,
            "<|end_content|>", "<|start_global_token|>", gt,
            "<|end_global_token|>",
        ]
    return "".join(inputs)


def build_control_prompt(text: str, gender: str, pitch: str = "moderate",
                         speed: str = "moderate") -> str:
    """Controllable-TTS prompt (reference spark.py process_prompt_control)."""
    assert gender in GENDER_MAP, f"gender must be in {list(GENDER_MAP)}"
    attributes = "".join([
        TokenParser.gender_token(gender),
        TokenParser.mel_level(pitch),
        TokenParser.speed_level(speed),
    ])
    return "".join([
        TASK_TOKEN_MAP["controllable_tts"], "<|start_content|>", text,
        "<|end_content|>", "<|start_style_label|>", attributes,
        "<|end_style_label|>",
    ])


def parse_generated_tokens(text: str) -> Tuple[List[int], List[int]]:
    """Extract (semantic ids, global ids) from decoded LM output via the
    bicodec_semantic_N / bicodec_global_N markers."""
    import re

    semantic = [int(m) for m in re.findall(r"bicodec_semantic_(\d+)", text)]
    global_ = [int(m) for m in re.findall(r"bicodec_global_(\d+)", text)]
    return semantic, global_
