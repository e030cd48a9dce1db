"""Whisper's long-form transcription (counterpart of
``mlx_audio_tpu/models/stt/whisper/transcribe.py``): a host-side seek loop
over 30 s windows, as a small state machine.

What it does is openai-whisper's behaviour: temperature fallback, segments
cut at timestamp tokens, no-speech skipping, and the word-anomaly
hallucination heuristics with their constants.  One decoded window is a
``Window``, the output so far a ``Transcript``, and ``_SeekLoop`` owns the
cursor, a method a rule.  The log-mel and each window's decode run on the
model's device (api.py, decoding.py).

Checkpoints load from a local directory only (``Model.from_pretrained``);
an audio path is read through ``utils.audio_io`` at 16 kHz.  Whisper
runs in float32 (a checkpoint's "quantization" entry is dropped, as in the
JAX package).
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from mlx_audio_tpu_torch.models.stt.whisper import api
from mlx_audio_tpu_torch.models.stt.whisper.audio import (
    FRAMES_PER_SECOND,
    HOP_LENGTH,
    SAMPLE_RATE,
    log_mel_spectrogram,
    pad_or_trim,
)
from mlx_audio_tpu_torch.models.stt.whisper.decoding import DecodingOptions, DecodingResult
from mlx_audio_tpu_torch.models.stt.whisper.model import ModelDimensions, WhisperModel
from mlx_audio_tpu_torch.models.stt.whisper.timing import add_word_timestamps
from mlx_audio_tpu_torch.models.stt.whisper.tokenizer import LANGUAGES, get_tokenizer
from mlx_audio_tpu_torch.utils.audio_io import load_audio

# Word-anomaly scoring constants (openai-whisper's hallucination spec).
_ANOMALY_LOW_PROB = 0.15
_ANOMALY_SHORT_S = 0.133
_ANOMALY_SHORT_WEIGHT = 15.0
_ANOMALY_LONG_S = 2.0
_ANOMALY_SCORE_LIMIT = 3.0
_ANOMALY_HEAD_WORDS = 8
_EDGE_GUARD_S = 2.0
_PUNCT_CHARS = "\"'“¿([{-\"'.。,，!！?？:：”)]}、"


def format_timestamp(seconds: float) -> str:
    assert seconds >= 0
    ms = round(seconds * 1000.0)
    hours, ms = divmod(ms, 3_600_000)
    minutes, ms = divmod(ms, 60_000)
    secs, ms = divmod(ms, 1_000)
    hours_marker = f"{hours:02d}:" if hours > 0 else ""
    return f"{hours_marker}{minutes:02d}:{secs:02d}.{ms:03d}"


@dataclass
class STTOutput:
    text: str
    segments: Optional[List[dict]] = None
    language: Optional[str] = None


# ---------------------------------------------------------------------------
# Seek-loop value types
# ---------------------------------------------------------------------------


@dataclass
class Window:
    """One decoded mel window plus its time geometry."""

    seek: int                 # window start, mel frames
    size: int                 # content frames in this window
    mel: torch.Tensor         # padded [n_frames, n_mels] fed to decode
    result: DecodingResult
    tokens: np.ndarray        # int token ids

    start_s: float            # seek in seconds
    end_s: float              # window END (full n_frames) in seconds
    duration_s: float         # size in seconds

    def timestamp_mask(self, first_ts: int) -> np.ndarray:
        return self.tokens >= first_ts

    def ends_with_lone_timestamp(self, first_ts: int) -> bool:
        m = self.timestamp_mask(first_ts)
        return len(self.tokens) >= 2 and m[-2:].tolist() == [False, True]


@dataclass
class Transcript:
    """Accumulated output: segments, the rolling token context used as the
    next window's prompt, and the conditioning reset point."""

    segments: List[dict] = field(default_factory=list)
    tokens: List[int] = field(default_factory=list)
    reset_at: int = 0         # prompt context starts here
    prompt_header: int = 0    # initial_prompt token count (excluded in text)

    def prompt(self) -> List[int]:
        return self.tokens[self.reset_at:]

    def absorb(self, window_segments: List[dict],
               keep_conditioning: bool) -> None:
        self.segments.extend(
            {"id": i, **s}
            for i, s in enumerate(window_segments, start=len(self.segments))
        )
        for s in window_segments:
            self.tokens.extend(s["tokens"])
        if not keep_conditioning:
            self.reset_at = len(self.tokens)


def _word_anomaly_score(word: dict) -> float:
    score = 0.0
    if word.get("probability", 0.0) < _ANOMALY_LOW_PROB:
        score += 1.0
    span = word["end"] - word["start"]
    if span < _ANOMALY_SHORT_S:
        score += (_ANOMALY_SHORT_S - span) * _ANOMALY_SHORT_WEIGHT
    if span > _ANOMALY_LONG_S:
        score += span - _ANOMALY_LONG_S
    return score


def _segment_is_anomaly(segment: Optional[dict]) -> bool:
    if segment is None or not segment.get("words"):
        return False
    head = [w for w in segment["words"]
            if w["word"] not in _PUNCT_CHARS][:_ANOMALY_HEAD_WORDS]
    total = sum(_word_anomaly_score(w) for w in head)
    return total >= _ANOMALY_SCORE_LIMIT or total + 0.01 >= len(head)


def _first_worded(segments: List[dict]) -> Optional[dict]:
    return next((s for s in segments if s.get("words")), None)


def _last_word_end(segments: List[dict]) -> Optional[float]:
    return next(
        (w["end"] for s in reversed(segments)
         for w in reversed(s.get("words", []))),
        segments[-1]["end"] if segments else None,
    )


# ---------------------------------------------------------------------------
# The seek loop
# ---------------------------------------------------------------------------


class _SeekLoop:
    """Owns the frame cursor and all per-window decisions."""

    def __init__(self, model: "Model", tokenizer, mel: torch.Tensor,
                 content_frames: int, *, temperatures, decode_kwargs: dict,
                 compression_limit, logprob_floor, no_speech_limit,
                 condition_on_previous_text: bool, word_timestamps: bool,
                 prepend_punctuations: str, append_punctuations: str,
                 hallucination_silence: Optional[float],
                 verbose: Optional[bool]):
        self.model = model
        self.tokenizer = tokenizer
        self.mel = mel
        self.content_frames = content_frames
        self.content_s = float(content_frames * HOP_LENGTH / SAMPLE_RATE)
        self.temperatures = temperatures
        self.decode_kwargs = decode_kwargs
        self.compression_limit = compression_limit
        self.logprob_floor = logprob_floor
        self.no_speech_limit = no_speech_limit
        self.condition = condition_on_previous_text
        self.word_timestamps = word_timestamps
        self.prepend_punctuations = prepend_punctuations
        self.append_punctuations = append_punctuations
        self.hallucination_silence = hallucination_silence

        self.verbose = verbose
        self.window_frames = 2 * model.dims.n_audio_ctx
        # frames per emitted audio token, and seconds per timestamp tick
        self.frames_per_token = self.window_frames // model.dims.n_audio_ctx
        self.tick_s = self.frames_per_token * HOP_LENGTH / SAMPLE_RATE

        self.out = Transcript()
        self.last_speech_s = 0.0

    # -- decode ------------------------------------------------------------

    def _decode_once(self, mel_window, temperature: float) -> DecodingResult:
        kwargs = dict(self.decode_kwargs)
        # sampled retries can't beam; greedy doesn't best-of
        for k in (("beam_size", "patience") if temperature > 0
                  else ("best_of",)):
            kwargs.pop(k, None)
        options = DecodingOptions(**kwargs, temperature=temperature)
        return api.decode(self.model, mel_window, options,
                          tokenizer=self.tokenizer)

    def _acceptable(self, r: DecodingResult) -> bool:
        if (self.no_speech_limit is not None
                and r.no_speech_prob > self.no_speech_limit):
            return True          # silence: no retry will help
        if (self.compression_limit is not None
                and r.compression_ratio > self.compression_limit):
            return False         # repetition loop
        if (self.logprob_floor is not None
                and r.avg_logprob < self.logprob_floor):
            return False         # low confidence
        return True

    def decode_window(self, seek: int, clip_end: int) -> Window:
        """Decode one window at `seek` with temperature fallback."""
        size = min(self.window_frames, self.content_frames - seek,
                   clip_end - seek)
        padded = pad_or_trim(self.mel[seek: seek + size], self.window_frames,
                             axis=-2)
        self.decode_kwargs["prompt"] = self.out.prompt()
        result = None
        for t in self.temperatures:
            result = self._decode_once(padded, t)
            if self._acceptable(result):
                break
        return Window(
            seek=seek, size=size, mel=padded, result=result,
            tokens=np.array(result.tokens),
            start_s=float(seek * HOP_LENGTH / SAMPLE_RATE),
            end_s=float((seek + self.window_frames) * HOP_LENGTH / SAMPLE_RATE),
            duration_s=size * HOP_LENGTH / SAMPLE_RATE,
        )

    def is_silence(self, win: Window) -> bool:
        if self.no_speech_limit is None:
            return False
        if win.result.no_speech_prob <= self.no_speech_limit:
            return False
        # confident text overrides the no-speech gate
        return not (self.logprob_floor is not None
                    and win.result.avg_logprob > self.logprob_floor)

    # -- segmentation ------------------------------------------------------

    def _make_segment(self, win: Window, start: float, end: float,
                      tokens) -> dict:
        tokens = [int(t) for t in tokens]
        return {
            "seek": win.seek,
            "start": start,
            "end": end,
            "text": self.tokenizer.decode(
                [t for t in tokens if t < self.tokenizer.eot]),
            "tokens": tokens,
            "temperature": win.result.temperature,
            "avg_logprob": win.result.avg_logprob,
            "compression_ratio": win.result.compression_ratio,
            "no_speech_prob": win.result.no_speech_prob,
        }

    def split_on_timestamps(self, win: Window) -> Tuple[List[dict], int]:
        """Segment a window on its timestamp tokens; returns (segments,
        next seek position)."""
        first_ts = self.tokenizer.timestamp_begin
        mask = win.timestamp_mask(first_ts)
        lone_ending = win.ends_with_lone_timestamp(first_ts)
        pair_starts = (np.where(mask[:-1] & mask[1:])[0] + 1).tolist()

        if not pair_starts:
            # one segment spanning to the last timestamp (if any) or the
            # whole window
            span = win.duration_s
            stamps = win.tokens[np.where(mask)[0]]
            if len(stamps) and int(stamps[-1]) != first_ts:
                span = (int(stamps[-1]) - first_ts) * self.tick_s
            seg = self._make_segment(win, win.start_s, win.start_s + span,
                                     win.tokens)
            return [seg], win.seek + win.size

        cuts = pair_starts + ([len(win.tokens)] if lone_ending else [])
        segments = []
        lo = 0
        for hi in cuts:
            piece = win.tokens[lo:hi]
            t0 = (int(piece[0]) - first_ts) * self.tick_s
            t1 = (int(piece[-1]) - first_ts) * self.tick_s
            segments.append(self._make_segment(
                win, win.start_s + t0, win.start_s + t1, piece))
            lo = hi
        if lone_ending:
            return segments, win.seek + win.size
        resume_tick = int(win.tokens[lo - 1]) - first_ts
        return segments, win.seek + resume_tick * self.frames_per_token

    # -- word timestamps + hallucination pass ------------------------------

    def time_words(self, win: Window, segments: List[dict]) -> None:
        add_word_timestamps(
            segments=segments, model=self.model, tokenizer=self.tokenizer,
            mel=win.mel, num_frames=win.size,
            prepend_punctuations=self.prepend_punctuations,
            append_punctuations=self.append_punctuations,
            last_speech_timestamp=self.last_speech_s,
            # the decode pass already encoded this window — no second
            # encoder run for word timing
            audio_features=win.result.audio_features,
        )

    def drop_hallucinations(self, win: Window, segments: List[dict],
                            lone_ending: bool,
                            seek: int) -> Tuple[Optional[int], int]:
        """openai-whisper's silence-gap heuristics.  Returns
        (retry_seek | None, adjusted next seek).  A retry_seek means the
        whole window is discarded and re-decoded further in."""
        limit = self.hallucination_silence
        if not lone_ending:
            tail = _last_word_end(segments)
            if tail is not None and tail > win.start_s:
                if win.end_s - tail > limit:
                    seek = round(tail * FRAMES_PER_SECOND)
                else:
                    seek = win.seek + win.size

        # a late first segment after a silent gap: re-decode past the gap
        head = _first_worded(segments)
        if head is not None and _segment_is_anomaly(head):
            gap = head["start"] - win.start_s
            if gap > limit:
                return win.seek + round(gap * FRAMES_PER_SECOND), seek

        # drop an anomalous segment isolated by silence on both sides
        prev_end = self.last_speech_s
        for i, seg in enumerate(segments):
            if not seg.get("words"):
                continue
            if _segment_is_anomaly(seg):
                nxt = _first_worded(segments[i + 1:])
                nxt_start = (nxt["words"][0]["start"] if nxt is not None
                             else win.start_s + win.duration_s)
                quiet_before = (
                    seg["start"] - prev_end > limit
                    or seg["start"] < limit
                    or seg["start"] - win.start_s < _EDGE_GUARD_S
                )
                quiet_after = (
                    nxt_start - seg["end"] > limit
                    or _segment_is_anomaly(nxt)
                    or win.end_s - seg["end"] < _EDGE_GUARD_S
                )
                if quiet_before and quiet_after:
                    seek = round(max(win.start_s + 1, seg["start"])
                                 * FRAMES_PER_SECOND)
                    if self.content_s - seg["end"] < limit:
                        seek = self.content_frames
                    del segments[i:]
                    break
            prev_end = seg["end"]
        return None, seek

    # -- one window --------------------------------------------------------

    def process_window(self, seek: int, clip_end: int) -> int:
        """Decode + segment one window; absorb its output.  Returns the
        next seek position."""
        win = self.decode_window(seek, clip_end)
        if self.is_silence(win):
            return seek + win.size

        segments, next_seek = self.split_on_timestamps(win)
        lone_ending = win.ends_with_lone_timestamp(
            self.tokenizer.timestamp_begin)

        if self.word_timestamps:
            self.time_words(win, segments)
            if not lone_ending:
                tail = _last_word_end(segments)
                if tail is not None and tail > win.start_s:
                    next_seek = round(tail * FRAMES_PER_SECOND)
            if self.hallucination_silence is not None:
                retry, next_seek = self.drop_hallucinations(
                    win, segments, lone_ending, next_seek)
                if retry is not None:
                    return retry          # discard this window entirely
            tail = _last_word_end(segments)
            if tail is not None:
                self.last_speech_s = tail

        if self.verbose:
            for seg in segments:
                print(f"[{format_timestamp(seg['start'])} --> "
                      f"{format_timestamp(seg['end'])}] {seg['text']}")

        for seg in segments:
            if seg["start"] == seg["end"] or not seg["text"].strip():
                seg.update(text="", tokens=[], words=[])

        self.out.absorb(
            segments,
            keep_conditioning=(self.condition
                               and win.result.temperature <= 0.5),
        )
        return next_seek

    def run(self, seek_clips: List[Tuple[int, int]]) -> Transcript:
        seek = seek_clips[0][0]
        for clip_start, clip_end in seek_clips:
            seek = max(seek, clip_start)
            while seek < clip_end:
                seek = self.process_window(seek, clip_end)
        return self.out


# ---------------------------------------------------------------------------
# Model / loading
# ---------------------------------------------------------------------------


def _load_weight_files(model_path: Path) -> dict:
    """Weights of a checkpoint directory: ``*.safetensors`` (MLX-community
    ``weights.safetensors`` or HF ``model.safetensors``, shards too) or
    ``weights.npz``."""
    from mlx_audio_tpu_torch.codec.loading import load_weights_files

    try:
        return load_weights_files(model_path)
    except FileNotFoundError:
        f = model_path / "weights.npz"
        if f.exists():
            return dict(np.load(f))
        raise


class Model(WhisperModel):
    """Whisper with the transcription API."""

    # HF transformers WhisperConfig field names -> ModelDimensions
    _HF_DIM_MAP = {
        "num_mel_bins": "n_mels",
        "max_source_positions": "n_audio_ctx",
        "d_model": "n_audio_state",
        "encoder_attention_heads": "n_audio_head",
        "encoder_layers": "n_audio_layer",
        "vocab_size": "n_vocab",
        "max_target_positions": "n_text_ctx",
        "decoder_attention_heads": "n_text_head",
        "decoder_layers": "n_text_layer",
    }

    @classmethod
    def from_pretrained(cls, path: str, device: str = "cuda") -> "Model":
        """Load a local checkpoint directory (MLX-community or HF
        transformers layout); nothing is fetched."""
        from mlx_audio_tpu_torch.codec.loading import checkpoint_dir, load_config
        from mlx_audio_tpu_torch.convert import params_from_jax

        model_path = checkpoint_dir(path)
        config = load_config(model_path)
        config.pop("quantization", None)
        if "d_model" in config:  # HF transformers layout
            for hf_k, our_k in cls._HF_DIM_MAP.items():
                if hf_k in config:
                    config[our_k] = config[hf_k]
            config["n_text_state"] = config["d_model"]
        model = cls(ModelDimensions.from_dict(config), device=device)
        state = params_from_jax(model.sanitize(_load_weight_files(model_path)), model)
        model.load_state_dict(state, strict=False)
        model._asset_dir = str(model_path)
        return model

    def _tokenizer(self, language=None, task=None):
        return get_tokenizer(
            self.is_multilingual, num_languages=self.num_languages,
            language=language, task=task,
            asset_dir=getattr(self, "_asset_dir", None),
        )

    def detect_language(self, mel, tokenizer=None):
        return api.detect_language(self, mel, tokenizer)

    def decode(self, mel, options: DecodingOptions = DecodingOptions(), **kwargs):
        tokenizer = self._tokenizer(options.language or "en", options.task)
        return api.decode(self, mel, options, tokenizer=tokenizer, **kwargs)

    def _pick_language(self, mel: torch.Tensor, window_frames: int,
                       verbose) -> str:
        if not self.is_multilingual:
            return "en"
        _, probs = self.detect_language(pad_or_trim(mel, window_frames, axis=-2))
        language = max(probs, key=probs.get)
        if verbose is not None:
            print(f"Detected language: {LANGUAGES[language].title()}")
        return language

    @staticmethod
    def _clip_ranges(clip_timestamps, content_frames: int) -> list:
        """'a,b,c,...' seconds -> [(start_frame, end_frame), ...]; an odd
        count leaves the final range open to the end of the audio."""
        if isinstance(clip_timestamps, str):
            clip_timestamps = [float(t) for t in
                               (clip_timestamps.split(",")
                                if clip_timestamps else [])]
        points = [round(t * FRAMES_PER_SECOND) for t in clip_timestamps]
        if not points:
            points = [0]
        if len(points) % 2 == 1:
            points.append(content_frames)
        else:
            points[-1] = min(content_frames, points[-1])
        return list(zip(points[::2], points[1::2]))

    def generate(
        self,
        audio: Union[str, np.ndarray],
        *,
        verbose: Optional[bool] = None,
        temperature: Union[float, Tuple[float, ...]] = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0),
        compression_ratio_threshold: Optional[float] = 2.4,
        logprob_threshold: Optional[float] = -1.0,
        no_speech_threshold: Optional[float] = 0.6,
        condition_on_previous_text: bool = True,
        initial_prompt: Optional[str] = None,
        word_timestamps: bool = False,
        prepend_punctuations: str = "\"'“¿([{-",
        append_punctuations: str = "\"'.。,，!！?？:：”)]}、",
        clip_timestamps: Union[str, List[float]] = "0",
        hallucination_silence_threshold: Optional[float] = None,
        **decode_options,
    ) -> STTOutput:
        """Transcribe audio of any length (16 kHz samples, or a file path
        read and resampled to 16 kHz)."""
        decode_options.pop("max_tokens", None)
        decode_options.pop("generation_stream", None)
        if isinstance(audio, str):
            audio = load_audio(audio, SAMPLE_RATE)

        # the window follows the model's audio context (3000 mel frames, 30
        # s, for the published Whispers; 2 mel frames an audio token)
        window_frames = 2 * self.dims.n_audio_ctx
        mel = log_mel_spectrogram(audio, n_mels=self.dims.n_mels,
                                  padding=window_frames * HOP_LENGTH,
                                  device=self.device)
        content_frames = mel.shape[-2] - window_frames

        if decode_options.get("language") is None:
            decode_options["language"] = self._pick_language(
                mel, window_frames, verbose)
        language = decode_options["language"]
        task = decode_options.get("task", "transcribe")
        tokenizer = self._tokenizer(language, task)

        if word_timestamps and task == "translate":
            warnings.warn(
                "Word-level timestamps on translations may not be reliable.")

        loop = _SeekLoop(
            self, tokenizer, mel, content_frames,
            temperatures=([temperature]
                          if isinstance(temperature, (int, float))
                          else temperature),
            decode_kwargs=decode_options,
            compression_limit=compression_ratio_threshold,
            logprob_floor=logprob_threshold,
            no_speech_limit=no_speech_threshold,
            condition_on_previous_text=condition_on_previous_text,
            word_timestamps=word_timestamps,
            prepend_punctuations=prepend_punctuations,
            append_punctuations=append_punctuations,
            hallucination_silence=hallucination_silence_threshold,
            verbose=verbose,
        )
        if initial_prompt is not None:
            header = tokenizer.encode(" " + initial_prompt.strip())
            loop.out.tokens.extend(header)
            loop.out.prompt_header = len(header)

        out = loop.run(self._clip_ranges(clip_timestamps, content_frames))
        return STTOutput(
            text=tokenizer.decode(out.tokens[out.prompt_header:]),
            segments=out.segments,
            language=language,
        )
