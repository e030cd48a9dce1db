"""Spark-TTS: a Qwen2-0.5B LM over BiCodec's semantic and global tokens
(counterpart of ``mlx_audio_tpu/models/tts/spark/spark.py``): voice
cloning (a reference clip -> global and semantic prompt tokens) and
controllable synthesis (gender, pitch and speed tokens), decoded to a
waveform by BiCodec.

The LM is the port's causal-LM loop (``models.lm.causal``); Qwen2 is the
Llama architecture with biased q, k and v projections and a tied head.
After ``quantize_model(model.lm, group_size=64, bits=8)`` its projections
and the tied head (``QuantizedEmbedding.as_linear``) run through the
``quantized_matmul`` kernel at decode row counts; BiCodec's wave generator
runs both conv kernels (``bicodec.py``).  Under a mesh with dp > 1 a
multi-segment control-mode ``generate`` decodes its segments as one
``generate_batch``.  A tokenizer is passed in, or loads from
``config.tokenizer_name`` (or ``config.model_path``) with
``local_files_only=True``: an object whose ``tokenizer(text,
return_tensors="np").input_ids`` are ids and whose ``decode(ids,
skip_special_tokens=False)`` is text.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from mlx_audio_tpu_torch.models.base import (
    BaseModelArgs,
    init_weights,
    make_generation_result,
    model_device,
)
from mlx_audio_tpu_torch.models.lm.causal import (
    LlamaForCausalLM,
    generate_tokens,
    generate_tokens_batch,
)
from mlx_audio_tpu_torch.models.lm.llama import LlamaConfig
from mlx_audio_tpu_torch.models.tts.spark.audio_tokenizer import BiCodecTokenizer
from mlx_audio_tpu_torch.models.tts.spark.bicodec import BiCodec
from mlx_audio_tpu_torch.models.tts.spark.token_parser import (
    build_clone_prompt,
    build_control_prompt,
    parse_generated_tokens,
)

# float UI factors -> level names
PITCH_MAP = SPEED_MAP = {
    0.0: "very_low", 0.5: "low", 1.0: "moderate", 1.5: "high", 2.0: "very_high",
}

END_OF_SPEECH = 128258


@dataclass
class ModelConfig(BaseModelArgs):
    """Defaults: the published widths of ``SparkAudio/Spark-TTS-0.5B``'s
    LLM (Qwen2-0.5B)."""

    model_path: Optional[Path] = None
    tokenizer_name: Optional[str] = None
    sample_rate: int = 16000
    bos_token_id: int = 151643
    eos_token_id: int = 151645
    hidden_size: int = 896
    intermediate_size: int = 4864
    max_position_embeddings: int = 32768
    model_type: str = "spark"
    num_attention_heads: int = 14
    num_hidden_layers: int = 24
    num_key_value_heads: int = 2
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1000000.0
    tie_word_embeddings: bool = True
    vocab_size: int = 166000
    rope_scaling: Optional[Dict[str, Any]] = None

    def llama_config(self) -> LlamaConfig:
        return LlamaConfig(
            num_hidden_layers=self.num_hidden_layers,
            num_attention_heads=self.num_attention_heads,
            num_key_value_heads=self.num_key_value_heads,
            head_dim=self.hidden_size // self.num_attention_heads,
            hidden_size=self.hidden_size,
            intermediate_size=self.intermediate_size,
            rms_norm_eps=self.rms_norm_eps,
            vocab_size=self.vocab_size,
            max_position_embeddings=self.max_position_embeddings,
            rope_theta=self.rope_theta,
            rope_scaling=self.rope_scaling,
            tie_word_embeddings=self.tie_word_embeddings,
            qkv_bias=True,
        )


def _level(value) -> str:
    return PITCH_MAP.get(value, value if isinstance(value, str) else "moderate")


def _np_tokens(tokens) -> np.ndarray:
    if isinstance(tokens, torch.Tensor):
        tokens = tokens.cpu().numpy()
    return np.asarray(tokens).reshape(-1)


class Model(nn.Module):
    """User-facing Spark-TTS.  Runs on ``device``, "cuda" unless the caller
    asks for "cpu"; the LM's weights (and BiCodec's and wav2vec2's when
    they are not given) are drawn from ``seed`` on the device."""

    def __init__(self, config, bicodec: Optional[BiCodec] = None, wav2vec2=None,
                 tokenizer=None, device: str = "cuda", seed: int = 0):
        super().__init__()
        if isinstance(config, dict):
            config = ModelConfig.from_dict(config)
        device = model_device(device, "Model")
        self.config = config
        with torch.device(device):
            self.lm = LlamaForCausalLM(config.llama_config())
        init_weights(self.lm, torch.Generator(device).manual_seed(seed))
        self.bicodec = bicodec if bicodec is not None else BiCodec(device=device,
                                                                   seed=seed)
        self._audio_tokenizer = BiCodecTokenizer(bicodec=self.bicodec,
                                                 wav2vec2=wav2vec2, seed=seed)
        self._tokenizer = tokenizer
        self.device = device

    @property
    def sample_rate(self) -> int:
        return self.config.sample_rate

    @property
    def model_type(self) -> str:
        return "spark"

    @property
    def tokenizer(self):
        if self._tokenizer is None:
            name = self.config.tokenizer_name or str(self.config.model_path)
            try:
                from transformers import AutoTokenizer

                self._tokenizer = AutoTokenizer.from_pretrained(
                    name, local_files_only=True)
            except (ImportError, OSError, ValueError) as exc:
                raise RuntimeError(
                    f"Spark's tokenizer ({name}) needs transformers and its files "
                    "on this machine; pass tokenizer= instead") from exc
        return self._tokenizer

    def _ids(self, prompt: str) -> np.ndarray:
        return np.asarray(self.tokenizer(prompt, return_tensors="np").input_ids[0])

    # -- prompts -----------------------------------------------------------

    def process_prompt(self, text: str, ref_audio, ref_text: Optional[str],
                       ref_tokens=None):
        """The voice-clone prompt and the reference's global tokens [1, 32].
        ``ref_tokens``, an earlier ``tokenize(ref_audio)``, spares the
        wav2vec2 and BiCodec pass over the reference."""
        if ref_tokens is None:
            ref_tokens = self._audio_tokenizer.tokenize(ref_audio)
        global_tokens, semantic_tokens = (_np_tokens(t) for t in ref_tokens)
        prompt = build_clone_prompt(text, ref_text, global_tokens, semantic_tokens)
        return prompt, global_tokens.reshape(1, -1)

    def process_prompt_control(self, gender: str, pitch: str, speed: str,
                               text: str):
        return build_control_prompt(text, gender, pitch=pitch, speed=speed)

    # -- generation --------------------------------------------------------

    def generate(self, text: str, ref_audio=None, ref_text: Optional[str] = None,
                 gender: str = "male", pitch: float = 1.0, speed: float = 1.0,
                 temperature: float = 0.8, top_k: int = 50, top_p: float = 0.95,
                 max_tokens: int = 3000, verbose: bool = False,
                 split_pattern: str = "\n", seed: int = 0, **kwargs):
        """One GenerationResult per segment of ``text`` (split at
        ``split_pattern``), batch 1.  With ``ref_audio`` (samples) the voice
        is cloned, and the reference is tokenized once for every segment;
        else ``gender``, ``pitch`` and ``speed`` set it."""
        from mlx_audio_tpu_torch.parallel.context import data_parallel

        pitch_level, speed_level = _level(pitch), _level(speed)
        if ref_audio is not None:  # voice cloning overrides the attributes
            gender = None
        segments = [s for s in text.split(split_pattern) if s.strip()]
        if data_parallel(len(segments)) is not None and gender is not None:
            yield from self.generate_batch(
                segments, gender=gender, pitch=pitch, speed=speed,
                temperature=temperature, top_k=top_k, top_p=top_p,
                max_tokens=max_tokens, seed=seed, **kwargs)
            return
        ref_tokens = (self._audio_tokenizer.tokenize(ref_audio)
                      if ref_audio is not None else None)
        for segment_idx, text_split in enumerate(text.split(split_pattern)):
            if not text_split.strip():
                continue
            if gender is not None:
                prompt = self.process_prompt_control(gender, pitch_level, speed_level,
                                                     text_split)
                global_token_ids = None
            else:
                prompt, global_token_ids = self.process_prompt(
                    text_split, ref_audio, ref_text, ref_tokens=ref_tokens)
            input_ids = self._ids(prompt)

            t0 = time.perf_counter()
            generated = []
            for chunk in generate_tokens(
                    self.lm, input_ids, max_tokens=max_tokens,
                    temperature=temperature, top_k=top_k, top_p=top_p,
                    repetition_penalty=kwargs.get("repetition_penalty", 1.3),
                    repetition_context_size=kwargs.get("repetition_context_size", 20),
                    stop_tokens=(self.config.eos_token_id, END_OF_SPEECH),
                    seed=seed + segment_idx):
                generated.extend(int(t) for t in chunk)

            predicts = self.tokenizer.decode(generated, skip_special_tokens=False)
            semantic_ids, global_ids = parse_generated_tokens(predicts)
            if global_token_ids is None:
                global_token_ids = np.asarray(global_ids, dtype=np.int64)[None]
            if len(semantic_ids) == 0:
                continue
            audio = self._audio_tokenizer.detokenize(
                global_token_ids, np.asarray(semantic_ids, dtype=np.int64)[None])
            yield make_generation_result(
                np.asarray(audio).reshape(-1), self.config.sample_rate, segment_idx,
                len(semantic_ids), time.perf_counter() - t0, self.device)

    def generate_batch(self, texts, gender: str = "male", pitch=1.0, speed=1.0,
                       temperature: float = 0.8, top_k: int = 50,
                       top_p: float = 0.95, max_tokens: int = 3000,
                       seed: int = 0, **kwargs):
        """Batched control-mode synthesis: one LM decode for every text (the
        rows share each weight read), then BiCodec, the rows of equal
        (semantic, global) lengths detokenized together.  One
        GenerationResult per text; an empty one for a text with no semantic
        tokens."""
        pitch_level, speed_level = _level(pitch), _level(speed)
        prompts = [self._ids(self.process_prompt_control(gender, pitch_level,
                                                         speed_level, t))
                   for t in texts]
        t0 = time.perf_counter()
        outs = generate_tokens_batch(
            self.lm, prompts, max_tokens=max_tokens, temperature=temperature,
            top_k=top_k, top_p=top_p,
            repetition_penalty=kwargs.get("repetition_penalty", 1.3),
            repetition_context_size=kwargs.get("repetition_context_size", 20),
            stop_tokens=(self.config.eos_token_id, END_OF_SPEECH), seed=seed)
        elapsed = time.perf_counter() - t0
        parsed = [parse_generated_tokens(
            self.tokenizer.decode(g.tolist(), skip_special_tokens=False)) for g in outs]
        audios: dict = {}
        groups: dict = {}
        for i, (sem, glo) in enumerate(parsed):
            if len(sem) == 0:
                audios[i] = np.zeros((0,), dtype=np.float32)
            else:
                groups.setdefault((len(sem), len(glo)), []).append(i)
        for idxs in groups.values():
            sem = np.asarray([parsed[i][0] for i in idxs], dtype=np.int64)
            glo = np.asarray([parsed[i][1] for i in idxs], dtype=np.int64)
            wavs = np.asarray(self._audio_tokenizer.detokenize(glo, sem))
            for row, i in zip(wavs.reshape(len(idxs), -1), idxs):
                audios[i] = row
        return [make_generation_result(audios[i], self.config.sample_rate, i,
                                       len(parsed[i][0]), elapsed / max(len(texts), 1),
                                       self.device)
                for i in range(len(outs))]

    # -- weights -----------------------------------------------------------

    def sanitize(self, weights: dict) -> dict:
        """Spark's checkpoints in one dictionary: the LLM's (HF Qwen2 keys)
        under ``lm.``, BiCodec's (its torch layouts fixed) under
        ``bicodec.``; wav2vec2 loads on its own."""
        lm_w, bicodec_w, out = {}, {}, {}
        bicodec_roots = ("encoder.", "decoder.", "quantizer.", "speaker_encoder.",
                         "prenet.", "postnet.")
        for k, v in weights.items():
            if k.startswith(("lm.", "bicodec.")):
                out[k] = np.asarray(v)
            elif k.startswith(bicodec_roots):
                bicodec_w[k] = v
            elif k.startswith(("model.", "lm_head")):
                lm_w[k] = v
            else:
                out[k] = np.asarray(v)
        for k, v in self.bicodec.sanitize(bicodec_w).items():
            out[f"bicodec.{k}"] = v
        for k, v in lm_w.items():
            out[f"lm.{k}"] = np.asarray(v)
        return out
