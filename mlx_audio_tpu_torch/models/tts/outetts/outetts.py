"""OuteTTS: a Llama (or Qwen2/Qwen3) LM over 2-codebook DAC tokens
(counterpart of ``mlx_audio_tpu/models/tts/outetts/outetts.py``).

Word-level speaker profiles with duration and feature tokens, interleaved
c1/c2 code generation and streaming decode, on the port's causal-LM loop
(``models.lm.causal``).  After ``quantize_model(model.lm, group_size=64,
bits=8)`` the projections and the tied head (``QuantizedEmbedding.as_linear``)
run through the ``quantized_matmul`` kernel at decode row counts; the 24 kHz
DAC's resblock convs take the conv kernels their route names.  Under a
mesh with dp > 1 a multi-chunk, non-streaming ``generate`` without a
reference decodes its chunks as one ``generate_batch``.  Left for later:
tokenizer downloads (``tokenizer=`` or a local path).
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

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
from mlx_audio_tpu_torch.models.tts.outetts.audio_processor import AudioProcessor
from mlx_audio_tpu_torch.models.tts.outetts.prompt_processor import PromptProcessor

# tokens a second of audio: 75 DAC frames, a c1 and a c2 token each (the
# streaming interval's unit)
TOKENS_PER_SECOND = 137.5


@dataclass
class ModelConfig(BaseModelArgs):
    """Defaults: the published widths of ``OuteAI/Llama-OuteTTS-1.0-1B``."""

    model_type: str = "llama"
    hidden_size: int = 2048
    num_hidden_layers: int = 16
    intermediate_size: int = 8192
    num_attention_heads: int = 32
    num_key_value_heads: Optional[int] = 8
    head_dim: Optional[int] = None
    rms_norm_eps: float = 1e-5
    vocab_size: int = 134400
    max_position_embeddings: int = 8192
    rope_theta: float = 500000.0
    rope_scaling: Optional[dict] = None
    tie_word_embeddings: bool = True
    tokenizer_name: str = "OuteAI/Llama-OuteTTS-1.0-1B"
    sample_rate: int = 24000

    def to_llama(self) -> LlamaConfig:
        return LlamaConfig(
            num_hidden_layers=self.num_hidden_layers,
            num_attention_heads=self.num_attention_heads,
            num_key_value_heads=self.num_key_value_heads or self.num_attention_heads,
            head_dim=self.head_dim or self.hidden_size // self.num_attention_heads,
            hidden_size=self.hidden_size,
            intermediate_size=self.intermediate_size,
            rms_norm_eps=self.rms_norm_eps,
            vocab_size=self.vocab_size,
            max_position_embeddings=min(self.max_position_embeddings, 8192),
            rope_theta=self.rope_theta,
            rope_scaling=self.rope_scaling,
            tie_word_embeddings=self.tie_word_embeddings,
            # the Qwen2 and Qwen3 variants
            qkv_bias=self.model_type == "qwen2",
            use_qk_norm=self.model_type == "qwen3",
        )


class Model(nn.Module):
    """User-facing OuteTTS model.  Runs on ``device``, "cuda" unless the
    caller asks for "cpu"; the LM's weights (and the 24 kHz DAC's, when no
    ``dac_model`` is given) are drawn from ``seed`` on the device.  The
    tokenizer is passed in, or loaded from ``config.tokenizer_name`` as a
    local directory: an object with ``encode(text, add_special_tokens=False)
    -> ids``."""

    def __init__(self, config, dac_model=None, tokenizer=None,
                 device: str = "cuda", seed: int = 0):
        super().__init__()
        if isinstance(config, dict):
            config = ModelConfig.from_dict(config)
        device = model_device(device, "Model")
        self.config = config
        with torch.device(device):
            self.lm = LlamaForCausalLM(config.to_llama())
        init_weights(self.lm, torch.Generator(device).manual_seed(seed))
        self._tokenizer = tokenizer
        self._audio_processor = None
        self._dac_model = dac_model
        self.device = device
        self.seed = seed

    @property
    def sample_rate(self):
        return self.config.sample_rate

    def _get_tokenizer(self):
        if self._tokenizer is None:
            from mlx_audio_tpu_torch.codec.loading import checkpoint_dir

            path = checkpoint_dir(self.config.tokenizer_name)
            from transformers import AutoTokenizer

            self._tokenizer = AutoTokenizer.from_pretrained(str(path))
        return self._tokenizer

    @property
    def audio_processor(self) -> AudioProcessor:
        if self._audio_processor is None:
            self._audio_processor = AudioProcessor(self._dac_model, self.device,
                                                   self.seed)
        return self._audio_processor

    def get_speaker(self, voice: Optional[str], ref_audio=None) -> Optional[dict]:
        if voice is None and ref_audio is None:
            default = Path(__file__).parent / "default_speaker.json"
            if default.exists():
                return self.audio_processor.load_speaker(str(default))
            return None
        if voice is not None:
            return self.audio_processor.load_speaker(voice)
        return self.audio_processor.create_speaker_from_whisper(ref_audio)

    def chunk_text(self, text: str, max_words: int = 30) -> List[str]:
        sentences = [s.strip() for s in re.split(r"[.!?。！？︕︖]+", text) if s.strip()]
        chunks, current, length = [], [], 0
        for sentence in sentences:
            words = sentence.split()
            if length + len(words) > max_words and current:
                chunks.append(" ".join(current))
                current, length = [], 0
            current.extend(words)
            length += len(words)
        if current:
            chunks.append(" ".join(current))
        return chunks

    def _decode(self, codes) -> np.ndarray:
        """[c1 codes, c2 codes] -> audio [T]."""
        return self.audio_processor.audio_codec.decode(np.asarray(codes)[None])[0, 0]

    def generate(self, text, voice: Optional[str] = None,
                 temperature: float = 0.4, top_p: float = 0.9,
                 max_tokens: int = 1200, ref_audio=None,
                 repetition_penalty: float = 1.1,
                 repetition_context_size: int = 64,
                 stream: bool = False, streaming_interval: float = 2.0,
                 seed: int = 0, **kwargs):
        """One GenerationResult per chunk of ``text`` (``chunk_text``), batch
        1.  With ``stream=True`` a chunk's codes so far are decoded every
        ``int(streaming_interval * 137.5)`` tokens and the new audio
        yielded."""
        tokenizer = self._get_tokenizer()
        prompt_processor = PromptProcessor(tokenizer)
        speaker = self.get_speaker(voice, ref_audio)
        eos_id = tokenizer.encode(prompt_processor.special_tokens.eos,
                                  add_special_tokens=False)
        stop = tuple(eos_id[-1:])
        interval = max(1, int(streaming_interval * TOKENS_PER_SECOND))

        from mlx_audio_tpu_torch.parallel.context import data_parallel

        chunks = self.chunk_text(text)
        if data_parallel(len(chunks)) is not None and not stream and ref_audio is None:
            yield from self.generate_batch(
                chunks, voice=voice, temperature=temperature, top_p=top_p,
                max_tokens=max_tokens, repetition_penalty=repetition_penalty,
                repetition_context_size=repetition_context_size, seed=seed)
            return
        for seg_idx, prompt in enumerate(chunks):
            completion = prompt_processor.get_completion_prompt(prompt, speaker)
            input_ids = np.asarray(
                tokenizer.encode(completion, add_special_tokens=False))
            start = time.perf_counter()
            generated: List[int] = []
            yielded_frames = 0
            yielded_tokens = 0
            for chunk in generate_tokens(
                    self.lm, input_ids, max_tokens=max_tokens,
                    temperature=temperature, top_p=top_p,
                    repetition_penalty=repetition_penalty,
                    repetition_context_size=repetition_context_size,
                    stop_tokens=stop, seed=seed + seg_idx):
                generated.extend(int(t) for t in chunk)
                if stream and len(generated) - yielded_tokens >= interval:
                    codes = prompt_processor.extract_audio_from_tokens(generated)
                    if codes[0]:
                        audio = self._decode(codes)
                        yield make_generation_result(
                            audio[yielded_frames:], self.config.sample_rate,
                            seg_idx, len(generated) - yielded_tokens,
                            time.perf_counter() - start, self.device)
                        yielded_frames = audio.shape[0]
                        yielded_tokens = len(generated)
                        start = time.perf_counter()
            codes = prompt_processor.extract_audio_from_tokens(generated)
            if not codes[0]:
                continue
            audio = self._decode(codes)
            if audio.shape[0] > yielded_frames:
                yield make_generation_result(
                    audio[yielded_frames:], self.config.sample_rate, seg_idx,
                    len(generated) - yielded_tokens,
                    time.perf_counter() - start, self.device)

    def generate_batch(self, texts, voice: Optional[str] = None,
                       temperature: float = 0.4, top_p: float = 0.9,
                       max_tokens: int = 1200,
                       repetition_penalty: float = 1.1,
                       repetition_context_size: int = 64, seed: int = 0,
                       **kwargs):
        """All texts' chunks in one batched decode (the rows share every
        weight read), then a DAC decode each.  One GenerationResult per
        text, its chunks' audio concatenated; an empty one for a text that
        produced no codes."""
        tokenizer = self._get_tokenizer()
        prompt_processor = PromptProcessor(tokenizer)
        speaker = self.get_speaker(voice, None)
        eos_id = tokenizer.encode(prompt_processor.special_tokens.eos,
                                  add_special_tokens=False)
        start = time.perf_counter()

        rows, owner = [], []
        for ti, text in enumerate(texts):
            for prompt in self.chunk_text(text):
                completion = prompt_processor.get_completion_prompt(prompt, speaker)
                rows.append(np.asarray(
                    tokenizer.encode(completion, add_special_tokens=False)))
                owner.append(ti)
        if not rows:
            return [make_generation_result(
                np.zeros((0,), dtype=np.float32), self.config.sample_rate,
                ti, 0, 0.0, self.device) for ti in range(len(texts))]
        outs = generate_tokens_batch(
            self.lm, rows, max_tokens=max_tokens, temperature=temperature,
            top_p=top_p, repetition_penalty=repetition_penalty,
            repetition_context_size=repetition_context_size,
            stop_tokens=tuple(eos_id[-1:]), seed=seed)
        elapsed = time.perf_counter() - start
        results = []
        for ti in range(len(texts)):
            segs, n_tok = [], 0
            for i, gen in enumerate(outs):
                if owner[i] != ti:
                    continue
                codes = prompt_processor.extract_audio_from_tokens(gen.tolist())
                if codes and codes[0]:
                    segs.append(self._decode(codes))
                    n_tok += len(gen)
            audio = (np.concatenate(segs) if segs
                     else np.zeros((0,), dtype=np.float32))
            results.append(make_generation_result(
                audio, self.config.sample_rate, ti, n_tok,
                elapsed / len(texts), self.device))
        return results

    def sanitize(self, weights: dict) -> dict:
        """HF Llama/Qwen checkpoints map one to one under the ``lm.``
        prefix."""
        out = {}
        for k, v in weights.items():
            if k.startswith("model.model.") or k.startswith("model.lm_head"):
                k = "lm." + k[len("model."):]
            elif k.startswith("model.") or k.startswith("lm_head"):
                k = "lm." + k
            elif not k.startswith("lm."):
                k = "lm.model." + k
            out[k] = np.asarray(v)
        return out
