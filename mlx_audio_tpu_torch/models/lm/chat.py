"""The chat text-LM stage of the speech-to-speech assistant (counterpart of
``mlx_audio_tpu/models/lm/chat.py``).

A Llama / Qwen2 / Qwen3-family checkpoint in the standard HF layout, its
chat-template tokenizer, and the port's causal-LM loop
(``models/lm/causal.py``).  The JAX package compiles one prefill and one
decode-chunk graph a 64-token prompt bucket and warms every bucket; eager
PyTorch compiles nothing a shape, so :meth:`ChatLM.prewarm` runs one turn.
Checkpoints and tokenizers load from local directories only.
"""

from __future__ import annotations

import logging
from typing import List, Optional

import numpy as np
import torch

from mlx_audio_tpu_torch.models.lm.causal import (
    LlamaForCausalLM,
    generate_tokens,
    generate_tokens_batch,
)
from mlx_audio_tpu_torch.models.lm.llama import LlamaConfig, cast_lm

logger = logging.getLogger("mlx_audio_tpu_torch.chat")

# short conversational sentences, no unspeakable punctuation
SYSTEM_PROMPT = (
    "You are a helpful voice assistant. You always respond with short "
    "sentences and never use punctuation like parentheses or colons that "
    "wouldn't appear in conversational speech."
)


def llama_config_from_hf(config: dict) -> LlamaConfig:
    """HF llama/qwen2/qwen3 config.json -> LlamaConfig."""
    hidden = config["hidden_size"]
    heads = config["num_attention_heads"]
    mtype = str(config.get("model_type", "llama")).lower()
    return LlamaConfig(
        num_hidden_layers=config["num_hidden_layers"],
        num_attention_heads=heads,
        num_key_value_heads=config.get("num_key_value_heads", heads),
        head_dim=config.get("head_dim") or hidden // heads,
        hidden_size=hidden,
        intermediate_size=config["intermediate_size"],
        rms_norm_eps=config.get("rms_norm_eps", 1e-5),
        vocab_size=config["vocab_size"],
        max_position_embeddings=min(config.get("max_position_embeddings", 8192), 8192),
        attention_bias=config.get("attention_bias", False),
        mlp_bias=config.get("mlp_bias", False),
        rope_theta=config.get("rope_theta", 10000.0),
        rope_scaling=config.get("rope_scaling"),
        tie_word_embeddings=config.get("tie_word_embeddings", False),
        qkv_bias=mtype == "qwen2",
        use_qk_norm=mtype == "qwen3",
    )


def sanitize_hf_causal_lm(weights: dict) -> dict:
    """HF ``model.*`` / ``lm_head.*`` keys map one to one onto
    LlamaForCausalLM; the buffers some conversions ship (rotary
    ``inv_freq``, attention bias masks) are dropped: the RoPE tables are
    computed."""
    out = {}
    for k, v in weights.items():
        if k.endswith(("rotary_emb.inv_freq", ".attn.bias", ".attn.masked_bias")):
            continue
        out[k if k.startswith(("model.", "lm_head")) else "model." + k] = np.asarray(v)
    return out


class ChatLM:
    """A conversational text LM: a checkpoint, its chat template and the
    causal-LM decode loop."""

    def __init__(self, model: LlamaForCausalLM, tokenizer, max_tokens: int = 256,
                 temperature: float = 0.6, top_p: float = 0.9,
                 system_prompt: str = SYSTEM_PROMPT):
        self.model = model
        self.tokenizer = tokenizer
        self.max_tokens = max_tokens
        self.temperature = temperature
        self.top_p = top_p
        self.system_prompt = system_prompt

    @classmethod
    def from_pretrained(cls, path: str, dtype=None, tokenizer=None,
                        device: str = "cuda", **kwargs) -> "ChatLM":
        """A local checkpoint directory (HF layout) on ``device``, cast to
        ``dtype`` but the RoPE tables.  Without ``tokenizer`` the
        directory's own loads with ``local_files_only=True``; nothing is
        fetched."""
        from mlx_audio_tpu_torch.codec.loading import load_weights_files
        from mlx_audio_tpu_torch.convert import params_from_jax
        from mlx_audio_tpu_torch.models.base import model_device
        from mlx_audio_tpu_torch.utils.loader import DTYPES, get_model_path, load_config

        root = get_model_path(path)
        config = load_config(root)
        with torch.device(model_device(device, "ChatLM")):
            model = LlamaForCausalLM(llama_config_from_hf(config))
        weights = sanitize_hf_causal_lm(load_weights_files(root))
        missing, unexpected = model.load_state_dict(params_from_jax(weights, model),
                                                    strict=False)
        missing = [k for k in missing if not k.endswith(("rope_cos", "rope_sin"))]
        if missing or unexpected:
            raise KeyError(f"{root}: checkpoint does not fit the config: missing "
                           f"{sorted(missing)[:5]}, unexpected {sorted(unexpected)[:5]}")
        if dtype is not None:
            cast_lm(model, DTYPES[dtype] if isinstance(dtype, str) else dtype)
        if tokenizer is None:
            try:
                from transformers import AutoTokenizer

                tokenizer = AutoTokenizer.from_pretrained(str(root), local_files_only=True)
            except Exception as exc:
                raise RuntimeError(
                    f"{root}: no chat tokenizer there (the port loads local files "
                    "only); pass tokenizer= to ChatLM.from_pretrained") from exc
        return cls(model, tokenizer, **kwargs)

    def _stop_tokens(self) -> tuple:
        stops = set()
        eos = getattr(self.tokenizer, "eos_token_id", None)
        if eos is not None:
            if isinstance(eos, (list, tuple)):
                stops.update(int(e) for e in eos)
            else:
                stops.add(int(eos))
        # Llama 3 ends a turn with <|eot_id|>, Qwen with <|im_end|>; a
        # sentencepiece tokenizer without them answers unk_token_id, which
        # must not cut replies short
        unk = getattr(self.tokenizer, "unk_token_id", None)
        for tok in ("<|eot_id|>", "<|im_end|>"):
            try:
                tid = self.tokenizer.convert_tokens_to_ids(tok)
                if tid is not None and tid >= 0 and tid != unk:
                    stops.add(int(tid))
            except Exception:
                pass
        return tuple(stops)

    def _tokenize_messages(self, messages: List[dict]) -> List[int]:
        if hasattr(self.tokenizer, "apply_chat_template"):
            return self.tokenizer.apply_chat_template(
                messages, tokenize=True, add_generation_prompt=True)
        # a plain tokenizer: a simple transcript format
        prompt = "".join(f"{m['role']}: {m['content']}\n" for m in messages) + "assistant:"
        return self.tokenizer.encode(prompt)

    def _build_prompt_ids(self, text: str,
                          history: Optional[List[dict]] = None) -> List[int]:
        """The chat-template prompt, evicting the oldest history turns while
        prompt and generation budget overflow the context (the system
        prompt and the user's message always stay), then keeping the tail
        if those alone overflow it."""
        history = list(history or [])
        budget = self.model.config.max_position_embeddings - self.max_tokens

        def build():
            return ([{"role": "system", "content": self.system_prompt}]
                    + history + [{"role": "user", "content": text}])

        ids = self._tokenize_messages(build())
        while len(ids) > budget and history:
            history.pop(0)
            ids = self._tokenize_messages(build())
        if len(ids) > budget:
            logger.warning(
                "chat prompt (%d tokens) exceeds the %d-token context budget even "
                "with empty history; truncating to the tail", len(ids), budget)
            ids = ids[-budget:]
        return ids

    def respond(self, text: str, history: Optional[List[dict]] = None,
                seed: int = 0) -> str:
        """One chat turn: history and the user's text -> the reply."""
        ids = self._build_prompt_ids(text, history)
        out = generate_tokens_batch(
            self.model, [np.asarray(ids, dtype=np.int32)], max_tokens=self.max_tokens,
            temperature=self.temperature, top_p=self.top_p,
            stop_tokens=self._stop_tokens(), seed=seed)[0]
        return self.tokenizer.decode(out.tolist(), skip_special_tokens=True).strip()

    def respond_stream(self, text: str, history: Optional[List[dict]] = None,
                       seed: int = 0, chunk: int = 8):
        """A streamed chat turn: yields the decoded reply so far after every
        ``chunk`` generated tokens (the last yield is the whole reply), so
        the speech-to-speech pipeline can speak the first sentence while
        the LM decodes on."""
        ids = self._build_prompt_ids(text, history)
        toks: List[int] = []
        for piece in generate_tokens(
                self.model, np.asarray(ids, dtype=np.int32), max_tokens=self.max_tokens,
                temperature=self.temperature, top_p=self.top_p,
                stop_tokens=self._stop_tokens(), chunk=chunk, seed=seed):
            toks.extend(piece.tolist())
            yield self.tokenizer.decode(toks, skip_special_tokens=True).strip()

    def prewarm(self) -> int:
        """One streamed turn with the session's sampling settings, so that
        the first live turn does not pay for the kernels' and libraries'
        first use.  Eager PyTorch builds nothing a prompt length, so one
        turn covers every prompt (the JAX package warms one turn a 64-token
        bucket).  Returns the turns run: 1."""
        for _ in self.respond_stream("Hello."):
            pass
        return 1

    # the VoicePipeline calls its llm stage as a callable(text) -> text
    __call__ = respond
