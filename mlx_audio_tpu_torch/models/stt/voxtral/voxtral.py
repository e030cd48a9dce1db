"""Voxtral: speech to text by an LLM (counterpart of
``mlx_audio_tpu/models/stt/voxtral/voxtral.py``).  A Whisper-style audio
tower, a multimodal projector, and a Llama LM whose input embeddings take
the audio tokens in place of the audio placeholders.

* The audio tower's conv1 (K = 3, 'same', 128 mels into 1280) takes
  ``nn.layers.conv1d``'s ``dilated_conv1d`` kernel; a quantized LM's
  projections and head take ``quantized_matmul`` at decode row counts.
* The JAX package's jitted decode chunk (a ``lax.scan`` of up to 32 steps)
  is a Python loop of as many steps; the host reads the tokens once a
  chunk, as the JAX package does.  Prompts are left-padded to a bucket of
  64, as there (a result depends on it: RoPE's absolute positions round).
* Sampling: a call's seed comes from a host generator seeded ``seed``, and
  row i samples with its own generator (``models.sampling``); the JAX PRNG
  cannot be reproduced, so only greedy tokens are compared with it.
* An audio file path is read through ``utils.audio_io`` at 16 kHz.
* Under an active mesh (``parallel.context``) with tp > 1 the model's
  projections split by ``tp_rules_llama``; with dp > 1 a batch of windows
  pads to a dp multiple by repeating its last window, and each data row
  decodes its windows on its replica under ``row_offset``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mlx_audio_tpu_torch.models.base import BaseModelArgs, init_weights, model_device
from mlx_audio_tpu_torch.models.lm.llama import LlamaConfig, LlamaModel
from mlx_audio_tpu_torch.models.sampling import (
    call_seed,
    sample_top_k_rows,
    sample_top_p_rows,
)
from mlx_audio_tpu_torch.models.stt.whisper.audio import log_mel_spectrogram
from mlx_audio_tpu_torch.models.stt.whisper.transcribe import STTOutput
from mlx_audio_tpu_torch.nn.layers import Conv1d, Embedding, LayerNorm, Linear
from mlx_audio_tpu_torch.utils.audio_io import load_audio

_CHUNK = 32  # decode steps between the host's looks at the end-of-speech tokens


@dataclass
class AudioConfig(BaseModelArgs):
    num_mel_bins: int = 128
    d_model: int = 1280
    encoder_layers: int = 32
    encoder_attention_heads: int = 20
    encoder_ffn_dim: int = 5120
    intermediate_size: int = 5120
    max_source_positions: int = 1500
    scale_embedding: bool = False


@dataclass
class TextConfig(BaseModelArgs):
    model_type: str = "llama"
    vocab_size: int = 131072
    max_position_embeddings: int = 131072
    hidden_size: int = 3072
    intermediate_size: int = 8192
    num_hidden_layers: int = 30
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    rms_norm_eps: float = 1e-5
    rope_theta: float = 1e8
    rope_scaling: Optional[Dict[str, Any]] = None
    attention_bias: bool = False
    mlp_bias: bool = False
    head_dim: Optional[int] = None
    tie_word_embeddings: bool = False

    def to_llama(self, max_ctx: int = 4096) -> LlamaConfig:
        return LlamaConfig(
            num_hidden_layers=self.num_hidden_layers,
            num_attention_heads=self.num_attention_heads,
            num_key_value_heads=self.num_key_value_heads,
            head_dim=self.head_dim or self.hidden_size // self.num_attention_heads,
            hidden_size=self.hidden_size,
            intermediate_size=self.intermediate_size,
            rms_norm_eps=self.rms_norm_eps,
            vocab_size=self.vocab_size,
            max_position_embeddings=min(self.max_position_embeddings, max_ctx),
            attention_bias=self.attention_bias,
            mlp_bias=self.mlp_bias,
            rope_theta=self.rope_theta,
            rope_scaling=self.rope_scaling,
            tie_word_embeddings=self.tie_word_embeddings,
        )


@dataclass
class ModelConfig(BaseModelArgs):
    model_type: str = "voxtral"
    audio_config: dict = field(default_factory=dict)
    text_config: dict = field(default_factory=dict)
    audio_token_id: int = 24
    tokenizer_name: Optional[str] = None


class VoxtralEncoderLayer(nn.Module):
    def __init__(self, cfg: AudioConfig):
        super().__init__()
        d = cfg.d_model
        self.n_head = cfg.encoder_attention_heads
        self.head_dim = d // self.n_head
        self.q_proj = Linear(d, d, bias=True)
        self.k_proj = Linear(d, d, bias=False)
        self.v_proj = Linear(d, d, bias=True)
        self.out_proj = Linear(d, d, bias=True)
        self.self_attn_layer_norm = LayerNorm(d)
        self.fc1 = Linear(d, cfg.encoder_ffn_dim)
        self.fc2 = Linear(cfg.encoder_ffn_dim, d)
        self.final_layer_norm = LayerNorm(d)

    def _attn(self, x):
        b, t, d = x.shape

        def split(z):
            return z.reshape(b, t, self.n_head, self.head_dim).transpose(1, 2)

        q = split(self.q_proj(x)) * self.head_dim ** -0.5
        k = split(self.k_proj(x))
        v = split(self.v_proj(x))
        probs = torch.softmax((q @ k.transpose(-1, -2)).float(), dim=-1).to(x.dtype)
        return self.out_proj((probs @ v).transpose(1, 2).reshape(b, t, d))

    def forward(self, x):
        x = x + self._attn(self.self_attn_layer_norm(x))
        return x + self.fc2(F.gelu(self.fc1(self.final_layer_norm(x))))


class VoxtralEncoder(nn.Module):
    def __init__(self, cfg: AudioConfig):
        super().__init__()
        d = cfg.d_model
        self.conv1 = Conv1d(cfg.num_mel_bins, d, 3, padding=1)
        self.conv2 = Conv1d(d, d, 3, stride=2, padding=1)
        self.embed_positions = Embedding(cfg.max_source_positions, d)
        self.layers = nn.ModuleList(VoxtralEncoderLayer(cfg)
                                    for _ in range(cfg.encoder_layers))
        self.layer_norm = LayerNorm(d)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """mel [B, frames, num_mel_bins] -> [B, frames / 2, d_model]."""
        x = F.gelu(self.conv1(mel))
        x = F.gelu(self.conv2(x))
        # through the call, not .weight: a quantized embedding dequantizes
        x = x + self.embed_positions(torch.arange(x.shape[1], device=x.device))
        for layer in self.layers:
            x = layer(x)
        return self.layer_norm(x)


class MultiModalProjector(nn.Module):
    def __init__(self, audio_cfg: AudioConfig, text_cfg: TextConfig):
        super().__init__()
        self.linear_1 = Linear(audio_cfg.intermediate_size, text_cfg.hidden_size, bias=False)
        self.linear_2 = Linear(text_cfg.hidden_size, text_cfg.hidden_size, bias=False)

    def forward(self, x):
        return self.linear_2(F.gelu(self.linear_1(x)))


class Model(nn.Module):
    """Voxtral: weights drawn from ``seed`` on ``device``; ``tokenizer`` is
    any object with ``decode(ids) -> str``."""

    def __init__(self, config, tokenizer=None, device: str = "cuda", seed: int = 0):
        super().__init__()
        if isinstance(config, dict):
            config = ModelConfig.from_dict(config)
        device = model_device(device, "Voxtral")
        self.config = config
        self.audio_cfg = AudioConfig.from_dict(config.audio_config or {})
        self.text_cfg = TextConfig.from_dict(config.text_config or {})
        self.audio_token_id = config.audio_token_id
        with torch.device(device):
            self.audio_tower = VoxtralEncoder(self.audio_cfg)
            self.multi_modal_projector = MultiModalProjector(self.audio_cfg, self.text_cfg)
            self.language_model = LlamaModel(self.text_cfg.to_llama())
            if not self.text_cfg.tie_word_embeddings:
                self.lm_head = Linear(self.text_cfg.hidden_size, self.text_cfg.vocab_size,
                                      bias=False)
        init_weights(self, torch.Generator(device).manual_seed(seed))
        self._tokenizer = tokenizer
        self.device = device

    def lm_logits(self, hidden):
        if self.text_cfg.tie_word_embeddings:
            return self.language_model.embed_tokens.as_linear(hidden)
        return self.lm_head(hidden)

    def get_audio_embeds(self, mel: torch.Tensor) -> torch.Tensor:
        """mel [B, frames, bins] -> audio token embeddings [N, hidden]: the
        encoder's frames grouped by intermediate_size / d_model (4 for the
        published config) before the projector."""
        feats = self.audio_tower(mel)
        group = self.audio_cfg.intermediate_size // self.audio_cfg.d_model
        t = feats.shape[1] - feats.shape[1] % group
        feats = feats[:, :t].reshape(-1, self.audio_cfg.intermediate_size)
        return self.multi_modal_projector(feats)

    @torch.no_grad()
    def merge_input_embeddings(self, input_ids: torch.Tensor,
                               mel: Optional[torch.Tensor]) -> torch.Tensor:
        """The LM's input embeddings of ``input_ids`` [B, T], each
        audio_token_id in turn replaced by the next audio embedding of
        ``mel``."""
        input_ids = torch.as_tensor(input_ids, device=self.device)
        embeds = self.language_model.embed_tokens(input_ids)
        if mel is None:
            return embeds
        audio_embeds = self.get_audio_embeds(torch.as_tensor(mel, device=self.device))
        b, t = input_ids.shape
        flat_mask = (input_ids == self.audio_token_id).reshape(-1)
        idx = torch.clamp(torch.cumsum(flat_mask, 0) - 1, 0, audio_embeds.shape[0] - 1)
        # promoted, as jnp.where promotes: a bf16 LM's prompt takes the
        # float32 audio embeddings as they are, and its prefill runs float32
        spliced = torch.where(flat_mask[:, None], audio_embeds[idx],
                              embeds.reshape(b * t, -1))
        return spliced.reshape(embeds.shape)

    def generate(self, audio, *, mel=None, input_ids=None, max_tokens: int = 128,
                 temperature: float = 0.0, top_p: float = 0.95, top_k: int = 0,
                 eos_token_ids=(2,), seed: int = 0, **kwargs) -> STTOutput:
        """Transcribe: 16 kHz audio, or ``mel`` [frames, bins] with prompt
        ``input_ids`` holding one audio_token_id for each audio embedding.
        Audio longer than one encoder window decodes as one batch of
        windows that share a prompt."""
        if isinstance(audio, str):
            audio = load_audio(audio, 16000)
        if mel is None and input_ids is None and audio is not None:
            full_mel = log_mel_spectrogram(np.asarray(audio),
                                           n_mels=self.audio_cfg.num_mel_bins,
                                           device=self.device)
            window = 2 * self.audio_cfg.max_source_positions
            if full_mel.shape[0] > window:
                mels = torch.stack([self._pad_window(full_mel[s: s + window])
                                    for s in range(0, int(full_mel.shape[0]), window)])
                rows = self._decode_window_rows(
                    mels, self._ids_for_window(), max_tokens=max_tokens,
                    temperature=temperature, top_p=top_p, top_k=top_k,
                    eos_token_ids=eos_token_ids, seed=seed)
                texts = [self._tokenizer.decode(r) if self._tokenizer is not None else ""
                         for r in rows]
                return STTOutput(text=" ".join(t for t in texts if t),
                                 segments=[{"tokens": r} for r in rows],
                                 language=kwargs.get("language", "en"))

        if mel is None or input_ids is None:
            mel, input_ids = self._prepare_inputs(audio, **kwargs)
        mel = torch.as_tensor(mel, dtype=torch.float32, device=self.device)
        generated = self._decode_window_rows(
            mel[None], input_ids, max_tokens=max_tokens, temperature=temperature,
            top_p=top_p, top_k=top_k, eos_token_ids=eos_token_ids, seed=seed)[0]
        text = self._tokenizer.decode(generated) if self._tokenizer is not None else ""
        return STTOutput(text=text, segments=[{"tokens": generated}],
                         language=kwargs.get("language", "en"))

    def _dtype(self) -> torch.dtype:
        # a quantized embedding holds uint8 codes: activations take the
        # scales' dtype
        emb = self.language_model.embed_tokens
        return emb.scales.dtype if hasattr(emb, "scales") else emb.weight.dtype

    def _decode_window_rows(self, mels, input_ids, **kw):
        """Windows mels [W, frames, bins] with one shared prompt [T] ->
        each window's generated token list, on the active mesh's placement
        (see the module docstring)."""
        from mlx_audio_tpu_torch.parallel.context import active_mesh, placement
        from mlx_audio_tpu_torch.parallel.mesh import tp_rules_llama

        w = mels.shape[0]
        models, _, n = placement(self, w, tp_rules_llama)
        if len(models) == 1:
            return models[0]._decode_rows(mels, input_ids, **kw)
        mels = torch.cat([mels, mels[-1:].expand(n - w, *mels.shape[1:])])
        parts = active_mesh().map_rows(models, n, lambda m, lo, hi: m._decode_rows(
            mels[lo:hi], input_ids, **kw))
        return [r for part in parts for r in part][:w]

    @torch.no_grad()
    def _decode_rows(self, mels, input_ids, *, max_tokens: int,
                     temperature: float, top_p: float, top_k: int,
                     eos_token_ids, seed: int):
        """``_decode_window_rows`` on this model: the end-of-speech tokens
        are checked on the host once a chunk of up to _CHUNK steps."""
        w = mels.shape[0]
        ids = np.asarray(input_ids).reshape(-1)
        t = len(ids)
        bucket = max(64, -(-t // 64) * 64)
        pad = bucket - t
        padded = np.zeros((w, bucket), dtype=np.int64)
        padded[:, pad:] = ids
        lm = self.language_model
        caches = lm.init_cache(w, max_len=bucket + max_tokens, dtype=self._dtype())
        pad_len = torch.full((w,), pad, dtype=torch.int64, device=self.device)
        generator = torch.Generator().manual_seed(seed)

        def sample(logits):
            if temperature == 0:
                return torch.argmax(logits, dim=-1)
            if top_p < 1.0:
                return sample_top_p_rows(logits, temperature, top_p,
                                         call_seed(generator)).long()
            return sample_top_k_rows(logits, temperature, top_k,
                                     call_seed(generator)).long()

        embeds = self.merge_input_embeddings(
            torch.as_tensor(padded, device=self.device),
            torch.as_tensor(mels, dtype=torch.float32, device=self.device))
        h, caches = lm.prefill(caches, embeds, pad_len)
        logits = self.lm_logits(h[:, -1]).float()
        if temperature == 0:
            first = torch.argmax(logits, dim=-1)
        else:
            first = sample_top_p_rows(logits, temperature, top_p,
                                      call_seed(generator)).long()
        first_np = first.cpu().numpy()

        out = [[] for _ in range(w)]
        done = np.zeros((w,), dtype=bool)
        for i in range(w):
            if int(first_np[i]) in eos_token_ids:
                done[i] = True
            else:
                out[i].append(int(first_np[i]))
        last = first
        produced = 1
        while produced < max_tokens and not done.all():
            n = min(_CHUNK, max_tokens - produced)
            toks = []
            for _ in range(n):
                emb = lm.embed_tokens(last[:, None])
                h, caches = lm.step(caches, emb, pad_len)
                last = sample(self.lm_logits(h[:, -1]).float())
                toks.append(last)
            toks_np = torch.stack(toks).cpu().numpy()  # [n, W]
            for step in range(n):
                for i in range(w):
                    if done[i]:
                        continue
                    tk = int(toks_np[step, i])
                    if tk in eos_token_ids:
                        done[i] = True
                    else:
                        out[i].append(tk)
            produced += n
        return out

    def _pad_window(self, mel: torch.Tensor) -> torch.Tensor:
        window = 2 * self.audio_cfg.max_source_positions
        if mel.shape[0] < window:
            mel = F.pad(mel, (0, 0, 0, window - mel.shape[0]))
        return mel

    def _ids_for_window(self) -> np.ndarray:
        group = self.audio_cfg.intermediate_size // self.audio_cfg.d_model
        n_audio_tokens = self.audio_cfg.max_source_positions // group
        return np.asarray([1] + [self.audio_token_id] * n_audio_tokens, dtype=np.int32)

    def _prepare_inputs(self, audio, language="en", **kwargs):
        """One window's mel, padded or trimmed to 2 * max_source_positions
        frames (the encoder's positional table; HF pads so too), and its
        prompt: BOS, then one placeholder an audio embedding."""
        mel = log_mel_spectrogram(np.asarray(audio), n_mels=self.audio_cfg.num_mel_bins,
                                  device=self.device)
        window = 2 * self.audio_cfg.max_source_positions
        mel = self._pad_window(mel)[:window]
        n_audio_tokens = (mel.shape[0] // 2) // (
            self.audio_cfg.intermediate_size // self.audio_cfg.d_model)
        ids = [1] + [self.audio_token_id] * n_audio_tokens
        return mel, np.asarray(ids, dtype=np.int32)

    def sanitize(self, weights: dict) -> dict:
        """An HF checkpoint -> the JAX package's layout (conv [K, I, O]);
        ``convert.params_from_jax`` takes the result to the port's."""
        out = {}
        for k, v in weights.items():
            v = np.asarray(v)
            if "conv" in k and k.endswith("weight") and v.ndim == 3:
                v = v.transpose(2, 1, 0)  # torch [O, I, K] -> [K, I, O]
            k = k.replace("language_model.model.", "language_model.")
            k = k.replace("language_model.lm_head.", "lm_head.")
            if k.startswith("audio_tower."):
                # HF nests the encoder's projections under .self_attn.
                k = k.replace(".self_attn.", ".")
            out[k] = v
        return out
