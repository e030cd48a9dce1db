"""Whisper's encoder and decoder (counterpart of
``mlx_audio_tpu/models/stt/whisper/model.py``).

A conv and transformer audio encoder with sinusoidal positions; a text
decoder with learned absolute positions and cross-attention.  Decode state
is a list of ``nn.attention.KVCache`` objects, written in place.  Prompts
are right-padded (learned absolute positions forbid left padding); after a
prefill the caches' write index is rewound to the last valid slot, because
the decode loops feed the prompt's last token again on their first step.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mlx_audio_tpu_torch.models.base import check_array_shape, init_weights, model_device
from mlx_audio_tpu_torch.nn.attention import KVCache
from mlx_audio_tpu_torch.nn.layers import Conv1d, Embedding, LayerNorm, Linear


@dataclass
class ModelDimensions:
    n_mels: int
    n_audio_ctx: int
    n_audio_state: int
    n_audio_head: int
    n_audio_layer: int
    n_vocab: int
    n_text_ctx: int
    n_text_state: int
    n_text_head: int
    n_text_layer: int

    @classmethod
    def from_dict(cls, params: dict) -> "ModelDimensions":
        return cls(**{k: v for k, v in params.items()
                      if k in cls.__annotations__})


def sinusoids(length: int, channels: int, max_timescale: float = 10000) -> np.ndarray:
    assert channels % 2 == 0
    log_inc = math.log(max_timescale) / (channels // 2 - 1)
    inv = np.exp(-log_inc * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x)  # the exact (erf) form, as jax.nn.gelu(approximate=False)


class WhisperAttention(nn.Module):
    """Whisper's layout: query, key, value and out; the key has no bias."""

    def __init__(self, n_state: int, n_head: int):
        super().__init__()
        self.n_head = n_head
        self.head_dim = n_state // n_head
        self.query = Linear(n_state, n_state)
        self.key = Linear(n_state, n_state, bias=False)
        self.value = Linear(n_state, n_state)
        self.out = Linear(n_state, n_state)

    def _split(self, x):
        b, l, _ = x.shape
        return x.reshape(b, l, self.n_head, self.head_dim).transpose(1, 2)

    def _merge(self, x):
        b, h, l, d = x.shape
        return x.transpose(1, 2).reshape(b, l, h * d)

    def _attend(self, q, k, v, mask=None, return_qk=False):
        scores = (q @ k.transpose(-1, -2)).float() * self.head_dim ** -0.5
        if mask is not None:
            scores = scores + mask
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        return self.out(self._merge(probs @ v)), (scores if return_qk else None)

    def self_full(self, x, mask=None):
        q, k, v = self._split(self.query(x)), self._split(self.key(x)), self._split(self.value(x))
        return self._attend(q, k, v, mask)[0]

    def self_cached(self, cache: KVCache, x, mask, origins=None):
        """Write x's keys and values at the cache's write index and attend
        over the whole buffer with the additive ``mask``.

        ``origins`` [B, max_len] (beam search): for each row and position,
        the row whose keys and values hold this row's history there.  A beam
        reorder then moves that map, not the cache; the attention gathers
        the rows it reads."""
        q = self._split(self.query(x))
        cache.update(self._split(self.key(x)), self._split(self.value(x)))
        kk, vv = cache.k, cache.v
        if origins is not None:
            idx = origins.long()[:, None, :, None].expand(-1, kk.shape[1], -1, kk.shape[3])
            kk = torch.gather(kk, 0, idx)
            vv = torch.gather(vv, 0, idx)
        return self._attend(q, kk, vv, mask)[0], cache

    def cross(self, x, k, v, return_qk=False):
        return self._attend(self._split(self.query(x)), k, v, None, return_qk)

    def cross_kv(self, xa):
        return self._split(self.key(xa)), self._split(self.value(xa))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, n_state: int, n_head: int, cross_attention: bool = False):
        super().__init__()
        self.attn = WhisperAttention(n_state, n_head)
        self.attn_ln = LayerNorm(n_state)
        self.cross_attn = WhisperAttention(n_state, n_head) if cross_attention else None
        self.cross_attn_ln = LayerNorm(n_state) if cross_attention else None
        self.mlp1 = Linear(n_state, n_state * 4)
        self.mlp2 = Linear(n_state * 4, n_state)
        self.mlp_ln = LayerNorm(n_state)

    def encoder_call(self, x):
        x = x + self.attn.self_full(self.attn_ln(x))
        return x + self.mlp2(_gelu(self.mlp1(self.mlp_ln(x))))

    def decoder_call(self, x, cache, mask, cross_k, cross_v, return_qk=False,
                     origins=None):
        y, cache = self.attn.self_cached(cache, self.attn_ln(x), mask, origins=origins)
        x = x + y
        y, qk = self.cross_attn.cross(self.cross_attn_ln(x), cross_k, cross_v, return_qk)
        x = x + y
        x = x + self.mlp2(_gelu(self.mlp1(self.mlp_ln(x))))
        return x, cache, qk


class AudioEncoder(nn.Module):
    def __init__(self, n_mels, n_ctx, n_state, n_head, n_layer):
        super().__init__()
        # conv1 (K = 3, 'same') takes nn.layers.conv1d's dilated_conv1d
        # kernel where its widths are multiples of 128 (128 mels into 1280)
        self.conv1 = Conv1d(n_mels, n_state, kernel_size=3, padding=1)
        self.conv2 = Conv1d(n_state, n_state, kernel_size=3, stride=2, padding=1)
        self.register_buffer("positional_embedding", torch.tensor(
            sinusoids(n_ctx, n_state), dtype=torch.float32))
        self.blocks = nn.ModuleList(ResidualAttentionBlock(n_state, n_head)
                                    for _ in range(n_layer))
        self.ln_post = LayerNorm(n_state)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, n_frames, n_mels] (NLC) -> [B, n_audio_ctx, n_state]."""
        x = _gelu(self.conv1(x))
        x = _gelu(self.conv2(x))
        x = x + self.positional_embedding.to(x.dtype)
        for block in self.blocks:
            x = block.encoder_call(x)
        return self.ln_post(x)


class TextDecoder(nn.Module):
    def __init__(self, n_vocab, n_ctx, n_state, n_head, n_layer):
        super().__init__()
        self.n_ctx = n_ctx
        self.token_embedding = Embedding(n_vocab, n_state)
        self.positional_embedding = nn.Parameter(torch.zeros(n_ctx, n_state),
                                                 requires_grad=False)
        self.blocks = nn.ModuleList(
            ResidualAttentionBlock(n_state, n_head, cross_attention=True)
            for _ in range(n_layer))
        self.ln = LayerNorm(n_state)

    def init_weights(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.positional_embedding.zero_()  # the JAX package's init

    def compute_cross_kv(self, xa: torch.Tensor) -> list:
        """The cross-attention keys and values, once a window."""
        return [b.cross_attn.cross_kv(xa) for b in self.blocks]

    def init_cache(self, batch: int, max_len: int, dtype=torch.float32) -> list:
        n_head = self.blocks[0].attn.n_head
        head_dim = self.positional_embedding.shape[1] // n_head
        return [KVCache.create(batch, n_head, max_len, head_dim, dtype,
                               self.positional_embedding.device)
                for _ in self.blocks]

    def _positions(self, start: int, length: int) -> torch.Tensor:
        # lax.dynamic_slice's clamp: a slice that would run past the table
        # starts where it ends at the last row
        start = max(0, min(start, self.n_ctx - length))
        return self.positional_embedding[start:start + length]

    def full_forward(self, tokens: torch.Tensor, xa: torch.Tensor,
                     return_cross_qk: bool = False):
        """A plain causal forward over the whole token sequence (alignment:
        the cross-attention scores)."""
        t = tokens.shape[1]
        x = self.token_embedding(tokens) + self.positional_embedding[:t]
        i = torch.arange(t, device=x.device)
        mask = torch.where(i[None, :] <= i[:, None], 0.0, -1e9).float()
        cross_kv = self.compute_cross_kv(xa)
        caches = self.init_cache(tokens.shape[0], t, dtype=x.dtype)
        qks = []
        for block, cache, (ck, cv) in zip(self.blocks, caches, cross_kv):
            x, _, qk = block.decoder_call(x, cache, mask, ck, cv, return_cross_qk)
            qks.append(qk)
        logits = self.token_embedding.as_linear(self.ln(x))
        return (logits, qks) if return_cross_qk else logits

    def prefill(self, caches: list, tokens: torch.Tensor, n_valid: int,
                cross_kv: list):
        """A right-padded prompt [B, Lb] of ``n_valid`` valid tokens a row.
        Returns hidden [B, Lb, D] and the caches, their write index rewound
        to the last valid slot (n_valid - 1): the decode loops feed
        tokens[n_valid - 1] again on their first step, which must overwrite
        that slot, not append a second copy (that shifts every generated
        position by one)."""
        b, lb = tokens.shape
        x = self.token_embedding(tokens) + self.positional_embedding[:lb]
        max_len = caches[0].k.shape[-2]
        i = torch.arange(lb, device=x.device)[:, None]
        j = torch.arange(max_len, device=x.device)[None, :]
        mask = torch.where((j <= i) & (j < lb), 0.0, -1e9).float()
        for block, cache, (ck, cv) in zip(self.blocks, caches, cross_kv):
            x, cache, _ = block.decoder_call(x, cache, mask, ck, cv)
            cache.idx = int(n_valid) - 1
        return self.ln(x), caches

    def step(self, caches: list, tokens: torch.Tensor, cross_kv: list,
             origins=None):
        """One decode step: tokens [B, 1] at position caches[0].idx.
        ``origins`` [B, max_len]: the beam reorder map (``self_cached``)."""
        pos = caches[0].idx
        x = self.token_embedding(tokens) + self._positions(pos, 1)
        max_len = caches[0].k.shape[-2]
        j = torch.arange(max_len, device=x.device)[None, None, None, :]
        mask = torch.where(j <= pos, 0.0, -1e9).float()
        for block, cache, (ck, cv) in zip(self.blocks, caches, cross_kv):
            x, cache, _ = block.decoder_call(x, cache, mask, ck, cv, origins=origins)
        return self.token_embedding.as_linear(self.ln(x))[:, -1], caches


class WhisperModel(nn.Module):
    """Encoder and decoder (the transcription loop is transcribe.py's
    ``Model``).  Weights are drawn from ``seed`` on ``device``."""

    def __init__(self, dims: ModelDimensions, device: str = "cuda", seed: int = 0):
        super().__init__()
        device = model_device(device, type(self).__name__)
        self.dims = dims
        with torch.device(device):
            self.encoder = AudioEncoder(dims.n_mels, dims.n_audio_ctx, dims.n_audio_state,
                                        dims.n_audio_head, dims.n_audio_layer)
            self.decoder = TextDecoder(dims.n_vocab, dims.n_text_ctx, dims.n_text_state,
                                       dims.n_text_head, dims.n_text_layer)
        all_heads = np.zeros((dims.n_text_layer, dims.n_text_head), dtype=bool)
        all_heads[dims.n_text_layer // 2:] = True
        self.register_buffer("alignment_heads", torch.tensor(
            np.asarray(all_heads.nonzero()).T, dtype=torch.int32, device=device))
        init_weights(self, torch.Generator(device).manual_seed(seed))
        self.device = device

    @property
    def is_multilingual(self):
        return self.dims.n_vocab >= 51865

    @property
    def num_languages(self):
        return self.dims.n_vocab - 51765 - int(self.is_multilingual)

    def embed_audio(self, mel):
        return self.encoder(mel)

    def sanitize(self, weights: dict) -> dict:
        """A checkpoint -> the JAX package's layout (conv [K, I, O]): MLX
        conv weights [O, K, I] and torch's [O, I, K]; HF-transformers
        ``WhisperForConditionalGeneration`` keys are detected and renamed
        to the OpenAI layout first.  ``convert.params_from_jax`` takes the
        result to the port's layout."""
        if any(".self_attn.q_proj." in k for k in weights):
            weights = sanitize_hf_whisper(weights)
        out = {}
        for k, v in weights.items():
            v = np.asarray(v)
            if k.endswith(".conv1.weight") or k.endswith(".conv2.weight"):
                v = v.transpose(1, 2, 0) if check_array_shape(v) else v.transpose(2, 1, 0)
            if k.endswith("_positional_embedding"):
                k = k.replace("_positional_embedding", "positional_embedding")
            out[k] = v
        return out


_HF_RULES = (
    (".self_attn.q_proj.", ".attn.query."),
    (".self_attn.k_proj.", ".attn.key."),
    (".self_attn.v_proj.", ".attn.value."),
    (".self_attn.out_proj.", ".attn.out."),
    (".encoder_attn.q_proj.", ".cross_attn.query."),
    (".encoder_attn.k_proj.", ".cross_attn.key."),
    (".encoder_attn.v_proj.", ".cross_attn.value."),
    (".encoder_attn.out_proj.", ".cross_attn.out."),
    (".self_attn_layer_norm.", ".attn_ln."),
    (".encoder_attn_layer_norm.", ".cross_attn_ln."),
    (".fc1.", ".mlp1."),
    (".fc2.", ".mlp2."),
    (".final_layer_norm.", ".mlp_ln."),
)
_HF_NAMES = {
    "decoder.embed_tokens.weight": "decoder.token_embedding.weight",
    "decoder.embed_positions.weight": "decoder.positional_embedding",
    "encoder.layer_norm.weight": "encoder.ln_post.weight",
    "encoder.layer_norm.bias": "encoder.ln_post.bias",
    "decoder.layer_norm.weight": "decoder.ln.weight",
    "decoder.layer_norm.bias": "decoder.ln.bias",
}


def sanitize_hf_whisper(weights: dict) -> dict:
    """HF-transformers Whisper keys -> the OpenAI layout.  Conv weights stay
    torch's [O, I, K] here (``sanitize`` transposes them); the encoder's
    sinusoidal ``embed_positions`` and the tied ``proj_out`` are dropped."""
    out = {}
    for k, v in weights.items():
        k = k.removeprefix("model.")
        if k.startswith("proj_out.") or k == "encoder.embed_positions.weight":
            continue
        k = k.replace(".layers.", ".blocks.")
        for old, new in _HF_RULES:
            k = k.replace(old, new)
        out[_HF_NAMES.get(k, k)] = np.asarray(v)
    return out
