"""PLBERT: the ALBERT phoneme encoder used by Kokoro (counterpart of
``mlx_audio_tpu/models/tts/kokoro/albert.py``).

Shared cross-layer weights (num_hidden_groups), post-LN attention blocks,
pooled [CLS] output, exact GELU, additive -10000 padding mask.  NLC layout.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from mlx_audio_tpu_torch.models.base import BaseModelArgs
from mlx_audio_tpu_torch.nn import (
    Embedding,
    LayerNorm,
    Linear,
    scaled_dot_product_attention,
)


@dataclass
class AlbertModelArgs(BaseModelArgs):
    num_hidden_layers: int
    num_attention_heads: int
    hidden_size: int
    intermediate_size: int
    max_position_embeddings: int
    model_type: str = "albert"
    embedding_size: int = 128
    inner_group_num: int = 1
    num_hidden_groups: int = 1
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    type_vocab_size: int = 2
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12
    vocab_size: int = 30522
    dropout: float = 0.0


class AlbertEmbeddings(nn.Module):
    def __init__(self, config: AlbertModelArgs):
        super().__init__()
        self.word_embeddings = Embedding(config.vocab_size, config.embedding_size)
        self.position_embeddings = Embedding(config.max_position_embeddings,
                                             config.embedding_size)
        self.token_type_embeddings = Embedding(config.type_vocab_size,
                                               config.embedding_size)
        self.LayerNorm = LayerNorm(config.embedding_size, eps=config.layer_norm_eps)

    def forward(self, input_ids, token_type_ids=None):
        position_ids = torch.arange(input_ids.shape[1],
                                    device=input_ids.device)[None, :]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        emb = (self.word_embeddings(input_ids)
               + self.position_embeddings(position_ids)
               + self.token_type_embeddings(token_type_ids))
        return self.LayerNorm(emb)


class AlbertSelfAttention(nn.Module):
    def __init__(self, config: AlbertModelArgs):
        super().__init__()
        self.num_heads = config.num_attention_heads
        self.head_dim = config.hidden_size // config.num_attention_heads
        self.query = Linear(config.hidden_size, config.hidden_size)
        self.key = Linear(config.hidden_size, config.hidden_size)
        self.value = Linear(config.hidden_size, config.hidden_size)
        self.dense = Linear(config.hidden_size, config.hidden_size)
        self.LayerNorm = LayerNorm(config.hidden_size, eps=config.layer_norm_eps)

    def forward(self, x, mask=None):
        b, l, _ = x.shape

        def split(t):
            return t.reshape(b, l, self.num_heads, self.head_dim).transpose(1, 2)

        ctx = scaled_dot_product_attention(split(self.query(x)),
                                           split(self.key(x)),
                                           split(self.value(x)), mask)
        ctx = ctx.transpose(1, 2).reshape(b, l, -1)
        return self.LayerNorm(self.dense(ctx) + x)


class AlbertLayer(nn.Module):
    def __init__(self, config: AlbertModelArgs):
        super().__init__()
        self.attention = AlbertSelfAttention(config)
        self.full_layer_layer_norm = LayerNorm(config.hidden_size,
                                               eps=config.layer_norm_eps)
        self.ffn = Linear(config.hidden_size, config.intermediate_size)
        self.ffn_output = Linear(config.intermediate_size, config.hidden_size)

    def forward(self, x, mask=None):
        attn = self.attention(x, mask)
        h = self.ffn_output(F.gelu(self.ffn(attn)))  # exact (erf) GELU
        return self.full_layer_layer_norm(h + attn)


class AlbertLayerGroup(nn.Module):
    def __init__(self, config: AlbertModelArgs):
        super().__init__()
        self.albert_layers = nn.ModuleList(
            AlbertLayer(config) for _ in range(config.inner_group_num))

    def forward(self, x, mask=None):
        for layer in self.albert_layers:
            x = layer(x, mask)
        return x


class AlbertEncoder(nn.Module):
    def __init__(self, config: AlbertModelArgs):
        super().__init__()
        self.num_hidden_layers = config.num_hidden_layers
        self.num_hidden_groups = config.num_hidden_groups
        self.embedding_hidden_mapping_in = Linear(config.embedding_size,
                                                  config.hidden_size)
        self.albert_layer_groups = nn.ModuleList(
            AlbertLayerGroup(config) for _ in range(config.num_hidden_groups))

    def forward(self, x, mask=None):
        x = self.embedding_hidden_mapping_in(x)
        for i in range(self.num_hidden_layers):
            group = i * self.num_hidden_groups // self.num_hidden_layers
            x = self.albert_layer_groups[group](x, mask)
        return x


class CustomAlbert(nn.Module):
    def __init__(self, config: AlbertModelArgs):
        super().__init__()
        self.config = config
        self.embeddings = AlbertEmbeddings(config)
        self.encoder = AlbertEncoder(config)
        self.pooler = Linear(config.hidden_size, config.hidden_size)

    def forward(self, input_ids, attention_mask=None):
        """attention_mask: [B, L] 1 for valid tokens.  Returns (sequence
        [B, L, H], pooled [B, H])."""
        emb = self.embeddings(input_ids)
        add_mask = None
        if attention_mask is not None:
            add_mask = (1.0 - attention_mask[:, None, None, :].float()) * -10000.0
        seq = self.encoder(emb, add_mask)
        return seq, torch.tanh(self.pooler(seq[:, 0]))
