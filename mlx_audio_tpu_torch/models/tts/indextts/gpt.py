"""IndexTTS's embedding-level GPT-2 decoder stack (counterpart of
``mlx_audio_tpu/models/tts/indextts/gpt.py``): inputs are embeddings (the
caller adds the learned text and mel positions), HF gpt2 key names
(``h.N.ln_1``, ``attn.c_attn`` fused q/k/v, ``mlp.c_fc``, ``ln_f``), the
tanh-approximate GELU in the MLP.

Caches are the port's ``KVCache`` (written in place, a Python-int write
index shared by every row).  Attention reads the cache up to its write
frontier only; what lies past it is masked in the JAX package, which
reads the whole buffer.  ``prefill`` takes a right-padded prompt and
rewinds the frontier to its valid length; ``prefill_left`` takes a
left-padded ragged batch, whose pad slots every later ``step`` masks
through ``pad_len``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from mlx_audio_tpu_torch.nn.attention import KVCache
from mlx_audio_tpu_torch.nn.layers import LayerNorm, Linear, promote_operands


@dataclass
class GPT2Args:
    n_embd: int
    n_head: int
    n_layer: int
    layer_norm_epsilon: float = 1e-5


def _pad_mask(pad_len: torch.Tensor, length: int) -> torch.Tensor:
    """Additive [B, 1, 1, length] mask hiding each row's left-pad slots."""
    j = torch.arange(length, device=pad_len.device)
    return torch.where(j >= pad_len[:, None], 0.0, -1e9)[:, None, None]


class GPT2Attention(nn.Module):
    def __init__(self, args: GPT2Args):
        super().__init__()
        self.n_head = args.n_head
        self.head_dim = args.n_embd // args.n_head
        self.c_attn = Linear(args.n_embd, 3 * args.n_embd)
        self.c_proj = Linear(args.n_embd, args.n_embd)

    def _split(self, x):
        b, t, _ = x.shape
        return x.reshape(b, t, self.n_head, self.head_dim).transpose(1, 2)

    def forward(self, x, cache: KVCache, mask: Optional[torch.Tensor]):
        q, k, v = (self._split(t) for t in self.c_attn(x).chunk(3, dim=-1))
        cache.update(k, v)
        keys, values = cache.k[:, :, :cache.idx], cache.v[:, :, :cache.idx]
        # a bf16 model's float32 prompt meets its bf16 caches: mixed
        # operands promote, as the JAX package's einsums do
        scores = (torch.matmul(*promote_operands(q, keys.transpose(-1, -2))).float()
                  * self.head_dim ** -0.5)
        if mask is not None:
            scores = scores + mask
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        out = torch.matmul(*promote_operands(probs, values))
        b, h, t, d = out.shape
        return self.c_proj(out.transpose(1, 2).reshape(b, t, h * d))


class GPT2MLP(nn.Module):
    def __init__(self, args: GPT2Args):
        super().__init__()
        self.c_fc = Linear(args.n_embd, 4 * args.n_embd)
        self.c_proj = Linear(4 * args.n_embd, args.n_embd)

    def forward(self, x):
        return self.c_proj(F.gelu(self.c_fc(x), approximate="tanh"))


class GPT2Block(nn.Module):
    def __init__(self, args: GPT2Args):
        super().__init__()
        self.ln_1 = LayerNorm(args.n_embd, eps=args.layer_norm_epsilon)
        self.attn = GPT2Attention(args)
        self.ln_2 = LayerNorm(args.n_embd, eps=args.layer_norm_epsilon)
        self.mlp = GPT2MLP(args)

    def forward(self, x, cache, mask):
        x = x + self.attn(self.ln_1(x), cache, mask)
        return x + self.mlp(self.ln_2(x))


class GPT2Model(nn.Module):
    def __init__(self, args: GPT2Args):
        super().__init__()
        self.n_head = args.n_head
        self.head_dim = args.n_embd // args.n_head
        self.h = nn.ModuleList(GPT2Block(args) for _ in range(args.n_layer))
        self.ln_f = LayerNorm(args.n_embd, eps=args.layer_norm_epsilon)

    def init_cache(self, batch: int, max_len: int, dtype=torch.float32,
                   device=None) -> List[KVCache]:
        device = self.ln_f.weight.device if device is None else device
        return [KVCache.create(batch, self.n_head, max_len, self.head_dim, dtype, device)
                for _ in self.h]

    def _run(self, caches, x, mask):
        for layer, cache in zip(self.h, caches):
            x = layer(x, cache, mask)
        return self.ln_f(x)

    def prefill(self, caches: List[KVCache], embeds: torch.Tensor, n_valid: int):
        """RIGHT-padded prompt embeddings [B, Lb, D] into empty caches ->
        (hidden at the last valid position [B, D] after ln_f, caches rewound
        to ``n_valid``)."""
        i = torch.arange(embeds.shape[1], device=embeds.device)
        mask = torch.where(i[None, :] <= i[:, None], 0.0, -1e9)
        x = self._run(caches, embeds, mask)
        n_valid = int(n_valid)
        for cache in caches:
            cache.idx = n_valid
        return x[:, n_valid - 1], caches

    def prefill_left(self, caches: List[KVCache], embeds: torch.Tensor,
                     pad_len: torch.Tensor):
        """LEFT-padded prompt embeddings [B, Lb, D] (row b's prompt in slots
        [pad_len[b], Lb)) -> (hidden at the shared frontier Lb - 1 [B, D]
        after ln_f, caches at idx = Lb).  Every row's write frontier is the
        same index, and the pad slots are masked out of every read."""
        i = torch.arange(embeds.shape[1], device=embeds.device)
        ok = (i[None, :] <= i[:, None])[None] & (i >= pad_len[:, None])[:, None]
        mask = torch.where(ok, 0.0, -1e9)[:, None]
        return self._run(caches, embeds, mask)[:, -1], caches

    def step(self, caches: List[KVCache], embed: torch.Tensor,
             pad_len: Optional[torch.Tensor] = None):
        """One embedding [B, 1, D] at the cache frontier -> (hidden [B, D]
        after ln_f, caches).  ``pad_len`` [B] (left-padded batches) masks
        each row's pad slots."""
        mask = None if pad_len is None else _pad_mask(pad_len, caches[0].idx + 1)
        return self._run(caches, embed, mask)[:, -1], caches
