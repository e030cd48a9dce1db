"""The causal-LM wrapper and its token generation loop (counterpart of
``mlx_audio_tpu/models/lm/causal.py``), shared by the LLM-over-audio-token
families (Orpheus first).

* Prompts are left-padded to a bucket of 64 and prefilled once into caches
  of ``bucket + max_tokens`` slots; the loop then steps the model a token at
  a time, ``chunk`` tokens between the host's looks at the stop tokens (the
  JAX package's ``lax.scan`` chunk), so the tokens, the stops mid-chunk and
  the budget are the JAX package's.
* The repetition penalty rescales the logits of every token in the last
  ``repetition_context_size`` (the mask built by a scatter, not a one-hot
  over the vocabulary; the division by a tensor, which rounds as numpy does:
  CUDA divides by a Python scalar through its reciprocal).
* Sampling: each sampling call takes a seed from a host-side generator
  seeded ``seed``, and row i samples with its own generator of that seed
  (``models.sampling``), so a row's tokens do not depend on its batch.  The
  JAX PRNG cannot be reproduced, so only greedy tokens are compared with it.
* A tied head goes through the embedding's ``as_linear``: on a quantized
  model, the ``quantized_matmul`` kernel at decode row counts.
* Under an active mesh (``parallel.context``) with tp > 1 the Llama weights
  split by ``tp_rules_llama``, and with dp > 1 the batch pads to a dp
  multiple and each data row decodes its slice of the rows on its replica,
  at the whole batch's prompt bucket, under ``row_offset`` so a row draws
  as in the whole batch.  The replicas step in turn, a chunk at a time, and
  the host's stop checks read every replica.  This one hook covers every
  causal-LM family: Orpheus, OuteTTS, Spark, ``ChatLM`` and Voxtral's LM.
"""

from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np
import torch
from torch import nn

from mlx_audio_tpu_torch.models.lm.llama import LlamaConfig, LlamaModel, lm_dtype
from mlx_audio_tpu_torch.models.sampling import (
    call_seed,
    row_offset,
    sample_top_k_rows,
    sample_top_p_rows,
)
from mlx_audio_tpu_torch.nn.layers import Linear


class LlamaForCausalLM(nn.Module):
    """LlamaModel and an LM head (tied embeddings supported)."""

    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.config = config
        self.model = LlamaModel(config)
        self.tie_word_embeddings = config.tie_word_embeddings
        if not config.tie_word_embeddings:
            self.lm_head = Linear(config.hidden_size, config.vocab_size, bias=False)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        if self.tie_word_embeddings:
            return self.model.embed_tokens.as_linear(hidden)
        return self.lm_head(hidden)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.logits(self.model(input_ids))


def _bucket(n: int, step: int = 64) -> int:
    return max(step, -(-n // step) * step)


def _sample(logits, temperature, top_k, top_p, generator):
    """[B, V] float32 logits -> int32 tokens [B]."""
    if temperature == 0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    seed = call_seed(generator)
    if top_p < 1.0:
        return sample_top_p_rows(logits, temperature, top_p, seed)
    return sample_top_k_rows(logits, temperature, top_k, seed)


def _penalize(logits, window, penalty: torch.Tensor):
    """Logits of the tokens in window [B, R] (-1 = empty) divided by the
    penalty where positive, multiplied where not."""
    b, v = logits.shape
    hist = torch.where(window < 0, v, window).long()
    seen = torch.zeros((b, v + 1), dtype=torch.bool, device=logits.device)
    seen.scatter_(1, hist, True)
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen[:, :v], penalized, logits)


@torch.no_grad()
def _prefill(model, caches, pad_len, prompt):
    h, caches = model.model.prefill(caches, prompt, pad_len)
    return model.logits(h[:, -1]).float()


@torch.no_grad()
def _decode_chunk(model, caches, pad_len, last, window, n, temperature, top_k,
                  top_p, penalty, generator):
    """``n`` decode steps from token ``last`` [B].  ``window`` [B, R] is the
    rolling buffer of recent tokens.  Returns (tokens [n, B], window,
    last)."""
    toks = []
    for _ in range(n):
        h, _ = model.model.step(caches, last[:, None], pad_len)
        logits = model.logits(h[:, -1]).float()
        if penalty is not None:
            logits = _penalize(logits, window, penalty)
        last = _sample(logits, temperature, top_k, top_p, generator)
        window = torch.cat([window[:, 1:], last[:, None]], dim=1)
        toks.append(last)
    return torch.stack(toks), window, last


def _start(model, prompts, max_tokens, max_cache_len, repetition_penalty,
           repetition_context_size, bucket: Optional[int] = None):
    """Left-pad the prompts to one bucket (the least that fits unless given)
    and make the decode state: (caches, pad_len, prompt [B, bucket], the
    penalty tensor or None, an empty window [B, R])."""
    dev = model.model.rope_cos.device
    bucket = bucket or _bucket(max(len(p) for p in prompts))
    prompt = np.zeros((len(prompts), bucket), dtype=np.int64)
    pad = np.zeros((len(prompts),), dtype=np.int64)
    for i, p in enumerate(prompts):
        pad[i] = bucket - len(p)
        prompt[i, pad[i]:] = p
    caches = model.model.init_cache(len(prompts),
                                    max_len=max_cache_len or bucket + max_tokens,
                                    dtype=lm_dtype(model))
    penalty = (None if repetition_penalty == 1.0 else
               torch.tensor(repetition_penalty, dtype=torch.float32, device=dev))
    window = torch.full((len(prompts), max(repetition_context_size, 1)), -1,
                        dtype=torch.int32, device=dev)
    return (caches, torch.as_tensor(pad, device=dev),
            torch.as_tensor(prompt, device=dev), penalty, window)


def _placement(model, batch: int):
    """The active mesh's ``placement`` of a causal LM: split by
    ``tp_rules_llama`` when tp > 1."""
    from mlx_audio_tpu_torch.parallel.context import placement
    from mlx_audio_tpu_torch.parallel.mesh import tp_rules_llama

    return placement(model, batch, tp_rules_llama)


class _Replica:
    """One data row's decode state: its model, caches, window, last tokens
    and the first batch row it holds."""

    def __init__(self, model, lo, prompts, max_tokens, max_cache_len,
                 repetition_penalty, repetition_context_size, bucket, seed):
        self.model, self.lo = model, lo
        (self.caches, self.pad_len, self.prompt, self.penalty,
         self.window) = _start(model, prompts, max_tokens, max_cache_len,
                               repetition_penalty, repetition_context_size,
                               bucket)
        # every replica takes the call seeds in the whole batch's order
        self.generator = torch.Generator().manual_seed(seed)

    def first(self, temperature, top_k, top_p) -> torch.Tensor:
        with row_offset(self.lo):
            logits = _prefill(self.model, self.caches, self.pad_len, self.prompt)
            self.last = _sample(logits, temperature, top_k, top_p, self.generator)
        self.window[:, -1] = self.last
        return self.last

    def chunk(self, n, temperature, top_k, top_p) -> torch.Tensor:
        with row_offset(self.lo):
            toks, self.window, self.last = _decode_chunk(
                self.model, self.caches, self.pad_len, self.last, self.window, n,
                temperature, top_k, top_p, self.penalty, self.generator)
        return toks


def generate_tokens_batch(
    model: LlamaForCausalLM,
    prompts: List[np.ndarray],
    max_tokens: int = 1200,
    temperature: float = 0.6,
    top_k: int = 0,
    top_p: float = 1.0,
    repetition_penalty: float = 1.0,
    repetition_context_size: int = 20,
    stop_tokens: tuple = (),
    chunk: int = 64,
    seed: int = 0,
    max_cache_len: Optional[int] = None,
) -> List[np.ndarray]:
    """Batched decode: the B prompts share every weight read.  Stops are
    tracked per row on the host between chunks; finished rows keep stepping
    until all stop or the budget runs out.  Returns each prompt's generated
    tokens (the stop token excluded).  Under an active mesh the rows split
    over its data replicas (see the module docstring)."""
    prompts = [np.asarray(p).reshape(-1) for p in prompts]
    b = len(prompts)
    models, slices, n_rows = _placement(model, b)
    rows = prompts + [prompts[-1]] * (n_rows - b)  # dp padding, dropped below
    bucket = _bucket(max(len(p) for p in prompts))
    reps = [_Replica(m, lo, rows[lo:hi], max_tokens, max_cache_len,
                     repetition_penalty, repetition_context_size, bucket, seed)
            for m, (lo, hi) in zip(models, slices)]
    firsts = [r.first(temperature, top_k, top_p) for r in reps]
    first_np = np.concatenate([f.cpu().numpy() for f in firsts])

    out = [[] for _ in range(b)]
    done = np.zeros((b,), dtype=bool)
    for i in range(b):
        if int(first_np[i]) in stop_tokens:
            done[i] = True
        else:
            out[i].append(int(first_np[i]))
    produced = 1
    while produced < max_tokens and not done.all():
        n = min(chunk, max_tokens - produced)
        toks = [r.chunk(n, temperature, top_k, top_p) for r in reps]
        for row in np.concatenate([t.cpu().numpy() for t in toks], axis=1):
            for i in range(b):
                if done[i]:
                    continue
                if int(row[i]) in stop_tokens:
                    done[i] = True
                else:
                    out[i].append(int(row[i]))
        produced += n
    return [np.asarray(o, dtype=np.int32) for o in out]


def generate_tokens(
    model: LlamaForCausalLM,
    input_ids: np.ndarray,
    max_tokens: int = 1200,
    temperature: float = 0.6,
    top_k: int = 0,
    top_p: float = 1.0,
    repetition_penalty: float = 1.0,
    repetition_context_size: int = 20,
    stop_tokens: tuple = (),
    chunk: int = 64,
    seed: int = 0,
    max_cache_len: Optional[int] = None,
) -> Iterator[np.ndarray]:
    """Yield generated token chunks (int32 [<= chunk]) for one prompt [T]
    until a stop token or the budget; the host looks for stops a chunk at a
    time.  Under a mesh with tp > 1 the weights split by
    ``tp_rules_llama``."""
    input_ids = np.asarray(input_ids).reshape(-1)
    (run,), _, _ = _placement(model, 1)
    rep = _Replica(run, 0, [input_ids], max_tokens, max_cache_len,
                   repetition_penalty, repetition_context_size, None, seed)
    first_np = int(rep.first(temperature, top_k, top_p)[0])
    if first_np in stop_tokens:
        return
    yield np.asarray([first_np], dtype=np.int32)

    produced = 1
    while produced < max_tokens:
        n = min(chunk, max_tokens - produced)
        toks = rep.chunk(n, temperature, top_k, top_p)
        out = []
        for tok in toks[:, 0].cpu().numpy():
            if int(tok) in stop_tokens:
                break
            out.append(int(tok))
        if out:
            yield np.asarray(out, dtype=np.int32)
        produced += len(out)
        if len(out) < n:
            return
