"""Bark, the three-stage GPT TTS (text -> semantic -> coarse -> fine) over
EnCodec (counterpart of ``mlx_audio_tpu/models/tts/bark/bark.py``).

The JAX package's jitted ``lax.scan`` chunks are Python loops here: the
semantic stage runs up to 64 steps between the host's looks at the early
stop (a sampled class 10 000), the coarse stage a sliding window at a time
(a prefill, or the caches carried from the window before while its context
is that window's context and tokens at the same positions), the fine stage
one non-causal forward a codebook and window.  Rows of a batch decode in
lockstep; EnCodec decodes rows of equal length in one call, whose LSTMs run
``kernels.lstm``.

The JAX PRNG cannot be reproduced: a sampled step draws text b's Gumbel
noise from ``models.sampling.row_generator(seed, b)`` on a seed taken from
a host generator (seeded ``seed``, ``seed + 1``, ``seed + 2`` for the three
stages), so a text's draws do not depend on the other rows of its batch;
``_cat_rows`` also takes the noise itself.  At a temperature of 1e-6 every
stage takes the argmax, as the JAX package's does, and ``_fine_predict``
takes it when the temperature is None.  Left for later: the data-parallel
mesh branches.  The default tokenizer (``bert-base-multilingual-cased``)
loads from local files only; pass ``tokenizer=`` otherwise.
"""

from __future__ import annotations

import math
import re
import time
from dataclasses import dataclass
from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mlx_audio_tpu_torch.models.base import (
    BaseModelArgs,
    init_weights,
    make_generation_result,
    model_device,
)
from mlx_audio_tpu_torch.models.sampling import call_seed, gumbel, row_generator
from mlx_audio_tpu_torch.models.tts.bark.gpt import GPT, FineGPT, GPTConfig

TEXT_ENCODING_OFFSET = 10_048
SEMANTIC_PAD_TOKEN = 10_000
TEXT_PAD_TOKEN = 129_595
SEMANTIC_INFER_TOKEN = 129_599
CONTEXT_WINDOW_SIZE = 1024
SEMANTIC_RATE_HZ = 49.9
SEMANTIC_VOCAB_SIZE = 10_000
CODEBOOK_SIZE = 1024
N_COARSE_CODEBOOKS = 2
N_FINE_CODEBOOKS = 8
COARSE_RATE_HZ = 75
COARSE_SEMANTIC_PAD_TOKEN = 12_048
COARSE_INFER_TOKEN = 12_050
SAMPLE_RATE = 24_000
# semantic steps between the host's looks at the early stop
SEMANTIC_CHUNK = 64


@dataclass
class ModelConfig(BaseModelArgs):
    semantic_config: dict = None
    coarse_acoustics_config: dict = None
    fine_acoustics_config: dict = None
    codec_config: dict = None
    model_type: str = "bark"
    model_size: str = "base"
    codec_path: str = "mlx-community/encodec-24khz-float32"
    sample_rate: int = 24000


def bark_config() -> ModelConfig:
    """``suno/bark``'s three GPTs (HF ``BarkConfig``): 24 layers, 16 heads,
    width 1024, block size 1024, no biases; vocabularies semantic 129 600
    in and 10 048 out, coarse 12 096, fine 1 056 with 8 codebooks, 1
    given."""
    gpt = dict(block_size=1024, n_layer=24, n_head=16, n_embd=1024, bias=False)
    return ModelConfig(
        semantic_config=dict(gpt, input_vocab_size=129_600, output_vocab_size=10_048),
        coarse_acoustics_config=dict(gpt, input_vocab_size=12_096,
                                     output_vocab_size=12_096),
        fine_acoustics_config=dict(gpt, input_vocab_size=1_056, output_vocab_size=1_056,
                                   n_codes_total=8, n_codes_given=1))


# ---------------------------------------------------------------------------
# Stage loops
# ---------------------------------------------------------------------------


def _cat_rows(logits, temperature: float, seed: Optional[int] = None,
              noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-row categorical over [B, ..., V]: argmax(logits / temperature +
    Gumbel noise), row b's noise from ``row_generator(seed, b)`` unless
    ``noise`` (the logits' shape) is given."""
    dev = logits.device
    if noise is None:
        noise = torch.stack([gumbel(logits.shape[1:], row_generator(seed, i, dev), dev)
                             for i in range(logits.shape[0])])
    temp = torch.tensor(temperature, dtype=torch.float32, device=dev)
    return torch.argmax(logits / temp + noise, dim=-1).to(torch.int32)


def _semantic_relevant(logits):
    """The 10 000 semantic classes and the pad class, the early stop."""
    logits = logits.float()
    return torch.cat([logits[:, :SEMANTIC_VOCAB_SIZE],
                      logits[:, SEMANTIC_PAD_TOKEN:SEMANTIC_PAD_TOKEN + 1]], dim=-1)


def _feed(tok):
    """The token fed on: the early stop feeds the pad token."""
    return torch.where(tok >= SEMANTIC_VOCAB_SIZE, SEMANTIC_PAD_TOKEN, tok).long()


@torch.no_grad()
def _semantic_prefill(model, encoded, hist, seed: int, max_steps: int,
                      temperature: float):
    """The merged text and history embeddings and the infer token ->
    (the first sampled token [B], the token fed next [B], caches)."""
    sem = model.semantic
    emb = sem.input_embeds_layer(encoded) + sem.input_embeds_layer(hist)[None]
    b = encoded.shape[0]
    infer = sem.input_embeds_layer(
        torch.tensor([SEMANTIC_INFER_TOKEN], device=encoded.device))[None]
    prompt = torch.cat([emb, infer.expand(b, 1, emb.shape[-1])], dim=1)
    n = prompt.shape[1]
    caches = sem.init_cache(b, n + max_steps, dtype=sem.input_embeds_layer.weight.dtype)
    logits, caches = sem.prefill(caches, prompt, n)
    tok0 = _cat_rows(_semantic_relevant(logits), temperature, seed)
    return tok0, _feed(tok0), caches


@torch.no_grad()
def _semantic_chunk(model, caches, last, generator, chunk: int, temperature: float):
    """``chunk`` semantic steps over a [B] row batch; a sampled class 10 000
    is the early stop, emitted as SEMANTIC_VOCAB_SIZE (the host truncates
    each row).  Returns (tokens [chunk, B], caches, the token fed next)."""
    toks = []
    for _ in range(chunk):
        logits, caches = model.semantic.step(caches, last[:, None])
        tok = _cat_rows(_semantic_relevant(logits), temperature, call_seed(generator))
        last = _feed(tok)
        toks.append(tok)
    return torch.stack(toks), caches, last


def _coarse_sample(logits, parity: int, temperature: float, seed: int):
    """One coarse token from the parity codebook's logit range."""
    start = SEMANTIC_VOCAB_SIZE + parity * CODEBOOK_SIZE
    ids = torch.arange(logits.shape[-1], device=logits.device)[None]
    masked = torch.where((ids >= start) & (ids < start + CODEBOOK_SIZE),
                         logits.float(), float("-inf"))
    return _cat_rows(masked, temperature, seed)


def _coarse_scan(model, caches, tok0, parity0: int, generator, steps: int,
                 temperature: float):
    """steps - 1 cached decode steps after an already sampled tok0; the
    parity flips every step.  Returns (tokens [steps, B], caches)."""
    toks, prev, parity = [tok0], tok0, parity0
    for _ in range(steps - 1):
        logits, caches = model.coarse_acoustics.step(caches, prev.long()[:, None])
        parity = 1 - parity
        prev = _coarse_sample(logits, parity, temperature, call_seed(generator))
        toks.append(prev)
    return torch.stack(toks), caches


@torch.no_grad()
def _coarse_window(model, x_in, n_valid: int, parity0: int, generator,
                   steps: int, cache_len: int, temperature: float):
    """One coarse sliding window over a [B, L] row batch: prefill the padded
    contexts (rows share ``n_valid``), then ``steps`` tokens.  The caches
    come back at n_valid + steps - 1: the last token is not written, the
    next window feeds it (``_coarse_window_carry``)."""
    coarse = model.coarse_acoustics
    caches = coarse.init_cache(x_in.shape[0], cache_len,
                               dtype=coarse.input_embeds_layer.weight.dtype)
    logits0, caches = coarse.prefill(caches, coarse.input_embeds_layer(x_in), n_valid)
    tok0 = _coarse_sample(logits0, parity0, temperature, call_seed(generator))
    return _coarse_scan(model, caches, tok0, parity0, generator, steps, temperature)


@torch.no_grad()
def _coarse_window_carry(model, caches, last_tok, parity0: int, generator,
                         steps: int, temperature: float):
    """A window whose context is the last window's context and tokens at the
    same positions: no prefill, the first logits from one cached step on the
    last token (the same function as the prefill's last row).  Takes its
    seeds in the order ``_coarse_window`` does."""
    logits0, caches = model.coarse_acoustics.step(caches, last_tok.long()[:, None])
    tok0 = _coarse_sample(logits0, parity0, temperature, call_seed(generator))
    return _coarse_scan(model, caches, tok0, parity0, generator, steps, temperature)


def _cache_bucket(n: int) -> int:
    """192-granular cache capacity (the window padding's bucket)."""
    return -(-n // 192) * 192


def _grow_caches(caches, new_len: int):
    """Extend each KVCache's capacity to ``new_len`` with zeros past the
    write position (unwritten slots are masked)."""
    cur = caches[0].k.shape[-2]
    if cur >= new_len:
        return caches
    for c in caches:
        c.k = F.pad(c.k, (0, 0, 0, new_len - cur))
        c.v = F.pad(c.v, (0, 0, 0, new_len - cur))
    return caches


@torch.no_grad()
def _fine_predict(model, in_buffer, rel_start, seed: Optional[int], pred_idx: int,
                  temperature: Optional[float]):
    """in_buffer [B, 1024, 8], rel_start [B]: codebook ``pred_idx`` filled
    from each row's ``rel_start`` on, the argmax when ``temperature`` is
    None."""
    relevant = model.fine_acoustics(pred_idx, in_buffer).float()[:, :, :CODEBOOK_SIZE]
    if temperature is None:
        preds = torch.argmax(relevant, dim=-1)
    else:
        preds = _cat_rows(relevant, temperature, seed)
    t = in_buffer.shape[1]
    keep = torch.arange(t, device=in_buffer.device)[None] < rel_start[:, None]
    out = in_buffer.clone()
    out[:, :, pred_idx] = torch.where(keep, in_buffer[:, :, pred_idx], preds.long())
    return out


# ---------------------------------------------------------------------------


def _flatten_codebooks(arr: np.ndarray, offset_size: int = CODEBOOK_SIZE) -> np.ndarray:
    arr = arr.copy()
    for n in range(1, arr.shape[0]):
        arr[n, :] += offset_size * n
    return arr.T.reshape(-1)


def load_voice_prompt(voice_prompt_input):
    """A voice prompt: an ``.npz`` path or a dict with the semantic, coarse
    and fine prompts."""
    if isinstance(voice_prompt_input, str):
        return dict(np.load(voice_prompt_input))
    if isinstance(voice_prompt_input, dict):
        for k in ("semantic_prompt", "coarse_prompt", "fine_prompt"):
            assert k in voice_prompt_input
        return voice_prompt_input
    raise ValueError("voice prompt format unrecognized")


class Model(nn.Module):
    """User-facing Bark.  Runs on ``device``, "cuda" unless the caller asks
    for "cpu", with the GPTs' weights drawn from ``seed``.  ``codec`` is an
    EnCodec; without one, a ``codec_config`` builds one on the device,
    else ``codec_path`` (a local checkpoint directory) loads on first use.
    ``tokenizer`` is any object with ``encode(text, add_special_tokens=
    False) -> ids``."""

    def __init__(self, config: Union[ModelConfig, dict], codec=None,
                 tokenizer=None, device: str = "cuda", seed: int = 0):
        super().__init__()
        if isinstance(config, dict):
            config = ModelConfig.from_dict(config)
        self.config = config
        device = model_device(device, "Model")
        with torch.device(device):
            self.semantic = GPT(GPTConfig.from_dict(config.semantic_config or {}))
            self.coarse_acoustics = GPT(GPTConfig.from_dict(
                config.coarse_acoustics_config
                or {"input_vocab_size": 12096, "output_vocab_size": 12096}))
            self.fine_acoustics = FineGPT(GPTConfig.from_dict(
                config.fine_acoustics_config
                or {"input_vocab_size": 1056, "output_vocab_size": 1056}))
        gen = torch.Generator(device).manual_seed(seed)
        for stage in (self.semantic, self.coarse_acoustics, self.fine_acoustics):
            init_weights(stage, gen)
        self.device = device
        if codec is None and isinstance(config.codec_config, dict):
            # suno/bark's HF checkpoints embed the EnCodec (codec_model.*)
            from mlx_audio_tpu_torch.codec.encodec import Encodec, EncodecConfig

            codec = Encodec(EncodecConfig.from_dict(config.codec_config),
                            device=str(device), seed=seed)
        self._codec = codec
        self._tokenizer = tokenizer

    @property
    def sample_rate(self):
        return self.config.sample_rate

    def _get_tokenizer(self):
        if self._tokenizer is None:
            try:
                from transformers import BertTokenizer

                self._tokenizer = BertTokenizer.from_pretrained(
                    "bert-base-multilingual-cased", local_files_only=True)
            except (ImportError, OSError) as exc:
                raise RuntimeError(
                    "Bark's default tokenizer, bert-base-multilingual-cased, "
                    "needs transformers and its files on this machine; pass "
                    "tokenizer= instead") from exc
        return self._tokenizer

    def _get_codec(self):
        if self._codec is None:
            from mlx_audio_tpu_torch.codec.encodec import Encodec

            self._codec, _ = Encodec.from_pretrained(self.config.codec_path,
                                                     device=str(self.device))
        return self._codec

    # -- stage drivers -----------------------------------------------------

    def generate_text_semantic(self, text: str, voice=None,
                               temperature: float = 0.7, seed: int = 0,
                               max_steps: int = 768) -> np.ndarray:
        return self.generate_text_semantic_batch(
            [text], voice, temperature, seed, max_steps)[0]

    def _text_rows(self, texts) -> np.ndarray:
        tokenizer = self._get_tokenizer()
        rows = []
        for text in texts:
            encoded = np.asarray(tokenizer.encode(text, add_special_tokens=False)
                                 ) + TEXT_ENCODING_OFFSET
            encoded = encoded[:256]
            rows.append(np.pad(encoded, (0, 256 - len(encoded)),
                               constant_values=TEXT_PAD_TOKEN))
        return np.stack(rows)

    @staticmethod
    def _semantic_history(voice) -> np.ndarray:
        if voice is None:
            return np.full(256, SEMANTIC_PAD_TOKEN)
        hist = np.asarray(load_voice_prompt(voice)["semantic_prompt"])[-256:]
        return np.pad(hist, (0, 256 - len(hist)), constant_values=SEMANTIC_PAD_TOKEN)

    def generate_text_semantic_batch(self, texts, voice=None,
                                     temperature: float = 0.7, seed: int = 0,
                                     max_steps: int = 768) -> list:
        """Stage 1: B texts -> each row's semantic tokens, decoded in
        lockstep, each row's early stop tracked on the host."""
        b = len(texts)
        dev = self.device
        encoded = torch.as_tensor(self._text_rows(texts), dtype=torch.long, device=dev)
        hist = torch.as_tensor(self._semantic_history(voice), dtype=torch.long, device=dev)
        generator = torch.Generator().manual_seed(seed)
        tok0, last, caches = _semantic_prefill(self, encoded, hist, call_seed(generator),
                                               max_steps, temperature)
        tok0_np = tok0.cpu().numpy()
        out = [[] for _ in range(b)]
        done = tok0_np >= SEMANTIC_VOCAB_SIZE
        for i in range(b):
            if not done[i]:
                out[i].append(int(tok0_np[i]))
        produced = 1
        while produced < max_steps and not done.all():
            n_chunk = min(SEMANTIC_CHUNK, max_steps - produced)
            toks, caches, last = _semantic_chunk(self, caches, last, generator,
                                                 n_chunk, temperature)
            for row in toks.cpu().numpy():          # [n, B]
                for i in range(b):
                    if done[i]:
                        continue
                    if row[i] >= SEMANTIC_VOCAB_SIZE:
                        done[i] = True
                    else:
                        out[i].append(int(row[i]))
            produced += n_chunk
        return [np.asarray(o, dtype=np.int32) for o in out]

    def generate_coarse(self, x_semantic: np.ndarray, voice=None,
                        temperature: float = 0.7, max_coarse_history: int = 630,
                        sliding_window_len: int = 60, seed: int = 0) -> np.ndarray:
        return self.generate_coarse_batch(
            [x_semantic], voice, temperature, max_coarse_history,
            sliding_window_len, seed)[0]

    def generate_coarse_batch(self, sems, voice=None, temperature: float = 0.7,
                              max_coarse_history: int = 630,
                              sliding_window_len: int = 60, seed: int = 0,
                              kv_carry: bool = True) -> list:
        """Stage 2: rows decode their sliding windows in lockstep (every
        window's context has one length across rows, so the right-padded
        prefill shares one valid length); a row past its budget steps on and
        is cut to its own length at the end.  While a window's context is
        the last window's context and tokens, checked row by row, it
        carries that window's caches instead of a prefill; ``kv_carry=False``
        prefills every window."""
        ratio = COARSE_RATE_HZ / SEMANTIC_RATE_HZ * N_COARSE_CODEBOOKS
        max_semantic_history = int(math.floor(max_coarse_history / ratio))
        if voice is not None:
            vp = load_voice_prompt(voice)
            sem_hist = np.asarray(vp["semantic_prompt"])
            coarse_hist = _flatten_codebooks(np.asarray(vp["coarse_prompt"])
                                             ) + SEMANTIC_VOCAB_SIZE
            n_sem = min(max_semantic_history, len(sem_hist) - len(sem_hist) % 2,
                        int(math.floor(len(coarse_hist) / ratio)))
            n_coarse = int(round(n_sem * ratio))
            sem_hist = sem_hist[-n_sem:].astype(np.int32)
            coarse_hist = coarse_hist[-n_coarse:].astype(np.int32)[:-2]
        else:
            sem_hist = np.zeros(0, dtype=np.int32)
            coarse_hist = np.zeros(0, dtype=np.int32)

        b = len(sems)
        n_steps = [int(round(math.floor(len(s) * ratio / N_COARSE_CODEBOOKS)
                             * N_COARSE_CODEBOOKS)) for s in sems]
        x_sem_rows = [np.concatenate([sem_hist, s]).astype(np.int32) for s in sems]
        x_coarse_rows = [list(coarse_hist) for _ in range(b)]
        base_sem_idx = len(sem_hist)
        n_steps_max = max(n_steps)
        generator = torch.Generator().manual_seed(seed + 1)
        n_step = 0
        bucket = 257 + max_coarse_history
        # (caches, last token, the next window's expected context rows)
        carry = None
        while n_step < n_steps_max:
            sem_idx = base_sem_idx + int(round(n_step / ratio))
            rows = []
            for i in range(b):
                x_in = x_sem_rows[i][max(0, sem_idx - max_semantic_history):][:256]
                x_in = np.pad(x_in, (0, 256 - len(x_in)),
                              constant_values=COARSE_SEMANTIC_PAD_TOKEN)
                tail = np.asarray(x_coarse_rows[i][-max_coarse_history:], dtype=np.int32)
                rows.append(np.concatenate([x_in, [COARSE_INFER_TOKEN], tail]
                                           ).astype(np.int32))
            clen = len(rows[0])      # lockstep rows: one length every window
            steps = min(sliding_window_len, n_steps_max - n_step)
            # even steps sample codebook 0's logits [10000, 11024)
            parity0 = 0 if n_step % N_COARSE_CODEBOOKS == 0 else 1
            use_carry = (kv_carry and carry is not None
                         and all(np.array_equal(rows[i], carry[2][i]) for i in range(b)))
            if use_carry:
                caches = _grow_caches(carry[0], _cache_bucket(clen + steps))
                toks, caches = _coarse_window_carry(self, caches, carry[1], parity0,
                                                    generator, steps, temperature)
            else:
                # a 192-bucket of the context, not the largest: exact, the
                # prefill masks by the valid length
                wbucket = min(bucket, -(-clen // 192) * 192)
                padded = np.full((b, wbucket), COARSE_SEMANTIC_PAD_TOKEN, dtype=np.int64)
                for i in range(b):
                    padded[i, :len(rows[i])] = rows[i]
                toks, caches = _coarse_window(
                    self, torch.as_tensor(padded, device=self.device), clen, parity0,
                    generator, steps, _cache_bucket(clen + steps), temperature)
            toks_np = toks.cpu().numpy()             # [steps, B]
            for i in range(b):
                x_coarse_rows[i].extend(int(t) for t in toks_np[:, i])
            carry = (caches, toks[-1],
                     [np.concatenate([rows[i], toks_np[:, i]]) for i in range(b)])
            n_step += steps

        outs = []
        for i in range(b):
            gen = np.asarray(x_coarse_rows[i][len(coarse_hist):],
                             dtype=np.int32)[:n_steps[i]]
            gen = gen.reshape(-1, N_COARSE_CODEBOOKS).T - SEMANTIC_VOCAB_SIZE
            for n in range(1, N_COARSE_CODEBOOKS):
                gen[n, :] -= n * CODEBOOK_SIZE
            outs.append(gen)
        return outs

    def generate_fine(self, x_coarse_gen: np.ndarray,
                      temperature: Optional[float] = 0.7, seed: int = 0) -> np.ndarray:
        return self.generate_fine_batch([x_coarse_gen], temperature, seed)[0]

    def generate_fine_batch(self, coarse_list, temperature: Optional[float] = 0.7,
                            seed: int = 0) -> list:
        """Stage 3: rows pad to one length and fill their 1024-wide
        non-causal windows together; each row is cut to its coarse
        length."""
        b = len(coarse_list)
        n_coarse = coarse_list[0].shape[0]
        t_rows = [c.shape[1] for c in coarse_list]
        t_max = max(1024, max(t_rows))
        in_rows = []
        for c in coarse_list:
            arr = np.concatenate([c, np.full((N_FINE_CODEBOOKS - n_coarse, c.shape[1]),
                                             CODEBOOK_SIZE)], axis=0)
            if arr.shape[1] < t_max:
                arr = np.concatenate([arr, np.full((N_FINE_CODEBOOKS, t_max - arr.shape[1]),
                                                   CODEBOOK_SIZE)], axis=1)
            in_rows.append(arr.T.astype(np.int32))   # [T, 8]
        in_arr = np.stack(in_rows)                   # [B, T, 8]
        n_loops = max(0, int(math.ceil((t_max - 1024) / 512))) + 1
        generator = torch.Generator().manual_seed(seed + 2)
        for n in range(n_loops):
            start_idx = min(n * 512, t_max - 1024)
            start_fill_idx = min(n * 512, t_max - 512)
            rel_start = start_fill_idx - start_idx
            buf = torch.as_tensor(in_arr[:, start_idx:start_idx + 1024],
                                  dtype=torch.long, device=self.device)
            rel = torch.full((b,), rel_start, dtype=torch.long, device=self.device)
            for nn_ in range(n_coarse, N_FINE_CODEBOOKS):
                seed_n = None if temperature is None else call_seed(generator)
                buf = _fine_predict(self, buf, rel, seed_n, nn_, temperature)
            in_arr[:, start_fill_idx:start_idx + 1024] = buf.cpu().numpy()[:, rel_start:]
        return [in_arr[i].T[:, :t_rows[i]] for i in range(b)]

    def codec_decode(self, fine_tokens: np.ndarray) -> np.ndarray:
        """EnCodec decode of [8, T] fine tokens -> [1, samples]."""
        codes = torch.as_tensor(np.asarray(fine_tokens), dtype=torch.long)[None, None]
        audio = self._get_codec().decode(codes, [None])
        return audio.float().cpu().numpy()[:, :, 0]

    def generate(self, text: str, voice=None, temperature: float = 0.7,
                 seed: int = 0, **kwargs):
        yield self.generate_batch([text], voice=voice, temperature=temperature,
                                  seed=seed, **kwargs)[0]

    def generate_batch(self, texts, voice=None, temperature: float = 0.7,
                       seed: int = 0, **kwargs) -> list:
        """B texts through the three stages in one batch loop each, then
        EnCodec: rows with equal fine lengths decode in one call.
        ``max_steps`` bounds the semantic stage (768).  One
        GenerationResult per text."""
        start = time.perf_counter()
        b = len(texts)
        sems = self.generate_text_semantic_batch(
            list(texts), voice, temperature, seed,
            max_steps=kwargs.get("max_steps", 768))
        coarse = self.generate_coarse_batch(sems, voice, temperature, seed=seed)
        fines = self.generate_fine_batch(coarse, temperature, seed=seed)
        elapsed = time.perf_counter() - start
        audios, groups = {}, {}
        for i in range(b):
            if fines[i].shape[1] == 0:
                audios[i] = np.zeros((0,), dtype=np.float32)
            else:
                groups.setdefault(fines[i].shape[1], []).append(i)
        codec = self._get_codec()
        for idxs in groups.values():
            codes = torch.as_tensor(np.stack([fines[i] for i in idxs]),
                                    dtype=torch.long)[None]      # [1, G, 8, T]
            # a bf16 EnCodec's audio leaves as float32 (numpy holds no bf16)
            wavs = codec.decode(codes, [None]).float().cpu().numpy()  # [G, T, C]
            for row, i in enumerate(idxs):
                audios[i] = wavs[row, :, 0]
        return [make_generation_result(audios[i], self.config.sample_rate, i,
                                       int(len(sems[i])), elapsed / b, self.device)
                for i in range(b)]

    def sanitize(self, weights: dict) -> dict:
        """suno / HF checkpoints -> the JAX package's paths: the compiled
        module prefixes dropped, GPT-2's ``h.N.`` as ``layers.N.``, the
        causal-mask buffers skipped, ``codec_model.*`` through
        ``sanitize_hf_encodec`` into ``_codec.*``.  ``convert.
        params_from_jax`` takes them on to the port's layouts."""
        out, codec_weights = {}, {}
        for k, v in weights.items():
            k = k.replace("_orig_mod.transformer.", "").replace("_orig_mod.", "")
            k = re.sub(r"(^|\.)h\.(\d+)\.", r"\1layers.\2.", k)
            if k.startswith("codec_model."):
                codec_weights[k[len("codec_model."):]] = np.asarray(v)
                continue
            if "codec" in k or k.endswith(".attn.bias"):
                continue
            out[k] = np.asarray(v)
        if codec_weights and self._codec is not None:
            from mlx_audio_tpu_torch.codec.encodec import sanitize_hf_encodec

            out.update({f"_codec.{k}": v
                        for k, v in sanitize_hf_encodec(codec_weights).items()})
        return out
