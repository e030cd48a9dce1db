"""Whisper's decoding API: ``decode`` (greedy, sampled or beam) and
``detect_language`` (counterpart of
``mlx_audio_tpu/models/stt/whisper/api.py``), host glue around the loops in
decoding.py.

The JAX package pads the prompt to a bucket of 32 for its jitted prefill;
the padded positions are causally masked and overwritten by the decode, so
no result depends on the bucket, and the port prefills the prompt as it
is.  Under an active mesh with dp > 1 a batch of windows pads to a dp
multiple by repeating its last window, and each data row decodes its
windows on its replica (``_decode_impl``, under ``row_offset``).
"""

from __future__ import annotations

from dataclasses import replace
from typing import List, Optional, Union

import numpy as np
import torch

from mlx_audio_tpu_torch.models.stt.whisper.audio import CHUNK_LENGTH
from mlx_audio_tpu_torch.models.stt.whisper.decoding import (
    DecodingOptions,
    DecodingResult,
    FilterConfig,
    beam_search_loop,
    compression_ratio,
    greedy_decode_loop,
)
from mlx_audio_tpu_torch.models.stt.whisper.tokenizer import Tokenizer, get_tokenizer

_SAMPLE_LEN_CAP = 224  # n_text_ctx // 2


@torch.no_grad()
def _encode_mel(model, mel) -> torch.Tensor:
    """mel [B, frames, n_mels] -> audio features, in the weights' dtype."""
    mel = torch.as_tensor(mel, device=model.device)
    return model.encoder(mel.to(model.encoder.conv1.weight.dtype))


@torch.no_grad()
def _prefill(model, caches, cross_kv, tokens, n_valid: int, sot_index: int):
    h, caches = model.decoder.prefill(caches, tokens, n_valid, cross_kv)
    sot_logits = model.decoder.token_embedding.as_linear(h[:, sot_index])
    return sot_logits.float(), caches


@torch.no_grad()
def _lang_id(model, features, sot_token: int, lang_token_ids):
    b = features.shape[0]
    tokens = torch.full((b, 1), sot_token, dtype=torch.int64, device=features.device)
    logits = model.decoder.full_forward(tokens, features)[:, 0].float()
    mask = torch.full((logits.shape[-1],), float("-inf"), device=logits.device)
    mask[torch.as_tensor(lang_token_ids, device=logits.device)] = 0.0
    logits = logits + mask
    return torch.argmax(logits, dim=-1), torch.softmax(logits, dim=-1)


def _is_features(model, x) -> bool:
    return tuple(x.shape[-2:]) == (model.dims.n_audio_ctx, model.dims.n_audio_state)


def detect_language(model, mel_or_features, tokenizer: Optional[Tokenizer] = None):
    """Language ID from a window ([frames, n_mels] or a batch of them, or
    their audio features)."""
    if tokenizer is None:
        tokenizer = get_tokenizer(model.is_multilingual,
                                  num_languages=model.num_languages)
    x = torch.as_tensor(mel_or_features, device=model.device)
    single = x.ndim == 2
    if single:
        x = x[None]
    if not _is_features(model, x):
        x = _encode_mel(model, x)
    lang_tokens, probs = _lang_id(model, x, tokenizer.sot, tokenizer.all_language_tokens)
    probs = probs.cpu().numpy()
    language_probs = [
        {c: float(probs[i, j])
         for j, c in zip(tokenizer.all_language_tokens, tokenizer.all_language_codes)}
        for i in range(x.shape[0])
    ]
    if single:
        return lang_tokens[0], language_probs[0]
    return lang_tokens, language_probs


def _initial_tokens(tokenizer: Tokenizer, options: DecodingOptions,
                    n_ctx: int, sample_len: int) -> tuple:
    sot_sequence = tokenizer.sot_sequence
    if options.without_timestamps:
        sot_sequence = tokenizer.sot_sequence_including_notimestamps
    tokens = list(sot_sequence)
    if options.prefix:
        prefix_tokens = (
            tokenizer.encode(" " + options.prefix.strip())
            if isinstance(options.prefix, str) else list(options.prefix)
        )
        if sample_len is not None:
            max_prefix_len = n_ctx // 2 - sample_len
            prefix_tokens = prefix_tokens[-max_prefix_len:]
        tokens = tokens + prefix_tokens
    if options.prompt:
        prompt_tokens = (
            tokenizer.encode(" " + options.prompt.strip())
            if isinstance(options.prompt, str) else list(options.prompt)
        )
        tokens = [tokenizer.sot_prev] + prompt_tokens[-(n_ctx // 2 - 1):] + tokens
    return tuple(tokens)


def _suppress_token_list(tokenizer: Tokenizer, options: DecodingOptions) -> tuple:
    st = options.suppress_tokens
    if isinstance(st, str):
        st = [int(t) for t in st.split(",")] if st else []
    st = list(st or [])
    if -1 in st:
        st = [t for t in st if t >= 0]
        st.extend(tokenizer.non_speech_tokens)
    st.extend([tokenizer.transcribe, tokenizer.translate, tokenizer.sot,
               tokenizer.sot_prev, tokenizer.sot_lm])
    if tokenizer.no_speech is not None:
        st.append(tokenizer.no_speech)
    return tuple(sorted(set(st)))


@torch.no_grad()
def decode(model, mel, options: DecodingOptions = DecodingOptions(),
           tokenizer: Optional[Tokenizer] = None,
           **kwargs) -> Union[DecodingResult, List[DecodingResult]]:
    """Decode 30 s mel windows [A?, 3000, n_mels] (NLC), or their audio
    features; one result a window.  Under a mesh with dp > 1 the windows
    split over its data replicas."""
    from mlx_audio_tpu_torch.parallel.context import data_parallel

    dp = data_parallel(mel.shape[0] if getattr(mel, "ndim", 2) == 3 else 1)
    if dp is None:
        return _decode_impl(model, mel, options, tokenizer, **kwargs)
    mel, n = dp.pad_batch(torch.as_tensor(mel))
    parts = dp.map_rows(dp.place_replicated(model), mel.shape[0], lambda m, lo, hi: (
        _decode_impl(m, mel[lo:hi], options, tokenizer, **kwargs)))
    return [r for part in parts for r in part][:n]


def _decode_impl(model, mel, options: DecodingOptions = DecodingOptions(),
                 tokenizer: Optional[Tokenizer] = None,
                 **kwargs) -> Union[DecodingResult, List[DecodingResult]]:
    """``decode`` on one model."""
    if kwargs:
        options = replace(options, **kwargs)
    mel = torch.as_tensor(mel, device=model.device)
    single = mel.ndim == 2
    if single:
        mel = mel[None]

    if options.beam_size is not None and options.best_of is not None:
        raise ValueError("beam_size and best_of can't be given together")
    if options.temperature == 0 and options.best_of is not None:
        raise ValueError("best_of with greedy sampling (T=0) is not compatible")
    if options.patience is not None and options.beam_size is None:
        raise ValueError("patience requires beam_size to be given")

    language = options.language or "en"
    if tokenizer is None:
        tokenizer = get_tokenizer(model.is_multilingual, num_languages=model.num_languages,
                                  language=language, task=options.task)

    n_audio = mel.shape[0]
    n_ctx = model.dims.n_text_ctx
    sample_len = min(options.sample_len or n_ctx // 2, _SAMPLE_LEN_CAP)
    features = mel if _is_features(model, mel) else _encode_mel(model, mel.float())
    dev = features.device

    languages = [language] * n_audio
    language_probs = [None] * n_audio
    initial = list(_initial_tokens(tokenizer, options, n_ctx, sample_len))
    sot_index = initial.index(tokenizer.sot)
    if options.language is None or options.task == "lang_id":
        lang_tokens, language_probs = detect_language(model, features, tokenizer)
        languages = [max(p, key=p.get) for p in language_probs]
        if options.task == "lang_id":
            return [DecodingResult(audio_features=features[i], language=languages[i],
                                   language_probs=language_probs[i])
                    for i in range(n_audio)]

    n_init = len(initial)
    sample_begin = n_init
    cfg = FilterConfig(
        eot=tokenizer.eot,
        timestamp_begin=tokenizer.timestamp_begin,
        no_timestamps=tokenizer.no_timestamps,
        max_initial_timestamp_index=(
            round(options.max_initial_timestamp / (CHUNK_LENGTH / model.dims.n_audio_ctx))
            if options.max_initial_timestamp else -1),
        apply_timestamp_rules=not options.without_timestamps,
    )
    n_vocab = model.dims.n_vocab
    suppress_mask = np.zeros((n_vocab,), np.float32)
    if options.suppress_tokens:
        suppress_mask[list(_suppress_token_list(tokenizer, options))] = -np.inf
    blank_mask = np.zeros((n_vocab,), np.float32)
    if options.suppress_blank:
        blank_mask[tokenizer.encode(" ") + [tokenizer.eot]] = -np.inf
    if options.logit_bias:
        for tid, bias in options.logit_bias.items():
            suppress_mask[int(tid)] += float(bias)
    suppress_mask = torch.as_tensor(suppress_mask, device=dev)
    blank_mask = torch.as_tensor(blank_mask, device=dev)

    n_group = options.beam_size or options.best_of or 1
    buf_len = n_init + sample_len + 1

    # the token buffer, the prompt on the left
    tokens0 = np.full((n_audio, buf_len), tokenizer.eot, dtype=np.int64)
    lang_np = (lang_tokens.reshape(-1).cpu().numpy() if options.language is None
               else None)
    for i in range(n_audio):
        row = list(initial)
        if lang_np is not None:
            row[sot_index + 1] = int(lang_np[i])
        tokens0[i, :n_init] = row
    tokens0 = torch.as_tensor(tokens0, device=dev)

    cross_kv = model.decoder.compute_cross_kv(features)
    caches = model.decoder.init_cache(n_audio, buf_len, dtype=features.dtype)
    sot_logits, caches = _prefill(model, caches, cross_kv, tokens0[:, :n_init],
                                  n_init, sot_index)
    if tokenizer.no_speech is not None:
        no_speech_probs = torch.softmax(sot_logits, dim=-1)[:, tokenizer.no_speech].cpu().numpy()
    else:
        no_speech_probs = np.full(n_audio, np.nan)

    cutoff = None
    if options.eot_cutoff is not None:
        cutoff = torch.as_tensor(options.eot_cutoff, dtype=torch.int64, device=dev)
        if cutoff.shape != (n_audio,):
            raise ValueError(f"eot_cutoff must hold one length an audio, not "
                             f"{options.eot_cutoff} for {n_audio}")

    def tile(x, reps):
        return torch.repeat_interleave(x, reps, dim=0)

    def tile_caches(reps):
        for c in caches:
            c.k, c.v = tile(c.k, reps), tile(c.v, reps)
        return caches, [(tile(ck, reps), tile(cv, reps)) for ck, cv in cross_kv]

    if options.beam_size is not None:
        k = options.beam_size
        caches_b, cross_b = tile_caches(k)
        group_tokens, group_len, group_lp = beam_search_loop(
            model, caches_b, cross_b, tile(tokens0, k), n_init, sample_begin,
            suppress_mask, blank_mask, sample_len=sample_len, beam_size=k,
            params=cfg, patience=float(options.patience or 1.0),
            eot_cutoff=cutoff, compact=options.beam_compact)
    else:
        reps = n_group
        if reps > 1:  # best-of-n sampling
            caches, cross_kv = tile_caches(reps)
            tokens0 = tile(tokens0, reps)
        toks, t_end, sum_lp = greedy_decode_loop(
            model, caches, cross_kv, tokens0, n_init, sample_begin,
            torch.Generator().manual_seed(0), suppress_mask, blank_mask,
            sample_len=sample_len, temperature=options.temperature, params=cfg,
            eot_cutoff=tile(cutoff, reps) if cutoff is not None else None)
        group_tokens = toks.cpu().numpy().reshape(n_audio, reps, -1)
        group_len = np.full((n_audio, reps), t_end)
        group_lp = sum_lp.cpu().numpy().reshape(n_audio, reps)

    # on the host: the sampled region, cut at EOT, ranked
    results = []
    for i in range(n_audio):
        cand_tokens, cand_lp = [], []
        for g in range(group_tokens.shape[1]):
            seq = group_tokens[i, g, sample_begin: group_len[i, g]].tolist()
            if tokenizer.eot in seq:
                seq = seq[: seq.index(tokenizer.eot)]
            cand_tokens.append(seq)
            cand_lp.append(float(group_lp[i, g]))

        def score(lp, length):
            if options.length_penalty is None:
                penalty = max(length, 1)
            else:
                penalty = ((5 + length) / 6) ** options.length_penalty
            return lp / penalty

        sel = int(np.argmax([score(lp, len(t)) for lp, t in zip(cand_lp, cand_tokens)]))
        tokens_i = cand_tokens[sel]
        text = tokenizer.decode(tokens_i).strip()
        results.append(DecodingResult(
            audio_features=features[i],
            language=languages[i],
            language_probs=language_probs[i] if options.language is None else None,
            tokens=tokens_i,
            text=text,
            avg_logprob=cand_lp[sel] / (len(tokens_i) + 1),
            no_speech_prob=float(no_speech_probs[i]),
            temperature=options.temperature,
            compression_ratio=compression_ratio(text),
        ))
    return results[0] if single else results
