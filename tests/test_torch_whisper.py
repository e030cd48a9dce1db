"""Whisper in the port against the JAX package, float32 on the CPU: the port
twin of tests/test_whisper.py (one test a test there, at its tiny model,
``tiny_dims``: 2 layers at width 32, a 200-frame window, and its synthetic
tiktoken vocabulary), of the Whisper tests of tests/test_golden_hf.py
(tiny HF models built from a config, offline), and of the word timings.

Weights cross with ``convert.params_from_jax`` and
``load_state_dict(strict=True)``.  At the JAX init the decoder's positional
embedding is 0 and the norms are 1 and 0, which hide a wrong position or
axis, so both are drawn afresh before crossing; the token embedding is
scaled by 0.05, as the LM twins do (at the init's scale a tied tiny decoder
echoes the token it was fed).  Log-mels, encoder outputs and logits are
held to atol and rtol 1e-5 (JAX's matmuls at "highest" precision: its CPU
default rounds further); tokens, lengths, segments, word timings and
writer output are held equal, log-probabilities to 1e-5.  The JAX PRNG
cannot be reproduced, so a sampled decode is held to the port's own
properties.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mlx_audio_tpu.nn.layers as jax_layers
from mlx_audio_tpu.models.stt.whisper import api as japi
from mlx_audio_tpu.models.stt.whisper import decoding as jdec
from mlx_audio_tpu.models.stt.whisper import timing as jtiming
from mlx_audio_tpu.models.stt.whisper import transcribe as jtr
from mlx_audio_tpu.models.stt.whisper import writers as jwriters
from mlx_audio_tpu.models.stt.whisper.audio import log_mel_spectrogram as jax_log_mel
from mlx_audio_tpu.models.stt.whisper.model import WhisperModel as JaxWhisper
from mlx_audio_tpu.models.stt.whisper.tokenizer import Tokenizer as JaxTokenizer
from mlx_audio_tpu.nn.module import named_arrays, update_arrays
from mlx_audio_tpu_torch.convert import params_from_jax
from mlx_audio_tpu_torch.models.stt.whisper import api, decoding, timing, transcribe, writers
from mlx_audio_tpu_torch.models.stt.whisper.audio import log_mel_spectrogram, pad_or_trim
from mlx_audio_tpu_torch.models.stt.whisper.model import ModelDimensions, WhisperModel
from mlx_audio_tpu_torch.models.stt.whisper.tokenizer import Tokenizer
from mlx_audio_tpu_torch.nn.layers import conv1d_route
from test_whisper import tiny_dims, tiny_encoding

TOL = dict(atol=1e-5, rtol=1e-5)
EMBED_SCALE = 0.05


def _seeded(build):
    saved = jax_layers._INIT_RNG
    jax_layers._INIT_RNG = np.random.default_rng(0)
    try:
        return build()
    finally:
        jax_layers._INIT_RNG = saved


def _hi(fn, *a, **kw):
    with jax.default_matmul_precision("highest"):
        return fn(*a, **kw)


def carry(jax_model, port):
    named = {k: np.asarray(v) for k, v in named_arrays(jax_model)}
    port.load_state_dict(params_from_jax(named, port), strict=True)
    return port


def redraw(jm, seed: int = 1):
    rng = np.random.default_rng(seed)
    updates = {}
    for k, v in named_arrays(jm):
        v = np.asarray(v)
        if k == "decoder.positional_embedding":
            updates[k] = rng.normal(0.0, 0.1, v.shape).astype(np.float32)
        elif k == "decoder.token_embedding.weight":
            updates[k] = v * EMBED_SCALE
        elif k.split(".")[-2:-1] and k.split(".")[-2].endswith("ln"):
            updates[k] = (v + rng.normal(0.0, 0.1, v.shape)).astype(np.float32)
    return update_arrays(jm, updates)


def pair_of(dims, cls=JaxWhisper, port_cls=WhisperModel):
    jm = redraw(_seeded(lambda: cls(dims)))
    return jm, carry(jm, port_cls(ModelDimensions(**vars(dims)), device="cpu"))


@pytest.fixture(scope="module")
def toks():
    enc = tiny_encoding()
    kw = dict(num_languages=4, language="en", task="transcribe")
    return JaxTokenizer(encoding=enc, **kw), Tokenizer(encoding=enc, **kw)


@pytest.fixture(scope="module")
def models(toks):
    return pair_of(tiny_dims(toks[0]), jtr.Model, transcribe.Model)


@pytest.fixture(scope="module")
def pair(models):
    """The encoder, decoder and decode twins run on the transcription
    pair: the same weights, built once for the file."""
    return models


def _mel(seed, shape, scale=0.1):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _decode_both(pair, toks, mel, **opts):
    (jm, pm), (jt, pt) = pair, toks
    rj = _hi(japi.decode, jm, jnp.asarray(mel), jdec.DecodingOptions(**opts), tokenizer=jt)
    rp = api.decode(pm, mel, decoding.DecodingOptions(**opts), tokenizer=pt)
    return rj, rp


def _same_result(rj, rp):
    assert rp.tokens == rj.tokens
    assert rp.text == rj.text and rp.language == rj.language
    np.testing.assert_allclose(rp.avg_logprob, rj.avg_logprob, **TOL)
    np.testing.assert_allclose(rp.no_speech_prob, rj.no_speech_prob, **TOL)
    np.testing.assert_allclose(rp.compression_ratio, rj.compression_ratio, **TOL)
    np.testing.assert_allclose(rp.audio_features.numpy(), np.asarray(rj.audio_features), **TOL)


# ---------------------------------------------------------------------------
# twins of tests/test_whisper.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_mels", [80, 128])
def test_log_mel_shape_matches_jax(n_mels):
    x = np.random.default_rng(0).standard_normal(16000).astype(np.float32)
    got = log_mel_spectrogram(x, n_mels=n_mels).numpy()
    assert got.shape == (100, n_mels) and np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(jax_log_mel(x, n_mels=n_mels)), **TOL)


def test_log_mel_silence_matches_jax():
    """Silence maps to the floor: the maximum is taken over the whole
    array, as in the JAX package, padding included."""
    x = np.zeros(16000, dtype=np.float32)
    got = log_mel_spectrogram(x, padding=4000).numpy()
    want = np.asarray(jax_log_mel(x, padding=4000))
    assert got.max() <= 0.0
    np.testing.assert_allclose(got, want, **TOL)
    padded = pad_or_trim(torch.as_tensor(got), 300, axis=-2)
    np.testing.assert_array_equal(padded[:125].numpy(), got)
    np.testing.assert_array_equal(padded[125:].numpy(), 0.0)
    np.testing.assert_array_equal(pad_or_trim(padded, 60, axis=0).numpy(), got[:60])


def test_encoder_matches_jax(pair):
    jm, pm = pair
    mel = _mel(0, (2, 200, 80), 0.3)
    got = pm.encoder(torch.as_tensor(mel)).detach().numpy()
    assert got.shape == (2, 100, 32)
    np.testing.assert_allclose(got, np.asarray(_hi(jm.encoder, jnp.asarray(mel))), **TOL)


def test_greedy_decode_matches_jax(pair, toks):
    rj, rp = _decode_both(pair, toks, _mel(1, (200, 80)), language="en", sample_len=12)
    _same_result(rj, rp)
    assert len(set(rp.tokens)) > 3  # the tiny decoder does not echo one token


def test_decode_batched_matches_jax(pair, toks):
    rj, rp = _decode_both(pair, toks, _mel(2, (2, 200, 80)), language="en", sample_len=8)
    assert len(rp) == len(rj) == 2
    for a, b in zip(rj, rp):
        _same_result(a, b)


def test_beam_search_decode_matches_jax(pair, toks):
    mel = _mel(3, (200, 80))
    rj, rp = _decode_both(pair, toks, mel, language="en", sample_len=12, beam_size=3)
    _same_result(rj, rp)
    greedy = api.decode(pair[1], mel, decoding.DecodingOptions(language="en", sample_len=12),
                        tokenizer=toks[1])
    assert rp.tokens != greedy.tokens  # the search left the greedy path


def test_sampled_decode_batch_of_one_and_seed_repeat(pair, toks):
    """best_of 2 at temperature 0.8: a batch of one equals the single run,
    a run repeats, and the first window of a batch of two equals its single
    run (a row's draws depend on its seed and index only)."""
    pm, pt = pair[1], toks[1]
    mel = _mel(4, (2, 200, 80))
    opts = decoding.DecodingOptions(language="en", sample_len=8, temperature=0.8, best_of=2)
    single = api.decode(pm, mel[0], opts, tokenizer=pt)
    again = api.decode(pm, mel[0], opts, tokenizer=pt)
    one = api.decode(pm, mel[:1], opts, tokenizer=pt)[0]
    two = api.decode(pm, mel, opts, tokenizer=pt)
    assert single.tokens == again.tokens == one.tokens == two[0].tokens
    assert single.avg_logprob == one.avg_logprob
    greedy = api.decode(pm, mel[0], dataclasses.replace(opts, temperature=0.0, best_of=None),
                        tokenizer=pt)
    assert single.tokens != greedy.tokens


def test_without_timestamps_matches_jax(pair, toks):
    rj, rp = _decode_both(pair, toks, np.zeros((200, 80), np.float32), language="en",
                          sample_len=8, without_timestamps=True)
    _same_result(rj, rp)
    assert len(rp.tokens) <= 8


def test_timestamp_rules_filter_matches_jax(toks):
    """apply_filters on random logits over the rules' cases: at the start,
    after a lone timestamp, after a pair, after text; the -inf sets equal
    and the surviving logits within 1e-5."""
    jt = toks[0]
    v = jt.encoding.n_vocab
    cfg = dict(eot=jt.eot, timestamp_begin=jt.timestamp_begin,
               no_timestamps=jt.no_timestamps, max_initial_timestamp_index=50,
               apply_timestamp_rules=True)
    ts0 = jt.timestamp_begin
    rng = np.random.default_rng(5)
    sup = np.zeros(v, np.float32)
    sup[[3, 7]] = -np.inf
    blank = np.zeros(v, np.float32)
    blank[[32, jt.eot]] = -np.inf
    histories = [([], 3), ([ts0 + 60, ts0 + 1, ts0 + 2], 0), ([ts0 + 4], 0),
                 ([ts0 + 4, 65, 66], 0), ([ts0 + 4, 65, ts0 + 9], 0),
                 ([ts0 + 4, 65, ts0 + 9, ts0 + 9, 70], 0)]
    for hist, begin in histories:
        buf = np.full((2, 16), jt.eot, np.int64)
        t = max(len(hist), begin)
        buf[:, :len(hist)] = hist
        logits = rng.standard_normal((2, v)).astype(np.float32) * 3
        want = np.asarray(jdec.apply_filters(
            jnp.asarray(logits), jnp.asarray(buf, jnp.int32), jnp.asarray(t),
            jnp.asarray(begin), jdec.FilterConfig(**cfg), jnp.asarray(sup),
            jnp.asarray(blank)))
        got = decoding.apply_filters(torch.as_tensor(logits), torch.as_tensor(buf), t,
                                     begin, decoding.FilterConfig(**cfg),
                                     torch.as_tensor(sup), torch.as_tensor(blank)).numpy()
        np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], **TOL)


def _patch_tokenizer(monkeypatch, toks):
    monkeypatch.setattr(jtr.Model, "_tokenizer", lambda self, language=None, task=None: toks[0])
    monkeypatch.setattr(transcribe.Model, "_tokenizer",
                        lambda self, language=None, task=None: toks[1])


def _same_segments(sj, sp):
    assert len(sp) == len(sj)
    for a, b in zip(sj, sp):
        assert set(a) == set(b)
        for k in a:
            if k in ("avg_logprob", "no_speech_prob", "compression_ratio"):
                np.testing.assert_allclose(b[k], a[k], **TOL)
            elif k == "words":
                assert [w["word"] for w in b[k]] == [w["word"] for w in a[k]]
                for wa, wb in zip(a[k], b[k]):
                    assert (wb["start"], wb["end"]) == (wa["start"], wa["end"])
                    np.testing.assert_allclose(wb["probability"], wa["probability"], **TOL)
            else:
                assert b[k] == a[k], k


@pytest.mark.parametrize("word_timestamps", [False, True], ids=["segments", "words"])
def test_transcribe_end_to_end_matches_jax(models, toks, monkeypatch, word_timestamps):
    """Model.generate on 2 s of noise (one window), and with word
    timestamps (the alignment heads' DTW): text, segments and word timings
    equal."""
    _patch_tokenizer(monkeypatch, toks)
    jm, pm = models
    audio = _mel(5, (2 * 16000,), 0.05)
    kw = dict(temperature=0.0, language="en", no_speech_threshold=None,
              logprob_threshold=None, compression_ratio_threshold=None,
              word_timestamps=word_timestamps)
    oj = _hi(jm.generate, audio, **kw)
    op = pm.generate(audio, **kw)
    assert op.text == oj.text and op.language == oj.language == "en"
    _same_segments(oj.segments, op.segments)
    if word_timestamps:
        assert sum(len(s["words"]) for s in op.segments) > 1


def test_writers_match_jax(tmp_path):
    result = {
        "text": "hello world",
        "segments": [{"start": 0.0, "end": 1.5, "text": " hello"},
                     {"start": 1.5, "end": 3.0, "text": " world"}],
        "language": "en",
    }
    for side in ("jax", "port"):
        (tmp_path / side).mkdir()
    for fmt in ("txt", "srt", "vtt", "json", "tsv"):
        want = open(jwriters.get_writer(fmt, str(tmp_path / "jax"))(result, "a.wav")).read()
        got = open(writers.get_writer(fmt, str(tmp_path / "port"))(result, "a.wav")).read()
        assert got == want, fmt


def _scripted_decode(result_cls, tokenizer, calls):
    ts = tokenizer.timestamp_begin
    txt = tokenizer.encode("hi")
    script = [
        # a pair at <|1.00|> ending in text: seek goes to its boundary
        dict(tokens=[ts + 0] + txt + [ts + 50, ts + 50] + txt, avg_logprob=-0.1,
             no_speech_prob=0.0, temperature=0.0, compression_ratio=1.0),
        # silence: skipped a whole window
        dict(tokens=txt, avg_logprob=-5.0, no_speech_prob=0.99, temperature=0.0,
             compression_ratio=1.0),
        # a repetition loop at t = 0: the fallback retries
        dict(tokens=txt, avg_logprob=-0.1, no_speech_prob=0.0, temperature=0.0,
             compression_ratio=99.0),
        # a lone timestamp at the end consumes the window
        dict(tokens=[ts + 0] + txt + [ts + 80], avg_logprob=-0.1, no_speech_prob=0.0,
             temperature=0.5, compression_ratio=1.0),
    ]

    def scripted(model_, segment, options, tokenizer=None):
        calls.append(options.temperature)
        return result_cls(audio_features=None, language="en",
                          **script[min(len(calls), len(script)) - 1])
    return scripted


def test_seek_and_segmentation_logic_matches_jax(models, toks, monkeypatch):
    """The seek arithmetic, segmentation, silence skip and temperature
    fallback on scripted decode results, in both packages."""
    _patch_tokenizer(monkeypatch, toks)
    calls = {"jax": [], "port": []}
    monkeypatch.setattr(jtr.api, "decode",
                        _scripted_decode(jdec.DecodingResult, toks[0], calls["jax"]))
    monkeypatch.setattr(transcribe.api, "decode",
                        _scripted_decode(decoding.DecodingResult, toks[1], calls["port"]))
    audio = np.zeros(5 * 16000, dtype=np.float32)
    kw = dict(temperature=(0.0, 0.5), language="en", condition_on_previous_text=False)
    oj = models[0].generate(audio, **kw)
    op = models[1].generate(audio, **kw)
    assert calls["port"] == calls["jax"] == [0.0, 0.0, 0.0, 0.5]
    _same_segments(oj.segments, op.segments)
    assert [s["seek"] for s in op.segments] == [0, 300]
    assert op.text == oj.text


def _scripted_words(segments, **kwargs):
    # the first segment's words are anomalous (improbable, short) and
    # isolated by silence
    for i, seg in enumerate(segments):
        if i == 0:
            seg["words"] = [{"word": "hi", "start": seg["start"] + 0.01 * j,
                             "end": seg["start"] + 0.01 * (j + 1), "probability": 0.01}
                            for j in range(3)]
        else:
            seg["words"] = [{"word": "ok", "start": seg["start"], "end": seg["end"],
                             "probability": 0.9}]


def test_hallucination_silence_skipping_matches_jax(models, toks, monkeypatch):
    _patch_tokenizer(monkeypatch, toks)
    for mod, res, tok in ((jtr, jdec.DecodingResult, toks[0]),
                          (transcribe, decoding.DecodingResult, toks[1])):
        ts = tok.timestamp_begin
        txt = tok.encode("hi")
        result = res(audio_features=None, language="en",
                     tokens=[ts + 10] + txt + [ts + 40, ts + 40] + txt, avg_logprob=-0.1,
                     no_speech_prob=0.0, temperature=0.0, compression_ratio=1.0)
        monkeypatch.setattr(mod.api, "decode", lambda *a, r=result, **k: r)
        monkeypatch.setattr(mod, "add_word_timestamps", _scripted_words)
    audio = np.zeros(2 * 16000, dtype=np.float32)
    kw = dict(temperature=0.0, language="en", word_timestamps=True,
              condition_on_previous_text=False)
    for extra in ({}, {"hallucination_silence_threshold": 0.05}):
        oj = models[0].generate(audio, **kw, **extra)
        op = models[1].generate(audio, **kw, **extra)
        _same_segments(oj.segments, op.segments)
    plain = models[1].generate(audio, **kw)
    assert len(op.segments) < len(plain.segments)


def test_merge_punctuations_matches_jax():
    def build(cls):
        return [cls(w, t, 0.0, 0.0, 1.0) for w, t in
                ((" “", [1]), (" hello", [2]), (",", [3]), (" world", [4]), ("!", [5]))]

    kw = dict(prepended="\"'“¿([{-", appended="\"'.。,，!！?？:：”)]}、")
    a, b = build(jtiming.WordTiming), build(timing.WordTiming)
    jtiming.merge_punctuations(a, **kw)
    timing.merge_punctuations(b, **kw)
    assert [(w.word, w.tokens) for w in b] == [(w.word, w.tokens) for w in a]
    assert [(w.word, w.tokens) for w in b][1] == (" “ hello,", [1, 2, 3])


def test_iter_top_k_matches_lax_top_k():
    """The beam loop's (argmax, mask) selection gives lax.top_k's values
    and indices, ties in index order."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 5000)).astype(np.float32)
    x[1, 10] = x[1, 20] = x[1, 30] = 9.0  # a tie at the top
    v_ref, i_ref = jax.lax.top_k(jnp.asarray(x), 10)
    v_got, i_got = decoding._iter_top_k(torch.as_tensor(x), 10)
    np.testing.assert_array_equal(v_got.numpy(), np.asarray(v_ref))
    np.testing.assert_array_equal(i_got.numpy(), np.asarray(i_ref))
    v_st, i_st = decoding._top_k_stable(torch.as_tensor(x), 10)
    np.testing.assert_array_equal(i_st.numpy(), np.asarray(i_ref))


def test_beam_search_patience_matches_jax(pair, toks):
    rj, rp = _decode_both(pair, toks, _mel(3, (200, 80)), language="en", sample_len=10,
                          beam_size=2, patience=2.0)
    _same_result(rj, rp)
    assert np.isfinite(rp.avg_logprob)


def test_bundled_tiktoken_assets_load_from_the_port():
    """The port's vocabularies are its own package data: the multilingual
    and gpt2 tokenizers load from the port's assets and tokenize as the
    JAX package's."""
    from mlx_audio_tpu.models.stt.whisper import tokenizer as jtok
    from mlx_audio_tpu_torch.models.stt.whisper import tokenizer as ptok

    paths = ptok._asset_search_paths()
    assert len(paths) == 1 and paths[0].parts[-5:] == (
        "mlx_audio_tpu_torch", "models", "stt", "whisper", "assets")
    assert (paths[0] / "multilingual.tiktoken").exists()
    assert ptok._asset_search_paths("ckpt")[1:] == paths
    multi = ptok.get_tokenizer(True, language="en", task="transcribe")
    assert multi.sot == 50258 and multi.encoding.n_vocab == 51865
    want = jtok.get_tokenizer(True, language="en", task="transcribe")
    text = "hello world, ça va?"
    assert multi.encode(text) == want.encode(text)
    assert multi.decode(multi.encode(text)) == text
    assert multi.non_speech_tokens == want.non_speech_tokens
    en = ptok.get_tokenizer(False)
    assert en.eot == 50256 and en.decode(en.encode("hello world")) == "hello world"
    with pytest.raises(FileNotFoundError):
        ptok.get_encoding("missing-vocabulary")


def _port_beam(pm, toks, n_audio, beam, sample_len, seed, compact):
    """The port's beam search at one prefill of [sot], each audio's finish
    scripted at its own step (``eot_cutoff``)."""
    eot = toks[1].eot
    mel = _mel(seed, (n_audio, 200, 80), 0.3)
    buf_len = 1 + sample_len + 1
    tokens0 = torch.full((n_audio, buf_len), eot, dtype=torch.int64)
    tokens0[:, 0] = toks[1].sot
    cfg = decoding.FilterConfig(eot=eot, timestamp_begin=10 ** 9, no_timestamps=10 ** 9 + 1,
                                max_initial_timestamp_index=-1, apply_timestamp_rules=False)
    with torch.no_grad():
        feats = pm.encoder(torch.as_tensor(mel))
        ckv = pm.decoder.compute_cross_kv(feats)
        caches = pm.decoder.init_cache(n_audio, buf_len)
        _, caches = api._prefill(pm, caches, ckv, tokens0[:, :1], 1, 0)
    for c in caches:
        c.k, c.v = c.k.repeat_interleave(beam, 0), c.v.repeat_interleave(beam, 0)
    ckv = [(a.repeat_interleave(beam, 0), b.repeat_interleave(beam, 0)) for a, b in ckv]
    zeros = torch.zeros(pm.dims.n_vocab)
    cutoff = torch.arange(n_audio) * 7 + 3
    return decoding.beam_search_loop(
        pm, caches, ckv, tokens0.repeat_interleave(beam, 0), 1, 1, zeros, zeros,
        sample_len=sample_len, beam_size=beam, params=cfg, eot_cutoff=cutoff,
        compact=compact)


def test_beam_compaction_invariance(pair, toks):
    """Audios finish at staggered steps: the candidate pools with
    finished-audio compaction equal, step for step, those without it
    (test_eot_cutoff_... holds the results to the JAX package's)."""
    compact = _port_beam(pair[1], toks, 5, 3, 40, 17, True)
    whole = _port_beam(pair[1], toks, 5, 3, 40, 17, False)
    tok_a, len_a, sc_a = compact
    tok_b, len_b, sc_b = whole
    np.testing.assert_array_equal(len_a, len_b)
    np.testing.assert_array_equal(sc_a, sc_b)
    for i in range(tok_a.shape[0]):
        for c in range(tok_a.shape[1]):
            np.testing.assert_array_equal(tok_a[i, c, :len_a[i, c]], tok_b[i, c, :len_a[i, c]])
    # the audios retired at their scripted steps
    assert len_a.max(1).tolist() == [5, 12, 19, 26, 33]


def test_eot_cutoff_schedules_staggered_finishes_matches_jax(pair, toks):
    mel = _mel(11, (4, 200, 80))
    cutoff = [2, 5, 9, 13]
    kw = dict(language="en", sample_len=16, without_timestamps=True, eot_cutoff=cutoff)
    rj, rp = _decode_both(pair, toks, mel, **kw)
    assert [len(r.tokens) for r in rp] == cutoff
    for a, b in zip(rj, rp):
        _same_result(a, b)
    beam = dict(kw, beam_size=2)
    rj, rc = _decode_both(pair, toks, mel, **beam)
    rn = api.decode(pair[1], mel, decoding.DecodingOptions(**beam, beam_compact=False),
                    tokenizer=toks[1])
    for a, b, c in zip(rj, rc, rn):
        _same_result(a, b)
        assert c.tokens == b.tokens and c.avg_logprob == b.avg_logprob
    assert [len(r.tokens) for r in rc] == cutoff


def test_logit_bias_steers_decode_matches_jax(pair, toks):
    mel = _mel(8, (200, 80))
    eot = toks[0].eot
    for kw in (dict(sample_len=12, logit_bias={eot: 1e4}),
               dict(sample_len=6, logit_bias={7: 1e4}),
               dict(sample_len=12, beam_size=3, logit_bias={eot: 1e4})):
        rj, rp = _decode_both(pair, toks, mel, language="en", without_timestamps=True, **kw)
        _same_result(rj, rp)
    assert rp.tokens == rj.tokens and len(rp.tokens) <= 1


# ---------------------------------------------------------------------------
# the rest of the port's surface
# ---------------------------------------------------------------------------


def test_weights_cross_strict_and_convs_transpose(pair):
    """Every JAX array has its place in the port's state dict (strict
    load); the convs arrive as torch's [O, I, K]."""
    jm, pm = pair
    named = dict(named_arrays(jm))
    assert set(named) == set(pm.state_dict())
    w = np.asarray(named["encoder.conv1.weight"])  # [K, I, O]
    np.testing.assert_array_equal(pm.encoder.conv1.weight.numpy(), w.transpose(2, 1, 0))
    np.testing.assert_array_equal(pm.alignment_heads.numpy(), np.asarray(jm.alignment_heads))


@pytest.mark.parametrize("shape,route", [
    ((3, 128, 1280, 3000, 1), "shifted"),   # large-v3(-turbo) and Voxtral's conv1
    ((3, 80, 384, 3000, 1), "library"),     # the 80-mel Whispers' conv1 (tiny)
    ((3, 1280, 1280, 3000, 2), "library"),  # conv2, stride 2
], ids=["conv1-128-mels", "conv1-80-mels", "conv2-stride-2"])
def test_conv1d_route_of_the_whisper_stem(shape, route):
    """The 128-mel stem takes the dilated_conv1d kernel; the 80-mel one and
    the strided conv2 take the library."""
    k, c, c_out, l, stride = shape
    assert conv1d_route(k, c, c_out, l, stride=stride, padding=1) == route


def test_cached_decode_matches_full_forward(pair):
    """The cached step, replayed a token at a time after a prefill, gives
    the full forward's logits (the prefill's rewind of the write index)."""
    _, pm = pair
    with torch.no_grad():
        feats = pm.encoder(torch.as_tensor(_mel(11, (1, 200, 80), 0.5)))
        seq = torch.tensor([[257, 35, 47, 12, 80, 99]])
        ff = pm.decoder.full_forward(seq, feats)
        ckv = pm.decoder.compute_cross_kv(feats)
        caches = pm.decoder.init_cache(1, 16)
        _, caches = pm.decoder.prefill(caches, seq[:, :2], 2, ckv)
        for t in range(2, seq.shape[1]):
            lg, caches = pm.decoder.step(caches, seq[:, t - 1:t], ckv)
            np.testing.assert_allclose(lg[0].numpy(), ff[0, t - 1].numpy(), **TOL)


def test_default_device_is_cuda_and_local_loading(monkeypatch, tmp_path, toks):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        transcribe.Model(ModelDimensions(**vars(tiny_dims(toks[0]))))
    missing = str(tmp_path / "whisper-large-v3-turbo")
    with pytest.raises(FileNotFoundError, match="whisper-large-v3-turbo"):
        transcribe.Model.from_pretrained(missing)


def test_generate_reads_an_audio_path_as_jax_does(models, toks, monkeypatch, tmp_path):
    """A 24 kHz wav path is read and resampled to 16 kHz: the transcript and
    segments equal the JAX package's on the same file; a non-wav path
    raises the reference's gated error."""
    from mlx_audio_tpu_torch.utils.audio_io import save_audio

    _patch_tokenizer(monkeypatch, toks)
    jm, pm = models
    path = str(tmp_path / "speech.wav")
    save_audio(path, _mel(6, (2 * 24000,), 0.05), 24000)
    kw = dict(temperature=0.0, language="en", no_speech_threshold=None,
              logprob_threshold=None, compression_ratio_threshold=None)
    oj = _hi(jm.generate, path, **kw)
    op = pm.generate(path, **kw)
    assert op.text == oj.text
    _same_segments(oj.segments, op.segments)
    with pytest.raises(RuntimeError, match="soundfile"):
        pm.generate(str(tmp_path / "speech.flac"))


def test_from_pretrained_loads_a_local_hf_directory(tmp_path):
    """A local HF-transformers checkpoint directory loads through
    sanitize and params_from_jax, as the JAX package's loader takes it."""
    import json

    from safetensors.numpy import save_file

    _transformers()
    from transformers import WhisperConfig as HFConfig
    from transformers import WhisperForConditionalGeneration

    cfg = HFConfig(vocab_size=100, num_mel_bins=8, d_model=16, encoder_layers=1,
                   encoder_attention_heads=2, decoder_layers=1, decoder_attention_heads=2,
                   encoder_ffn_dim=64, decoder_ffn_dim=64, max_source_positions=16,
                   max_target_positions=16, pad_token_id=0, bos_token_id=1,
                   eos_token_id=2, decoder_start_token_id=1)
    torch.manual_seed(0)
    hf = WhisperForConditionalGeneration(cfg).eval()
    save_file({k: v.detach().numpy().copy() for k, v in hf.state_dict().items()},
              str(tmp_path / "model.safetensors"))
    (tmp_path / "config.json").write_text(json.dumps(cfg.to_dict()))
    pm = transcribe.Model.from_pretrained(str(tmp_path), device="cpu")
    mel = _mel(4, (1, 8, 32), 0.5)
    with torch.no_grad():
        want = hf.model.encoder(torch.as_tensor(mel)).last_hidden_state.numpy()
        got = pm.encoder(torch.as_tensor(mel.transpose(0, 2, 1))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# twins of the Whisper tests of tests/test_golden_hf.py
# ---------------------------------------------------------------------------


def _transformers():
    """transformers, without its TensorFlow and Flax back ends (slow to
    import, and unused here)."""
    os.environ.setdefault("USE_TF", "0")
    os.environ.setdefault("USE_FLAX", "0")
    import transformers

    return transformers


def _hf_pair(max_target_positions=16):
    _transformers()
    from transformers import WhisperConfig as HFConfig
    from transformers import WhisperForConditionalGeneration

    torch.manual_seed(0)
    hf = WhisperForConditionalGeneration(HFConfig(
        vocab_size=100, num_mel_bins=8, d_model=16, encoder_layers=2,
        encoder_attention_heads=2, decoder_layers=2, decoder_attention_heads=2,
        encoder_ffn_dim=64, decoder_ffn_dim=64, max_source_positions=16,
        max_target_positions=max_target_positions, pad_token_id=0, bos_token_id=1,
        eos_token_id=2, decoder_start_token_id=1)).eval()
    pm = WhisperModel(ModelDimensions(
        n_mels=8, n_audio_ctx=16, n_audio_state=16, n_audio_head=2, n_audio_layer=2,
        n_vocab=100, n_text_ctx=max_target_positions, n_text_state=16, n_text_head=2,
        n_text_layer=2), device="cpu")
    sd = {k: v.detach().numpy() for k, v in hf.state_dict().items()}
    pm.load_state_dict(params_from_jax(pm.sanitize(sd), pm), strict=False)
    return hf, pm


def test_whisper_matches_hf_transformers():
    hf, pm = _hf_pair()
    rng = np.random.default_rng(4)
    mel = (rng.standard_normal((1, 8, 32)) * 0.5).astype(np.float32)
    tokens = rng.integers(0, 100, size=(1, 10))
    with torch.no_grad():
        enc_hf = hf.model.encoder(torch.as_tensor(mel)).last_hidden_state
        logits_hf = hf(input_features=torch.as_tensor(mel),
                       decoder_input_ids=torch.as_tensor(tokens)).logits
        enc = pm.encoder(torch.as_tensor(mel.transpose(0, 2, 1)))
        logits = pm.decoder.full_forward(torch.as_tensor(tokens), enc)
    np.testing.assert_allclose(enc.numpy(), enc_hf.numpy(), **TOL)
    np.testing.assert_allclose(logits.numpy(), logits_hf.numpy(), **TOL)


def test_whisper_beam_search_matches_hf_generate():
    """The port's beam search against HF's beam scorer on a tiny Whisper:
    the same best sequences and scores for each audio."""
    hf, pm = _hf_pair(32)
    from transformers.generation import GenerationConfig, GenerationMixin

    rng = np.random.default_rng(11)
    n_audio, beam, sample_len = 3, 4, 10
    mel = (rng.standard_normal((n_audio, 8, 32)) * 0.5).astype(np.float32)
    gc = GenerationConfig(num_beams=beam, do_sample=False, max_new_tokens=sample_len,
                          length_penalty=0.0, early_stopping=True, output_scores=True,
                          return_dict_in_generate=True, pad_token_id=0, bos_token_id=1,
                          eos_token_id=2, decoder_start_token_id=1)
    with torch.no_grad():
        out = GenerationMixin.generate(
            hf, input_features=torch.as_tensor(mel),
            decoder_input_ids=torch.full((n_audio, 1), 1, dtype=torch.long),
            generation_config=gc)
        feats = pm.encoder(torch.as_tensor(mel.transpose(0, 2, 1)))
        buf_len = 1 + sample_len + 1
        tokens0 = torch.full((n_audio, buf_len), 2, dtype=torch.int64)
        tokens0[:, 0] = 1
        ckv = pm.decoder.compute_cross_kv(feats)
        caches = pm.decoder.init_cache(n_audio, buf_len)
        _, caches = api._prefill(pm, caches, ckv, tokens0[:, :1], 1, 0)
    for c in caches:
        c.k, c.v = c.k.repeat_interleave(beam, 0), c.v.repeat_interleave(beam, 0)
    ckv = [(a.repeat_interleave(beam, 0), b.repeat_interleave(beam, 0)) for a, b in ckv]
    cfg = decoding.FilterConfig(eot=2, timestamp_begin=100, no_timestamps=99,
                                max_initial_timestamp_index=-1, apply_timestamp_rules=False)
    fin_tokens, fin_len, fin_scores = decoding.beam_search_loop(
        pm, caches, ckv, tokens0.repeat_interleave(beam, 0), 1, 1, torch.zeros(100),
        torch.zeros(100), sample_len=sample_len, beam_size=beam, params=cfg)
    for i in range(n_audio):
        g = int(fin_scores[i].argmax())
        seq = fin_tokens[i, g, : fin_len[i, g]].tolist()
        ref = out.sequences[i].tolist()
        seq, ref = (s[: s.index(2)] if 2 in s else s for s in (seq, ref))
        assert seq == ref
        np.testing.assert_allclose(fin_scores[i, g], out.sequences_scores[i].item(), atol=1e-5)


def test_whisper_timestamp_filter_matches_hf_processor():
    _transformers()
    from transformers.generation.logits_process import WhisperTimeStampLogitsProcessor

    v, ts_begin, eot, no_ts, begin = 60, 40, 38, 39, 3

    class _GC:
        eos_token_id = eot
        no_timestamps_token_id = no_ts
        max_initial_timestamp_index = 10
        is_multilingual = False

    proc = WhisperTimeStampLogitsProcessor(_GC(), begin_index=begin,
                                           _detect_timestamp_from_logprob=True)
    cfg = decoding.FilterConfig(eot=eot, timestamp_begin=ts_begin, no_timestamps=no_ts,
                                max_initial_timestamp_index=10, apply_timestamp_rules=True)
    rng = np.random.default_rng(30)
    for seq in ([], [41], [41, 41], [41, 5, 7], [41, 5, 7, 44], [41, 5, 44, 44, 9, 12]):
        ids = np.asarray([[50, 51, 52] + seq], dtype=np.int64)
        logits = rng.standard_normal((1, v)).astype(np.float32) * 2.0
        with torch.no_grad():
            want = proc(torch.as_tensor(ids), torch.as_tensor(logits.copy())).numpy()[0]
        t = ids.shape[1]
        buf = np.full((1, t + 8), eot, dtype=np.int64)
        buf[0, :t] = ids[0]
        got = decoding.apply_filters(torch.as_tensor(logits), torch.as_tensor(buf), t, begin,
                                     cfg, torch.zeros(v), torch.zeros(v)).numpy()[0]
        assert (np.isfinite(got) == np.isfinite(want)).all(), seq
        np.testing.assert_allclose(got[np.isfinite(got)], want[np.isfinite(want)], **TOL)


def test_whisper_dtw_and_median_filter_match_hf_and_jax():
    _transformers()
    from transformers.models.whisper.generation_whisper import _dynamic_time_warping

    rng = np.random.default_rng(32)
    for shape in ((7, 13), (20, 20), (3, 40)):
        m = rng.standard_normal(shape).astype(np.float32)
        want = _dynamic_time_warping(m.astype(np.float64))
        got = timing.dtw(m)
        for g, w in zip(got, want):
            assert np.asarray(g).tolist() == np.asarray(w).tolist()
        x = rng.standard_normal((2,) + shape)
        np.testing.assert_array_equal(timing.median_filter(x, 7), jtiming.median_filter(x, 7))


def test_whisper_mel_frontend_matches_hf_feature_extractor():
    _transformers()
    from transformers import WhisperFeatureExtractor

    audio = (np.random.default_rng(0).standard_normal(16000 * 3) * 0.1).astype(np.float32)
    for n_mels in (80, 128):
        want = WhisperFeatureExtractor(feature_size=n_mels)(
            audio, sampling_rate=16000, return_tensors="np",
            padding="max_length").input_features[0]
        got = log_mel_spectrogram(audio, n_mels=n_mels, padding=480000).numpy()[:3000].T
        np.testing.assert_allclose(got, want, atol=1e-4)
