"""Parakeet in the port against the JAX package, float32 on the CPU: a twin
of each test of tests/test_parakeet.py at its tiny configs (TDT, RNN-T and
CTC heads on a 2-layer, 64-wide Conformer), the HF-transformers golden and
directory load of tests/test_golden_hf.py, and the frontend, encoder and
joint on their own.

Each head is built once for the file, in JAX with a seeded init, and its
arrays cross with ``convert.params_from_jax`` and
``load_state_dict(strict=True)``.  The JAX init leaves the batch norms'
statistics and affine at the identity and the attention's ``pos_bias_u``
and ``pos_bias_v`` at 0, which would hide a wrong axis: they are redrawn
before crossing.  Log-mel, encoder output and logits are held to atol 1e-4
and rtol 1e-4; tokens, times, durations and counts of the greedy loops are
held equal to the JAX package's.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mlx_audio_tpu.nn.layers as jax_layers
from mlx_audio_tpu.models.stt.parakeet import BaseParakeet as JaxBaseParakeet
from mlx_audio_tpu.models.stt.parakeet import alignment as jal
from mlx_audio_tpu.models.stt.parakeet import parakeet as jpk
from mlx_audio_tpu.models.stt.parakeet.audio import log_mel_spectrogram as jax_log_mel
from mlx_audio_tpu.nn.module import named_arrays, update_arrays
from mlx_audio_tpu_torch.convert import params_from_jax
from mlx_audio_tpu_torch.models.stt.parakeet import BaseParakeet, Model
from mlx_audio_tpu_torch.models.stt.parakeet import alignment as al
from mlx_audio_tpu_torch.models.stt.parakeet import parakeet as pk
from mlx_audio_tpu_torch.models.stt.parakeet.audio import log_mel_spectrogram
from test_parakeet import VOCAB, _eager_transducer_oracle, ctc_config, tdt_config

TOL = dict(atol=1e-4, rtol=1e-4)


def rnnt_config():
    cfg = tdt_config(tdt=False)
    cfg["model_defaults"] = {"tdt_durations": None}
    return cfg


def _seeded(build):
    saved = jax_layers._INIT_RNG
    jax_layers._INIT_RNG = np.random.default_rng(0)
    try:
        return build()
    finally:
        jax_layers._INIT_RNG = saved


def randomized(jm, seed=1):
    """The JAX model with its batch norms and relative-position biases drawn
    (running variances positive)."""
    rng = np.random.default_rng(seed)
    new = {}
    for k, v in named_arrays(jm):
        if k.endswith("running_var"):
            new[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k.endswith(("running_mean", "pos_bias_u", "pos_bias_v")) or ".batch_norm." in k:
            new[k] = (rng.standard_normal(v.shape) * 0.1 + (k.endswith("weight"))
                      ).astype(np.float32)
    return update_arrays(jm, new)


def carry(jm, tm):
    named = {k: np.asarray(v) for k, v in named_arrays(jm)}
    tm.load_state_dict(params_from_jax(named, tm), strict=True)
    return tm


def pair_of(config):
    jm = randomized(_seeded(lambda: JaxBaseParakeet.from_config(config)))
    return jm, carry(jm, BaseParakeet.from_config(config, device="cpu"))


@pytest.fixture(scope="module")
def models():
    return {"tdt": pair_of(tdt_config()), "rnnt": pair_of(rnnt_config()),
            "ctc": pair_of(ctc_config())}


def _audio(seed, n, scale=0.1):
    return (np.random.default_rng(seed).standard_normal(n) * scale).astype(np.float32)


def _tokens(result):
    return [(t.id, t.text, t.start, t.duration) for s in result.sentences for t in s.tokens]


def assert_same_result(got, want):
    assert got.text == want.text
    assert _tokens(got) == _tokens(want)


# ---------------------------------------------------------------------------
# the twins of tests/test_parakeet.py
# ---------------------------------------------------------------------------


def test_tdt_decode(models):
    jm, tm = models["tdt"]
    audio = _audio(0, 16000)
    got, want = tm.generate(audio), jm.generate(audio)
    assert_same_result(got, want)
    assert _tokens(got)
    for s in got.sentences:
        for t in s.tokens:
            assert t.start >= 0 and t.duration >= 0


def test_rnnt_decode(models):
    """Silence, the reference test's input, and seeded noise.  Silence's
    log-mel is a constant that the per-feature normalisation divides by
    its std (0) plus 1e-5: JAX's float32 mean leaves a rounding residue
    there (up to 0.16 after the division), the port's none, so the labels
    of silence are held to JAX's on JAX's own log-mel."""
    jm, tm = models["rnnt"]
    silence = np.zeros(8000, dtype=np.float32)
    got = tm.generate(silence)
    assert isinstance(got.text, str)
    assert_same_result(got, tm.decode(log_mel_spectrogram(silence, tm.preprocessor_config))[0])
    mel = jax_log_mel(silence, jm.preprocessor_config)
    assert_same_result(tm.decode(np.array(mel))[0], jm.decode(mel)[0])
    audio = _audio(6, 8000)
    got = tm.generate(audio)
    assert_same_result(got, jm.generate(audio))
    assert _tokens(got)


def test_ctc_decode(models):
    jm, tm = models["ctc"]
    audio = _audio(1, 8000)
    got = tm.generate(audio)
    assert_same_result(got, jm.generate(audio))
    assert isinstance(got.text, str)


def test_chunked_generate_merges(models):
    """Four seconds in chunks of 2 with 1 of overlap: the full chunks as one
    batch, the tail alone, then the merges."""
    jm, tm = models["ctc"]
    audio = _audio(2, 4 * 16000)
    kw = dict(chunk_duration=2.0, overlap_duration=1.0)
    assert_same_result(tm.generate(audio, **kw), jm.generate(audio, **kw))


def _tok_pair(i, start, dur=0.1):
    return (jal.AlignedToken(i, text=jal.decode_tokens([i], VOCAB), start=start, duration=dur),
            al.AlignedToken(i, text=al.decode_tokens([i], VOCAB), start=start, duration=dur))


def _split(spec):
    pairs = [_tok_pair(*s) for s in spec]
    return [p[0] for p in pairs], [p[1] for p in pairs]


def _as_tuples(tokens):
    return [(t.id, t.text, t.start, t.end, t.duration) for t in tokens]


def test_merge_contiguous_agreeing_overlap():
    ja, ta = _split([(0, 0.0), (1, 0.2), (2, 0.4), (3, 0.6)])
    jb, tb = _split([(2, 0.4), (3, 0.6), (4, 0.8)])
    got = al.merge_longest_contiguous(ta, tb, overlap_duration=0.5)
    assert _as_tuples(got) == _as_tuples(jal.merge_longest_contiguous(ja, jb, overlap_duration=0.5))
    assert [t.id for t in got] == [0, 1, 2, 3, 4]


def test_merge_lcs_fallback():
    ja, ta = _split([(0, 0.0), (1, 0.2), (2, 0.4)])
    jb, tb = _split([(1, 0.21), (5, 0.3), (2, 0.41), (4, 0.6)])
    got = al.merge_longest_common_subsequence(ta, tb, overlap_duration=0.5)
    want = jal.merge_longest_common_subsequence(ja, jb, overlap_duration=0.5)
    assert _as_tuples(got) == _as_tuples(want)
    assert got[0].id == 0 and got[-1].id == 4


def test_sentences_split_on_punctuation():
    jt, tt = _split([(11, 0.0), (13, 0.2), (12, 0.4), (10, 0.6)])
    got, want = al.tokens_to_sentences(tt), jal.tokens_to_sentences(jt)
    assert [(s.text, s.start, s.end, _as_tuples(s.tokens)) for s in got] == \
        [(s.text, s.start, s.end, _as_tuples(s.tokens)) for s in want]
    assert len(got) == 3 and got[0].text.endswith("!")


def test_batched_chunk_decode_matches_single(models):
    """A batch of two mels gives each row the tokens of decoding it alone,
    and the JAX package's."""
    jm, tm = models["ctc"]
    rng = np.random.default_rng(7)
    a, b = (rng.standard_normal(8000).astype(np.float32) * 0.1 for _ in range(2))
    mels = [log_mel_spectrogram(x, tm.preprocessor_config) for x in (a, b)]
    batch = tm.decode(torch.cat(mels))
    singles = [tm.decode(m)[0] for m in mels]
    want = jm.decode(jnp.concatenate([jax_log_mel(x, jm.preprocessor_config) for x in (a, b)]))
    for got, one, ref in zip(batch, singles, want):
        assert_same_result(got, one)
        assert_same_result(got, ref)


@pytest.mark.parametrize("tdt", [True, False])
def test_transducer_while_loop_matches_eager_oracle(models, tdt):
    """The port's Python loop emits the tokens, times, durations and counts
    of the JAX package's lax.while_loop on the same encoder features, and
    those of the eager oracle of the reference semantics; two rows of the
    same features each reproduce the one-row decode."""
    jm, tm = models["tdt" if tdt else "rnnt"]
    mel = np.random.default_rng(3).standard_normal((1, 120, 80)).astype(np.float32)
    features, lengths = jpk._encode_jit(jm, jnp.asarray(mel))
    max_len = int(lengths[0])
    kw = dict(vocab_size=len(jm.vocabulary), max_symbols=int(jm.max_symbols),
              max_out=max(16, (int(jm.max_symbols) + 1) * max_len), tdt=tdt)
    want = _eager_transducer_oracle(jm, features, max_len, tdt)
    assert len(want) > 0
    feats = np.asarray(features)
    for rows in (1, 2):
        f = np.concatenate([feats] * rows)
        lens = [max_len] * rows
        jt = jpk._transducer_greedy_loop(jm, jnp.asarray(f), jnp.asarray(lens, jnp.int32),
                                         jnp.asarray(jm.durations, jnp.int32), **kw)
        pt = pk.transducer_greedy_loop(tm, torch.as_tensor(f), torch.tensor(lens),
                                       tm.durations, **kw)[:4]
        for j, p in zip(jt, pt):
            np.testing.assert_array_equal(p.numpy(), np.asarray(j))
        toks, times, durs, count = (x.numpy() for x in pt)
        for row in range(rows):
            got = [(int(toks[row, i]), int(times[row, i]), int(durs[row, i]))
                   for i in range(int(count[row]))]
            assert got == want


def test_ctc_collapse_keeps_repeats_across_blank(models, monkeypatch):
    """[A, blank, A] emits A twice (NeMo's collapse), as in the JAX package."""
    jm, tm = models["ctc"]
    blank = len(VOCAB)
    frames = [0, blank, 0, 1, 1, blank, blank, 2]
    logits = np.full((1, len(frames), blank + 1), -10.0, dtype=np.float32)
    for t, tok in enumerate(frames):
        logits[0, t, tok] = 0.0
    monkeypatch.setattr(pk, "_ctc_logits", lambda m, mel: (torch.as_tensor(logits),
                                                           torch.tensor([len(frames)])))
    monkeypatch.setattr(jpk, "_ctc_logits_jit", lambda m, mel: (jnp.asarray(logits),
                                                                jnp.asarray([len(frames)])))
    mel = np.zeros((1, 10, 80), dtype=np.float32)
    got = tm.decode(mel)[0]
    assert_same_result(got, jm.decode(mel)[0])
    assert [t.id for s in got.sentences for t in s.tokens] == [0, 0, 1, 2]


# ---------------------------------------------------------------------------
# the layers on their own
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("normalize", ["per_feature", "all_features"])
def test_log_mel_matches_jax(models, normalize):
    import dataclasses

    args = dataclasses.replace(models["tdt"][1].preprocessor_config, normalize=normalize)
    audio = _audio(4, 12345, 0.3)
    got = log_mel_spectrogram(audio, args)
    want = np.asarray(jax_log_mel(audio, args))
    assert got.shape == want.shape == (1, 78, 80)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("head", ["tdt", "ctc"])
def test_encoder_and_heads_match_jax(models, head):
    """Encoder output and lengths at a batch of 2, then the joint's logits
    (TDT) or the CTC log-probs."""
    jm, tm = models[head]
    mel = np.random.default_rng(5).standard_normal((2, 97, 80)).astype(np.float32)
    jf, jl = jm.encoder(jnp.asarray(mel))
    with torch.no_grad():
        tf, tl = tm.encoder(torch.as_tensor(mel))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), **TOL)
    with torch.no_grad():
        if head == "ctc":
            got, want = tm.decoder(tf), jm.decoder(jf)
        else:
            tok = np.array([3, 7])
            state = tm.decoder.init_state(2)
            use = torch.tensor([True, False])
            pred, _ = tm.decoder.step(torch.as_tensor(tok), state, use)
            jpred, _ = jm.decoder.step(jnp.asarray(tok), jm.decoder.init_state(2),
                                       jnp.asarray([True, False]))
            np.testing.assert_allclose(pred.numpy(), np.asarray(jpred), **TOL)
            got, want = tm.joint(tf[:, 5], pred), jm.joint(jf[:, 5], jpred)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_default_device_is_cuda_and_the_factory_dispatches(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(ctc_config())
    assert type(Model(tdt_config(), device="cpu")).__name__ == "ParakeetTDT"
    m = Model(rnnt_config(), device="cpu")
    assert type(m).__name__ == "ParakeetRNNT" and m.durations == [1]


# ---------------------------------------------------------------------------
# HF-transformers ParakeetForCTC
# ---------------------------------------------------------------------------


def _hf_ctc():
    os.environ.setdefault("USE_TF", "0")
    os.environ.setdefault("USE_FLAX", "0")
    from transformers.models.parakeet import ParakeetCTCConfig, ParakeetEncoderConfig
    from transformers.models.parakeet.modeling_parakeet import ParakeetForCTC

    enc = ParakeetEncoderConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=64, conv_kernel_size=9, num_mel_bins=16,
        subsampling_factor=8, subsampling_conv_channels=8, dropout=0.0,
        attention_dropout=0.0, dropout_positions=0.0, scale_input=False)
    torch.manual_seed(0)
    return ParakeetForCTC(ParakeetCTCConfig(encoder_config=enc.to_dict(),
                                            vocab_size=33)).eval()


def _hf_logp(hf, mel):
    with torch.no_grad():
        t_in = torch.from_numpy(mel)
        return (hf.encoder(input_features=t_in).last_hidden_state.numpy(),
                torch.log_softmax(hf(input_features=t_in).logits, dim=-1).numpy())


def test_parakeet_ctc_matches_hf_transformers():
    """The port's Conformer and CTC head against HF ParakeetForCTC, the
    weights through the port's sanitize_hf_parakeet and params_from_jax:
    encoder states and log-probs within 1e-4."""
    from mlx_audio_tpu_torch.models.stt.parakeet import ParakeetCTC, sanitize_hf_parakeet
    from mlx_audio_tpu_torch.models.stt.parakeet.conformer import ConformerArgs
    from mlx_audio_tpu_torch.models.stt.parakeet.ctc import ConvASRDecoderArgs

    hf = _hf_ctc()
    ours = ParakeetCTC(
        None,
        ConformerArgs(feat_in=16, n_layers=2, d_model=32, n_heads=2,
                      ff_expansion_factor=2, subsampling_factor=8,
                      self_attention_model="rel_pos", subsampling="dw_striding",
                      conv_kernel_size=9, subsampling_conv_channels=8,
                      pos_emb_max_len=5000),
        ConvASRDecoderArgs(feat_in=32, num_classes=-1,
                           vocabulary=[str(i) for i in range(32)]),
        device="cpu")
    sd = {k: v.detach().numpy() for k, v in hf.state_dict().items()}
    ours.load_state_dict(params_from_jax(sanitize_hf_parakeet(sd), ours), strict=True)
    mel = np.random.default_rng(0).standard_normal((1, 64, 16)).astype(np.float32)
    enc_hf, logp_hf = _hf_logp(hf, mel)
    with torch.no_grad():
        enc, _ = ours.encoder(torch.as_tensor(mel))
        logp = ours.decoder(enc)
    assert enc.shape == enc_hf.shape
    np.testing.assert_allclose(enc.numpy(), enc_hf, **TOL)
    np.testing.assert_allclose(logp.numpy(), logp_hf, **TOL)


def test_parakeet_loads_an_hf_checkpoint_directory(tmp_path):
    """The Parakeet half of test_golden_hf.py's directory-load test, through
    the port's own local-directory loader: the vocabulary from the
    directory's tokenizer.json, log-probs equal to HF's within 1e-4."""
    import json

    hf = _hf_ctc()
    hf.save_pretrained(str(tmp_path / "parakeet"), safe_serialization=True)
    vocab33 = [[f"▁tok{i}", -float(i)] for i in range(33)]
    with open(tmp_path / "parakeet" / "tokenizer.json", "w") as f:
        json.dump({"model": {"type": "Unigram", "vocab": vocab33}}, f)
    pm = BaseParakeet.from_pretrained(str(tmp_path / "parakeet"), device="cpu")
    assert pm.vocabulary[:2] == ["▁tok0", "▁tok1"]
    assert len(pm.vocabulary) == 32  # vocab_size - 1 (the blank)
    mel = np.random.default_rng(40).standard_normal((1, 64, 16)).astype(np.float32)
    _, logp_hf = _hf_logp(hf, mel)
    with torch.no_grad():
        feats, _ = pm.encoder(torch.as_tensor(mel))
        logp = pm.decoder(feats)
    np.testing.assert_allclose(logp.numpy(), logp_hf, **TOL)
    with pytest.raises(FileNotFoundError):
        BaseParakeet.from_pretrained(str(tmp_path / "missing"), device="cpu")
