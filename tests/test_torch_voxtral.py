"""Voxtral in the port against the JAX package, float32 on the CPU: the port
twin of the Voxtral tests of tests/test_wav2vec_voxtral.py (at their tiny
configs) and of tests/test_golden_hf.py's Voxtral test (a tiny HF model
built from a config, offline).

Weights cross with ``convert.params_from_jax`` and
``load_state_dict(strict=True)``; a quantized pair is quantized after the
crossing, each package by its own ``quantize_model``, which give equal
codes.  The tiny LMs' tied embeddings are scaled by 0.05, as the LM twins
do (at the init's scale a tied tiny LM echoes the token it was fed).
Greedy tokens are held equal to the JAX package's, audio embeddings and spliced input
embeddings to atol and rtol 1e-5 (JAX's matmuls at "highest" precision).
The JAX PRNG cannot be reproduced, so sampled rows are held to the port's
own properties.  A file path is read as the JAX package reads it.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mlx_audio_tpu.nn.layers as jax_layers
from mlx_audio_tpu.models.stt.voxtral import voxtral as jvox
from mlx_audio_tpu.nn.module import named_arrays, update_arrays
from mlx_audio_tpu.nn.quantize import quantize_model as jax_quantize_model
from mlx_audio_tpu_torch.convert import params_from_jax
from mlx_audio_tpu_torch.models.stt.voxtral import voxtral
from mlx_audio_tpu_torch.nn import kernels
from mlx_audio_tpu_torch.nn.quantize import QuantizedLinear, quantize_model
from test_wav2vec_voxtral import FakeTok

TOL = dict(atol=1e-5, rtol=1e-5)
EMBED_SCALE = 0.05
AUDIO = dict(num_mel_bins=80, d_model=32, encoder_layers=2, encoder_attention_heads=4,
             encoder_ffn_dim=64, intermediate_size=128, max_source_positions=512)
TEXT = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, head_dim=8,
            max_position_embeddings=1024, tie_word_embeddings=True)


def _hi(fn, *a, **kw):
    with jax.default_matmul_precision("highest"):
        return fn(*a, **kw)


def pair_of(audio=AUDIO, text=TEXT, audio_token_id=24, bits=None):
    cfg = dict(audio_config=audio, text_config=text, audio_token_id=audio_token_id)
    saved = jax_layers._INIT_RNG
    jax_layers._INIT_RNG = np.random.default_rng(0)
    try:
        jm = jvox.Model(jvox.ModelConfig(**cfg), tokenizer=FakeTok())
    finally:
        jax_layers._INIT_RNG = saved
    if text["tie_word_embeddings"]:
        emb = "language_model.embed_tokens.weight"
        jm = update_arrays(jm, {emb: np.asarray(dict(named_arrays(jm))[emb]) * EMBED_SCALE})
    pm = voxtral.Model(cfg, tokenizer=FakeTok(), device="cpu")
    named = {k: np.asarray(v) for k, v in named_arrays(jm)}
    pm.load_state_dict(params_from_jax(named, pm), strict=True)
    if bits:
        jax_quantize_model(jm, group_size=16, bits=bits)
        quantize_model(pm, group_size=16, bits=bits)
    return jm, pm


def _audio(seed, seconds):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(int(seconds * 16000)) * 0.1).astype(np.float32)


def _generate_both(jm, pm, audio, **kw):
    oj = _hi(jm.generate, audio, temperature=0.0, eos_token_ids=(2,), **kw)
    op = pm.generate(audio, temperature=0.0, eos_token_ids=(2,), **kw)
    assert [s["tokens"] for s in op.segments] == [s["tokens"] for s in oj.segments]
    assert op.text == oj.text and op.language == oj.language == "en"
    return oj, op


@pytest.fixture(scope="module")
def pair():
    return pair_of()


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
def test_transcribe_end_to_end_matches_jax(pair, tied):
    """The tests' tied tiny LM (it settles on one token), and Voxtral-Mini's
    untied head, under which the greedy tokens vary."""
    jm, pm = pair if tied else pair_of(text=dict(TEXT, tie_word_embeddings=False))
    _, op = _generate_both(jm, pm, _audio(1, 1.0), max_tokens=12)
    toks = op.segments[0]["tokens"]
    assert len(toks) == 12 and (tied or len(set(toks)) > 4)


def test_int4_quantized_transcribe_matches_jax(monkeypatch):
    """Weight-only int4 (packed codes, groups of 16) over the whole model:
    the codes equal the JAX package's, the greedy tokens too, and every
    decode step's projections and head go to quantized_matmul (its plain
    version here) at one row."""
    jm, pm = pair_of(bits=4)
    qlin = [m for m in pm.modules() if isinstance(m, QuantizedLinear)]
    assert qlin and all(q.packed for q in qlin)
    got = pm.state_dict()
    want = params_from_jax({k: np.asarray(v) for k, v in named_arrays(jm)}, pm)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=k)
    calls = []
    qmm = kernels.quantized_matmul

    def counting(x, codes, *a, **kw):
        calls.append((x.shape[0], codes.shape[0]))
        return qmm(x, codes, *a, **kw)

    monkeypatch.setattr(kernels, "quantized_matmul", counting)
    _, op = _generate_both(jm, pm, _audio(1, 1.0), max_tokens=8)
    n = len(op.segments[0]["tokens"])
    heads = [c for c in calls if c == (1, TEXT["vocab_size"])]
    # the head at the prompt's last position, then 7 projections a layer
    # and the head a decode step, at one row
    assert n == 8 and len(heads) == n
    assert len(calls) == n + (n - 1) * 7 * TEXT["num_hidden_layers"]


def test_audio_embed_splice_matches_jax():
    jm, pm = pair_of(audio=dict(AUDIO, encoder_layers=1, intermediate_size=64,
                                max_source_positions=256),
                     text=dict(vocab_size=64, hidden_size=16, intermediate_size=32,
                               num_hidden_layers=1, num_attention_heads=2,
                               num_key_value_heads=2, head_dim=8, tie_word_embeddings=True),
                     audio_token_id=5)
    mel = (np.random.default_rng(2).standard_normal((1, 100, 80)) * 0.5).astype(np.float32)
    n_audio = (100 // 2) // (64 // 32)
    ids = np.asarray([[1] + [5] * n_audio + [2]])
    want = np.asarray(_hi(jm.merge_input_embeddings, jnp.asarray(ids), jnp.asarray(mel)))
    got = pm.merge_input_embeddings(torch.as_tensor(ids), torch.as_tensor(mel)).numpy()
    assert got.shape == (1, n_audio + 2, 16)
    np.testing.assert_allclose(got, want, **TOL)
    text_emb = pm.language_model.embed_tokens.weight.detach().numpy()
    np.testing.assert_array_equal(got[0, 0], text_emb[1])
    audio = pm.get_audio_embeds(torch.as_tensor(mel)).detach().numpy()
    np.testing.assert_array_equal(got[0, 1:-1], audio)


def test_long_audio_windows_match_jax():
    """4 s at a window of 128 frames: four windows decoded as one batch,
    each window's tokens equal."""
    jm, pm = pair_of(audio=dict(AUDIO, max_source_positions=64))
    _, op = _generate_both(jm, pm, _audio(2, 4.0), max_tokens=6)
    assert len(op.segments) == 4


def test_sampled_rows_do_not_depend_on_the_batch(pair):
    """A sampled decode: a window's row equals its one-window decode, a
    seed repeats, another seed differs."""
    pm = pair[1]
    mels = torch.stack([pm._prepare_inputs(_audio(s, 1.0))[0] for s in (3, 4)])
    ids = pm._ids_for_window()
    kw = dict(max_tokens=10, temperature=0.8, top_p=0.95, top_k=0, eos_token_ids=(2,))
    two = pm._decode_window_rows(mels, ids, seed=5, **kw)
    one = pm._decode_window_rows(mels[:1], ids, seed=5, **kw)
    again = pm._decode_window_rows(mels[:1], ids, seed=5, **kw)
    other = pm._decode_window_rows(mels[:1], ids, seed=6, **kw)
    assert two[0] == one[0] == again[0] and len(one[0]) == 10
    assert other[0] != one[0]


def test_file_path_reads_as_jax_loads_it(pair, tmp_path):
    """A 24 kHz wav path is read through utils/audio_io and resampled to
    16 kHz, in the port as in the JAX package: the greedy tokens and text
    equal; a non-wav path raises the reference's gated error."""
    from mlx_audio_tpu_torch.utils.audio_io import save_audio

    wav = tmp_path / "x.wav"
    save_audio(str(wav), _audio(0, 1.5), 24000)
    jm, pm = pair
    _, op = _generate_both(jm, pm, str(wav), max_tokens=4)
    assert len(op.segments[0]["tokens"]) == 4
    with pytest.raises(RuntimeError, match="soundfile"):
        pm.generate(str(tmp_path / "x.flac"), max_tokens=2)


def test_weights_cross_strict_and_configs_match_jax(pair, monkeypatch):
    jm, pm = pair
    assert set(dict(named_arrays(jm))) == set(pm.state_dict())
    w = np.asarray(dict(named_arrays(jm))["audio_tower.conv1.weight"])
    np.testing.assert_array_equal(pm.audio_tower.conv1.weight.numpy(), w.transpose(2, 1, 0))
    # the published text config leaves head_dim unset: 3072 / 32 = 96, as
    # the JAX package derives it; Voxtral-Mini-3B's is 128, given explicitly
    for extra in ({}, {"head_dim": 128}):
        got = voxtral.TextConfig(**extra).to_llama()
        want = jvox.TextConfig(**extra).to_llama()
        for f in ("head_dim", "hidden_size", "num_hidden_layers", "num_key_value_heads",
                  "vocab_size", "rope_theta", "max_position_embeddings",
                  "tie_word_embeddings"):
            assert getattr(got, f) == getattr(want, f), f
    assert voxtral.TextConfig().to_llama().head_dim == 96
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        voxtral.Model(dict(audio_config=AUDIO, text_config=TEXT))


def test_voxtral_matches_hf_transformers():
    """The audio tower, projector and spliced LM forward against HF's
    VoxtralForConditionalGeneration, loaded through sanitize and
    params_from_jax: audio embeddings and logits."""
    os.environ.setdefault("USE_TF", "0")
    os.environ.setdefault("USE_FLAX", "0")
    from transformers import LlamaConfig as HFLlamaConfig
    from transformers.models.voxtral import VoxtralConfig
    from transformers.models.voxtral.configuration_voxtral import VoxtralEncoderConfig
    from transformers.models.voxtral.modeling_voxtral import VoxtralForConditionalGeneration

    ac = VoxtralEncoderConfig(vocab_size=64, hidden_size=32, intermediate_size=64,
                              num_hidden_layers=2, num_attention_heads=2, num_mel_bins=16,
                              max_source_positions=64, dropout=0.0, attention_dropout=0.0,
                              activation_dropout=0.0)
    tc = HFLlamaConfig(vocab_size=96, hidden_size=16, intermediate_size=32,
                       num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1,
                       head_dim=8, max_position_embeddings=128, rope_theta=1e4,
                       rms_norm_eps=1e-5, attention_bias=False, mlp_bias=False,
                       tie_word_embeddings=False)
    torch.manual_seed(0)
    hf = VoxtralForConditionalGeneration(VoxtralConfig(
        audio_config=ac.to_dict(), text_config=tc.to_dict(), audio_token_id=90)).eval()
    pm = voxtral.Model({
        "audio_config": {"num_mel_bins": 16, "d_model": 32, "encoder_layers": 2,
                         "encoder_attention_heads": 2, "encoder_ffn_dim": 64,
                         "intermediate_size": 64, "max_source_positions": 64},
        "text_config": {"vocab_size": 96, "hidden_size": 16, "intermediate_size": 32,
                        "num_hidden_layers": 2, "num_attention_heads": 2,
                        "num_key_value_heads": 1, "head_dim": 8,
                        "max_position_embeddings": 128, "rope_theta": 1e4,
                        "rms_norm_eps": 1e-5, "tie_word_embeddings": False},
        "audio_token_id": 90}, device="cpu")
    sd = {k: v.detach().numpy() for k, v in hf.state_dict().items() if "rotary_emb" not in k}
    state = params_from_jax(pm.sanitize(sd), pm)
    missing, unexpected = pm.load_state_dict(state, strict=False)
    assert not unexpected and all("rope_" in k for k in missing)

    mel = np.random.default_rng(3).standard_normal((1, 16, 128)).astype(np.float32)
    with torch.no_grad():
        ae_hf = hf.get_audio_features(torch.as_tensor(mel)).numpy()
        ae = pm.get_audio_embeds(torch.as_tensor(mel.transpose(0, 2, 1))).numpy()
        assert ae.shape == ae_hf.shape
        np.testing.assert_allclose(ae, ae_hf, **TOL)
        ids = np.concatenate([np.array([1, 5, 7]), np.full(ae_hf.shape[0], 90),
                              np.array([9, 11, 2])]).astype(np.int64)[None]
        logits_hf = hf(input_ids=torch.as_tensor(ids),
                       input_features=torch.as_tensor(mel)).logits.numpy()
        embeds = pm.merge_input_embeddings(torch.as_tensor(ids),
                                           torch.as_tensor(mel.transpose(0, 2, 1)))
        logits = pm.lm_logits(pm.language_model(embeds)).numpy()
    np.testing.assert_allclose(logits, logits_hf, **TOL)
