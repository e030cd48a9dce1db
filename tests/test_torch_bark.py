"""Bark in the port against the JAX package, float32 on the CPU: the port
twin of tests/test_bark.py, on its tiny GPTs (``tiny_bark``'s configs) and
the EnCodec of tests/test_torch_encodec.py (LSTMs and codebooks drawn, not
zeros).

The JAX PRNG cannot be reproduced, so tokens are held equal at a
temperature of 1e-6, where both packages take the argmax (fine stage:
``temperature=None``), and each stage's teacher-forced logits to 1e-5.
Sampled runs are held to a one-text batch equal to the single run and to a
repeated seed.
"""

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mlx_audio_tpu.nn.layers as jax_layers
from mlx_audio_tpu.models.tts.bark.bark import Model as JaxBark
from mlx_audio_tpu.models.tts.bark.bark import ModelConfig as JaxModelConfig
from mlx_audio_tpu.models.tts.bark.gpt import GPT as JaxGPT
from mlx_audio_tpu.nn.module import named_arrays
from mlx_audio_tpu_torch.convert import params_from_jax
from mlx_audio_tpu_torch.models.tts.bark import Model, ModelConfig
from mlx_audio_tpu_torch.models.tts.bark.bark import (
    CODEBOOK_SIZE,
    N_COARSE_CODEBOOKS,
    N_FINE_CODEBOOKS,
    SEMANTIC_VOCAB_SIZE,
    _cat_rows,
)
from test_bark import FakeBertTokenizer, tiny_gpt_cfg
from test_torch_encodec import build_jax as build_jax_encodec
from test_torch_encodec import port_of as port_encodec

GREEDY = 1e-6
LOGIT_ATOL = 1e-5


def _configs():
    return dict(semantic_config=tiny_gpt_cfg(129600, 129600),
                coarse_acoustics_config=tiny_gpt_cfg(12096, 12096),
                fine_acoustics_config=tiny_gpt_cfg(1056, 1056, n_codes_total=8,
                                                   n_codes_given=1))


@pytest.fixture(scope="module")
def pair():
    je = build_jax_encodec()
    saved = jax_layers._INIT_RNG
    jax_layers._INIT_RNG = np.random.default_rng(0)
    try:
        jm = JaxBark(JaxModelConfig(**_configs()), codec=je,
                     tokenizer=FakeBertTokenizer())
    finally:
        jax_layers._INIT_RNG = saved
    tm = Model(ModelConfig(**_configs()), codec=port_encodec(je),
               tokenizer=FakeBertTokenizer(), device="cpu")
    named = {k: np.asarray(v) for k, v in named_arrays(jm)}
    tm.load_state_dict(params_from_jax(named, tm), strict=True)
    return jm, tm


def _ids(seed, n, high, offset=0):
    return np.random.default_rng(seed).integers(0, high, size=n) + offset


def test_teacher_forced_logits_match_jax(pair):
    """Semantic and coarse: a right-padded prefill (two rows sharing one
    valid length) then 6 cached steps of given tokens; fine: one forward of
    the first, a middle and the last predicted codebook."""
    jm, tm = pair
    prefill, step = jax.jit(JaxGPT.prefill), jax.jit(JaxGPT.step)
    for stage, vocab in (("semantic", 129600), ("coarse_acoustics", 12096)):
        jg, tg = getattr(jm, stage), getattr(tm, stage)
        prompt = np.stack([_ids(1, 20, vocab), _ids(2, 20, vocab)])
        j_caches = jg.init_cache(2, 40)
        t_caches = tg.init_cache(2, 40)
        lj, j_caches = prefill(jg, j_caches, jg.input_embeds_layer(jnp.asarray(prompt)),
                               jnp.asarray(17, jnp.int32))
        with torch.no_grad():
            lt, t_caches = tg.prefill(
                t_caches, tg.input_embeds_layer(torch.as_tensor(prompt)), 17)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=LOGIT_ATOL, rtol=0)
        for n, tok in enumerate(_ids(3, 6, vocab)):
            col = np.array([[tok], [(tok + 7) % vocab]])
            lj, j_caches = step(jg, j_caches, jnp.asarray(col))
            with torch.no_grad():
                lt, t_caches = tg.step(t_caches, torch.as_tensor(col))
            np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=LOGIT_ATOL,
                                       rtol=0, err_msg=f"{stage} step {n}")
    idx = np.random.default_rng(4).integers(0, 1056, size=(2, 64, 8))
    for pred in (1, 4, N_FINE_CODEBOOKS - 1):
        with torch.no_grad():
            lt = tm.fine_acoustics(pred, torch.as_tensor(idx)).numpy()
        lj = np.asarray(jm.fine_acoustics(pred, jnp.asarray(idx)))
        np.testing.assert_allclose(lt, lj, atol=LOGIT_ATOL, rtol=0)


def test_stage_tokens_match_jax_at_greedy_temperature(pair):
    jm, tm = pair
    texts = ["hello world", "a longer second text"]
    sem_j = jm.generate_text_semantic_batch(texts, temperature=GREEDY, max_steps=24)
    sem_t = tm.generate_text_semantic_batch(texts, temperature=GREEDY, max_steps=24)
    for a, b in zip(sem_t, sem_j):
        np.testing.assert_array_equal(a, b)
        assert len(a) > 0 and (a < SEMANTIC_VOCAB_SIZE).all()
    sems = [_ids(5, 20, SEMANTIC_VOCAB_SIZE).astype(np.int32),
            _ids(6, 14, SEMANTIC_VOCAB_SIZE).astype(np.int32)]
    co_j = jm.generate_coarse_batch(sems, temperature=GREEDY, sliding_window_len=12)
    co_t = tm.generate_coarse_batch(sems, temperature=GREEDY, sliding_window_len=12)
    for a, b in zip(co_t, co_j):
        np.testing.assert_array_equal(a, b)
    assert co_t[0].shape == (N_COARSE_CODEBOOKS, int(20 * 75 / 49.9))
    # a third row of 1100 frames takes the fine stage's long path: two
    # overlapping windows
    long = np.random.default_rng(7).integers(0, CODEBOOK_SIZE, size=(2, 1100)).astype(np.int32)
    fi_j = jm.generate_fine_batch(co_j + [long], temperature=None)
    fi_t = tm.generate_fine_batch(co_t + [long], temperature=None)
    for a, b, c in zip(fi_t, fi_j, co_t + [long]):
        np.testing.assert_array_equal(a, b)
        assert a.shape == (N_FINE_CODEBOOKS, c.shape[1])
        np.testing.assert_array_equal(a[:N_COARSE_CODEBOOKS], c)


def test_generate_batch_codes_and_audio_match_jax(pair, monkeypatch):
    jm, tm = pair
    seen = {"jax": [], "port": []}
    j_decode, t_decode = jm._codec.decode, tm._codec.decode
    monkeypatch.setattr(jm._codec.__class__, "decode", lambda self, c, s, m=None: (
        seen["jax"].append(np.asarray(c)), j_decode(c, s, m))[1])
    monkeypatch.setattr(tm._codec, "decode", lambda c, s, m=None: (
        seen["port"].append(c.numpy()), t_decode(c, s, m))[1])
    texts = ["hi there", "another text"]
    want = jm.generate_batch(texts, temperature=GREEDY, max_steps=24)
    got = tm.generate_batch(texts, temperature=GREEDY, max_steps=24)
    assert len(seen["port"]) == len(seen["jax"]) >= 1
    for a, b in zip(seen["port"], seen["jax"]):
        np.testing.assert_array_equal(a, b)
    for g, w in zip(got, want):
        assert g.samples == w.samples > 0
        np.testing.assert_allclose(g.audio, np.asarray(w.audio), atol=1e-4, rtol=0)


def test_sanitize_gpt2_keys(pair):
    tm = pair[1]
    w = {
        "semantic._orig_mod.transformer.h.0.attn.att_proj.weight": np.zeros((96, 32)),
        "semantic._orig_mod.lm_head.weight": np.zeros((129600, 32)),
        "semantic._orig_mod.transformer.h.0.attn.bias": np.zeros((1, 1, 8, 8)),
        "codec_model.quantizer.layers.0.codebook.embed": np.zeros((1024, 32)),
    }
    out = tm.sanitize(w)
    assert "semantic.layers.0.attn.att_proj.weight" in out
    assert "semantic.lm_head.weight" in out
    assert "_codec.quantizer.layers.0.codebook.embed" in out
    assert not any(k.endswith(".attn.bias") for k in out)


@pytest.mark.parametrize("with_voice", [False, True], ids=["plain", "voice"])
def test_coarse_kv_carry_matches_reprefill(pair, with_voice):
    """Early sliding windows carry their KV caches; tokens must equal those
    of a prefill every window, across a 192-bucket cache growth, and with a
    voice prompt's history (a shorter carry phase)."""
    tm = pair[1]
    rng = np.random.default_rng(8 if with_voice else 7)
    voice = None
    if with_voice:
        voice = {"semantic_prompt": rng.integers(0, SEMANTIC_VOCAB_SIZE, size=40),
                 "coarse_prompt": rng.integers(0, 1024, size=(2, 60)),
                 "fine_prompt": rng.integers(0, 1024, size=(8, 60))}
        sems = [rng.integers(0, SEMANTIC_VOCAB_SIZE, size=48).astype(np.int32)]
        kw = dict(sliding_window_len=12, seed=5)
    else:
        sems = [rng.integers(0, SEMANTIC_VOCAB_SIZE, size=80).astype(np.int32),
                rng.integers(0, SEMANTIC_VOCAB_SIZE, size=64).astype(np.int32)]
        kw = dict(sliding_window_len=16, seed=3)
    base = tm.generate_coarse_batch(sems, voice=voice, temperature=0.7,
                                    kv_carry=False, **kw)
    carried = tm.generate_coarse_batch(sems, voice=voice, temperature=0.7, **kw)
    for a, b in zip(base, carried):
        np.testing.assert_array_equal(a, b)


def test_sampled_one_text_batch_equals_single_run_and_seed_repeats(pair):
    tm = pair[1]
    single = list(tm.generate("sample me", temperature=0.7, seed=4, max_steps=12))[0]
    batch = tm.generate_batch(["sample me"], temperature=0.7, seed=4, max_steps=12)[0]
    again = tm.generate_batch(["sample me"], temperature=0.7, seed=4, max_steps=12)[0]
    other = tm.generate_batch(["sample me"], temperature=0.7, seed=5, max_steps=12)[0]
    assert single.samples > 0
    np.testing.assert_array_equal(batch.audio, single.audio)
    np.testing.assert_array_equal(again.audio, single.audio)
    assert other.samples != single.samples or not np.array_equal(other.audio, single.audio)
    # a row's draws do not depend on the other rows of its batch
    two = tm.generate_text_semantic_batch(["sample me", "x"], temperature=0.7, seed=4,
                                          max_steps=12)
    np.testing.assert_array_equal(
        two[0], tm.generate_text_semantic("sample me", temperature=0.7, seed=4,
                                          max_steps=12))


def test_cat_rows_takes_given_noise():
    """With the noise passed in, a draw is argmax(logits / T + noise)."""
    logits = torch.tensor([[0.0, 1.0, 2.0], [2.0, 1.0, 0.0]])
    noise = torch.tensor([[0.0, 0.0, -5.0], [0.0, 9.0, 0.0]])
    assert _cat_rows(logits, 1.0, noise=noise).tolist() == [1, 1]
