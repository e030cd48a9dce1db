"""Dia in the port against the JAX package, float32 on the CPU: the port
twin of tests/test_dia.py, at its tiny configs.

Weights cross with ``convert.params_from_jax`` (Dia's ``DenseGeneral``
weights keep their JAX layout) and load strictly.  Greedy codes (temperature
0) of ``_generate`` and ``generate_batch`` are held equal to the JAX
package's, the encoder output and the teacher-forced decoder logits to atol
1e-4 / rtol 1e-4, the audio to atol 1e-4.  The JAX PRNG cannot be
reproduced, so sampled runs are held to the port's own properties: a
one-text batch equals the single run, and a seed repeats.  The JAX init RNG
is reset for each model built here.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mlx_audio_tpu.models.tts.dia.model as jax_dia
import mlx_audio_tpu.nn.layers as jax_layers
from mlx_audio_tpu.models.tts.dia.audio import apply_audio_delay as jax_apply_delay
from mlx_audio_tpu.models.tts.dia.audio import revert_audio_delay as jax_revert_delay
from mlx_audio_tpu.nn.module import named_arrays
from mlx_audio_tpu_torch.codec.dac import DAC, DACConfig
from mlx_audio_tpu_torch.convert import params_from_jax
from mlx_audio_tpu_torch.models.tts import dia
from mlx_audio_tpu_torch.models.tts.dia import DiaConfig, Model
from mlx_audio_tpu_torch.models.tts.dia.audio import (
    apply_audio_delay,
    codebook_to_audio,
    codebook_to_audio_batch,
    revert_audio_delay,
)
from mlx_audio_tpu_torch.models.tts.dia.layers import DenseGeneral
from mlx_audio_tpu_torch.models.tts.dia.model import _trim_cross, sanitize_hf_dia
from test_dia import tiny_dia

AUDIO_ATOL = 1e-4
TOL = dict(atol=1e-4, rtol=1e-4)
TEXT = "[S1] hi [S2] hello"
BATCH_TEXTS = ["[S1] short one [S2] ok", "[S1] reply [S2] fine", "[S1] three"]


def _seeded(build):
    saved = jax_layers._INIT_RNG
    jax_layers._INIT_RNG = np.random.default_rng(0)
    try:
        return build()
    finally:
        jax_layers._INIT_RNG = saved


def _carry(jax_module, port_module):
    named = {k: np.asarray(v) for k, v in named_arrays(jax_module)}
    port_module.load_state_dict(params_from_jax(named, port_module), strict=True)
    return port_module


def port_config(cfg) -> DiaConfig:
    return DiaConfig.load_dict(dataclasses.asdict(cfg))


def port_pair(jm):
    jd = jm._dac
    td = _carry(jd, DAC(DACConfig(**vars(jd.config)), device="cpu"))
    tm = Model(port_config(jm.config), dac_model=td, device="cpu")
    _carry(jm.model, tm.model)
    return tm


@pytest.fixture(scope="module")
def dias():
    jm = _seeded(tiny_dia)
    return jm, port_pair(jm)


def _capture(monkeypatch, name):
    """Record the codes each model hands to ``name`` (codebook_to_audio or
    codebook_to_audio_batch) of its model module."""
    seen = {"jax": [], "port": []}
    for module, key in ((jax_dia, "jax"), (dia.model, "port")):
        fn = getattr(module, name)
        monkeypatch.setattr(module, name, lambda codes, *a, f=fn, k=key, **kw:
                            (seen[k].append(codes), f(codes, *a, **kw))[1])
    return seen


def test_delay_roundtrip_matches_jax():
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 1024, size=(2, 40, 4)).astype(np.int64)
    delay = [0, 2, 3, 5]
    got = apply_audio_delay(torch.as_tensor(codes), 1025, 1026, delay)
    ref = jax_apply_delay(jnp.asarray(codes), pad_value=1025, bos_value=1026,
                          delay_pattern=delay)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    back = revert_audio_delay(got, 0, delay, t_orig=40)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jax_revert_delay(ref, pad_value=0,
                                                  delay_pattern=delay, t_orig=40)))
    np.testing.assert_array_equal(back.numpy()[:, :35], codes[:, :35])


def test_text_input_and_split_turns_match_jax(dias):
    jm, tm = dias
    for text in ("[S1] hi", TEXT + " é", "x" * 100):
        for got, ref in zip(tm._prepare_text_input(text), jm._prepare_text_input(text)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    text = "[S1] a [S2] b [S1] c [S2] d [S1] e [S2] f"
    assert tm._split_turns(text) == jm._split_turns(text)
    assert tm._split_turns(TEXT) == jm._split_turns(TEXT)


def _encoded(jm, tm, text):
    src, pos, _, mask = jm._prepare_text_input(text)
    ref = jm.model.encoder(src, pos, mask)
    tsrc, tpos, _, tmask = tm._prepare_text_input(text)
    with torch.no_grad():
        got = tm.model.encoder(tsrc, tpos, tmask)
    return got, ref


def test_encoder_matches_jax(dias):
    got, ref = _encoded(*dias, TEXT)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_decoder_logits_teacher_forced_match_jax(dias):
    """Codes fed one step at a time through the cached decoder (2 rows,
    uncond and cond, the cross keys trimmed to their bucket; the port's
    state from ``Model._start``, as its entry points build it): the logits
    of every step equal the JAX package's within atol/rtol 1e-4."""
    jm, tm = dias
    c = jm.config.data.channels
    frames = np.random.default_rng(3).integers(0, 1024, size=(10, 2, c))
    src, pos, pad, mask = jm._prepare_text_input(TEXT)
    src2 = jnp.concatenate([jnp.zeros_like(src), src])
    pos2, pad2, mask2 = (jnp.concatenate([a, a]) for a in (pos, pad, mask))
    _, jkv = jax_dia._encode_text_jit(jm.model, src2, pos2, mask2)
    jkv, jca = jax_dia._trim_cross(jkv, pad2)
    jcache = jm.model.decoder.init_cache(2, 32)
    tcache, tkv, tca, tlast = tm._start([TEXT], 32)
    assert torch.equal(tlast, torch.full((2, c), jm.config.data.audio_bos_value))
    for step, frame in enumerate(frames):
        ref, jcache = jm.model.decoder.step(
            jnp.asarray(frame)[:, None], jnp.asarray([[step]]), jcache, jkv, None, jca)
        with torch.no_grad():
            got, _ = tm.model.decoder.step(
                torch.as_tensor(frame)[:, None], torch.tensor([[step]]), tcache,
                tkv, None, tca)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL, err_msg=str(step))
    assert tcache[0].idx == len(frames)


def test_trimmed_cross_keys_are_exact(dias):
    """Slicing the masked pad keys off the cross attention (to the
    64-bucket of the real text) leaves the decoder's logits bit for bit."""
    jm, tm = dias
    tm_cfg = port_config(jm.config)
    tm_cfg.data.text_length = 256
    model = Model(tm_cfg, dac_model=tm._dac, device="cpu")
    src, pos, pad, mask = model._prepare_text_input(TEXT)
    _, kv = dia.model._encode_text(model.model, src, pos, mask)
    trimmed, ca = _trim_cross(kv, pad)
    assert trimmed[0][0].shape[2] == 64 and ca.shape[-1] == 64
    full_ca = pad[:, None, None, :]
    frame = torch.full((1, 1, tm_cfg.data.channels), 1026)
    outs = []
    for keys, m in ((trimmed, ca), (kv, full_ca)):
        caches = model.model.decoder.init_cache(1, 8)
        with torch.no_grad():
            outs.append(model.model.decoder.step(frame, torch.tensor([[0]]), caches,
                                                 keys, None, m)[0])
    assert torch.equal(outs[0], outs[1])


def test_generate_greedy_matches_jax(dias, monkeypatch):
    """Greedy _generate: the codes handed to the DAC equal the JAX
    package's, the audio within atol 1e-4."""
    jm, tm = dias
    seen = _capture(monkeypatch, "codebook_to_audio")
    ref, ref_n = jm._generate(TEXT, max_tokens=40, temperature=0.0)
    got, got_n = tm._generate(TEXT, max_tokens=40, temperature=0.0)
    assert got_n == ref_n
    np.testing.assert_array_equal(seen["port"][0], seen["jax"][0])
    assert got.shape == np.asarray(ref).shape and got.size > 0
    np.testing.assert_allclose(got, np.asarray(ref), atol=AUDIO_ATOL, rtol=0)


def test_generate_batch_greedy_matches_jax(dias, monkeypatch):
    """Greedy generate_batch of three texts: codes equal to the JAX
    package's batch, and to the single greedy runs."""
    jm, tm = dias
    seen = _capture(monkeypatch, "codebook_to_audio_batch")
    kw = dict(max_tokens=30, temperature=0.0)
    ref = jm.generate_batch(BATCH_TEXTS, **kw)
    got = tm.generate_batch(BATCH_TEXTS, **kw)
    assert len(seen["port"][0]) == len(seen["jax"][0]) == 3
    for g, r in zip(seen["port"][0], seen["jax"][0]):
        np.testing.assert_array_equal(g, r)
    for g, r in zip(got, ref):
        assert g.token_count == r.token_count
        np.testing.assert_allclose(g.audio, np.asarray(r.audio), atol=AUDIO_ATOL, rtol=0)
    seen_single = _capture(monkeypatch, "codebook_to_audio")
    for text, codes in zip(BATCH_TEXTS, seen["port"][0]):
        tm._generate(text, **kw)
        np.testing.assert_array_equal(seen_single["port"][-1], codes)


def test_batched_dac_matches_per_row(dias):
    tm = dias[1]
    delay = tm.config.data.delay_pattern
    c = tm.config.data.channels
    rng = np.random.default_rng(5)
    rows = [rng.integers(0, 1026, size=(c, t)).astype(np.int32) for t in (40, 40, 52)]
    batched = codebook_to_audio_batch(rows, tm._dac, delay, c=c)
    for row, got in zip(rows, batched):
        ref = codebook_to_audio(row, tm._dac, delay, c=c)
        assert got.shape == ref.shape and got.size > 0
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_encoder_bucket_exact(temperature):
    """The encoder bucketed to the longest real text (128) gives the same
    codes, bit for bit, as the full 512 positions."""
    tm = port_pair(_seeded(tiny_dia))
    tm.config.data.text_length = 512
    texts = ["[S1] short one [S2] ok", "[S1] reply [S2] fine"]
    kw = dict(max_tokens=16, temperature=temperature, seed=3)
    bucketed = tm.generate_batch(texts, **kw)
    full = tm.generate_batch(texts, _encoder_bucket=512, **kw)
    for a, b in zip(bucketed, full):
        np.testing.assert_array_equal(a.audio, b.audio)


def test_sampled_batch_of_one_equals_single_and_seed_repeats(dias, monkeypatch):
    tm = dias[1]
    seen = _capture(monkeypatch, "codebook_to_audio")
    batch_seen = _capture(monkeypatch, "codebook_to_audio_batch")
    kw = dict(max_tokens=30, temperature=1.3, seed=7)
    single = tm._generate(TEXT, **kw)[0]
    again = tm._generate(TEXT, **kw)[0]
    np.testing.assert_array_equal(seen["port"][0], seen["port"][1])
    np.testing.assert_array_equal(single, again)
    other = tm._generate(TEXT, max_tokens=30, temperature=1.3, seed=8)[0]
    assert not np.array_equal(seen["port"][2], seen["port"][0])
    one = tm.generate_batch([TEXT], **kw)[0]
    np.testing.assert_array_equal(batch_seen["port"][0][0], seen["port"][0])
    np.testing.assert_array_equal(one.audio, single)
    # a text's draws do not depend on the texts after it in the batch
    two = tm.generate_batch([TEXT, "[S1] another [S2] text"], **kw)
    np.testing.assert_array_equal(batch_seen["port"][1][0], seen["port"][0])
    assert other.shape[0] > 0 and two[0].samples == one.samples


def test_voice_clone_long_prompt_matches_jax(dias, monkeypatch):
    """A reference longer than max_tokens frames: the cache holds BOS,
    prompt and generation, the prompt's frames are not output, and the
    greedy codes equal the JAX package's."""
    jm, tm = dias
    seen = _capture(monkeypatch, "codebook_to_audio")
    sr = tm.config.model.sample_rate
    ref_audio = (np.random.default_rng(0).standard_normal(sr) * 0.1).astype(np.float32)
    kw = dict(max_tokens=10, temperature=0.0, ref_audio=ref_audio, ref_text="[S1] ref")
    ref = list(jm.generate("[S1] hi", **kw))
    got = list(tm.generate("[S1] hi", **kw))
    assert len(got) == len(ref) == 1
    np.testing.assert_array_equal(seen["port"][0], seen["jax"][0])
    n_prompt = -(-sr // tm._dac.hop_length)
    assert seen["port"][0].shape[1] < n_prompt
    assert got[0].samples < sr // 2
    np.testing.assert_allclose(got[0].audio, np.asarray(ref[0].audio),
                               atol=AUDIO_ATOL, rtol=0)


def test_generate_end_to_end(dias):
    tm = dias[1]
    results = list(tm.generate("[S1] hi [S2] hello\n[S1] two", max_tokens=40,
                               temperature=1.0, seed=0))
    assert [r.segment_idx for r in results] == [0, 1]
    for r in results:
        assert r.samples > 0 and np.isfinite(r.audio).all()
        assert r.sample_rate == 16000


def _hf_dia_weights(cfg, seed=0):
    """A synthetic HF-transformers key set for the config's shapes."""
    rng = np.random.default_rng(seed)
    enc, dec = cfg.model.encoder, cfg.model.decoder
    ch, v = cfg.data.channels, cfg.model.tgt_vocab_size

    def w(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    out = {"model.encoder.embedding.weight": w(cfg.model.src_vocab_size, enc.n_embd),
           "model.encoder.norm.weight": w(enc.n_embd),
           "model.decoder.embeddings.embed.weight": w(ch * v, dec.n_embd),
           "model.decoder.norm.weight": w(dec.n_embd),
           "model.logits_dense.weight": w(ch * v, dec.n_embd)}
    for i in range(enc.n_layer):
        p = f"model.encoder.layers.{i}."
        out[p + "self_attention.q_proj.weight"] = w(enc.n_head * enc.head_dim, enc.n_embd)
        out[p + "self_attention.k_proj.weight"] = w(enc.n_head * enc.head_dim, enc.n_embd)
        out[p + "self_attention.v_proj.weight"] = w(enc.n_head * enc.head_dim, enc.n_embd)
        out[p + "self_attention.o_proj.weight"] = w(enc.n_embd, enc.n_head * enc.head_dim)
        out[p + "mlp.gate_up_proj.weight"] = w(2 * enc.n_hidden, enc.n_embd)
        out[p + "mlp.down_proj.weight"] = w(enc.n_embd, enc.n_hidden)
        out[p + "pre_sa_norm.weight"] = w(enc.n_embd)
        out[p + "post_sa_norm.weight"] = w(enc.n_embd)
    for i in range(dec.n_layer):
        p = f"model.decoder.layers.{i}."
        q, kv = dec.gqa_query_heads * dec.gqa_head_dim, dec.kv_heads * dec.gqa_head_dim
        cq = dec.cross_query_heads * dec.cross_head_dim
        out[p + "self_attention.q_proj.weight"] = w(q, dec.n_embd)
        out[p + "self_attention.k_proj.weight"] = w(kv, dec.n_embd)
        out[p + "self_attention.v_proj.weight"] = w(kv, dec.n_embd)
        out[p + "self_attention.o_proj.weight"] = w(dec.n_embd, q)
        out[p + "cross_attention.q_proj.weight"] = w(cq, dec.n_embd)
        out[p + "cross_attention.k_proj.weight"] = w(cq, enc.n_embd)
        out[p + "cross_attention.v_proj.weight"] = w(cq, enc.n_embd)
        out[p + "cross_attention.o_proj.weight"] = w(dec.n_embd, cq)
        out[p + "mlp.gate_up_proj.weight"] = w(2 * dec.n_hidden, dec.n_embd)
        out[p + "mlp.down_proj.weight"] = w(dec.n_embd, dec.n_hidden)
        for n in ("pre_sa_norm", "pre_ca_norm", "pre_mlp_norm"):
            out[p + n + ".weight"] = w(dec.n_embd)
    return out


def test_sanitize_hf_dia_matches_jax_and_loads(dias):
    """sanitize_hf_dia maps a synthetic HF key set as the JAX package's
    does, key for key and value for value; the result crosses
    params_from_jax untransposed and loads strictly."""
    jm, tm = dias
    weights = _hf_dia_weights(jm.config)
    got = sanitize_hf_dia(weights, tm.config)
    ref = jax_dia.sanitize_hf_dia(weights, jm.config)
    assert sorted(got) == sorted(ref) == sorted(tm.sanitize(weights))
    for k in ref:
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)
    assert sorted(got) == sorted("model." + k for k in tm.model.state_dict())
    fresh = Model(tm.config, dac_model=tm._dac, device="cpu")
    state = params_from_jax({k[len("model."):]: v for k, v in got.items()}, fresh.model)
    fresh.model.load_state_dict(state, strict=True)
    q = fresh.model.decoder.layers[0].self_attention.q_proj.weight
    np.testing.assert_array_equal(
        q.numpy(), weights["model.decoder.layers.0.self_attention.q_proj.weight"].T
        .reshape(q.shape))
    nari = {"decoder.norm.weight": np.ones(2), "model.encoder.norm.weight": np.ones(2)}
    assert sorted(tm.sanitize(nari)) == sorted(jm.sanitize(nari))


def test_dense_general_keeps_the_jax_layout(dias):
    """Every DenseGeneral weight of the carried model is the JAX array, not
    transposed: [D, H, hd], [H, hd, D], [D, 2, hidden], [D, C, V]."""
    jm, tm = dias
    named = dict(named_arrays(jm.model))
    state = tm.model.state_dict()
    dense = [n for n, m in tm.model.named_modules() if isinstance(m, DenseGeneral)]
    assert any(state[n + ".weight"].ndim == 3 for n in dense)
    for n in dense:
        np.testing.assert_array_equal(state[n + ".weight"].numpy(),
                                      np.asarray(named[n + ".weight"]))


def test_dac_path_loads_a_local_path_only(dias, tmp_path):
    tm = dias[1]
    m = Model(tm.config, dac_model=str(tmp_path / "missing"), device="cpu")
    with pytest.raises(FileNotFoundError):
        m._get_dac()


def test_default_device_is_cuda(monkeypatch):
    """Built with no device argument, the model asks for the card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(port_config(tiny_dia().config), dac_model=object())
