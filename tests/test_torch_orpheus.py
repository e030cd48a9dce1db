"""Orpheus and the causal-LM loop in the port against the JAX package,
float32 on the CPU: the port twin of tests/test_orpheus.py, at its tiny
configs.

Weights cross with ``convert.params_from_jax``.  Greedy tokens are held
equal to the JAX package's, from ``generate_tokens`` and from
``generate_tokens_batch``; Orpheus's SNAC codes equal and its audio within
atol 1e-4 (the tiny SNAC has no noise).  The JAX PRNG cannot be reproduced,
so sampled runs are held to their own properties (budget, vocabulary, a
batch of one equal to the single-prompt run).  The JAX init RNG is reset
for each model built here, and the LMs' embeddings scaled by 0.05, so that
greedy decoding does not collapse to one repeated token.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mlx_audio_tpu.models.tts.llama.llama as jax_orpheus
import mlx_audio_tpu.nn.layers as jax_layers
from mlx_audio_tpu.models.lm.causal import LlamaForCausalLM as JaxLM
from mlx_audio_tpu.models.lm.causal import generate_tokens as jax_generate_tokens
from mlx_audio_tpu.models.lm.causal import generate_tokens_batch as jax_generate_tokens_batch
from mlx_audio_tpu.models.lm.llama import LlamaConfig as JaxLlamaConfig
from mlx_audio_tpu.nn.module import named_arrays
from mlx_audio_tpu.nn.quantize import quantize_model as jax_quantize_model
from mlx_audio_tpu_torch.codec.dac import DAC
from mlx_audio_tpu_torch.codec.snac import SNAC, SNACConfig
from mlx_audio_tpu_torch.convert import params_from_jax
from mlx_audio_tpu_torch.models.lm import causal
from mlx_audio_tpu_torch.models.lm.causal import (
    LlamaForCausalLM,
    generate_tokens,
    generate_tokens_batch,
)
from mlx_audio_tpu_torch.models.lm.llama import LlamaConfig
from mlx_audio_tpu_torch.models.tts import llama as orpheus
from mlx_audio_tpu_torch.models.tts.llama import (
    Model,
    ModelConfig,
    decode_audio_from_codes,
    encode_audio_to_codes,
)
from mlx_audio_tpu_torch.models.tts.llama.llama import (
    AUDIO_MARK,
    CODE_OFFSET,
    EOH,
    EOT,
    SOH,
    STOP_AUDIO,
)
from mlx_audio_tpu_torch.nn import kernels
from mlx_audio_tpu_torch.nn.quantize import quantize_model
from test_orpheus import FakeTokenizer, tiny_model

AUDIO_ATOL = 1e-4
LM = dict(num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
          head_dim=8, hidden_size=32, intermediate_size=64, rms_norm_eps=1e-5,
          vocab_size=96, max_position_embeddings=512, tie_word_embeddings=True)
EMBED_SCALE = 0.05


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


@pytest.fixture(scope="module")
def lms():
    jm = _seeded(lambda: JaxLM(JaxLlamaConfig(**LM)))
    jm.model.embed_tokens.weight = jm.model.embed_tokens.weight * EMBED_SCALE
    return jm, _carry(jm, LlamaForCausalLM(LlamaConfig(**LM)))


def _single(gen, lm, prompt, **kw):
    return [t for c in gen(lm, prompt, **kw) for t in c.tolist()]


PROMPTS = [np.arange(5), np.arange(3, 70) % 96, np.arange(40, 52)]


@pytest.mark.parametrize("penalty", [1.0, 1.3])
def test_generate_tokens_matches_jax_greedy(lms, penalty):
    jm, tm = lms
    kw = dict(max_tokens=40, temperature=0.0, repetition_penalty=penalty,
              repetition_context_size=8, chunk=16)
    for p in PROMPTS:
        ref = _single(jax_generate_tokens, jm, p, **kw)
        assert _single(generate_tokens, tm, p, **kw) == ref
        assert len(ref) == 40


def test_generate_tokens_batch_matches_jax_greedy(lms):
    """Ragged prompts, penalty 1.3, and a stop token that the first row
    emits in the middle of a chunk: rows equal to the JAX package's batch
    and to their single-prompt runs."""
    jm, tm = lms
    kw = dict(max_tokens=40, temperature=0.0, repetition_penalty=1.3,
              repetition_context_size=8, chunk=8)
    row0 = _single(jax_generate_tokens, jm, PROMPTS[0], **kw)
    # row 0's first new token in the middle of a chunk
    at = next(i for i, t in enumerate(row0)
              if i % kw["chunk"] not in (0, 1) and t not in row0[:i])
    kw["stop_tokens"] = (row0[at],)
    ref = [o.tolist() for o in jax_generate_tokens_batch(jm, PROMPTS, **kw)]
    got = [o.tolist() for o in generate_tokens_batch(tm, PROMPTS, **kw)]
    assert got == ref
    assert got[0] == row0[:at]
    assert got == [_single(generate_tokens, tm, p, **kw) for p in PROMPTS]


def test_batch_of_one_equals_single_sampled(lms):
    """Sampled (temp 0.6, top-p 0.8, penalty 1.3): a one-prompt batch takes
    the single-prompt run's seeds and rows, token for token."""
    tm = lms[1]
    kw = dict(max_tokens=30, temperature=0.6, top_p=0.8, repetition_penalty=1.3,
              chunk=8, seed=4)
    single = _single(generate_tokens, tm, PROMPTS[1], **kw)
    assert generate_tokens_batch(tm, [PROMPTS[1]], **kw)[0].tolist() == single


def test_generate_tokens_loop_stops(lms):
    tm = lms[1]
    toks = _single(generate_tokens, tm, np.arange(10), max_tokens=40,
                   temperature=0.8, top_k=20, chunk=16, seed=3)
    assert 0 < len(toks) <= 40
    assert all(0 <= t < 96 for t in toks)
    stop = toks[len(toks) // 2]
    cut = _single(generate_tokens, tm, np.arange(10), max_tokens=40,
                  temperature=0.8, top_k=20, chunk=16, seed=3, stop_tokens=(stop,))
    assert cut == toks[:toks.index(stop)]


def test_generate_tokens_greedy_deterministic(lms):
    tm = lms[1]

    def run():
        return _single(generate_tokens, tm, np.arange(5), max_tokens=12,
                       temperature=0.0, chunk=8)

    assert run() == run()


def test_repetition_penalty_reduces_repeats(lms):
    tm = lms[1]
    plain = _single(generate_tokens, tm, np.arange(5), max_tokens=30,
                    temperature=0.0, chunk=16)
    pen = _single(generate_tokens, tm, np.arange(5), max_tokens=30,
                  temperature=0.0, repetition_penalty=5.0,
                  repetition_context_size=8, chunk=16)
    assert len(set(pen)) > len(set(plain))


def test_cached_replay_matches_full_forward(lms):
    """Teacher-forced tokens replayed one at a time through the left-padded
    prefill and the cached steps give the full forward's logits at every
    position, and the JAX package's full forward."""
    jm, tm = lms
    ids = np.random.default_rng(1).integers(0, 96, size=(1, 24))
    full = tm(torch.as_tensor(ids)).detach().numpy()
    np.testing.assert_allclose(full, np.asarray(jm(jnp.asarray(ids))), atol=1e-4, rtol=0)
    n0, pad = 7, 57  # a prompt of 7 left-padded to the 64 bucket
    caches = tm.model.init_cache(1, max_len=64 + 24)
    pad_len = torch.tensor([pad])
    prompt = torch.as_tensor(np.concatenate([np.zeros((1, pad), np.int64), ids[:, :n0]], 1))
    h, _ = tm.model.prefill(caches, prompt, pad_len)
    steps = [tm.logits(h[:, -1])]
    for t in range(n0, ids.shape[1]):
        h, _ = tm.model.step(caches, torch.as_tensor(ids[:, t:t + 1]), pad_len)
        steps.append(tm.logits(h[:, -1]))
    got = torch.stack(steps, dim=1).detach().numpy()
    np.testing.assert_allclose(got, full[:, n0 - 1:], atol=1e-5, rtol=0)


def test_quantized_lm_matches_jax_and_takes_the_kernel_route(lms, monkeypatch):
    """int8 in groups of 16: greedy tokens equal to the JAX package's
    quantized model; every projection and the tied head (a
    QuantizedEmbedding's as_linear) go to kernels.quantized_matmul at decode
    row counts."""
    jm = _seeded(lambda: JaxLM(JaxLlamaConfig(**LM)))
    jm.model.embed_tokens.weight = jm.model.embed_tokens.weight * EMBED_SCALE
    tm = _carry(jm, LlamaForCausalLM(LlamaConfig(**LM)))
    jax_quantize_model(jm, group_size=16, bits=8)
    quantize_model(tm, group_size=16, bits=8)
    calls = []
    qmm = kernels.quantized_matmul

    def counting(x, codes, *a):
        calls.append((x.shape[0], codes.shape[0]))
        return qmm(x, codes, *a)

    monkeypatch.setattr(kernels, "quantized_matmul", counting)
    kw = dict(max_tokens=20, temperature=0.0, repetition_penalty=1.3, chunk=8)
    for p in PROMPTS[:2]:
        assert (_single(generate_tokens, tm, p, **kw)
                == _single(jax_generate_tokens, jm, p, **kw))
    heads = [c for c in calls if c[1] == LM["vocab_size"]]
    assert len(heads) == 2 * 20 and all(rows == 1 for rows, _ in heads)


# -- Orpheus ------------------------------------------------------------------


@pytest.fixture(scope="module")
def orpheus_pair():
    jm = _seeded(tiny_model)
    js = jm._snac
    ts = _carry(js, SNAC(SNACConfig(**vars(js.config)), device="cpu"))
    tm = Model(ModelConfig(**vars(jm.config)), snac=ts,
               tokenizer=FakeTokenizer(), device="cpu")
    _carry(jm.lm, tm.lm)
    return jm, tm


def test_interleave_roundtrip_matches_jax(orpheus_pair):
    jm, tm = orpheus_pair
    audio = (np.random.default_rng(0).standard_normal(4096) * 0.1).astype(np.float32)
    interleaved = encode_audio_to_codes(audio, tm._snac)
    np.testing.assert_array_equal(
        interleaved, jax_orpheus.encode_audio_to_codes(audio, jm._snac))
    assert interleaved.shape[1] % 7 == 0
    frame = interleaved[0, :7]
    assert 0 <= frame[0] < 4096
    assert 4096 <= frame[1] < 2 * 4096
    assert 6 * 4096 <= frame[6] < 7 * 4096
    out = decode_audio_from_codes(interleaved[0].tolist(), tm._snac)
    ref = jax_orpheus.decode_audio_from_codes(interleaved[0].tolist(), jm._snac)
    assert out.ndim == 2 and out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=AUDIO_ATOL, rtol=0)


def test_parse_output(orpheus_pair):
    tm = orpheus_pair[1]
    row = [1, 2, AUDIO_MARK] + [CODE_OFFSET + i for i in range(15)] + [STOP_AUDIO]
    assert tm.parse_output(np.asarray([row]))[0] == list(range(14))


def test_prepare_input_ids_layout(orpheus_pair):
    jm, tm = orpheus_pair
    rows = tm.prepare_input_ids(["hello", "a second one"], voice="tara")
    assert rows[0][0] == SOH and rows[0][-2] == EOT and rows[0][-1] == EOH
    ref = jm.prepare_input_ids(["hello", "a second one"], voice="tara")
    for got, want in zip(rows, ref):
        np.testing.assert_array_equal(got, want)
    ref_audio = (np.random.default_rng(2).standard_normal(4096) * 0.1).astype(np.float32)
    cloned = tm.prepare_input_ids(["hi"], ref_audio=ref_audio, ref_text="ref")
    np.testing.assert_array_equal(
        cloned[0], jm.prepare_input_ids(["hi"], ref_audio=ref_audio, ref_text="ref")[0])


def test_orpheus_generate_matches_jax(orpheus_pair, monkeypatch):
    """Greedy generate through the tiny SNAC: the SNAC codes handed to the
    decoder equal the JAX package's, the audio within atol 1e-4."""
    jm, tm = orpheus_pair
    seen = {"jax": [], "port": []}
    for module, key in ((jax_orpheus, "jax"), (orpheus.llama, "port")):
        decode = module.decode_audio_from_codes
        monkeypatch.setattr(module, "decode_audio_from_codes",
                            lambda c, s, d=decode, k=key: (seen[k].append(list(c)), d(c, s))[1])
    kw = dict(voice="tara", temperature=0.0, max_tokens=50)
    ref = list(jm.generate("hello there\nsecond line", **kw))
    got = list(tm.generate("hello there\nsecond line", **kw))
    assert seen["port"] == seen["jax"] and len(seen["port"]) == 2
    assert len(got) == len(ref) == 2
    for r, g in zip(ref, got):
        assert g.token_count == r.token_count
        np.testing.assert_allclose(g.audio, r.audio, atol=AUDIO_ATOL, rtol=0)


def test_orpheus_generate_batch_plumbing(orpheus_pair, monkeypatch):
    """generate_batch: prompt and generated tokens joined, each row parsed
    and decoded; a row with no codes gives an empty result."""
    tm = orpheus_pair[1]
    fake = [np.asarray([AUDIO_MARK] + [CODE_OFFSET + i for i in range(14)]),
            np.asarray([AUDIO_MARK] + [CODE_OFFSET + i for i in range(7)]),
            np.asarray([AUDIO_MARK, 5])]
    monkeypatch.setattr(orpheus.llama, "generate_tokens_batch", lambda *a, **k: fake)
    results = tm.generate_batch(["first", "second", "third"], voice="tara")
    assert [r.samples > 0 for r in results] == [True, True, False]
    for r in results[:2]:
        assert np.isfinite(r.audio).all()


@pytest.mark.parametrize("build", [
    lambda: DAC(),
    lambda: SNAC(),
    lambda: Model(ModelConfig(hidden_size=32, num_hidden_layers=1, intermediate_size=64,
                              num_attention_heads=2, num_key_value_heads=1, vocab_size=64),
                  snac=object(), tokenizer=FakeTokenizer()),
], ids=["dac", "snac", "orpheus"])
def test_default_device_is_cuda(build, monkeypatch):
    """Built with no device argument, a model asks for the card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build()


def test_tokenizer_loads_a_local_path_only(orpheus_pair, tmp_path):
    cfg = ModelConfig(hidden_size=32, num_hidden_layers=1, intermediate_size=64,
                      num_attention_heads=2, num_key_value_heads=1, vocab_size=64,
                      tokenizer_name=str(tmp_path / "missing"))
    m = Model(cfg, snac=orpheus_pair[1]._snac, device="cpu")
    with pytest.raises(FileNotFoundError):
        m._get_tokenizer()


def test_sanitize_maps_hf_llama_keys(orpheus_pair):
    tm = orpheus_pair[1]
    w = {"model.norm.weight": np.ones(2), "lm_head.weight": np.ones(2),
         "layers.0.mlp.up_proj.weight": np.ones(2), "lm.model.x": np.ones(2)}
    assert sorted(tm.sanitize(w)) == sorted([
        "lm.model.norm.weight", "lm.lm_head.weight",
        "lm.model.layers.0.mlp.up_proj.weight", "lm.model.x"])
    assert causal._bucket(1) == 64 and causal._bucket(65) == 128
