"""Llama, its attention substrate and token sampling in the port against
the JAX package, float32 on the CPU.

Weights cross with ``convert.params_from_jax``; inputs are numpy draws.
Hidden states are held to atol 1e-5; the llama3-scaled RoPE tables and the
samples drawn on the JAX package's own Gumbel noise are held equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_audio_tpu.models import sampling as jsampling
from mlx_audio_tpu.models.lm.llama import LLAMA_FLAVORS as JAX_FLAVORS
from mlx_audio_tpu.models.lm.llama import LlamaConfig as JaxConfig
from mlx_audio_tpu.models.lm.llama import LlamaModel as JaxLlama
from mlx_audio_tpu.nn.attention import rope_table as jax_rope_table
from mlx_audio_tpu.nn.module import named_arrays
from mlx_audio_tpu_torch.convert import params_from_jax
from mlx_audio_tpu_torch.models import sampling
from mlx_audio_tpu_torch.models.lm.llama import LLAMA_FLAVORS, LlamaConfig, LlamaModel
from mlx_audio_tpu_torch.nn.attention import KVCache, cached_attention, rope_table

ATOL = 1e-5
SCALING = {"factor": 32.0, "low_freq_factor": 1.0, "high_freq_factor": 4.0,
           "original_max_position_embeddings": 8192, "rope_type": "llama3"}


def _cfg(cls, embed_vocab=50):
    return cls(num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
               head_dim=8, hidden_size=32, intermediate_size=64,
               rms_norm_eps=1e-5, vocab_size=embed_vocab,
               max_position_embeddings=64, rope_theta=500_000,
               rope_scaling=SCALING)


@pytest.fixture(scope="module")
def models():
    import mlx_audio_tpu.nn.layers as jax_layers

    # set up before conftest's per-test reseed: seed the JAX init here
    jax_layers._INIT_RNG = np.random.default_rng(0)
    jm = JaxLlama(_cfg(JaxConfig))
    port = LlamaModel(_cfg(LlamaConfig))
    port.load_state_dict(params_from_jax(
        {k: np.asarray(v) for k, v in named_arrays(jm)}, port), strict=True)
    return jm, port


@pytest.mark.parametrize("head_dim,scaling", [(64, SCALING), (128, SCALING), (16, None)])
def test_rope_tables_equal(head_dim, scaling):
    cos_j, sin_j = jax_rope_table(head_dim, 2048, base=500_000, scaling=scaling)
    cos_t, sin_t = rope_table(head_dim, 2048, base=500_000, scaling=scaling)
    np.testing.assert_array_equal(cos_t.numpy(), np.asarray(cos_j))
    np.testing.assert_array_equal(sin_t.numpy(), np.asarray(sin_j))


def test_flavors_match_the_jax_package():
    for name, cfg in LLAMA_FLAVORS.items():
        assert vars(cfg) == vars(JAX_FLAVORS[name]), name


def test_forward_matches_jax(models):
    jm, port = models
    ids = np.random.default_rng(0).integers(0, 50, size=(2, 10))
    ref = np.asarray(jm(jnp.asarray(ids)))
    with torch.no_grad():
        got = port(torch.as_tensor(ids)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_prefill_and_step_replay(models):
    """Left-padded prefill, then one-token-at-a-time steps, against the full
    forward of the port and against the JAX package's prefill and steps."""
    jm, port = models
    ids = np.random.default_rng(1).integers(0, 50, size=(1, 10))
    pad = 3
    padded = np.concatenate([np.zeros((1, pad), np.int64), ids], axis=1)
    with torch.no_grad():
        full = port(torch.as_tensor(ids)).numpy()
        caches = port.init_cache(1, max_len=24)
        pad_t = torch.tensor([pad])
        h, caches = port.prefill(caches, torch.as_tensor(padded[:, :pad + 6]), pad_t)
        outs = [h[:, pad:].numpy()]
        for t in range(pad + 6, pad + 10):
            h, caches = port.step(caches, torch.as_tensor(padded[:, t:t + 1]), pad_t)
            outs.append(h.numpy())
    got = np.concatenate(outs, axis=1)
    np.testing.assert_allclose(got, full, atol=ATOL, rtol=0)
    assert caches[0].idx == pad + 10

    jc = jm.init_cache(1, max_len=24)
    jpad = jnp.asarray([pad])
    h, jc = jm.prefill(jc, jnp.asarray(padded[:, :pad + 6]), jpad)
    ref = [np.asarray(h)[:, pad:]]
    for t in range(pad + 6, pad + 10):
        h, jc = jm.step(jc, jnp.asarray(padded[:, t:t + 1]), jpad)
        ref.append(np.asarray(h))
    np.testing.assert_allclose(got, np.concatenate(ref, axis=1), atol=ATOL, rtol=0)


def test_cached_attention_matches_jax():
    from mlx_audio_tpu.nn.attention import KVCache as JaxCache
    from mlx_audio_tpu.nn.attention import cached_attention as jax_cached

    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 4, 3, 8)).astype(np.float32)
    k = rng.standard_normal((2, 2, 3, 8)).astype(np.float32)
    v = rng.standard_normal((2, 2, 3, 8)).astype(np.float32)
    jc = JaxCache.create(2, 2, 10, 8)._replace(idx=jnp.asarray(4, jnp.int32))
    ref, jc = jax_cached(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jc)
    tc = KVCache.create(2, 2, 10, 8)
    tc.idx = 4
    got, tc = cached_attention(torch.as_tensor(q), torch.as_tensor(k),
                               torch.as_tensor(v), tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(tc.k.numpy(), np.asarray(jc.k))
    assert tc.idx == int(jc.idx) == 7


@pytest.mark.parametrize("temp,top_k,top_p", [(0.0, 0, 1.0), (0.8, 0, 1.0),
                                              (0.9, 5, 1.0), (1.0, 0, 0.7)])
def test_sampling_matches_jax_on_its_noise(temp, top_k, top_p):
    """A categorical draw is argmax(logits + Gumbel): given the JAX
    package's Gumbel draws the port returns the JAX package's samples."""
    key = jax.random.PRNGKey(3)
    logits = np.random.default_rng(3).standard_normal((6, 50)).astype(np.float32) * 3
    noise = np.array(jax.random.gumbel(key, logits.shape, jnp.float32))
    if top_p < 1.0:
        ref = jsampling.sample_top_p(key, jnp.asarray(logits), temp, top_p)
        got = sampling.sample_top_p(torch.as_tensor(logits), temp, top_p,
                                    noise=torch.as_tensor(noise))
    else:
        ref = jsampling.sample_top_k(key, jnp.asarray(logits), temp, top_k)
        got = sampling.sample_top_k(torch.as_tensor(logits), temp, top_k,
                                    noise=torch.as_tensor(noise))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_bisect_threshold_keeps_the_sorted_top_k():
    z = torch.as_tensor(np.random.default_rng(4).standard_normal((3, 40)),
                        dtype=torch.float32)
    tau = sampling._bisect_threshold(
        z, lambda t: (z >= t).sum(-1, keepdim=True) >= 7)
    kth = torch.sort(z, dim=-1).values[:, -7, None]
    assert torch.equal(z >= tau, z >= kth)


def test_generator_draws_are_reproducible():
    logits = torch.zeros(4, 30)
    a = sampling.sample_top_k(logits, 1.0, 0, torch.Generator().manual_seed(5))
    b = sampling.sample_top_k(logits, 1.0, 0, torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and a.dtype == torch.int32


def test_per_row_samplers_draw_independently_of_the_batch():
    """Row 0 of a 2-row call equals a 1-row call bit for bit, top-k (small
    and large vocabulary) and top-p alike; temperature 0 is greedy."""
    rng = np.random.default_rng(9)
    for v, top_k in ((64, 10), (20000, 40)):
        logits = torch.as_tensor(rng.standard_normal((2, v)), dtype=torch.float32)
        two = sampling.sample_top_k_rows(logits, 0.9, top_k, seed=11)
        one = sampling.sample_top_k_rows(logits[:1], 0.9, top_k, seed=11)
        assert two[0] == one[0] and two.dtype == torch.int32
    logits = torch.as_tensor(rng.standard_normal((3, 64)), dtype=torch.float32)
    rows = sampling.sample_top_p_rows(logits, 1.0, 0.8, seed=3)
    assert sampling.sample_top_p_rows(logits[:1], 1.0, 0.8, seed=3)[0] == rows[0]
    # row i's draw follows its own logits: the same logits in every row of
    # one call still give rows their own noise
    same = sampling.sample_top_k_rows(logits[:1].expand(64, -1), 2.0, 0, seed=3)
    assert len(set(same.tolist())) > 1
    torch.testing.assert_close(sampling.sample_top_k_rows(logits, 0.0, 5, seed=1),
                               torch.argmax(logits, -1).to(torch.int32))
