"""The port's samplers (``mlx_audio_tpu_torch/models/sampling.py``) against
the JAX package's: the twins of tests/test_sampling.py, plus
``make_sampler``'s routing.

A categorical draw is argmax(logits + Gumbel) in both packages, so each
twin draws 256 samples from the JAX package with 256 keys and hands the
port the same keys' Gumbel draws as ``noise``: the port's samples must
equal the JAX package's one for one (the large-vocabulary top-k draws
among its k kept values, so its noise has k columns), and lie in the
sorted-filter reference's kept set, as the JAX test holds its own.  The
repetition penalty is held to the JAX package's exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mlx_audio_tpu.models.sampling as jsampling
from mlx_audio_tpu_torch.models import sampling
from test_sampling import _kept_set_top_k, _kept_set_top_p

N_KEYS = 256


def _both(kind: str, logits: np.ndarray, **kw):
    """(the JAX package's samples over N_KEYS keys, the port's on those
    keys' Gumbel draws) for one row of logits."""
    jfn = {"top_k": jsampling.sample_top_k, "top_p": jsampling.sample_top_p}[kind]
    keys = jax.random.split(jax.random.PRNGKey(0), N_KEYS)
    ref = np.asarray(jax.vmap(lambda k: jfn(k, jnp.asarray(logits)[None], **kw)[0])(keys))
    v, top_k = logits.shape[-1], kw.get("top_k", 0)
    n = top_k if kind == "top_k" and 0 < top_k < v and v >= sampling._BISECT_MIN_VOCAB else v
    noise = np.array(jax.vmap(lambda k: jax.random.gumbel(k, (1, n), jnp.float32)[0])(keys))
    rows = torch.as_tensor(logits).expand(N_KEYS, -1)
    if kind == "top_k":
        got = sampling.sample_top_k(rows, kw["temp"], top_k, noise=torch.as_tensor(noise))
    else:
        got = sampling.sample_top_p(rows, kw["temp"], kw["top_p"], noise=torch.as_tensor(noise))
    return ref, got.numpy()


@pytest.mark.parametrize("v,k", [(97, 5), (640, 50), (1000, 1), (20_000, 50)])
def test_top_k_support_matches_sorted_reference(v, k):
    logits = np.random.default_rng(v).standard_normal(v).astype(np.float32) * 3
    ref, got = _both("top_k", logits, temp=0.8, top_k=k)
    np.testing.assert_array_equal(got, ref)
    assert set(got.tolist()) <= set(np.nonzero(_kept_set_top_k(logits, k))[0].tolist())
    if k == 1:
        assert set(got.tolist()) == {int(np.argmax(logits))}


def test_top_k_ties_at_boundary_are_kept():
    logits = np.zeros(64, np.float32)
    logits[[3, 17, 40]] = 5.0
    ref, got = _both("top_k", logits, temp=1.0, top_k=2)
    np.testing.assert_array_equal(got, ref)
    assert set(got.tolist()) == {3, 17, 40}


@pytest.mark.parametrize("v,p", [(97, 0.5), (640, 0.9), (4000, 0.95), (20_000, 0.9)])
def test_top_p_support_matches_nucleus_reference(v, p):
    logits = (np.random.default_rng(v + 1).standard_normal(v) * 4).astype(np.float32)
    ref, got = _both("top_p", logits, temp=1.0, top_p=p)
    np.testing.assert_array_equal(got, ref)
    assert set(got.tolist()) <= set(np.nonzero(_kept_set_top_p(logits, p))[0].tolist())


def test_top_p_is_not_degenerate_argmax():
    logits = np.array([2.0, 1.9, 1.8, -10.0], np.float32)
    ref, got = _both("top_p", logits, temp=1.0, top_p=0.95)
    np.testing.assert_array_equal(got, ref)
    assert len(set(got.tolist())) >= 2 and 3 not in set(got.tolist())


def test_greedy_and_disabled_filters():
    logits = np.array([0.1, 3.0, -1.0], np.float32)
    t = torch.as_tensor(logits)[None]
    assert int(sampling.sample_top_k(t, 0.0, 2)[0]) == 1
    assert int(sampling.sample_top_p(t, 0.0, 0.5)[0]) == 1
    ref, got = _both("top_k", logits, temp=2.0, top_k=0)
    np.testing.assert_array_equal(got, ref)
    assert set(got.tolist()) <= {0, 1, 2} and 1 in set(got.tolist())


def test_repetition_penalty_matches_reference():
    logits = np.array([[1.0, -1.0, 2.0, 0.5], [0.3, -2.0, -0.5, 4.0]], np.float32)
    hist = np.array([[2, -1, 0], [1, 1, -1]], np.int32)
    for penalty in (1.3, 2.0):
        ref = np.asarray(jsampling.apply_repetition_penalty(
            jnp.asarray(logits), jnp.asarray(hist), penalty))
        got = sampling.apply_repetition_penalty(torch.as_tensor(logits),
                                                torch.as_tensor(hist), penalty)
        np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_allclose(ref[0], [0.5, -1.0, 1.0, 0.5])  # last: penalty 2.0 above
    t = torch.as_tensor(logits)
    assert sampling.apply_repetition_penalty(t, torch.as_tensor(hist), 1.0) is t


@pytest.mark.parametrize("temp,top_k,top_p", [(0.8, 0, 1.0), (0.9, 5, 1.0),
                                              (1.0, 0, 0.7), (1.0, 5, 0.7), (0.0, 3, 0.5)])
def test_make_sampler_routes_as_jax(temp, top_k, top_p):
    """``top_p < 1`` takes nucleus sampling (top_k ignored), else top-k;
    on the JAX package's noise the port's sampler returns its samples."""
    logits = (np.random.default_rng(5).standard_normal((6, 50)) * 3).astype(np.float32)
    key = jax.random.PRNGKey(4)
    noise = torch.as_tensor(np.array(jax.random.gumbel(key, logits.shape, jnp.float32)))
    ref = jsampling.make_sampler(temp, top_k, top_p)(key, jnp.asarray(logits))
    sampler = sampling.make_sampler(temp, top_k, top_p)
    got = sampler(torch.as_tensor(logits), noise=noise)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    direct = (sampling.sample_top_p(torch.as_tensor(logits), temp, top_p, noise=noise)
              if top_p < 1.0 else
              sampling.sample_top_k(torch.as_tensor(logits), temp, top_k, noise=noise))
    assert torch.equal(got, direct)
    gen = sampler(torch.as_tensor(logits), generator=torch.Generator().manual_seed(1))
    again = sampler(torch.as_tensor(logits), generator=torch.Generator().manual_seed(1))
    assert torch.equal(gen, again) and gen.dtype == torch.int32
