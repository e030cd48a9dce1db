"""Wav2Vec2 in the port against the JAX package, float32 on the CPU: the port
twin of the Wav2Vec2 half of tests/test_wav2vec_voxtral.py, at its small
model (``small_w2v``), in both norm variants.

Weights cross with ``convert.params_from_jax`` and
``load_state_dict(strict=True)``.  The positional conv's weight norm is per
tap (``g`` [K, 1, 1] in the JAX package, torch's [1, 1, K] in the port); at
the JAX init ``g`` equals the tap norms, which hides a wrong axis, so every
model here draws ``g`` afresh before crossing.  The last hidden state, the
normed features and every hidden state are held to atol 1e-4 and rtol
1e-4; the numpy feature extractor is held exactly equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mlx_audio_tpu.nn.layers as jax_layers
from mlx_audio_tpu.models.stt.wav2vec import (
    Wav2Vec2FeatureExtractor as JaxFeatureExtractor,
)
from mlx_audio_tpu.nn.module import named_arrays, update_arrays
from mlx_audio_tpu_torch.convert import conv_kinds, params_from_jax
from mlx_audio_tpu_torch.models.stt.wav2vec import (
    ModelConfig,
    Wav2Vec2FeatureExtractor,
    Wav2Vec2Model,
)
from test_wav2vec_voxtral import small_w2v

TOL = dict(atol=1e-4, rtol=1e-4)
VARIANTS = {"group": {}, "stable": dict(do_stable_layer_norm=True,
                                        feat_extract_norm="layer")}


def _seeded(build):
    saved = jax_layers._INIT_RNG
    jax_layers._INIT_RNG = np.random.default_rng(0)
    try:
        return build()
    finally:
        jax_layers._INIT_RNG = saved


def redraw(jax_model, seed: int = 1):
    """Every weight-norm ``g`` drawn afresh, and the norms' scales and
    shifts moved off 1 and 0, so that a wrong axis shows."""
    rng = np.random.default_rng(seed)
    updates = {}
    for k, v in named_arrays(jax_model):
        v = np.asarray(v)
        if k.endswith("weight_g"):
            updates[k] = v * rng.uniform(0.5, 1.5, v.shape)
        elif "norm" in k and k.endswith(("weight", "bias")):
            updates[k] = v + rng.normal(0.0, 0.1, v.shape)
    return update_arrays(jax_model, updates)


def carry(jax_model, port):
    named = {k: np.asarray(v) for k, v in named_arrays(jax_model)}
    port.load_state_dict(params_from_jax(named, port), strict=True)
    return port


def port_of(jax_model):
    return carry(jax_model, Wav2Vec2Model(ModelConfig(**vars(jax_model.config)),
                                          device="cpu"))


@pytest.fixture(scope="module", params=list(VARIANTS))
def pair(request):
    jm = redraw(_seeded(lambda: small_w2v(**VARIANTS[request.param])))
    return jm, port_of(jm)


def _wav(seed, shape):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.1).astype(np.float32)


def test_hidden_states_match_jax(pair):
    jm, port = pair
    wav = _wav(0, (2, 4000))
    last, feats, hiddens = jm(jnp.asarray(wav), output_hidden_states=True)
    p_last, p_feats, p_hiddens = port(torch.as_tensor(wav), output_hidden_states=True)
    assert p_last.shape == last.shape and p_last.shape[2] == 32
    np.testing.assert_allclose(p_last.numpy(), np.asarray(last), **TOL)
    np.testing.assert_allclose(p_feats.numpy(), np.asarray(feats), **TOL)
    assert len(p_hiddens) == len(hiddens) == 3
    for p, j in zip(p_hiddens, hiddens):
        np.testing.assert_allclose(p.numpy(), np.asarray(j), **TOL)
    assert port(torch.as_tensor(wav))[2] is None


def test_pos_conv_g_crosses_per_tap(pair):
    """The positional conv's ``g`` is one a tap: it arrives as [1, 1, K],
    not on the output-channel axis; its owner is the one per-tap conv."""
    jm, port = pair
    k = jm.config.num_conv_pos_embeddings
    g = np.asarray(jm.encoder.pos_conv_embed.weight_g)
    assert g.shape == (k, 1, 1) and np.ptp(g) > 0
    got = port.state_dict()["encoder.pos_conv_embed.weight_g"]
    np.testing.assert_array_equal(got.numpy(), g.reshape(1, 1, k))
    assert port.encoder.pos_conv_embed.weight_v.shape == (32, 32 // 4, k)
    kinds = conv_kinds(port)
    assert kinds["encoder.pos_conv_embed"] == "conv_tap"
    assert sum(v == "conv_tap" for v in kinds.values()) == 1


def _hf_keys(jax_model, modern: bool):
    """A torch checkpoint of the JAX model's weights, in one of HF's two
    weight-norm key styles: conv [O, I, K], the positional conv's g
    [1, 1, K]."""
    out = {}
    for k, v in named_arrays(jax_model):
        v = np.asarray(v)
        if "pos_conv_embed" in k:
            name = {"weight_g": "parametrizations.weight.original0" if modern else "weight_g",
                    "weight_v": "parametrizations.weight.original1" if modern else "weight_v",
                    "bias": "bias"}[k.rpartition(".")[2]]
            k = k.rpartition(".")[0] + ".conv." + name
        if v.ndim == 3:
            v = v.transpose(2, 1, 0)
        out[k] = v
    return out


@pytest.mark.parametrize("modern", [False, True], ids=["weight_g_v", "parametrizations"])
def test_sanitize_matches_jax(pair, modern):
    """Both key styles sanitize as in the JAX package, back to the JAX
    model's own arrays, and load strictly into the port."""
    jm, port = pair
    hf = _hf_keys(jm, modern)
    assert any(".conv.parametrizations." in k for k in hf) == modern
    got, want = Wav2Vec2Model.sanitize(hf), jm.sanitize(hf)
    assert sorted(got) == sorted(want) == sorted(k for k, _ in named_arrays(jm))
    named = dict(named_arrays(jm))
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(got[k], np.asarray(named[k]))
    fresh = Wav2Vec2Model(ModelConfig(**vars(jm.config)), device="cpu", seed=5)
    fresh.load_state_dict(params_from_jax(got, fresh), strict=True)
    wav = torch.as_tensor(_wav(2, (1, 2000)))
    torch.testing.assert_close(fresh(wav)[0], port(wav)[0], rtol=0, atol=0)


def test_matches_hf_transformers_with_redrawn_g():
    """An HF ``Wav2Vec2Model`` (modern weight-norm keys, ``g`` redrawn)
    through ``sanitize`` and ``params_from_jax``: last hidden state within
    1e-4 of HF's."""
    from transformers import Wav2Vec2Config
    from transformers import Wav2Vec2Model as HFWav2Vec2

    torch.manual_seed(0)
    kw = dict(hidden_size=16, num_hidden_layers=2, num_attention_heads=2,
              intermediate_size=32, conv_dim=(4, 4), conv_stride=(5, 2),
              conv_kernel=(10, 3), num_feat_extract_layers=2,
              num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=2,
              do_stable_layer_norm=True, feat_extract_norm="layer")
    hf = HFWav2Vec2(Wav2Vec2Config(**kw)).eval()
    sd = {k: v.detach().numpy().copy() for k, v in hf.state_dict().items()
          if "masked_spec_embed" not in k}
    g_key = next(k for k in sd if k.endswith("original0"))
    sd[g_key] = sd[g_key] * np.random.default_rng(3).uniform(0.5, 1.5, sd[g_key].shape)
    hf.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()}, strict=False)
    port = Wav2Vec2Model(ModelConfig.from_dict(kw), device="cpu")
    port.load_state_dict(params_from_jax(port.sanitize(sd), port), strict=True)
    wav = torch.as_tensor(_wav(6, (1, 400)))
    with torch.no_grad():
        want = hf(wav).last_hidden_state
    torch.testing.assert_close(port(wav)[0], want, **TOL)


def test_feature_extractor_padding_and_mask_match_jax():
    fe = Wav2Vec2FeatureExtractor(do_normalize=True, return_attention_mask=True)
    ref = JaxFeatureExtractor(do_normalize=True, return_attention_mask=True)
    rng = np.random.default_rng(0)
    a = rng.standard_normal(1000).astype(np.float32) * 3 + 1
    b = rng.standard_normal(600).astype(np.float32)
    for args, kw in ((([a, b],), dict(padding=True)),
                     ((a,), dict(padding="max_length", max_length=1200, truncation=True)),
                     (([a],), dict(padding="max_length", max_length=512, truncation=True)),
                     (([a, b],), dict(padding=True, pad_to_multiple_of=256))):
        got, want = fe(*args, **kw), ref(*args, **kw)
        assert sorted(got) == sorted(want) == ["attention_mask", "input_values"]
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])
            assert got[k].dtype == want[k].dtype
    assert fe([a, b], padding=True).attention_mask[1, 600:].sum() == 0
    with pytest.raises(ValueError):
        fe([a, b])  # ragged without padding
    with pytest.raises(ValueError):
        fe(a, sampling_rate=8000)


def test_feature_extractor_2d_batch_and_overflow_match_jax():
    fe, ref = (Wav2Vec2FeatureExtractor(do_normalize=False),
               JaxFeatureExtractor(do_normalize=False))
    batch2d = np.random.default_rng(1).standard_normal((4, 320)).astype(np.float32)
    np.testing.assert_array_equal(fe(batch2d, padding=True).input_values,
                                  ref(batch2d, padding=True).input_values)
    np.testing.assert_array_equal(fe(batch2d, padding=True).input_values, batch2d)
    long = [np.zeros(500, dtype=np.float32), np.zeros(100, dtype=np.float32)]
    got = fe(long, padding="max_length", max_length=320).input_values
    assert got.shape == (2, 500)
    np.testing.assert_array_equal(
        got, ref(long, padding="max_length", max_length=320).input_values)


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Wav2Vec2Model(ModelConfig(hidden_size=16, num_hidden_layers=1,
                                  num_attention_heads=2, intermediate_size=32))
