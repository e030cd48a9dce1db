"""EnCodec in the port against the JAX package, float32 on the CPU: the port
twin of tests/test_encodec.py, at its reduced widths (``small_encodec``).

The JAX model initialises its LSTMs and codebooks to zeros; here they are
drawn from a seeded numpy generator (the codebooks at the encoder's output
scale, so the codes spread) before the weights cross with
``convert.params_from_jax`` and ``load_state_dict(strict=True)``.  Codes are
held equal and audio to atol 1e-4.
"""

import numpy as np
import pytest
import torch

import mlx_audio_tpu.nn.layers as jax_layers
from mlx_audio_tpu.codec.encodec import preprocess_audio as jax_preprocess
from mlx_audio_tpu.codec.encodec import sanitize_hf_encodec as jax_sanitize_hf
from mlx_audio_tpu.nn.module import named_arrays, update_arrays
from mlx_audio_tpu_torch.codec.encodec import (
    Encodec,
    EncodecConfig,
    preprocess_audio,
    sanitize_hf_encodec,
)
from mlx_audio_tpu_torch.codec.encodec import encodec as encodec_mod
from mlx_audio_tpu_torch.convert import params_from_jax
from mlx_audio_tpu_torch.nn import kernels
from test_encodec import small_encodec

AUDIO_ATOL = 1e-4


def randomized(jax_model, seed=1):
    """The JAX model with its LSTMs drawn at +-1/sqrt(H), its codebooks at
    std 0.02, the encoder output's scale at these widths, and the decoder's
    last conv scaled by 1e3, so that the audio is O(0.1) (about 1e-4 at the
    init scale, where an atol of 1e-4 would hold nothing)."""
    rng = np.random.default_rng(seed)
    h = jax_model.config.num_filters * 2 ** len(jax_model.config.upsampling_ratios)
    last = f"decoder.layers.{len(jax_model.decoder.layers) - 1}."
    upd = {}
    for k, v in named_arrays(jax_model):
        if ".lstm." in k:
            upd[k] = rng.uniform(-h ** -0.5, h ** -0.5, v.shape).astype(np.float32)
        elif k.endswith("codebook.embed"):
            upd[k] = (rng.standard_normal(v.shape) * 0.02).astype(np.float32)
        elif k.startswith(last):
            upd[k] = np.asarray(v) * 1e3
    return update_arrays(jax_model, upd)


def build_jax(**kw):
    saved = jax_layers._INIT_RNG
    jax_layers._INIT_RNG = np.random.default_rng(0)
    try:
        return randomized(small_encodec(**kw))
    finally:
        jax_layers._INIT_RNG = saved


def port_of(jax_model):
    named = {k: np.asarray(v) for k, v in named_arrays(jax_model)}
    port = Encodec(EncodecConfig(**vars(jax_model.config)), device="cpu")
    port.load_state_dict(params_from_jax(named, port), strict=True)
    return port


@pytest.fixture(scope="module")
def pair():
    jm = build_jax()
    return jm, port_of(jm)


def _audio(seed, n, scale=0.1):
    return (np.random.default_rng(seed).standard_normal(n) * scale).astype(np.float32)


@pytest.mark.parametrize("bandwidth,nq", [(None, 2), (6.0, 8)],
                         ids=["default", "6kbps"])
def test_codes_and_audio_match_jax(pair, bandwidth, nq):
    jm, tm = pair
    x = _audio(0, 16_000)
    a, m = jax_preprocess(x)
    codes_j, scales_j = jm.encode(a, m, bandwidth=bandwidth)
    ta, tmask = preprocess_audio(x)
    codes_t, scales_t = tm.encode(ta, tmask, bandwidth=bandwidth)
    assert codes_t.shape == (1, 1, nq, 50)
    assert scales_t == [None]
    np.testing.assert_array_equal(codes_t.numpy(), np.asarray(codes_j))
    assert len(np.unique(np.asarray(codes_j))) > 5
    y_j = np.asarray(jm.decode(codes_j, scales_j, m))
    y_t = tm.decode(codes_t, scales_t, tmask).numpy()
    assert y_t.shape == (1, 16_000, 1)
    np.testing.assert_allclose(y_t, y_j, atol=AUDIO_ATOL, rtol=0)


def test_exact_length_reconstruction(pair):
    tm = pair[1]
    audio, mask = preprocess_audio(np.zeros(32_000, dtype=np.float32))
    codes, scales = tm.encode(audio, mask)
    assert codes.shape == (1, 1, 2, 100)
    out = tm.decode(codes, scales, mask)
    assert out.shape == (1, 32_000, 1)
    assert torch.isfinite(out).all()


def test_unsupported_bandwidth_raises(pair):
    audio, mask = preprocess_audio(np.zeros(32_000, dtype=np.float32))
    with pytest.raises(ValueError):
        pair[1].encode(audio, mask, bandwidth=7.5)


def test_chunked_normalized_model_matches_jax():
    """Chunks of 1 s with 1% overlap, each scaled by its RMS, joined by
    linear overlap-add; the short tail chunk's codes padded to stack."""
    jm = build_jax(normalize=True, chunk_length_s=1.0, overlap=0.01)
    tm = port_of(jm)
    x = _audio(2, 50_000)
    a, m = jax_preprocess(x, 24000, jm.chunk_length, jm.chunk_stride)
    codes_j, scales_j = jm.encode(a, m)
    ta, tmask = preprocess_audio(x, 24000, tm.chunk_length, tm.chunk_stride)
    codes_t, scales_t = tm.encode(ta, tmask)
    assert codes_t.shape[0] > 1
    np.testing.assert_array_equal(codes_t.numpy(), np.asarray(codes_j))
    for s_t, s_j in zip(scales_t, scales_j):
        np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-6)
    y_j = np.asarray(jm.decode(codes_j, scales_j, m))
    y_t = tm.decode(codes_t, scales_t, tmask).numpy()
    assert y_t.shape == y_j.shape == (1, tmask.shape[1], 1)
    np.testing.assert_allclose(y_t, y_j, atol=AUDIO_ATOL, rtol=0)


def test_unilstm_runs_the_lstm_kernel_wrapper(pair, monkeypatch):
    """Each UniLSTM goes through nn.recurrent.lstm_scan into kernels.lstm:
    two layers in the encoder and two in the decoder, at H = 16 x filters."""
    tm = pair[1]
    calls = []
    wrapped = kernels.lstm

    def counting(xp, wh, h0, c0):
        calls.append(tuple(xp.shape))
        return wrapped(xp, wh, h0, c0)

    monkeypatch.setattr(kernels, "lstm", counting)
    scans = []
    scan = encodec_mod.lstm_scan
    monkeypatch.setattr(encodec_mod, "lstm_scan",
                        lambda *a, **k: (scans.append(1), scan(*a, **k))[1])
    audio, mask = preprocess_audio(_audio(3, 8000))
    codes, scales = tm.encode(audio, mask)
    tm.decode(codes, scales, mask)
    assert len(scans) == 4
    assert calls == [(1, 25, 4 * 128)] * 4


def _hf_keys(rng):
    """A synthetic HF EncodecModel key set: weight-normed convs (a dense
    conv, a transposed upsampler, the last conv), an LSTM layer with its
    two biases, a codebook with its buffers."""
    def w(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    p = ".parametrizations.weight.original"
    return {
        f"encoder.layers.0.conv{p}0": w(8, 1, 1), f"encoder.layers.0.conv{p}1": w(8, 1, 7),
        "encoder.layers.0.conv.bias": w(8),
        f"decoder.layers.0.conv{p}0": w(16, 1, 1), f"decoder.layers.0.conv{p}1": w(16, 4, 7),
        f"decoder.layers.3.conv{p}0": w(16, 1, 1), f"decoder.layers.3.conv{p}1": w(16, 8, 4),
        f"decoder.layers.9.conv{p}0": w(1, 1, 1), f"decoder.layers.9.conv{p}1": w(1, 8, 7),
        "encoder.layers.13.lstm.weight_ih_l0": w(64, 16),
        "encoder.layers.13.lstm.weight_hh_l0": w(64, 16),
        "encoder.layers.13.lstm.bias_ih_l0": w(64),
        "encoder.layers.13.lstm.bias_hh_l0": w(64),
        "quantizer.layers.0.codebook.embed": w(32, 4),
        "quantizer.layers.0.codebook.inited": w(1),
        "quantizer.layers.0.codebook.cluster_size": w(32),
        "quantizer.layers.0.codebook.embed_avg": w(32, 4),
    }


def test_sanitize_hf_encodec_matches_jax():
    weights = _hf_keys(np.random.default_rng(5))
    got, want = sanitize_hf_encodec(weights), jax_sanitize_hf(weights)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    assert got["decoder.layers.3.weight"].shape == (4, 16, 8)   # convT [K, I, O]
    assert got["decoder.layers.9.weight"].shape == (7, 8, 1)    # conv [K, I, O]
    np.testing.assert_array_equal(
        got["encoder.layers.13.lstm.0.bias"],
        weights["encoder.layers.13.lstm.bias_ih_l0"]
        + weights["encoder.layers.13.lstm.bias_hh_l0"])
    assert not any("cluster_size" in k or "inited" in k for k in got)
