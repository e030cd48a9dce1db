"""Vocos and the mel filterbank in the port against the JAX package, float32
on the CPU: the port twin of tests/test_vocos_bigvgan.py's Vocos tests, at
its reduced widths (``small_vocos``), and of ``dsp.mel_filters``.

Weights cross with ``convert.params_from_jax`` and
``load_state_dict(strict=True)``: the backbone's ``embed`` conv and the
depthwise ``dwconv`` are the port's ``Conv1d``.  Audio and mel features are
held to atol 1e-4 and rtol 1e-4 together (the head's ``exp`` is clipped at
100).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mlx_audio_tpu.nn.layers as jax_layers
from mlx_audio_tpu import dsp as jax_dsp
from mlx_audio_tpu.codec.vocos.vocos import EncodecFeatures as JaxEncodecFeatures
from mlx_audio_tpu.codec.vocos.vocos import ISTFTHead as JaxISTFTHead
from mlx_audio_tpu.codec.vocos.vocos import Vocos as JaxVocos
from mlx_audio_tpu.codec.vocos.vocos import VocosBackbone as JaxVocosBackbone
from mlx_audio_tpu.codec.vocos.vocos import log_mel_spectrogram as jax_log_mel
from mlx_audio_tpu.nn.module import named_arrays
from mlx_audio_tpu_torch import dsp
from mlx_audio_tpu_torch.codec.vocos import (
    EncodecFeatures,
    ISTFTHead,
    MelSpectrogramFeatures,
    Vocos,
    VocosBackbone,
    log_mel_spectrogram,
)
from mlx_audio_tpu_torch.convert import params_from_jax
from test_torch_encodec import build_jax as build_jax_encodec
from test_torch_encodec import port_of as port_encodec
from test_vocos_bigvgan import small_vocos

TOL = dict(atol=1e-4, rtol=1e-4)


def _seeded(build):
    saved = jax_layers._INIT_RNG
    jax_layers._INIT_RNG = np.random.default_rng(0)
    try:
        return build()
    finally:
        jax_layers._INIT_RNG = saved


def carry(jax_model, port):
    named = {k: np.asarray(v) for k, v in named_arrays(jax_model)}
    port.load_state_dict(params_from_jax(named, port), strict=True)
    return port


def port_small_vocos():
    return Vocos(MelSpectrogramFeatures(sample_rate=24000, n_fft=1024,
                                        hop_length=256, n_mels=100),
                 VocosBackbone(input_channels=100, dim=64, intermediate_dim=128,
                               num_layers=2),
                 ISTFTHead(dim=64, n_fft=1024, hop_length=256))


@pytest.fixture(scope="module")
def pair():
    jm = _seeded(small_vocos)
    return jm, carry(jm, port_small_vocos())


@pytest.mark.parametrize("norm,scale", [(None, "htk"), ("slaney", "htk"),
                                        (None, "slaney"), ("slaney", "slaney")])
def test_mel_filters_match_jax(norm, scale):
    got = dsp.mel_filters(24000, 1024, 100, norm=norm, mel_scale=scale)
    want = np.asarray(jax_dsp.mel_filters(24000, 1024, 100, norm=norm,
                                          mel_scale=scale))
    assert got.shape == (100, 513) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    f_max = dsp.mel_filters(16000, 400, 80, f_min=20, f_max=7600, norm=norm,
                            mel_scale=scale)
    np.testing.assert_array_equal(f_max.numpy(), np.asarray(jax_dsp.mel_filters(
        16000, 400, 80, f_min=20, f_max=7600, norm=norm, mel_scale=scale)))


def test_mel_roundtrip_contract(pair):
    """120 000 samples -> 119 552 (n_fft 1024, hop 256)."""
    out = pair[1](torch.zeros(1, 120_000))
    assert out.shape == (1, 119_552)
    assert torch.isfinite(out).all()


def test_log_mel_and_audio_match_jax(pair):
    jm, tm = pair
    x = (np.random.default_rng(0).standard_normal((2, 24_000)) * 0.1).astype(np.float32)
    mel_j = np.asarray(jax_log_mel(jnp.asarray(x)))
    mel_t = log_mel_spectrogram(torch.as_tensor(x)).numpy()
    assert mel_t.shape == mel_j.shape == (2, 93, 100)
    np.testing.assert_allclose(mel_t, mel_j, **TOL)
    np.testing.assert_allclose(tm(torch.as_tensor(x)).numpy(),
                               np.asarray(jm(jnp.asarray(x))), **TOL)


def test_decode_matches_jax(pair):
    jm, tm = pair
    feats = (np.random.default_rng(1).standard_normal((1, 50, 100)) * 0.1
             ).astype(np.float32)
    want = np.asarray(jm.decode(jnp.asarray(feats)))
    got = tm.decode(torch.as_tensor(feats)).numpy()
    assert got.shape == want.shape == (1, 49 * 256)
    np.testing.assert_allclose(got, want, **TOL)
    # channels-first features are transposed, as in the JAX package
    got_ncl = tm.decode(torch.as_tensor(feats).transpose(1, 2)).numpy()
    np.testing.assert_array_equal(got_ncl, got)


def test_decode_from_codes_through_encodec_features():
    """EnCodec-token Vocos: summed codebook embeddings, a bandwidth-
    conditioned backbone (AdaLayerNorm takes the integer id as a one-hot)."""
    je = build_jax_encodec()
    te = port_encodec(je)

    def jax_model():
        return JaxVocos(JaxEncodecFeatures(je, bandwidths=[1.5, 3.0, 6.0]),
                        JaxVocosBackbone(input_channels=32, dim=64, intermediate_dim=128,
                                         num_layers=2, adanorm_num_embeddings=3),
                        JaxISTFTHead(dim=64, n_fft=1280, hop_length=320))

    jm = _seeded(jax_model)
    tm = carry(jm, Vocos(EncodecFeatures(te, bandwidths=[1.5, 3.0, 6.0]),
                         VocosBackbone(input_channels=32, dim=64, intermediate_dim=128,
                                       num_layers=2, adanorm_num_embeddings=3),
                         ISTFTHead(dim=64, n_fft=1280, hop_length=320)))
    codes = np.random.default_rng(2).integers(0, 1024, size=(8, 1, 30))
    want = np.asarray(jax.jit(lambda m, c: m.decode_from_codes(c, bandwidth_id=2))(
        jm, jnp.asarray(codes)))
    got = tm.decode_from_codes(torch.as_tensor(codes), bandwidth_id=2).numpy()
    assert got.shape == want.shape == (1, 29 * 320)
    np.testing.assert_allclose(got, want, **TOL)
    feats = tm.feature_extractor.get_features_from_codes(torch.as_tensor(codes))
    np.testing.assert_allclose(
        feats.numpy(), np.asarray(jm.feature_extractor.get_features_from_codes(
            jnp.asarray(codes))), atol=1e-6, rtol=0)


def test_same_padding_raises():
    with pytest.raises(NotImplementedError):
        MelSpectrogramFeatures(padding="same")
    with pytest.raises(NotImplementedError):
        ISTFTHead(dim=8, n_fft=16, hop_length=4, padding="same")
    config = {"feature_extractor": {"class_path": "vocos.EncodecFeatures",
                                    "init_args": {}},
              "backbone": {"init_args": {}}, "head": {"init_args": {}}}
    with pytest.raises(NotImplementedError):
        Vocos.from_hparams(config, device="cpu")
