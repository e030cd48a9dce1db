"""Mimi in the port against the JAX package, at the tiny config of
tests/test_mimi.py, float32 on the CPU.

Weights cross with ``convert.params_from_jax`` (SEANet's and Mimi's
``upsample`` transposed convs included).  Codes from ``encode`` are held
equal; audio from ``decode`` to atol 1e-4.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_audio_tpu.codec.mimi import mimi_202407 as jax_mimi_202407
from mlx_audio_tpu.nn.module import named_arrays
from mlx_audio_tpu.nn.streaming import StreamableConv1d as JaxConv
from mlx_audio_tpu.nn.streaming import StreamableConvTranspose1d as JaxConvT
from mlx_audio_tpu_torch.codec.mimi import Mimi, MimiConfig, mimi_202407
from mlx_audio_tpu_torch.codec.mimi.seanet import SeanetConfig
from mlx_audio_tpu_torch.codec.mimi.transformer import TransformerConfig
from mlx_audio_tpu_torch.convert import params_from_jax
from mlx_audio_tpu_torch.nn.streaming import StreamableConv1d, StreamableConvTranspose1d
from test_mimi import tiny_mimi

AUDIO_ATOL = 1e-4


def port_config(jax_cfg) -> MimiConfig:
    d = dataclasses.asdict(jax_cfg)
    return MimiConfig(**{**d, "seanet": SeanetConfig(**d["seanet"]),
                         "transformer": TransformerConfig(**d["transformer"])})


def carry(jax_module, port_module, prefix=""):
    named = {prefix + k: np.asarray(v) for k, v in named_arrays(jax_module)}
    state = {k[len(prefix):]: v for k, v in params_from_jax(named).items()}
    port_module.load_state_dict(state, strict=True)
    return port_module


@pytest.fixture(scope="module")
def mimis():
    jm = tiny_mimi()
    return jm, carry(jm, Mimi(port_config(jm.cfg)))


def test_published_config_matches():
    assert port_config(jax_mimi_202407(32)) == mimi_202407(32)


@pytest.mark.parametrize("kind", ["conv_edge_strided", "conv_dilated",
                                  "convtr", "convtr_depthwise"])
def test_streamable_convs_match_jax(kind):
    x = np.random.default_rng(0).standard_normal((2, 37, 16)).astype(np.float32)
    if kind == "conv_edge_strided":
        j, t = (cls(16, 8, 4, stride=2, pad_mode="edge")
                for cls in (JaxConv, StreamableConv1d))
        prefix = "downsample."
    elif kind == "conv_dilated":
        j, t = (cls(16, 8, 3, dilation=2) for cls in (JaxConv, StreamableConv1d))
        prefix = "block."
    elif kind == "convtr":
        j, t = (cls(16, 8, 8, stride=4) for cls in (JaxConvT, StreamableConvTranspose1d))
        prefix = "upsample."
    else:
        j, t = (cls(16, 16, 4, stride=2, groups=16, bias=False)
                for cls in (JaxConvT, StreamableConvTranspose1d))
        prefix = "upsample."
    carry(j, t, prefix)
    np.testing.assert_allclose(t(torch.as_tensor(x)).detach().numpy(),
                               np.asarray(j(jnp.asarray(x))), atol=1e-5, rtol=0)


def test_encode_codes_equal(mimis):
    jm, tm = mimis
    pcm = (np.random.default_rng(1).standard_normal((2, 1, 1920 * 5)) * 0.1
           ).astype(np.float32)
    ref = np.asarray(jm.encode(jnp.asarray(pcm)))
    got = tm.encode(torch.as_tensor(pcm)).numpy()
    assert got.shape == ref.shape == (2, 4, 5)
    np.testing.assert_array_equal(got, ref)


def test_decode_audio_matches(mimis):
    jm, tm = mimis
    codes = np.random.default_rng(2).integers(0, 64, size=(2, 4, 6))
    ref = np.asarray(jm.decode(jnp.asarray(codes, jnp.int32)))
    got = tm.decode(torch.as_tensor(codes)).numpy()
    assert got.shape == ref.shape == (2, 1, 6 * 1920)
    np.testing.assert_allclose(got, ref, atol=AUDIO_ATOL, rtol=0)


def test_shape_contract(mimis):
    """5 s of 24 kHz -> codes (1, nq, 63) -> audio (1, 1, 120960)."""
    tm = mimis[1]
    codes = tm.encode(torch.zeros(1, 1, 120000))
    assert codes.shape == (1, 4, 63)
    assert tm.decode(codes).shape == (1, 1, 120960)


def test_codes_past_the_codebook_decode_to_nan_as_in_jax(mimis):
    """CSM's audio vocabulary (2051) is wider than Mimi's codebooks (2048):
    a code past them decodes to NaN in both packages (jnp.take fills)."""
    jm, tm = mimis
    codes = np.random.default_rng(3).integers(0, 64, size=(1, 4, 3))
    codes[0, 2, 1] = 64
    ref = np.asarray(jm.quantizer.decode(jnp.asarray(codes, jnp.int32)))
    got = tm.quantizer.decode(torch.as_tensor(codes)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    assert np.isnan(got[0, 1]).all() and not np.isnan(got[0, [0, 2]]).any()
    np.testing.assert_allclose(got[0, [0, 2]], ref[0, [0, 2]], atol=1e-5, rtol=0)
