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


def carry(jax_module, port_module):
    named = {k: np.asarray(v) for k, v in named_arrays(jax_module)}
    port_module.load_state_dict(params_from_jax(named, port_module), strict=True)
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
    elif kind == "conv_dilated":
        j, t = (cls(16, 8, 3, dilation=2) for cls in (JaxConv, StreamableConv1d))
    elif kind == "convtr":
        j, t = (cls(16, 8, 8, stride=4) for cls in (JaxConvT, StreamableConvTranspose1d))
    else:
        j, t = (cls(16, 16, 4, stride=2, groups=16, bias=False)
                for cls in (JaxConvT, StreamableConvTranspose1d))
    carry(j, t)
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


# ---------------------------------------------------------------------------
# The stateful path: port twins of tests/test_mimi.py's streaming tests, and
# the port's steps held to the JAX package's on carried weights
# ---------------------------------------------------------------------------


def test_streaming_decode_matches_batch(mimis):
    tm = mimis[1]
    codes = torch.as_tensor(np.random.default_rng(0).integers(0, 64, size=(1, 4, 6)))
    batch = tm.decode(codes)
    stream = tm.decode_frames(codes)
    assert stream.shape == batch.shape
    np.testing.assert_allclose(stream.numpy(), batch.numpy(), atol=1e-4, rtol=0)


def test_streaming_encode_matches_batch(mimis):
    tm = mimis[1]
    frames = 5
    pcm = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (1, frames * 1920, 1)) * 0.1, dtype=torch.float32)
    batch = tm.encode(pcm).numpy()
    state, codes = tm.init_state(1), []
    for t in range(frames):
        c, state = tm.encode_step(state, pcm[:, t * 1920:(t + 1) * 1920])
        codes.append(c.numpy())
    stream = np.concatenate(codes, axis=-1)
    assert stream.shape == batch.shape
    # argmin ties at float tolerance can differ on rare frames, as in JAX
    assert (stream == batch).mean() > 0.95


def test_streaming_roundtrip_state_reuse(mimis):
    """Two decode_step calls continue one stream, and a step leaves the
    state it was given as it was."""
    tm = mimis[1]
    codes = torch.as_tensor(np.random.default_rng(2).integers(0, 64, size=(1, 4, 2)))
    state0 = tm.init_state(1)
    a1, state1 = tm.decode_step(state0, codes[..., :1])
    a2, _ = tm.decode_step(state1, codes[..., 1:])
    two_step = torch.cat([a1, a2], dim=1)[..., 0].numpy()
    np.testing.assert_allclose(two_step, tm.decode(codes)[:, 0].numpy(), atol=1e-4, rtol=0)
    again, _ = tm.decode_step(state0, codes[..., :1])
    np.testing.assert_array_equal(again.numpy(), a1.numpy())


def test_streaming_decode_matches_batch_past_window(mimis):
    """A stream longer than the transformer's rotating window still matches
    the batch path.  The tiny model's weights at a window of 8 frames (the
    reference config's 250 would make the stream 507 frames long): 23
    frames, one at a time, wrap the ring twice."""
    jm = mimis[0]
    cfg = port_config(jm.cfg)
    cfg = dataclasses.replace(cfg, transformer=dataclasses.replace(cfg.transformer,
                                                                   context=8))
    tm = carry(jm, Mimi(cfg))
    n = tm.cfg.transformer.context * 2 + 7
    codes = torch.as_tensor(np.random.default_rng(7).integers(0, 64, size=(1, 4, n)))
    np.testing.assert_allclose(tm.decode_frames(codes).numpy(), tm.decode(codes).numpy(),
                               atol=2e-4, rtol=0)


def test_rotating_attention_step_equals_batch_tiny_window():
    """Two-token steps over a full ring of 4 slots equal the batch windowed
    attention: a step attends over the ring before its own writes."""
    from mlx_audio_tpu_torch.codec.mimi.transformer import Attention

    cfg = TransformerConfig(
        d_model=16, num_heads=2, num_layers=1, causal=True, norm_first=True,
        bias_ff=False, bias_attn=False, layer_scale=None,
        positional_embedding="rope", use_conv_bias=True, gating=False,
        norm="layer_norm", context=4, max_period=10000, max_seq_len=8192,
        kv_repeat=1, dim_feedforward=32, conv_layout=True)
    attn = Attention(cfg)
    for m in attn.modules():
        if hasattr(m, "init_weights"):
            m.init_weights(torch.Generator().manual_seed(0))
    x = torch.as_tensor(np.random.default_rng(0).standard_normal((1, 12, 16)) * 0.5,
                        dtype=torch.float32)
    with torch.no_grad():
        batch = attn(x)
        cache, outs = attn.init_cache(1), []
        for i in range(0, 12, 2):
            o, cache = attn.step(cache, x[:, i:i + 2])
            outs.append(o)
    torch.testing.assert_close(torch.cat(outs, dim=1), batch, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kind", ["conv_edge_strided", "conv_dilated", "convtr",
                                  "convtr_depthwise"])
def test_streamable_conv_steps_match_jax(kind):
    """Chunk by chunk, each conv's step equals the JAX step: the edge pad on
    the first chunk only, the transposed conv's bias-free overlap carry."""
    x = np.random.default_rng(4).standard_normal((2, 24, 16)).astype(np.float32)
    if kind == "conv_edge_strided":
        j, t = (cls(16, 8, 4, stride=2, pad_mode="edge") for cls in (JaxConv, StreamableConv1d))
    elif kind == "conv_dilated":
        j, t = (cls(16, 8, 3, dilation=2) for cls in (JaxConv, StreamableConv1d))
    elif kind == "convtr":
        j, t = (cls(16, 8, 8, stride=4) for cls in (JaxConvT, StreamableConvTranspose1d))
    else:
        j, t = (cls(16, 16, 4, stride=2, groups=16, bias=False)
                for cls in (JaxConvT, StreamableConvTranspose1d))
    if getattr(j, "bias", None) is not None:
        j.bias = jnp.asarray(np.linspace(-1, 1, j.bias.shape[0]), jnp.float32)
    carry(j, t)
    js, ts = j.init_state(2), t.init_state(2)
    for a in range(0, 24, 8):
        ref, js = j.step(js, jnp.asarray(x[:, a:a + 8]))
        with torch.no_grad():
            got, ts = t.step(ts, torch.as_tensor(x[:, a:a + 8]))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
        np.testing.assert_allclose(ts.buf.numpy(), np.asarray(js.buf), atol=1e-5, rtol=0)


def test_gappy_transposed_conv_refuses_to_stream():
    conv = StreamableConvTranspose1d(4, 4, 2, stride=3)
    with pytest.raises(NotImplementedError, match="ksize >= stride"):
        conv.init_state(1)


def test_decode_and_encode_steps_match_jax(mimis):
    """The port's decode_step and encode_step against the JAX package's,
    frame by frame on the same weights and carried states."""
    jm, tm = mimis
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 64, size=(1, 4, 4))
    js, ts = jm.init_state(1), tm.init_state(1)
    for f in range(codes.shape[-1]):
        ref, js = jm.decode_step(js, jnp.asarray(codes[..., f:f + 1], jnp.int32))
        got, ts = tm.decode_step(ts, torch.as_tensor(codes[..., f:f + 1]))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=0)
    pcm = (rng.standard_normal((1, 3 * 1920, 1)) * 0.1).astype(np.float32)
    js, ts = jm.init_state(1), tm.init_state(1)
    got_codes, ref_codes = [], []
    for f in range(3):
        ref, js = jm.encode_step(js, jnp.asarray(pcm[:, f * 1920:(f + 1) * 1920]))
        got, ts = tm.encode_step(ts, torch.as_tensor(pcm[:, f * 1920:(f + 1) * 1920]))
        ref_codes.append(np.asarray(ref))
        got_codes.append(got.numpy())
    assert (np.concatenate(got_codes, -1) == np.concatenate(ref_codes, -1)).mean() > 0.95
