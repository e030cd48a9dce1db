"""BigVGAN in the port against the JAX package, float32 on the CPU: the twins
of tests/test_vocos_bigvgan.py's BigVGAN tests at its ``small_bigvgan``
widths, a model wide enough that its resblocks take both conv kernels'
routes (their plain versions on the CPU), the routes of BigVGAN-v2-24kHz's
resblocks, and the strict crossing of every array of BigVGAN and Parakeet.

The JAX init sets ``weight_g`` to the norm of ``weight_v`` and the snake
parameters to 0 (log scale), which would hide a wrong axis: both are
redrawn before crossing.  Audio is held to atol 1e-4 and rtol 1e-4.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mlx_audio_tpu.nn.layers as jax_layers
from mlx_audio_tpu.codec.bigvgan import BigVGAN as JaxBigVGAN
from mlx_audio_tpu.codec.bigvgan import BigVGANConfig as JaxBigVGANConfig
from mlx_audio_tpu.codec.bigvgan import bigvgan as jbv
from mlx_audio_tpu.models.stt.parakeet import BaseParakeet as JaxBaseParakeet
from mlx_audio_tpu.nn.module import named_arrays, update_arrays
from mlx_audio_tpu_torch.codec.bigvgan import BigVGAN, BigVGANConfig
from mlx_audio_tpu_torch.codec.bigvgan import bigvgan as tbv
from mlx_audio_tpu_torch.convert import params_from_jax
from mlx_audio_tpu_torch.models.stt.parakeet import BaseParakeet
from mlx_audio_tpu_torch.nn import layers
from test_parakeet import ctc_config, tdt_config
from test_vocos_bigvgan import small_bigvgan

TOL = dict(atol=1e-4, rtol=1e-4)

# nvidia/bigvgan_v2_24khz_100band_256x's config.json
BIGVGAN_V2_24KHZ = dict(
    num_mels=100, upsample_rates=[4, 4, 2, 2, 2, 2],
    upsample_kernel_sizes=[8, 8, 4, 4, 4, 4], upsample_initial_channel=1536,
    resblock="1", resblock_kernel_sizes=[3, 7, 11],
    resblock_dilation_sizes=[[1, 3, 5], [1, 3, 5], [1, 3, 5]],
    activation="snakebeta", snake_logscale=True, use_tanh_at_final=False,
    use_bias_at_final=False)


def _seeded(build):
    saved = jax_layers._INIT_RNG
    jax_layers._INIT_RNG = np.random.default_rng(0)
    try:
        return build()
    finally:
        jax_layers._INIT_RNG = saved


def randomized(jm, seed=1):
    """Every weight_g, snake alpha and beta drawn."""
    rng = np.random.default_rng(seed)
    new = {}
    for k, v in named_arrays(jm):
        if k.endswith("weight_g"):
            new[k] = (np.asarray(v) * rng.uniform(0.5, 1.5, v.shape)).astype(np.float32)
        elif k.endswith((".alpha", ".beta")):
            new[k] = (rng.standard_normal(v.shape) * 0.3).astype(np.float32)
    return update_arrays(jm, new)


def carry(jm, tm):
    named = {k: np.asarray(v) for k, v in named_arrays(jm)}
    tm.load_state_dict(params_from_jax(named, tm), strict=True)
    return tm


def pair(config: dict):
    jm = randomized(_seeded(lambda: JaxBigVGAN(JaxBigVGANConfig(**config))))
    return jm, carry(jm, BigVGAN(BigVGANConfig(**config), device="cpu"))


def _mel(seed, shape):
    return (np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("resblock,act", [("1", "snakebeta"), ("2", "snake")])
def test_bigvgan_upsampling_contract(resblock, act):
    """[B, num_mels, T] in, [B, 8 T, 1] out (4 x 2 upsampling), bounded by the
    final tanh; on a seeded mel, equal to the JAX package's."""
    jm = randomized(_seeded(lambda: small_bigvgan(resblock, act)))
    tm = carry(jm, BigVGAN(jm.config, device="cpu"))
    out = tm(torch.zeros(1, 20, 16))
    assert out.shape == (1, 16 * 8, 1)
    assert bool(torch.isfinite(out).all()) and float(out.abs().max()) <= 1.0
    mel = _mel(2, (2, 20, 16))
    got = tm(torch.as_tensor(mel))
    np.testing.assert_allclose(got.numpy(), np.asarray(jm(jnp.asarray(mel))), **TOL)
    assert float(got.abs().max()) > 1e-3


def test_kaiser_filter_dc_gain():
    f = tbv.kaiser_sinc_filter1d(0.25, 0.3, 12)
    np.testing.assert_allclose(f.sum(), 1.0, atol=1e-6)
    for args in ((0.25, 0.3, 12), (0.5, 0.6, 12), (0.25, 0.3, 11), (0.0, 0.3, 12)):
        np.testing.assert_array_equal(tbv.kaiser_sinc_filter1d(*args),
                                      jbv.kaiser_sinc_filter1d(*args))


def test_antialiased_activation_preserves_length():
    """Up 2x, snake, down 2x keeps the length; values equal to JAX's."""
    alpha = (np.random.default_rng(3).standard_normal(8) * 0.3).astype(np.float32)
    ja = jbv.Activation1d(jbv.SnakeAct(8))
    ja.act.alpha = jnp.asarray(alpha)
    ta = tbv.Activation1d(tbv.SnakeAct(8))
    with torch.no_grad():
        ta.act.alpha.copy_(torch.as_tensor(alpha))
    x = np.random.default_rng(1).standard_normal((2, 40, 8)).astype(np.float32)
    y = ta(torch.as_tensor(x))
    assert y.shape == x.shape
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ja(jnp.asarray(x))), **TOL)


def test_bigvgan_on_both_conv_kernel_routes(monkeypatch):
    """At 128 channels and 4096 rows the resblock convs route to both
    kernels (banded at K = 7, d = 1; shifted at K = 3 and at d = 3), whose
    plain versions run on the CPU; the audio equals the JAX package's."""
    config = dict(num_mels=20, upsample_rates=[4, 2], upsample_kernel_sizes=[8, 4],
                  upsample_initial_channel=256, resblock="1",
                  resblock_kernel_sizes=[3, 7], resblock_dilation_sizes=[[1, 3], [1, 3]],
                  activation="snakebeta", snake_logscale=True)
    jm, tm = pair(config)
    routes = {}
    route_fn = layers.conv1d_route

    def recording(k, c, c_out, l, dilation=1, *a):
        route = route_fn(k, c, c_out, l, dilation, *a)
        routes[(route, c, k, dilation)] = routes.get((route, c, k, dilation), 0) + 1
        return route

    monkeypatch.setattr(layers, "conv1d_route", recording)
    mel = _mel(5, (1, 20, 1024)) * 0.5
    got = tm(torch.as_tensor(mel))
    assert got.shape == (1, 8192, 1)
    assert routes[("banded", 128, 7, 1)] == 3
    assert routes[("shifted", 128, 7, 3)] == 1
    assert routes[("shifted", 128, 3, 1)] + routes[("shifted", 128, 3, 3)] == 4
    np.testing.assert_allclose(got.numpy(), np.asarray(jm(jnp.asarray(mel))), **TOL)


def test_bigvgan_v2_resblocks_route_to_both_conv_kernels():
    """BigVGAN-v2-24kHz's resblocks on a 10 s mel (938 frames): all 18 convs
    of the 768-channel stage [B, 3752, 768] take dilated_conv1d; at 384
    channels and 15 008 rows, K = 7 and 11 at d = 1 and 3 take banded_conv1d
    (10 convs), K = 3 and d = 5 dilated_conv1d (8); the later stages,
    conv_pre and conv_post the library.  The modules are built on the meta
    device (shapes only)."""
    cfg = BigVGANConfig(**BIGVGAN_V2_24KHZ)
    frames = 938
    with torch.device("meta"):
        blocks = [(i, tbv.AMPBlock1(cfg.upsample_initial_channel // 2 ** (i + 1), True,
                                    "snakebeta", k, d))
                  for i in range(len(cfg.upsample_rates))
                  for k, d in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes)]
    counts = {}
    for i, block in blocks:
        rows = frames * int(np.prod(cfg.upsample_rates[:i + 1]))
        for conv in (*block.convs1, *block.convs2):
            c_out, c, k = conv.weight_v.shape
            route = layers.conv1d_route(k, c, c_out, rows, conv.dilation, conv.stride,
                                        conv.groups, conv.padding)
            counts[(i, route)] = counts.get((i, route), 0) + 1
    assert counts == {(0, "shifted"): 18, (1, "banded"): 10, (1, "shifted"): 8,
                      (2, "library"): 18, (3, "library"): 18, (4, "library"): 18,
                      (5, "library"): 18}


@pytest.mark.parametrize("family", ["bigvgan", "parakeet_tdt", "parakeet_ctc"])
def test_params_from_jax_loads_strict(family):
    """Every array of the JAX model crosses by name and shape: the WN
    convs' (v, g) and the transposed convs of ``ups``, the filters, the
    Conformer's 2-d convs (HWIO -> OIHW), LSTMs and the joint."""
    if family == "bigvgan":
        jm = small_bigvgan()
        tm = BigVGAN(jm.config, device="cpu")
    else:
        cfg = tdt_config() if family == "parakeet_tdt" else ctc_config()
        jm = JaxBaseParakeet.from_config(cfg)
        tm = BaseParakeet.from_config(cfg, device="cpu")
    named = {k: np.asarray(v) for k, v in named_arrays(jm)}
    state = params_from_jax(named, tm)
    assert set(state) == set(tm.state_dict())
    tm.load_state_dict(state, strict=True)
    for key, t in tm.state_dict().items():
        assert t.shape == state[key].shape, key
    if family == "parakeet_ctc":
        w = named["encoder.pre_encode.conv.1.weight"]  # depthwise 3x3, HWIO
        np.testing.assert_array_equal(tm.encoder.pre_encode.conv[1].weight.numpy(),
                                      w.transpose(3, 2, 0, 1))
    if family == "bigvgan":
        v = named["ups.0.0.weight_v"]  # [K, Cin, Cout] -> [Cin, Cout, K]
        np.testing.assert_array_equal(tm.ups[0][0].weight_v.numpy(), v.transpose(1, 2, 0))


def test_from_pretrained_loads_a_local_mlx_layout_directory(tmp_path):
    """A local directory in the MLX layout (convs [O, K, I], weight_g [O, 1,
    1], snake parameters [1, C, 1], filters [1, 1, K]) loads through the
    port's sanitize and params_from_jax: the audio equals the JAX model's
    whose arrays were written; a missing directory raises."""
    import json

    from safetensors.numpy import save_file

    jm = randomized(_seeded(lambda: small_bigvgan()))
    weights = {}
    for k, v in named_arrays(jm):
        v = np.asarray(v)
        if k.endswith(("weight_v", "weight_g")):
            v = v.transpose(2, 0, 1)
        elif k.endswith((".alpha", ".beta")):
            v = v.reshape(1, -1, 1)
        elif k.endswith(".filter"):
            v = v.reshape(1, 1, -1)
        weights[k] = np.ascontiguousarray(v)
    save_file(weights, str(tmp_path / "model.safetensors"))
    (tmp_path / "config.json").write_text(json.dumps(vars(jm.config)))
    tm = BigVGAN.from_pretrained(str(tmp_path), device="cpu")
    mel = _mel(9, (1, 20, 12))
    np.testing.assert_allclose(tm(torch.as_tensor(mel)).numpy(),
                               np.asarray(jm(jnp.asarray(mel))), **TOL)
    with pytest.raises(FileNotFoundError):
        BigVGAN.from_pretrained(str(tmp_path / "missing"), device="cpu")
