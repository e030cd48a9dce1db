"""Per-layer parity: the port's layers against the JAX package's.

Each case builds the JAX layer with its random init, carries the weights
across with ``mlx_audio_tpu_torch.convert.params_from_jax``, feeds both the
same numpy inputs on the CPU and compares.  Tolerance atol 1e-5 in float32
unless a case states its own.
"""

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mlx_audio_tpu.nn as jnn
from mlx_audio_tpu import dsp as jdsp
from mlx_audio_tpu.models.tts.kokoro import istftnet as jist
from mlx_audio_tpu.nn.module import named_arrays
from mlx_audio_tpu_torch import dsp as tdsp
from mlx_audio_tpu_torch import nn as tnn
from mlx_audio_tpu_torch.convert import params_from_jax
from mlx_audio_tpu_torch.models.tts.kokoro import istftnet as tist
from mlx_audio_tpu_torch.nn import kernels as tnn_kernels

ATOL = 1e-5
ROOT = Path(__file__).resolve().parent.parent

# One cap on torch's intra-op threads for the whole suite.  pytest-xdist
# has every worker collect every test file, so this module-level call runs
# in each worker during collection, before any test: the port's twins then
# run 2 threads a worker instead of a full pool each (6 workers on 8 cores
# oversubscribe the cores several times over).
TORCH_THREADS = 2
torch.set_num_threads(TORCH_THREADS)


def _carry(jax_layer, port_layer):
    """Load the JAX layer's weights into the port layer."""
    named = {k: np.asarray(v) for k, v in named_arrays(jax_layer)}
    port_layer.load_state_dict(params_from_jax(named, port_layer), strict=True)
    return port_layer


def _x(shape, seed=0, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _mask(b, l):
    lengths = np.array([l, l * 2 // 3])[:b]
    return np.arange(l)[None, :] < lengths[:, None]


def _case_layernorm():
    j, t = jnn.LayerNorm(48), tnn.LayerNorm(48)
    x = _x((2, 7, 48))
    return j(jnp.asarray(x)), _carry(j, t)(torch.as_tensor(x))


def _case_instancenorm_masked():
    j, t = jnn.InstanceNorm1d(16), tnn.InstanceNorm1d(16)
    x, m = _x((2, 40, 16)), _mask(2, 40)
    return (j(jnp.asarray(x), jnp.asarray(m)),
            t(torch.as_tensor(x), torch.as_tensor(m)))


def _case_adain_masked():
    j, t = jnn.AdaIN1d(24, 16), tnn.AdaIN1d(24, 16)
    x, m, s = _x((2, 40, 16)), _mask(2, 40), _x((2, 24), 1)
    return (j(jnp.asarray(x), jnp.asarray(s), jnp.asarray(m)),
            _carry(j, t)(torch.as_tensor(x), torch.as_tensor(s),
                         torch.as_tensor(m)))


def _case_adalayernorm():
    j, t = jnn.AdaLayerNorm(24, 16), tnn.AdaLayerNorm(24, 16)
    x, s = _x((2, 9, 16)), _x((2, 24), 1)
    return (j(jnp.asarray(x), jnp.asarray(s)),
            _carry(j, t)(torch.as_tensor(x), torch.as_tensor(s)))


def _conv_case(c, c_out, k, l, dilation=1, stride=1, padding=None,
               wn=True):
    padding = jnn.get_padding(k, dilation) if padding is None else padding
    kw = dict(stride=stride, padding=padding, dilation=dilation)
    if wn:
        j, t = jnn.WNConv1d(c, c_out, k, **kw), tnn.WNConv1d(c, c_out, k, **kw)
    else:
        j, t = jnn.Conv1d(c, c_out, k, **kw), tnn.Conv1d(c, c_out, k, **kw)
    x = _x((2, l, c), scale=0.3)
    return j(jnp.asarray(x)), _carry(j, t)(torch.as_tensor(x))


def _case_convtranspose(depthwise):
    if depthwise:
        kw = dict(kernel_size=3, stride=2, padding=1, groups=16)
        j, t = jnn.WNConvTranspose1d(16, 16, **kw), tnn.WNConvTranspose1d(16, 16, **kw)
    else:
        kw = dict(kernel_size=12, stride=6, padding=3)
        j, t = jnn.WNConvTranspose1d(16, 8, **kw), tnn.WNConvTranspose1d(16, 8, **kw)
    x = _x((2, 13, 16))
    return j(jnp.asarray(x)), _carry(j, t)(torch.as_tensor(x))


def _case_lstm_lengths():
    j, t = jnn.LSTM(12, 8), tnn.LSTM(12, 8)
    x = _x((3, 10, 12))
    lengths = np.array([10, 6, 1])
    out_j, ((hf, cf), (hb, cb)) = j(jnp.asarray(x), lengths=jnp.asarray(lengths))
    out_t, ((hf2, cf2), (hb2, cb2)) = _carry(j, t)(torch.as_tensor(x),
                                                   lengths=torch.as_tensor(lengths))
    return (jnp.concatenate([out_j.reshape(3, -1), hf, cf, hb, cb], -1),
            torch.cat([out_t.reshape(3, -1), hf2, cf2, hb2, cb2], -1))


def _case_interpolate(mode, align_corners, size):
    x = _x((2, 11, 3))
    return (jnn.interpolate(jnp.asarray(x), size=size, mode=mode,
                            align_corners=align_corners),
            tnn.interpolate(torch.as_tensor(x), size=size, mode=mode,
                            align_corners=align_corners))


def _case_stft():
    x = _x((2, 613))
    re_j, im_j = jdsp.stft_realimag(jnp.asarray(x), 20, 5, 20, "hann_periodic")
    re_t, im_t = tdsp.stft_realimag(torch.as_tensor(x), 20, 5, 20, "hann_periodic")
    return (jnp.concatenate([re_j, im_j], -1), torch.cat([re_t, im_t], -1))


def _case_istft():
    re, im = _x((2, 11, 30)), _x((2, 11, 30), 1)
    spec = re + 1j * im
    return (jdsp.istft(jnp.asarray(spec), 5, 20, "hann_periodic"),
            tdsp.istft(torch.as_tensor(spec), 5, 20, "hann_periodic"))


def _case_unwrap():
    p = np.cumsum(_x((2, 50, 11), scale=2.0), axis=1)
    p = (p + np.pi) % (2 * np.pi) - np.pi
    return (jist.unwrap(jnp.asarray(p), axis=-2),
            tist.unwrap(torch.as_tensor(p), dim=-2))


CASES = {
    "layernorm": _case_layernorm,
    "instancenorm_masked": _case_instancenorm_masked,
    "adain_masked": _case_adain_masked,
    "adalayernorm": _case_adalayernorm,
    "wnconv1d_library": lambda: _conv_case(16, 24, 5, 37, dilation=2),
    "conv1d_strided": lambda: _conv_case(22, 16, 12, 150, stride=6,
                                         padding=3, wn=False),
    "wnconv1d_shifted_route": lambda: _conv_case(128, 128, 3, 2100, dilation=3),
    "wnconv1d_banded_route": lambda: _conv_case(128, 128, 7, 4200),
    "wnconv1d_banded_residue_route": lambda: _conv_case(128, 128, 11, 12400,
                                                        dilation=3),
    "wnconvtranspose1d": lambda: _case_convtranspose(False),
    "wnconvtranspose1d_depthwise": lambda: _case_convtranspose(True),
    "lstm_lengths": _case_lstm_lengths,
    "interpolate_nearest": lambda: _case_interpolate("nearest", None, 25),
    "interpolate_linear": lambda: _case_interpolate("linear", None, 4),
    "interpolate_linear_align_corners": lambda: _case_interpolate("linear", True, 30),
    "stft_realimag": _case_stft,
    "istft": _case_istft,
    "unwrap": _case_unwrap,
}


@pytest.mark.parametrize("case", list(CASES))
def test_layer_matches_jax(case):
    ref, got = CASES[case]()
    assert tuple(got.shape) == tuple(ref.shape)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=ATOL, rtol=0)


KOKORO_FRAMES = 1300  # the frame bucket of a full 510-phoneme segment


def test_kokoro_82m_resblock_convs_reach_the_kernels():
    """At Kokoro-82M's width and frame bucket every Generator resblock conv
    routes to a kernel: K = 3 to the shifted kernel, K = 7 and 11 to the
    banded one; every other conv of the decoder goes to the library."""
    from mlx_audio_tpu_torch.models.tts.kokoro.presets import kokoro_82m_config

    cfg = kokoro_82m_config()
    gen = tist.Generator(cfg.style_dim, **cfg.istftnet)
    length = 2 * KOKORO_FRAMES
    routes = {}
    for i, rate in enumerate(gen.upsample_rates):
        length = length * rate + (1 if i == gen.num_upsamples - 1 else 0)
        blocks = [*gen.resblocks[i * gen.num_kernels:(i + 1) * gen.num_kernels],
                  gen.noise_res[i]]
        for block in blocks:
            for conv in [*block.convs1, *block.convs2]:
                out_c, in_c, k = conv.weight_v.shape
                route = tnn.conv1d_route(k, in_c, out_c, length, conv.dilation,
                                         conv.stride, conv.groups, conv.padding)
                assert route == ("shifted" if k == 3 else "banded"), (i, k)
                routes[route] = routes.get(route, 0) + 1
    # 2 stages x (3 resblocks + 1 noise resblock) x 3 dilations x 2 convs
    assert routes == {"shifted": 12, "banded": 36}
    post = gen.conv_post.weight_v.shape
    assert tnn.conv1d_route(post[2], post[1], post[0], length, 1, 1, 1, 3) == "library"
    assert tnn.conv1d_route(3, 1090, 1024, KOKORO_FRAMES, 1, 1, 1, 1) == "library"
    assert tnn.conv1d_route(7, 128, 128, length, 1, 1, 1, 3,
                            torch.bfloat16) == "banded"
    assert tnn.conv1d_route(7, 128, 128, length, 1, 1, 1, 3,
                            torch.float16) == "library"


@pytest.mark.parametrize("k,route", [(11, "banded"), (13, "banded"),
                                     (15, "shifted")])
def test_banded_route_stops_where_the_kernel_runs_out_of_shared_memory(k, route):
    """The banded kernel stages K weight slices a stage, so its shared
    memory grows with K; the route sends no K to it that its wrapper would
    refuse on the card: K = 15 goes to the shifted kernel instead."""
    fits = tnn_kernels.banded_conv1d_smem_bytes(k) <= tnn_kernels.SMEM_LIMIT_BYTES
    assert fits == (route == "banded")
    assert tnn.conv1d_route(k, 128, 128, 8192, 1, 1, 1, (k - 1) // 2) == route


@pytest.mark.parametrize("k,d,channels,stages", [(3, 1, 32, 2), (3, 5, 32, 2),
                                                 (11, 5, 8, 3), (15, 1, 8, 2)])
def test_dilated_kernel_shared_memory_and_route(k, d, channels, stages):
    """csrc/dilated_conv1d.cu stages a halo window of 192 + (K-1) d rows and
    K [s, 128] weight slices, S deep, plus one split window: 4 (S (W + 136 s
    K) + W) bytes with W = (s + 4) (192 + (K-1) d), taking the first (s, S)
    of (32, 2), (8, 3), (8, 2) that fits a block.  Every one of these still
    routes to it."""
    window = (channels + 4) * (192 + (k - 1) * d)
    want = 4 * (stages * (window + 136 * channels * k) + window)
    assert tnn_kernels.dilated_conv1d_smem_bytes(k, d) == want
    assert want <= tnn_kernels.SMEM_LIMIT_BYTES
    assert tnn.conv1d_route(k, 128, 128, 8192, d, 1, 1, (k - 1) * d // 2) == "shifted"


@pytest.mark.parametrize("logscale", [True, False], ids=["log", "linear"])
def test_snake_beta_matches_jax(logscale):
    """SnakeBeta x + sin^2(a x) / b per channel, with a and b given as logs
    or as they are (positive then, as a checkpoint's are)."""
    rng = np.random.default_rng(3)
    x = _x((2, 17, 8), seed=4, scale=2.0)
    alpha = rng.standard_normal(8).astype(np.float32) * 0.5
    beta = rng.standard_normal(8).astype(np.float32) * 0.5
    if not logscale:
        alpha, beta = np.exp(alpha), np.exp(beta)
    want = np.asarray(jnn.snake_beta(jnp.asarray(x), jnp.asarray(alpha), jnp.asarray(beta),
                                     alpha_logscale=logscale))
    got = tnn.snake_beta(torch.as_tensor(x), torch.as_tensor(alpha), torch.as_tensor(beta),
                         alpha_logscale=logscale)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=1e-5)


def test_port_imports_no_jax():
    """Neither the port nor chip_smoke.py imports JAX or the JAX package;
    the files it parses include utils/audio_io, Parakeet's, BigVGAN's,
    IndexTTS's, S3's and CSM's SilentCipher and tokenizer loader."""
    files = sorted((ROOT / "mlx_audio_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    names = {p.relative_to(ROOT).as_posix() for p in files}
    port = "mlx_audio_tpu_torch/"
    assert {port + "utils/audio_io.py", port + "codec/bigvgan/bigvgan.py"} <= names
    assert {f"{port}models/stt/parakeet/{m}.py" for m in (
        "audio", "alignment", "conformer", "ctc", "rnnt", "parakeet")} <= names
    assert {f"{port}models/tts/indextts/{m}.py" for m in (
        "__init__", "attention", "conformer", "ecapa", "gpt", "indextts", "normalize",
        "perceiver", "vocoder")} <= names
    assert {port + "codec/s3/__init__.py", port + "codec/s3/s3.py",
            port + "models/tts/sesame/silentcipher.py",
            port + "models/tts/sesame/tokenizer.py"} <= names

    def banned(name):
        return (name in ("jax", "mlx_audio_tpu") or name.startswith("jax.")
                or name.startswith("mlx_audio_tpu."))

    found = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            found += [f"{path.relative_to(ROOT)}: {n}" for n in names if banned(n)]
    assert not found, found
