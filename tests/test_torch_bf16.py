"""bf16 in the port against the JAX package's bf16, on the CPU at tiny
widths: the three kernels' plain versions, the conv route, operand
promotion, the bf16 weight bridge, Kokoro end to end, and the conv codecs
and vocoders (the twins of tests/test_bf16_families.py).

A model in bf16 is the float32 model cast with ``.to(torch.bfloat16)``, its
weights carried from the JAX model cast with ``.astype(jnp.bfloat16)`` bit
for bit.  Both frameworks round to bf16 at their own places (the port's
kernels sum in float32 and round each output once; the JAX package runs its
CPU convs through XLA and its LSTM as a bf16 ``lax.scan``), so outputs are
held to a relative RMS, each with the bound stated beside it, and codes to
JAX's wherever JAX's nearest-codeword margin exceeds a stated bf16 bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_audio_tpu.nn.module import named_arrays
from mlx_audio_tpu.nn.pallas_ops import (
    banded_conv1d_pallas,
    banded_conv_supported as jax_banded_supported,
    dilated_conv1d_pallas,
)
from mlx_audio_tpu.nn.layers import _dilated_conv1d_residue as jax_residue
from mlx_audio_tpu.nn.recurrent import lstm_scan as jax_lstm_scan
from mlx_audio_tpu_torch.convert import params_from_jax
from mlx_audio_tpu_torch.nn import kernels, lstm_scan
from mlx_audio_tpu_torch.nn import layers as tlayers

BF16 = torch.bfloat16


def _np(a) -> np.ndarray:
    """A JAX or torch array as float64 numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32), dtype=np.float64)


def rel_rms(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.sqrt(np.mean((got - want) ** 2))
                 / (np.sqrt(np.mean(want ** 2)) + 1e-12))


def _bf16_pair(rng, shape, scale):
    """The same bf16 values as a JAX array and a torch tensor."""
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.as_tensor(np.asarray(j, np.float32)).to(BF16)


def port_of(jax_module, port_module):
    """``port_module`` cast to bf16 and loaded with ``jax_module``'s bf16
    leaves, bit for bit; returns it."""
    port_module.to(BF16)
    named = {k: np.asarray(v) for k, v in named_arrays(jax_module)}
    port_module.load_state_dict(params_from_jax(named, port_module))
    return port_module


# ---------------------------------------------------------------------------
# the kernels' plain versions against the JAX kernels in bf16
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k,d", [(3, 1), (7, 3), (11, 5)])
def test_dilated_conv_plain_bf16_matches_pallas(k, d):
    """Both sum in float32 and round once: within one bf16 step."""
    rng = np.random.default_rng(k)
    xj, xt = _bf16_pair(rng, (2, 1111, 128), 0.3)
    wj, wt = _bf16_pair(rng, (k, 128, 128), 0.05)
    want = dilated_conv1d_pallas(xj, wj, d, interpret=True)
    got = kernels.dilated_conv1d(xt, wt, d)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    assert kernels.bf16_steps(got, torch.as_tensor(_np(want))) <= 1.0


@pytest.mark.parametrize("k,d", [(7, 1), (11, 1), (7, 3)])
def test_banded_conv_plain_bf16_matches_pallas(k, d):
    """The banded plain version (and the residue fold, which keeps bf16)
    against banded_conv1d_pallas in bf16: within one bf16 step."""
    from functools import partial

    rng = np.random.default_rng(10 + k + d)
    xj, xt = _bf16_pair(rng, (1, 4096 + 37, 128), 0.3)
    wj, wt = _bf16_pair(rng, (k, 128, 128), 0.05)
    want = jax_residue(xj, wj, d, partial(banded_conv1d_pallas, interpret=True))
    got = tlayers._dilated_conv1d_residue(xt, wt, d, kernels.banded_conv1d)
    assert got.dtype == BF16
    assert kernels.bf16_steps(got, torch.as_tensor(_np(want))) <= 1.0


# the JAX scan carries h and c in bf16, the port's plain version (as its
# kernel) in float32: over 24 steps their outputs part by a few bf16 steps
# (observed up to 7.0e-3 relative RMS)
LSTM_REL_RMS = 2e-2


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_plain_bf16_matches_scan(reverse):
    rng = np.random.default_rng(3)
    b, t, h = 3, 24, 64
    xj, xt = _bf16_pair(rng, (b, t, 4 * h), 0.3)
    wj, wt = _bf16_pair(rng, (4 * h, h), 0.1)
    hj, ht = _bf16_pair(rng, (b, h), 0.1)
    cj, ct = _bf16_pair(rng, (b, h), 0.1)
    want = jax_lstm_scan(xj, wj, hj, cj, reverse=reverse, return_cells=True)
    got = lstm_scan(xt, wt, ht, ct, reverse=reverse, return_cells=True)
    assert got[0].dtype == BF16 and want[0].dtype == jnp.bfloat16
    for g, w in zip((got[0], got[1], *got[2]), (want[0], want[1], *want[2])):
        assert rel_rms(g, w) < LSTM_REL_RMS


def test_lstm_plain_bf16_is_float32_rounded_once():
    """The plain version on bf16 operands is its float32 run on the same
    values, each output rounded to bf16 once."""
    rng = np.random.default_rng(4)
    _, xt = _bf16_pair(rng, (2, 9, 128), 0.3)
    _, wt = _bf16_pair(rng, (32, 128), 0.1)
    _, ht = _bf16_pair(rng, (2, 32), 0.1)
    got = kernels.lstm(xt, wt, ht, ht)
    ref = kernels.lstm(xt.float(), wt.float(), ht.float(), ht.float())
    for g, r in zip((got[0], got[1], *got[2]), (ref[0], ref[1], *ref[2])):
        assert g.dtype == BF16 and torch.equal(g, r.to(BF16))


# ---------------------------------------------------------------------------
# the route, promotion and the weight bridge
# ---------------------------------------------------------------------------


def _jax_route(k, c, c_out, l, d):
    """The JAX package's conv1d dispatch with both TPU opt-ins on and its
    VMEM clauses dropped, as the port drops them (a Hopper block's shared
    memory takes their place, tests/test_torch_layers.py): its banded gate
    at dtype_size 0, its shifted clause without the weight-bytes term."""
    if k > 1 and k % 2 == 1:
        if jax_banded_supported(k, c, c_out, l // max(d, 1), 0):
            return "banded"
        if l >= 2048 and c % 128 == 0 and c_out % 128 == 0:
            return "shifted"
    return "library"


# (K, C, Cout, L, d): Kokoro-82M's resblocks at the bench's 1300 frames,
# BigVGAN-v2-24kHz's on a 10 s mel, DAC-44kHz's on a 3 s clip, and the
# tiny twins' widths below
ROUTE_SHAPES = (
    [(k, c, c, l, d) for k in (3, 7, 11) for d in (1, 3, 5)
     for c, l in ((256, 15600), (128, 156001), (768, 3752), (384, 15008))]
    + [(7, c, c, l, d) for d in (1, 3, 9)
       for c, l in ((128, 66304), (256, 16576), (512, 2072), (768, 2072), (384, 16576))]
    + [(k, 16, 16, 600, d) for k in (3, 7, 11) for d in (1, 3, 5)]
    + [(3, 128, 1280, 3000, 1), (7, 64, 64, 5000, 1), (9, 128, 128, 4096, 1)])


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
def test_conv1d_route_agrees_with_the_jax_gates(dtype):
    """bf16 takes the kernels under the float32 shape rules, with the
    shared-memory limits in 2-byte tiles; f16 and f64 stay on the
    library."""
    for k, c, c_out, l, d in ROUTE_SHAPES:
        pad = (k - 1) * d // 2
        got = tlayers.conv1d_route(k, c, c_out, l, d, 1, 1, pad, dtype)
        assert got == _jax_route(k, c, c_out, l, d), (k, c, c_out, l, d)
        for other in (torch.float16, torch.float64):
            assert tlayers.conv1d_route(k, c, c_out, l, d, 1, 1, pad, other) == "library"


def test_float32_input_into_bf16_layers_runs_in_float32():
    """As jnp.matmul and promote_conv_operands do: a bf16 conv (here on the
    banded route), transposed conv, Linear or LSTM given float32 input
    computes in float32 on its bf16 weights' values and returns float32."""
    from mlx_audio_tpu.nn import layers as jlayers
    from mlx_audio_tpu.nn.recurrent import LSTM as JaxLSTM
    from mlx_audio_tpu_torch.nn import LSTM

    rng = np.random.default_rng(6)
    x = (rng.standard_normal((2, 4200, 128)) * 0.3).astype(np.float32)
    assert tlayers.conv1d_route(7, 128, 128, 4200, 1, 1, 1, 3) == "banded"
    pairs = ((jlayers.Conv1d(128, 128, 7, padding=3), tlayers.Conv1d(128, 128, 7, padding=3),
              x),
             (jlayers.Linear(128, 96), tlayers.Linear(128, 96), x[:, :9]),
             (JaxLSTM(128, 16), LSTM(128, 16), x[:, :11]))
    for jm, tm, xin in pairs:
        jm = jm.astype(jnp.bfloat16)
        port_of(jm, tm)
        got, want = tm(torch.as_tensor(xin)), jm(jnp.asarray(xin))
        if isinstance(tm, LSTM):
            got, want = got[0], want[0]
        assert got.dtype == torch.float32 and want.dtype == jnp.float32
        np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=1e-4)

    w = (rng.standard_normal((8, 128, 64)) * 0.05).astype(np.float32)  # [K, in, out]
    wj = jnp.asarray(w, jnp.bfloat16)
    wt = torch.as_tensor(_np(wj)).to(BF16).permute(1, 2, 0)  # [in, out, K]
    got = tlayers.conv_transpose1d(torch.as_tensor(x[:, :50]), wt, 4, 2)
    want = jlayers.conv_transpose1d(jnp.asarray(x[:, :50]), wj, 4, 2)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=1e-4)


def test_params_from_jax_carries_bf16_bit_for_bit():
    from mlx_audio_tpu.nn import layers as jlayers

    jm = jlayers.WNConv1d(24, 40, 5, padding=2).astype(jnp.bfloat16)
    tm = tlayers.WNConv1d(24, 40, 5, padding=2).to(BF16)
    named = {k: np.asarray(v) for k, v in named_arrays(jm)}
    sd = params_from_jax(named, tm)
    for key, arr in named.items():
        t = sd[key]
        assert t.dtype == BF16
        ref = arr.view(np.uint16)
        if key == "weight_v":
            ref = ref.transpose(2, 1, 0)
        elif key == "weight_g":
            ref = ref.reshape(-1, 1, 1)
        assert np.array_equal(t.view(torch.int16).numpy().view(np.uint16), ref), key
    tm.load_state_dict(sd)
    assert tm.weight_v.dtype == BF16


# ---------------------------------------------------------------------------
# Kokoro-82M's graph at tests/test_kokoro.py's tiny config
# ---------------------------------------------------------------------------

# audio past the first HEAD samples (see tests/test_torch_kokoro.py: the
# symmetric first STFT frame's phase is +-pi by rounding) against JAX's bf16
# run: observed 1.3e-2 with bf16 inputs (the bench's), 4.7e-3 with the
# entry points' float32 reference and speed; bf16 against float32 differs
# by 8e-2 in either framework
KOKORO_REL_RMS = 4e-2
KOKORO_FRAMES = 64


@pytest.fixture(scope="module")
def kokoros():
    import mlx_audio_tpu.nn.layers as jax_layers
    from mlx_audio_tpu.models.tts.kokoro.model import Model as JaxModel
    from mlx_audio_tpu_torch.models.tts.kokoro import Model
    from test_torch_kokoro import _port_config, tiny_config

    # set up before conftest's per-test reseed: seed the JAX init here
    jax_layers._INIT_RNG = np.random.default_rng(0)
    j32 = JaxModel(tiny_config())
    p32 = Model(_port_config(), device="cpu")
    p32.load_state_dict(params_from_jax(
        {k: np.asarray(v) for k, v in named_arrays(j32)}, p32))
    j16 = j32.astype(jnp.bfloat16)
    return j32, j16, p32, port_of(j16, Model(_port_config(), device="cpu"))


def _kokoro_inputs(cfg):
    rng = np.random.default_rng(0)
    ids = rng.integers(1, cfg.n_token, (2, 16))
    ref = (np.random.default_rng(1).standard_normal((2, 2 * cfg.style_dim)) * 0.1
           ).astype(np.float32)
    return ids, np.full((2,), 16), ref


def _jax_kokoro(model, ids, lengths, ref, speed, key):
    from mlx_audio_tpu.models.tts.kokoro.model import _duration_stage, _synthesis_stage

    style = model.config.style_dim
    d, pred = _duration_stage(model, jnp.asarray(ids, jnp.int32),
                              jnp.asarray(lengths, jnp.int32), ref[:, style:], speed)
    pred = jnp.minimum(pred, 3)
    audio, total = _synthesis_stage(
        model, jnp.asarray(ids, jnp.int32), jnp.asarray(lengths, jnp.int32), d, pred,
        ref, key, jnp.zeros((KOKORO_FRAMES,), jnp.int32))
    return audio, np.asarray(pred), np.asarray(total)


def _port_kokoro(model, ids, lengths, ref, speed, key):
    from mlx_audio_tpu_torch.models.tts.kokoro import duration_stage, synthesis_stage
    from test_torch_kokoro import _source_draws

    style = model.config.style_dim
    d, pred = duration_stage(model, torch.as_tensor(ids), torch.as_tensor(lengths),
                             ref[:, style:], speed)
    pred = torch.minimum(pred, torch.tensor(3))
    rand_ini, noise = _source_draws(key, 2, KOKORO_FRAMES)
    audio, total = synthesis_stage(model, torch.as_tensor(ids), torch.as_tensor(lengths),
                                   d, pred, ref, KOKORO_FRAMES, rand_ini, noise)
    return audio, pred.numpy(), total.numpy()


@pytest.mark.parametrize("inputs", ["bf16", "f32"])
def test_kokoro_bf16_matches_jax(kokoros, inputs):
    """The twin of tests/test_kokoro.py::test_bf16_forward_finite_and_close:
    the bf16 model's capped durations equal JAX's bf16 run's and the
    port's float32 run's; its audio is finite, in JAX's dtype, and within
    KOKORO_REL_RMS of JAX's past HEAD.  ``inputs`` "bf16" feeds the
    reference and speed in bf16, as bench.py does; "f32" in float32, as the
    entry points do, so that promotion decides the dtype as in JAX."""
    from test_torch_kokoro import HEAD

    j32, j16, p32, p16 = kokoros
    ids, lengths, ref = _kokoro_inputs(j32.config)
    key = jax.random.PRNGKey(0)
    jdt, tdt = (jnp.bfloat16, BF16) if inputs == "bf16" else (jnp.float32, torch.float32)
    ref_j = jnp.asarray(ref).astype(jdt)
    ref_t = torch.as_tensor(_np(ref_j)).to(tdt)
    a_j, dur_j, tot_j = _jax_kokoro(j16, ids, lengths, ref_j, jnp.ones((2,), jdt), key)
    a_t, dur_t, tot_t = _port_kokoro(p16, ids, lengths, ref_t, torch.ones(2, dtype=tdt), key)
    _, dur_32, _ = _port_kokoro(p32, ids, lengths, torch.as_tensor(ref), torch.ones(2), key)
    np.testing.assert_array_equal(dur_t, dur_j)
    np.testing.assert_array_equal(dur_t, dur_32)
    np.testing.assert_array_equal(tot_t, tot_j)
    assert str(a_t.dtype).split(".")[-1] == str(a_j.dtype)
    assert a_t.shape == (2, KOKORO_FRAMES * 600)
    assert bool(torch.isfinite(a_t.float()).all())
    assert rel_rms(a_t[:, HEAD:], a_j[:, HEAD:]) < KOKORO_REL_RMS


def test_kokoro_bf16_entry_points(kokoros, tmp_path):
    """generate, generate_batch and synthesize_batch of the bf16 model:
    durations equal to the JAX bf16 model's synthesize_batch, float32
    audio of the durations' length, finite."""
    _, j16, _, p16 = kokoros
    texts = ["ab cd", "abc de fgh"]
    pack = (np.random.default_rng(2).standard_normal((510, 1, 256)) * 0.1
            ).astype(np.float32)
    voice = tmp_path / "voice.npy"
    np.save(voice, pack)
    refs = np.stack([pack[len(t) - 1].reshape(-1) for t in texts])
    got = p16.synthesize_batch(texts, refs, speeds=1.3)
    want = j16.synthesize_batch(texts, refs, speeds=1.3)
    for (audio, dur), (_, dur_j) in zip(got, want):
        np.testing.assert_array_equal(dur, np.asarray(dur_j))
        assert audio.dtype == np.float32 and audio.shape == (int(dur.sum()) * 600,)
        assert np.isfinite(audio).all()
    batch = p16.generate_batch(texts, voice=str(voice), speed=1.3)
    single = list(p16.generate(texts[1], voice=str(voice), speed=1.3))
    assert [r.samples for r in batch] == [a.shape[0] for a, _ in got]
    assert [r.samples for r in single] == [got[1][0].shape[0]]
    for r in (*batch, *single):
        assert r.audio.dtype == np.float32 and np.isfinite(r.audio).all()


# ---------------------------------------------------------------------------
# the conv codecs and vocoders: twins of tests/test_bf16_families.py
# ---------------------------------------------------------------------------

# decoded audio against JAX's bf16 decode of the same codes: observed DAC
# 1.0e-2, SNAC 1.3e-2, EnCodec 1.1e-2, Mimi 6.9e-4, BigVGAN 6.1e-3 (bf16 mel),
# Vocos 6.6e-7 (float32 features: every layer promotes to float32)
AUDIO_REL_RMS = 5e-2
# EnCodec's encoder run bf16 end to end against JAX's (observed 5.4e-2)
BF16_ENCODER_REL_RMS = 1e-1
# a code may differ from JAX's only where JAX's winning distance beats the
# runner-up by at most this share of the runner-up's magnitude (one bf16
# step, 2^-7), or at a frame where an earlier level already differs
TIE_SHARE = 2.0 ** -7


class _Margins:
    """Records, under jax.disable_jit, the margin and scale of every
    nearest-codeword argmin the JAX codecs take (jnp.argmin over squared
    distances), one entry a quantizer level, in order."""

    def __init__(self, monkeypatch):
        self.levels = []
        argmin = jnp.argmin

        def recording(a, axis=None, **kw):
            d = np.sort(np.asarray(a, np.float64), axis=-1)
            self.levels.append((d[..., 1] - d[..., 0],
                                np.maximum(np.abs(d[..., 0]), np.abs(d[..., 1]))))
            return argmin(a, axis=axis, **kw)

        monkeypatch.setattr(jnp, "argmin", recording)


def _codes_agree(name, got_levels, want_levels, margins):
    """Every code of ``got_levels`` equals JAX's, except where JAX's margin
    is a near-tie (TIE_SHARE) or an earlier level differs at that frame
    (levels of other lengths are mapped by time).  Prints the share of
    positions whose margins all exceed the bound."""
    decided, bad, diffs = [], [], []
    for lvl, (g, w) in enumerate(zip(got_levels, want_levels)):
        g, w = np.asarray(g).reshape(w.shape), np.asarray(w)
        margin, scale = (m.reshape(w.shape) for m in margins[lvl])
        tie = margin <= TIE_SHARE * scale
        diff = g != w
        t = np.arange(w.shape[-1])
        after = np.zeros_like(diff)
        for j, dj in enumerate(diffs):
            after |= dj[..., t * dj.shape[-1] // w.shape[-1]]
        bad.append(int((diff & ~tie & ~after).sum()))
        decided.append(float((~tie).mean()))
        diffs.append(diff)
    print(f"{name}: codes decided beyond a bf16 step of the distance, a level: "
          f"{[round(x, 4) for x in decided]}; differing codes "
          f"{[int(d.sum()) for d in diffs]}")
    assert sum(bad) == 0, bad


def _audio_close(got, want):
    assert bool(torch.isfinite(got.float()).all())
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    assert tuple(got.shape) == tuple(want.shape)
    assert rel_rms(got, want) < AUDIO_REL_RMS


def test_dac_snac_bf16_matches_jax(monkeypatch):
    """Twin of test_bf16_families.py::test_dac_snac_bf16: float32 PCM into
    bf16 DAC and SNAC (the encoders promote to float32, the decoders run
    bf16 from the codebooks); SNAC's decode takes JAX's bf16 noise draws."""
    from mlx_audio_tpu_torch.codec.dac import DAC, DACConfig
    from mlx_audio_tpu_torch.codec.snac import SNAC, SNACConfig
    from test_dac_snac import small_dac, small_snac
    from test_torch_dac_snac import _seeded

    rng = np.random.default_rng(2)
    pcm = (rng.standard_normal((1, 1, 3200)) * 0.1).astype(np.float32)
    jd = _seeded(small_dac).astype(jnp.bfloat16)
    td = port_of(jd, DAC(DACConfig(**vars(jd.config)), device="cpu"))
    margins = _Margins(monkeypatch)
    with jax.disable_jit():
        z_j, codes_j, _ = jd.encode(jnp.asarray(pcm))
    z_t, codes_t, _ = td.encode(torch.as_tensor(pcm))
    _codes_agree("DAC", codes_t.numpy().transpose(1, 0, 2),
                 np.asarray(codes_j).transpose(1, 0, 2), margins.levels)
    _audio_close(td.decode(torch.as_tensor(_np(z_j)).to(BF16)), jd.decode(z_j))

    pcm24 = (rng.standard_normal((1, 1, 8192)) * 0.1).astype(np.float32)
    js = _seeded(small_snac).astype(jnp.bfloat16)
    ts = port_of(js, SNAC(SNACConfig(**vars(js.config)), device="cpu"))
    margins.levels.clear()
    with jax.disable_jit():
        codes_j = js.encode(jnp.asarray(pcm24))
    codes_t = ts.encode(torch.as_tensor(pcm24))
    _codes_agree("SNAC", [c.numpy() for c in codes_t], [np.asarray(c) for c in codes_j],
                 margins.levels)
    lens = np.cumprod(js.config.decoder_rates) * codes_j[-1].shape[1]
    noise = [torch.as_tensor(_np(jax.random.normal(
        jax.random.PRNGKey(0), (1, int(n), 1), dtype=jnp.bfloat16))).to(BF16) for n in lens]
    got = ts.decode([torch.as_tensor(np.asarray(c)) for c in codes_j], noise=noise)
    _audio_close(got, js.decode(codes_j))


def test_mimi_roundtrip_bf16_matches_jax(monkeypatch):
    """Twin of test_bf16_families.py::test_mimi_roundtrip_bf16."""
    from mlx_audio_tpu_torch.codec.mimi import Mimi
    from test_mimi import tiny_mimi
    from test_torch_mimi import port_config

    jm = tiny_mimi(nq=4).astype(jnp.bfloat16)
    tm = port_of(jm, Mimi(port_config(jm.cfg)))
    pcm = (np.random.default_rng(0).standard_normal((1, 1, 1920 * 3)) * 0.1
           ).astype(np.float32)
    margins = _Margins(monkeypatch)
    with jax.disable_jit():
        codes_j = jm.encode(jnp.asarray(pcm))
    codes_t = tm.encode(torch.as_tensor(pcm))
    _codes_agree("Mimi", codes_t.numpy().transpose(1, 0, 2),
                 np.asarray(codes_j).transpose(1, 0, 2), margins.levels)
    _audio_close(tm.decode(torch.as_tensor(np.asarray(codes_j))), jm.decode(codes_j))
    # streaming from init_state's default float32 state and caches, as in
    # JAX: the steps promote to float32 (observed 1.0e-4 relative RMS)
    js, ts = jm.init_state(1), tm.init_state(1)
    for f in range(codes_j.shape[-1]):
        frame = np.asarray(codes_j)[..., f:f + 1]
        want, js = jm.decode_step(js, jnp.asarray(frame))
        got, ts = tm.decode_step(ts, torch.as_tensor(frame))
        _audio_close(got, want)


def test_encodec_roundtrip_bf16_matches_jax(monkeypatch):
    """Twin of test_bf16_families.py::test_encodec_roundtrip_bf16, at
    tests/test_torch_encodec.py's randomized weights."""
    from mlx_audio_tpu.codec.encodec import preprocess_audio as jax_preprocess
    from mlx_audio_tpu_torch.codec.encodec import Encodec, EncodecConfig, preprocess_audio
    from test_torch_encodec import build_jax

    je = build_jax().astype(jnp.bfloat16)
    te = port_of(je, Encodec(EncodecConfig(**vars(je.config)), device="cpu"))
    x = (np.random.default_rng(1).standard_normal(24_000) * 0.1).astype(np.float32)
    audio, mask = jax_preprocess(x)
    margins = _Margins(monkeypatch)
    with jax.disable_jit():
        codes_j, scales_j = je.encode(audio, mask)
    ta, tmask = preprocess_audio(x)
    codes_t, _ = te.encode(ta, tmask)
    _codes_agree("EnCodec", codes_t.numpy()[0].transpose(1, 0, 2),
                 np.asarray(codes_j)[0].transpose(1, 0, 2), margins.levels)
    got = te.decode(torch.as_tensor(np.asarray(codes_j)), [None], tmask)
    _audio_close(got, je.decode(codes_j, scales_j, mask))
    # a bf16 tensor keeps its dtype into the encoder (an array becomes
    # float32), as JAX's encode keeps it.  Run bf16 end to end, the two
    # encoders part by 5.4e-2 relative RMS (observed: JAX's LSTM carries
    # bf16 state, the port's float32, and each rounds at its own places), so
    # half the codes differ and only the encoder output is held here
    audio16 = jnp.asarray(audio, jnp.bfloat16)
    want = je.encoder(audio16)
    got = te.encoder(torch.as_tensor(_np(audio16)).to(BF16))
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    assert rel_rms(got, want) < BF16_ENCODER_REL_RMS
    codes_t, _ = te.encode(torch.as_tensor(_np(audio16)).to(BF16), tmask)
    assert torch.equal(codes_t[0], te.quantizer.encode(got, te.config.target_bandwidths[0]))


def test_vocos_bigvgan_bf16_matches_jax():
    """Twin of test_bf16_families.py::test_vocos_bigvgan_bf16: Vocos decodes
    float32 features (JAX's ISTFT head takes no bf16), BigVGAN a float32
    mel (promoted) and a bf16 mel (bf16 throughout)."""
    from mlx_audio_tpu_torch.codec.bigvgan import BigVGAN
    from test_torch_bigvgan import _seeded as seeded_bigvgan
    from test_torch_bigvgan import randomized
    from test_torch_vocos import _seeded, port_small_vocos
    from test_vocos_bigvgan import small_bigvgan, small_vocos

    rng = np.random.default_rng(3)
    jv = _seeded(small_vocos).astype(jnp.bfloat16)
    tv = port_of(jv, port_small_vocos())
    feats = (rng.standard_normal((1, 50, 100)) * 0.1).astype(np.float32)
    _audio_close(tv.decode(torch.as_tensor(feats)), jv.decode(jnp.asarray(feats)))

    jb = randomized(seeded_bigvgan(small_bigvgan)).astype(jnp.bfloat16)
    tb = port_of(jb, BigVGAN(jb.config, device="cpu"))
    mel = (rng.standard_normal((1, 20, 20)) * 0.1).astype(np.float32)
    _audio_close(tb(torch.as_tensor(mel)), jb(jnp.asarray(mel)))
    mel16 = jnp.asarray(mel, jnp.bfloat16)
    _audio_close(tb(torch.as_tensor(_np(mel16)).to(BF16)), jb(mel16))
