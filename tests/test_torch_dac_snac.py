"""DAC and SNAC in the port against the JAX package, float32 on the CPU: the
port twin of tests/test_dac_snac.py, at its reduced widths.

Weights cross with ``convert.params_from_jax`` given the port module, which
tells the transposed convs by type (those of DAC and SNAC have no ``ups``
or ``upsample`` path component).  Codes
are held equal and audio to atol 1e-4.  SNAC's noise blocks draw from the
JAX PRNG, which torch cannot reproduce: the port's decode is fed the JAX
package's ``PRNGKey(0)`` draws.  The JAX init RNG is reset for each model
built here, so the weights do not depend on which tests ran first.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mlx_audio_tpu.nn.layers as jax_layers
from mlx_audio_tpu.codec.dac import DACFile as JaxDACFile
from mlx_audio_tpu.codec.dac.chunked import get_delay as jax_get_delay
from mlx_audio_tpu.codec.dac.chunked import get_output_length as jax_get_output_length
from mlx_audio_tpu.codec.dac.dac import sanitize_hf_dac as jax_sanitize_hf_dac
from mlx_audio_tpu.codec.snac import SNAC as JaxSNAC
from mlx_audio_tpu.codec.snac import SNACConfig as JaxSNACConfig
from mlx_audio_tpu.nn.module import named_arrays
from mlx_audio_tpu_torch.codec.dac import DAC, DACConfig, DACFile
from mlx_audio_tpu_torch.codec.dac.chunked import (
    get_delay,
    get_output_length,
    unpadded_twin,
)
from mlx_audio_tpu_torch.codec.dac.dac import sanitize_hf_dac
from mlx_audio_tpu_torch.codec.snac import SNAC, SNACConfig
from mlx_audio_tpu_torch.convert import params_from_jax
from test_dac_snac import small_dac, small_snac

AUDIO_ATOL = 1e-4


def _seeded(build):
    """``build()`` with the JAX init RNG reset, so every call gives the
    same weights."""
    saved = jax_layers._INIT_RNG
    jax_layers._INIT_RNG = np.random.default_rng(0)
    try:
        return build()
    finally:
        jax_layers._INIT_RNG = saved


def carry(jax_module, port_module):
    named = {k: np.asarray(v) for k, v in named_arrays(jax_module)}
    port_module.load_state_dict(params_from_jax(named, port_module), strict=True)
    return port_module


def port_dac(jax_dac):
    return carry(jax_dac, DAC(DACConfig(**vars(jax_dac.config)), device="cpu"))


def port_snac(jax_snac):
    return carry(jax_snac, SNAC(SNACConfig(**vars(jax_snac.config)), device="cpu"))


@pytest.fixture(scope="module")
def dacs():
    jd = _seeded(small_dac)
    return jd, port_dac(jd)


def _audio(seed, n, scale=0.1):
    return (np.random.default_rng(seed).standard_normal(n) * scale).astype(np.float32)


def test_dac_16khz_contract(dacs):
    td = dacs[1]
    z, codes, latents = td.encode(torch.zeros(1, 1, 80_000))
    assert z.shape == (1, 250, td.latent_dim)
    assert codes.shape == (1, 4, 250)
    assert latents.shape == (1, 250, 4 * 8)
    y = td.decode(z)
    assert y.shape == (1, 1, 79_992)
    assert torch.isfinite(y).all()


def test_dac_codes_past_the_codebook_decode_to_nan_as_in_jax(dacs):
    """A code one past the codebook (OuteTTS's streams hold 1025 codes, its
    DAC's codebooks 1024) decodes to NaN where the JAX package's does; in
    range, finite as before."""
    jd, td = dacs
    n = td.codebook_size
    codes = np.random.default_rng(6).integers(0, n, size=(1, 4, 6))
    codes[0, 1, 3] = n
    got = td.decode_codes(torch.as_tensor(codes)).numpy()
    ref = np.asarray(jd.decode_codes(jnp.asarray(codes)))
    assert np.isnan(got).any()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    codes[0, 1, 3] = 5
    assert np.isfinite(td.decode_codes(torch.as_tensor(codes)).numpy()).all()


def test_dac_codes_and_audio_match_jax(dacs):
    jd, td = dacs
    audio = _audio(0, 3200)[None, None]
    z_j, codes_j, lat_j = jd.encode(jnp.asarray(audio))
    z_t, codes_t, lat_t = td.encode(torch.as_tensor(audio))
    np.testing.assert_array_equal(codes_t.numpy(), np.asarray(codes_j))
    np.testing.assert_allclose(lat_t.numpy(), np.asarray(lat_j), atol=1e-5, rtol=0)
    y_j = np.asarray(jd.decode(z_j))
    y_t = td.decode(z_t).numpy()
    np.testing.assert_allclose(y_t, y_j, atol=AUDIO_ATOL, rtol=0)
    # the codes round trip: decode_codes gives decode(z)'s audio
    np.testing.assert_allclose(td.decode_codes(codes_t).numpy(), y_t, atol=1e-4, rtol=0)
    assert (codes_t.numpy() >= 0).all() and (codes_t.numpy() < 64).all()


def test_dac_call_returns_original_length(dacs):
    out = dacs[1](torch.zeros(1, 1, 12_345))
    assert out["audio"].shape == (1, 1, 12_345)


@pytest.fixture(scope="module")
def snacs():
    js = _seeded(small_snac)
    return js, port_snac(js)


def _jax_noise(rates, t0, batch=1):
    """The JAX package's draws: every block's key is PRNGKey(0)."""
    lens = np.cumprod(rates) * t0
    return [torch.as_tensor(np.array(jax.random.normal(
        jax.random.PRNGKey(0), (batch, int(n), 1), dtype=jnp.float32)))
        for n in lens]


def test_snac_24khz_contract(snacs):
    ts = snacs[1]
    codes = ts.encode(torch.zeros(1, 1, 120_000))
    assert [tuple(c.shape) for c in codes] == [(1, 59), (1, 118), (1, 236)]
    recon = ts.decode(codes)
    assert recon.shape == (1, 1, 120_832)
    assert torch.isfinite(recon).all()


def test_snac_noise_fed_from_jax(snacs):
    """noise=True: codes equal; audio within atol 1e-4 when the port's
    decode takes the JAX package's draws."""
    js, ts = snacs
    audio = _audio(1, 8192)[None, None]
    codes_j = js.encode(jnp.asarray(audio))
    codes_t = ts.encode(torch.as_tensor(audio))
    for cj, ct in zip(codes_j, codes_t):
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    ref = np.asarray(js.decode(codes_j))
    noise = _jax_noise(js.config.decoder_rates, codes_t[-1].shape[1])
    got = ts.decode(codes_t, noise=noise).numpy()
    np.testing.assert_allclose(got, ref, atol=AUDIO_ATOL, rtol=0)
    # with no draws given every block draws from a generator seeded 0: the
    # same audio on every call
    np.testing.assert_array_equal(ts.decode(codes_t).numpy(), ts.decode(codes_t).numpy())


@pytest.fixture(scope="module")
def attention_snacs():
    """The windowed attention variant (window 8), dense convs, no noise."""
    cfg = dict(sampling_rate=24000, encoder_dim=16, encoder_rates=[2, 4, 8, 8],
               decoder_dim=128, decoder_rates=[8, 8, 4, 2], attn_window_size=8,
               codebook_size=64, codebook_dim=8, vq_strides=[4, 2, 1],
               noise=False, depthwise=False)
    js = _seeded(lambda: JaxSNAC(JaxSNACConfig(**cfg)))
    return js, port_snac(js)


@pytest.mark.parametrize("frames", [3, 5])
def test_snac_with_attention_matches_jax(attention_snacs, frames):
    """The windowed attention variant (window 8), dense convs, no noise; 5
    frames of LM-made codes (20 steps) are not a window multiple: decode
    pads and trims them."""
    js, ts = attention_snacs
    if frames == 3:
        audio = _audio(2, 24_000)[None, None]
        codes_j = js.encode(jnp.asarray(audio))
        codes_t = ts.encode(torch.as_tensor(audio))
        for cj, ct in zip(codes_j, codes_t):
            np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    else:
        rng = np.random.default_rng(3)
        codes_j = [jnp.asarray(rng.integers(0, 64, size=(1, frames * s)), jnp.int32)
                   for s in (1, 2, 4)]
        codes_t = [torch.as_tensor(np.array(c)) for c in codes_j]
    ref = np.asarray(js.decode(codes_j))
    got = ts.decode(codes_t).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=AUDIO_ATOL, rtol=0)


def test_snac_from_pretrained_roundtrip(tmp_path):
    """SNAC.from_pretrained reads a checkpoint directory in the published
    layout ([O, K, I]-major weight-norm tensors, [1, C, 1] alphas) written
    with safetensors.numpy, and gives the source model's codes."""
    from safetensors.numpy import save_file

    cfg = dict(sampling_rate=24000, encoder_dim=4, encoder_rates=[2, 2],
               decoder_dim=8, decoder_rates=[2, 2], attn_window_size=None,
               codebook_size=16, codebook_dim=4, vq_strides=[2, 1],
               noise=False, depthwise=False)
    model = _seeded(lambda: JaxSNAC(JaxSNACConfig.from_dict(cfg)))
    weights = {}
    for k, v in named_arrays(model):
        v = np.asarray(v)
        if k.endswith("alpha") and v.ndim == 1:
            v = v.reshape(1, -1, 1)
        elif k.endswith(("weight_v", "weight_g")) and v.ndim == 3:
            v = v.transpose(2, 0, 1)
        weights[k] = np.ascontiguousarray(v)
    ckpt = tmp_path / "snac"
    ckpt.mkdir()
    save_file(weights, str(ckpt / "model.safetensors"))
    (ckpt / "config.json").write_text(json.dumps(cfg))

    loaded = SNAC.from_pretrained(str(ckpt), device="cpu")
    audio = _audio(0, 256)[None, :, None]
    ref = model.encode(jnp.asarray(audio))
    got = loaded.encode(torch.as_tensor(audio))
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    with pytest.raises(FileNotFoundError):
        SNAC.from_pretrained(str(tmp_path / "missing"), device="cpu")


# -- chunked compress and decompress -----------------------------------------


def test_dac_output_length_matches_model(dacs):
    """get_output_length equals the valid-conv chain's output and the JAX
    package's arithmetic; the twin shares the parameters and leaves the
    caller's model padded."""
    jd, td = dacs
    twin = unpadded_twin(td)
    n = 64 * td.hop_length
    z, _, _ = twin.encode(torch.zeros(1, 1, n))
    assert twin.decode(z).shape[-1] == get_output_length(td, n)
    assert get_output_length(td, n) == jax_get_output_length(jd, n)
    assert get_delay(td) == jax_get_delay(jd)
    assert twin.encoder.block[0].weight_v is td.encoder.block[0].weight_v
    assert all(a is b for a, b in zip(twin.parameters(), td.parameters()))
    assert td.encoder.block[0].padding == 3 and twin.encoder.block[0].padding == 0
    z2, _, _ = td.encode(torch.zeros(1, 1, n))
    assert n - td.hop_length < td.decode(z2).shape[-1] <= n


def test_dac_compress_roundtrip_long_matches_jax(dacs, tmp_path):
    """4 s, longer than the window: the windows' codes equal the JAX
    package's; the .dac file saves and loads; decompress trims to the
    original length, within atol 1e-4 of the JAX package's."""
    jd, td = dacs
    audio = _audio(0, 4 * td.sample_rate, 0.3)
    f = td.compress(audio, win_duration=1.3)
    fj = jd.compress(audio, win_duration=1.3)
    assert f.padding is False and f.chunk_length == fj.chunk_length
    np.testing.assert_array_equal(f.codes, np.asarray(fj.codes))
    assert f.codes.shape[1] == td.n_codebooks
    assert f.codes.shape[-1] % f.chunk_length == 0

    path = f.save(tmp_path / "clip")
    assert path.suffix == ".dac"
    loaded = DACFile.load(path)
    np.testing.assert_array_equal(loaded.codes, f.codes)
    assert loaded.original_length == audio.shape[-1]
    wav = td.decompress(loaded)
    assert wav.shape == (1, audio.shape[-1])
    np.testing.assert_allclose(wav, jd.decompress(JaxDACFile.load(path)),
                               atol=AUDIO_ATOL, rtol=0)


def test_dac_compress_short_clip_and_its_wav_file(dacs, tmp_path):
    """A clip of at most win_duration takes the one padded encode; the same
    clip written to a wav file compresses from its path to the JAX
    package's codes; a non-wav path raises the reference's gated error."""
    from mlx_audio_tpu_torch.utils.audio_io import save_audio

    jd, td = dacs
    audio = _audio(1, int(0.3 * td.sample_rate), 0.3)
    f = td.compress(audio, win_duration=1.0)
    assert f.padding is True
    np.testing.assert_array_equal(f.codes, np.asarray(jd.compress(audio).codes))
    assert td.decompress(f).shape == (1, audio.shape[-1])
    wav = str(tmp_path / "clip.wav")
    save_audio(wav, audio, td.sample_rate)
    g = td.compress(wav, win_duration=1.0)
    np.testing.assert_array_equal(g.codes, np.asarray(jd.compress(wav).codes))
    assert g.original_length == audio.shape[-1]
    with pytest.raises(RuntimeError, match="soundfile"):
        td.compress(str(tmp_path / "clip.flac"))


def test_dac_chunked_matches_serial_windows(dacs):
    """The batched window encode equals encoding each window alone."""
    td = dacs[1]
    sr = td.sample_rate
    audio = _audio(2, 3 * sr, 0.3)
    f = td.compress(audio, win_duration=1.3, normalize_db=None)
    twin = unpadded_twin(td)
    delay = get_delay(td)
    n_samples = int(np.ceil(1.3 * sr / td.hop_length) * td.hop_length)
    hop = get_output_length(td, n_samples)
    padded = np.pad(audio, (delay, delay))
    serial = []
    for start in range(0, audio.shape[-1], hop):
        piece = padded[start: start + n_samples]
        piece = np.pad(piece, (0, n_samples - piece.shape[-1]))
        serial.append(twin.encode(torch.as_tensor(piece)[None, None])[1].numpy())
    np.testing.assert_array_equal(f.codes, np.concatenate(serial, axis=-1))


def test_dac_decompress_reference_style_seconds(dacs):
    """A file that stores original_length in float seconds decompresses to
    that many samples."""
    td = dacs[1]
    sr = td.sample_rate
    audio = _audio(3, int(0.4 * sr), 0.3)
    f = td.compress(audio, win_duration=1.0)
    ref_style = DACFile(codes=f.codes, chunk_length=f.chunk_length,
                        original_length=audio.shape[-1] / sr, input_db=f.input_db,
                        channels=1, sample_rate=sr, padding=True)
    assert td.decompress(ref_style).shape == (1, audio.shape[-1])


def _hf_dac_weights(jd, seed=0):
    """A synthetic HF-transformers ``DacModel`` key set for ``jd``'s
    config: folded conv weights [O, I, K], transposed [I, O, K],
    ``res_unit`` naming, [1, C, 1] alphas."""
    rng = np.random.default_rng(seed)
    cfg = jd.config
    out = {}

    def conv(name, o, i, k, transposed=False):
        shape = (i, o, k) if transposed else (o, i, k)
        out[f"{name}.weight"] = rng.standard_normal(shape).astype(np.float32) * 0.1
        out[f"{name}.bias"] = rng.standard_normal(o).astype(np.float32) * 0.1

    def snake(name, c):
        out[f"{name}.alpha"] = rng.uniform(0.5, 1.5, (1, c, 1)).astype(np.float32)

    def res_units(prefix, c):
        for u in (1, 2, 3):
            snake(f"{prefix}.res_unit{u}.snake1", c)
            conv(f"{prefix}.res_unit{u}.conv1", c, c, 7)
            snake(f"{prefix}.res_unit{u}.snake2", c)
            conv(f"{prefix}.res_unit{u}.conv2", c, c, 1)

    d = cfg.encoder_dim
    conv("encoder.conv1", d, 1, 7)
    for i, s in enumerate(cfg.encoder_rates):
        res_units(f"encoder.block.{i}", d)
        snake(f"encoder.block.{i}.snake1", d)
        conv(f"encoder.block.{i}.conv1", 2 * d, d, 2 * s)
        d *= 2
    snake("encoder.snake1", d)
    conv("encoder.conv2", jd.latent_dim, d, 3)
    for q in range(cfg.n_codebooks):
        conv(f"quantizer.quantizers.{q}.in_proj", cfg.codebook_dim, jd.latent_dim, 1)
        conv(f"quantizer.quantizers.{q}.out_proj", jd.latent_dim, cfg.codebook_dim, 1)
        out[f"quantizer.quantizers.{q}.codebook.weight"] = rng.standard_normal(
            (cfg.codebook_size, cfg.codebook_dim)).astype(np.float32)
    conv("decoder.conv1", cfg.decoder_dim, jd.latent_dim, 7)
    for i, s in enumerate(cfg.decoder_rates):
        c_in, c_out = cfg.decoder_dim // 2 ** i, cfg.decoder_dim // 2 ** (i + 1)
        snake(f"decoder.block.{i}.snake1", c_in)
        conv(f"decoder.block.{i}.conv_t1", c_out, c_in, 2 * s, transposed=True)
        res_units(f"decoder.block.{i}", c_out)
    snake("decoder.snake1", c_out)
    conv("decoder.conv2", 1, c_out, 7)
    return out


def test_sanitize_hf_dac_synthetic_keys(dacs):
    """sanitize_hf_dac maps a synthetic HF key set to what the JAX
    package's does, every key and value, and the result loads strictly into
    the port's DAC (its transposed convs by module type)."""
    jd, _ = dacs
    weights = _hf_dac_weights(jd)
    got = sanitize_hf_dac(weights)
    ref = jax_sanitize_hf_dac(weights)
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    td = DAC(DACConfig(**vars(jd.config)), device="cpu")
    assert sorted(td.state_dict()) == sorted(got)
    td.load_state_dict(params_from_jax(td.sanitize(weights), td), strict=True)
    w = td.decoder.model[1].block[1].weight_v
    np.testing.assert_array_equal(
        w.numpy(), weights["decoder.block.0.conv_t1.weight"])
    assert torch.isfinite(td.decode(torch.zeros(1, 4, jd.latent_dim))).all()


@functools.lru_cache(maxsize=None)
def _kokoro_pair():
    from mlx_audio_tpu.models.tts.kokoro import Model as JaxKokoro
    from mlx_audio_tpu_torch.models.tts.kokoro import Model as Kokoro
    from test_torch_kokoro import _port_config, tiny_config

    return JaxKokoro(tiny_config()), Kokoro(_port_config(), device="cpu")


@functools.lru_cache(maxsize=None)
def _mimi_pair():
    from mlx_audio_tpu_torch.codec.mimi import Mimi
    from test_mimi import tiny_mimi
    from test_torch_mimi import port_config

    jm = tiny_mimi()
    return jm, Mimi(port_config(jm.cfg))


@functools.lru_cache(maxsize=None)
def _csm_pair():
    from mlx_audio_tpu.models.tts.sesame.model import Model as JaxCSM
    from mlx_audio_tpu_torch.codec.mimi import Mimi
    from mlx_audio_tpu_torch.models.tts.sesame import Model as CSM
    from test_mimi import tiny_mimi
    from test_sesame import FakeTokenizer, tiny_config
    from test_torch_mimi import port_config

    jm = JaxCSM(tiny_config(), mimi=tiny_mimi(nq=4), text_tokenizer=FakeTokenizer())
    return jm, CSM(tiny_config(), mimi=Mimi(port_config(jm.mimi.cfg)),
                   text_tokenizer=FakeTokenizer(), device="cpu")


@pytest.mark.parametrize("pair", [_kokoro_pair, _mimi_pair, _csm_pair],
                         ids=["kokoro", "mimi", "csm"])
def test_params_from_jax_by_module_type_matches_the_name_rule(pair):
    """Kokoro, Mimi and CSM load as before: the weights that the module
    types lay out as transposed convs are those under an ``ups``, ``pool``
    or ``upsample`` path component, the rule the bridge used before, and
    every 3-d weight is the JAX array with its axes moved accordingly."""
    jax_model, port = pair()
    named = {k: np.asarray(v) for k, v in named_arrays(jax_model)}
    state = params_from_jax(named, port)
    assert sorted(state) == sorted(named)
    by_name = {k for k in named if {"ups", "pool", "upsample"} & set(k.split("."))}
    for k, w in named.items():
        if w.ndim == 3 and k.endswith("weight_g"):
            w = w.reshape(-1, 1, 1)
        elif w.ndim == 3 and k.endswith(("weight_v", "weight")):
            w = w.transpose((1, 2, 0) if k in by_name else (2, 1, 0))
        assert torch.equal(state[k], torch.tensor(w)), k
    assert any(named[k].ndim == 3 for k in by_name)
    port.load_state_dict(state, strict=True)


@functools.lru_cache(maxsize=None)
def _dac_pair():
    jd = _seeded(small_dac)
    return jd, DAC(DACConfig(**vars(jd.config)), device="cpu")


@functools.lru_cache(maxsize=None)
def _snac_pair():
    js = _seeded(small_snac)
    return js, SNAC(SNACConfig(**vars(js.config)), device="cpu")


def _rank_rule(named, port):
    """The bridge before conv owners were typed: every 3-d ``weight`` and
    ``weight_v`` moved as a conv's, the transposed convs told by type."""
    from mlx_audio_tpu_torch.nn.layers import WNConvTranspose1d
    from mlx_audio_tpu_torch.nn.streaming import StreamableConvTranspose1d

    convt = {n for n, m in port.named_modules()
             if isinstance(m, (WNConvTranspose1d, StreamableConvTranspose1d))}
    out = {}
    for k, w in named.items():
        if w.ndim == 3 and k.endswith("weight_g"):
            w = w.reshape(-1, 1, 1)
        elif w.ndim == 3 and k.endswith(("weight_v", "weight")):
            w = w.transpose((1, 2, 0) if k.rpartition(".")[0] in convt else (2, 1, 0))
        out[k] = torch.tensor(w)
    return out


@pytest.mark.parametrize("pair", [_kokoro_pair, _mimi_pair, _csm_pair, _dac_pair,
                                  _snac_pair],
                         ids=["kokoro", "mimi", "csm", "dac", "snac"])
def test_params_from_jax_by_owner_type_leaves_conv_families_unchanged(pair):
    """Typing the owner of every 3-d weight (conv, transposed conv, or
    neither) gives the state dicts of Kokoro, Mimi, CSM, DAC and SNAC that
    moving every 3-d weight as a conv's gave: their 3-d weights are all
    conv weights."""
    from mlx_audio_tpu_torch.convert import conv_kinds

    jax_model, port = pair()
    # EnCodec's conv types leave these families' conv kinds as they were
    assert conv_kinds(port) == _earlier_conv_kinds(port)
    named = {k: np.asarray(v) for k, v in named_arrays(jax_model)}
    state = params_from_jax(named, port)
    before = _rank_rule(named, port)
    assert sorted(state) == sorted(before)
    for k in state:
        assert torch.equal(state[k], before[k]), k
    assert any(named[k].ndim == 3 for k in named)
    port.load_state_dict(state, strict=True)


def _earlier_conv_kinds(port):
    """conv_kinds as it was before EnCodec's conv types: the state dicts of
    the families before EnCodec follow from it alone."""
    from mlx_audio_tpu_torch.nn.layers import Conv1d, WNConv1d, WNConvTranspose1d
    from mlx_audio_tpu_torch.nn.streaming import (
        StreamableConv1d,
        StreamableConvTranspose1d,
    )

    kinds = {}
    for name, m in port.named_modules():
        if isinstance(m, (Conv1d, WNConv1d, StreamableConv1d)):
            kinds[name] = "conv"
        elif isinstance(m, (WNConvTranspose1d, StreamableConvTranspose1d)):
            kinds[name] = "convt"
    return kinds


@functools.lru_cache(maxsize=None)
def _encodec_pair():
    from test_torch_encodec import build_jax
    from mlx_audio_tpu_torch.codec.encodec import Encodec, EncodecConfig

    jm = build_jax()
    return jm, Encodec(EncodecConfig(**vars(jm.config)), device="cpu")


@functools.lru_cache(maxsize=None)
def _vocos_pair():
    from test_torch_vocos import port_small_vocos
    from test_vocos_bigvgan import small_vocos

    return _seeded(small_vocos), port_small_vocos()


@pytest.mark.parametrize("pair", [_encodec_pair, _vocos_pair], ids=["encodec", "vocos"])
def test_params_from_jax_by_owner_type_moves_encodec_and_vocos_convs(pair):
    """EnCodec's convs and transposed convs and Vocos's convs (the
    depthwise ``dwconv`` a grouped ``Conv1d``) arrive in torch's layouts;
    every other weight as it is."""
    jax_model, port = pair()
    named = {k: np.asarray(v) for k, v in named_arrays(jax_model)}
    state = params_from_jax(named, port)
    kinds = {"conv": 0, "convt": 0}
    from mlx_audio_tpu_torch.convert import conv_kinds

    owner = conv_kinds(port)
    for k, w in named.items():
        kind = owner.get(k.rpartition(".")[0])
        if w.ndim == 3 and kind:
            kinds[kind] += 1
            w = w.transpose((1, 2, 0) if kind == "convt" else (2, 1, 0))
        assert torch.equal(state[k], torch.tensor(w)), k
    assert kinds["conv"] > 0
    assert (kinds["convt"] > 0) == (pair is _encodec_pair)
    port.load_state_dict(state, strict=True)


def _before_tap_rule(named, port):
    """The bridge before the wav2vec2 positional conv's per-tap rule: the
    conv and transposed-conv owner types of EnCodec and earlier, every 3-d
    ``weight_g`` on one channel axis."""
    from mlx_audio_tpu_torch.codec.encodec.encodec import (
        EncodecConv1d,
        EncodecConvTranspose1d,
    )
    from mlx_audio_tpu_torch.nn.layers import Conv1d, WNConv1d, WNConvTranspose1d
    from mlx_audio_tpu_torch.nn.streaming import (
        StreamableConv1d,
        StreamableConvTranspose1d,
    )

    kinds = {}
    for name, m in port.named_modules():
        if isinstance(m, (Conv1d, WNConv1d, StreamableConv1d, EncodecConv1d)):
            kinds[name] = "conv"
        elif isinstance(m, (WNConvTranspose1d, StreamableConvTranspose1d,
                            EncodecConvTranspose1d)):
            kinds[name] = "convt"
    out = {}
    for k, w in named.items():
        kind = kinds.get(k.rpartition(".")[0])
        if w.ndim == 3 and k.endswith("weight_g"):
            w = w.reshape(-1, 1, 1)
        elif w.ndim == 3 and k.endswith(("weight_v", "weight")) and kind:
            w = w.transpose((1, 2, 0) if kind == "convt" else (2, 1, 0))
        out[k] = torch.tensor(w)
    return out


@functools.lru_cache(maxsize=None)
def _bark_pair():
    from test_torch_bark import _configs
    from mlx_audio_tpu.models.tts.bark import Model as JaxBark
    from mlx_audio_tpu.models.tts.bark import ModelConfig as JaxBarkConfig
    from mlx_audio_tpu_torch.models.tts.bark import Model as Bark
    from mlx_audio_tpu_torch.models.tts.bark import ModelConfig as BarkConfig
    from test_torch_encodec import build_jax as build_jax_encodec
    from test_torch_encodec import port_of as port_encodec

    je = build_jax_encodec()
    jm = _seeded(lambda: JaxBark(JaxBarkConfig(**_configs()), codec=je))
    return jm, Bark(BarkConfig(**_configs()), codec=port_encodec(je), device="cpu")


@functools.lru_cache(maxsize=None)
def _dia_models():
    import dataclasses

    from mlx_audio_tpu_torch.models.tts.dia import DiaConfig, Model as Dia
    from test_dia import tiny_dia

    jm = _seeded(tiny_dia)
    return jm, Dia(DiaConfig.load_dict(dataclasses.asdict(jm.config)),
                   dac_model=port_dac(jm._dac), device="cpu")


def _dia_pair():
    jm, port = _dia_models()
    return jm.model, port.model


@pytest.mark.parametrize("pair", [_kokoro_pair, _mimi_pair, _csm_pair, _dac_pair,
                                  _snac_pair, _encodec_pair, _vocos_pair, _bark_pair,
                                  _dia_pair],
                         ids=["kokoro", "mimi", "csm", "dac", "snac", "encodec", "vocos",
                              "bark", "dia"])
def test_params_from_jax_per_tap_rule_leaves_ported_families_unchanged(pair):
    """The per-tap owner rule (wav2vec2's positional conv) leaves the state
    dict of every family ported before it as it was: none of them has a
    per-tap conv."""
    from mlx_audio_tpu_torch.convert import conv_kinds

    jax_model, port = pair()
    assert "conv_tap" not in conv_kinds(port).values()
    named = {k: np.asarray(v) for k, v in named_arrays(jax_model)}
    state = params_from_jax(named, port)
    before = _before_tap_rule(named, port)
    assert sorted(state) == sorted(before)
    for k in state:
        assert torch.equal(state[k], before[k]), k
    port.load_state_dict(state, strict=True)


def test_params_from_jax_keeps_dense_general_layout():
    """A tiny Dia's DenseGeneral weights ([D, H, hd], [H, hd, D], [D, 2,
    hidden], [D, C, V]; 3-d and named ``weight``) arrive untransposed and
    load strictly; its DAC's convs move as before."""
    from mlx_audio_tpu_torch.convert import conv_kinds
    from mlx_audio_tpu_torch.models.tts.dia.layers import DenseGeneral

    jm, port = _dia_models()
    assert conv_kinds(port.model) == _earlier_conv_kinds(port.model)
    assert conv_kinds(port._dac) == _earlier_conv_kinds(port._dac)
    named = {k: np.asarray(v) for k, v in named_arrays(jm.model)}
    state = params_from_jax(named, port.model)
    dense = {n + ".weight" for n, m in port.model.named_modules()
             if isinstance(m, DenseGeneral)}
    assert sum(named[k].ndim == 3 for k in dense) >= 5
    for k in dense:
        assert torch.equal(state[k], torch.tensor(named[k])), k
    port.model.load_state_dict(state, strict=True)


def test_dac_from_pretrained_hf_layout(dacs, tmp_path):
    """DAC.from_pretrained reads an HF-transformers checkpoint directory (its
    config field names, the synthetic key set above in safetensors) and
    decodes as a model given the same weights directly."""
    from safetensors.numpy import save_file

    jd, _ = dacs
    cfg = jd.config
    weights = _hf_dac_weights(jd, seed=1)
    ckpt = tmp_path / "dac"
    ckpt.mkdir()
    save_file(weights, str(ckpt / "model.safetensors"))
    (ckpt / "config.json").write_text(json.dumps({
        "encoder_hidden_size": cfg.encoder_dim, "downsampling_ratios": cfg.encoder_rates,
        "decoder_hidden_size": cfg.decoder_dim, "upsampling_ratios": cfg.decoder_rates,
        "n_codebooks": cfg.n_codebooks, "codebook_size": cfg.codebook_size,
        "codebook_dim": cfg.codebook_dim, "sampling_rate": cfg.sample_rate}))
    loaded = DAC.from_pretrained(str(ckpt), device="cpu")
    assert loaded.config.encoder_rates == cfg.encoder_rates
    direct = DAC(DACConfig(**vars(cfg)), device="cpu")
    direct.load_state_dict(params_from_jax(sanitize_hf_dac(weights), direct), strict=True)
    codes = torch.as_tensor(np.random.default_rng(4).integers(0, 64, size=(1, 4, 5)))
    np.testing.assert_array_equal(loaded.decode_codes(codes).numpy(),
                                  direct.decode_codes(codes).numpy())
