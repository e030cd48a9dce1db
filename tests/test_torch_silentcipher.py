"""SilentCipher, the complex STFT and Conv2d in the port against the JAX
package (twins of tests/test_sesame.py's silentcipher tests), on the CPU.

The tiny SilentCipher config is tests/test_sesame.py's; the JAX model's
weights cross with ``convert.params_from_jax`` (its conv2d HWIO weights to
OIHW).  ``encode_wav``'s audio, ``dsp.stft`` and ``Conv2d`` within 1e-5;
``decode_wav``'s messages and status equal, its confidence within 1e-5.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mlx_audio_tpu.nn as jnn
import mlx_audio_tpu.nn.layers as jax_layers
from mlx_audio_tpu import dsp as jdsp
from mlx_audio_tpu.models.tts.sesame import silentcipher as jsc
from mlx_audio_tpu.models.tts.sesame import watermarking as jwm
from mlx_audio_tpu.nn.module import named_arrays
from mlx_audio_tpu_torch import dsp as tdsp
from mlx_audio_tpu_torch.convert import params_from_jax
from mlx_audio_tpu_torch.models.tts.sesame import silentcipher as tsc
from mlx_audio_tpu_torch.models.tts.sesame import watermarking as twm
from mlx_audio_tpu_torch.nn.layers import Conv2d

ATOL = 1e-5
TINY = dict(sample_rate=44100, n_fft=512, hop_length=128, msg_len=5, msg_vocab=256,
            hidden=8, enc_layers=1, dec_layers=2, message_band=64)
KEY = [212, 211, 146, 56, 201]


def _named(m) -> dict:
    return {k: np.asarray(v) for k, v in named_arrays(m)}


@pytest.fixture(scope="module")
def pair():
    """(JAX SilentCipherModel, the port's with its weights)."""
    jax_layers._INIT_RNG = np.random.default_rng(0)
    jm = jsc.SilentCipherModel(jsc.SilentCipherConfig(**TINY))
    tm = tsc.SilentCipherModel(tsc.SilentCipherConfig(**TINY), device="cpu", seed=1)
    tm.load_state_dict(params_from_jax(_named(jm), tm), strict=True)
    return jm, tm


def _audio(seed=0, n=44100):
    return (np.random.default_rng(seed).standard_normal(n) * 0.1).astype(np.float32)


def test_silentcipher_encode_decode_api_roundtrip(pair):
    """Twin of test_sesame.py:292: encode_wav keeps the length and meets the
    SDR constraint; decode_wav returns the server result's keys."""
    _, tm = pair
    audio = _audio()
    out, _, _ = tm.encode_wav(audio, 44100, KEY, message_sdr=36)
    assert out.shape == audio.shape
    delta = out - audio
    assert 10 * np.log10(np.mean(audio ** 2) / (np.mean(delta ** 2) + 1e-12)) >= 30.0
    res = tm.decode_wav(out, 44100, phase_shift_decoding=True)
    assert set(res) >= {"status", "messages"}
    assert len(res["messages"][0]) == 5 and all(0 <= m < 256 for m in res["messages"][0])


def test_silentcipher_sanitize_torch_conv_layout(pair):
    """Twin of test_sesame.py:310: ``module.`` stripped, conv2d [O, I, kh,
    kw] -> [kh, kw, I, O], ``dec_c.*`` dropped, as the JAX package's."""
    jm, tm = pair
    w = {"module.enc_c.conv_in.weight": np.zeros((8, 6, 3, 3), np.float32),
         "enc_c.conv_in.bias": np.zeros(8, np.float32),
         "module.dec_c.conv_in.weight": np.zeros((8, 1, 3, 3), np.float32)}
    out = tm.sanitize(w)
    assert out.keys() == jm.sanitize(w).keys() == {"enc_c.conv_in.weight", "enc_c.conv_in.bias"}
    assert out["enc_c.conv_in.weight"].shape == (3, 3, 6, 8)
    assert out["enc_c.conv_in.bias"].shape == (8,)


def test_load_watermarker_dispatch(pair, tmp_path, monkeypatch):
    """Twin of test_sesame.py:319: no checkpoint -> the DSSS fallback; a
    native directory (by argument or by $MLX_AUDIO_TPU_SILENTCIPHER) -> the
    SilentCipher model with its weights; a torch-layout directory (module.
    prefixes, OIHW convs, a dec_c array) -> the same weights; a mismatch
    raises the JAX package's ValueError; watermark() and verify() take the
    model."""
    import chip_smoke
    from safetensors.numpy import save_file

    jm, tm = pair
    monkeypatch.delenv("MLX_AUDIO_TPU_SILENTCIPHER", raising=False)
    assert isinstance(twm.load_watermarker(device="cpu"), twm.Watermarker)

    native = tmp_path / "native"
    native.mkdir()
    (native / "config.json").write_text(json.dumps({"native_format": True, **TINY}))
    save_file(_named(jm), str(native / "model.safetensors"))
    torch_dir = tmp_path / "torch"
    torch_dir.mkdir()
    (torch_dir / "config.json").write_text(json.dumps(TINY))
    save_file(chip_smoke.silentcipher_torch_weights(
        {k: t.numpy() for k, t in tm.state_dict().items()}), str(torch_dir / "model.safetensors"))

    want = tm.state_dict()
    for loaded in (twm.load_watermarker(str(native), device="cpu"),
                   twm.load_watermarker(str(torch_dir), device="cpu")):
        assert isinstance(loaded, tsc.SilentCipherModel)
        for k, t in loaded.state_dict().items():
            assert torch.equal(t, want[k]), k
    monkeypatch.setenv("MLX_AUDIO_TPU_SILENTCIPHER", str(native))
    loaded = twm.load_watermarker(device="cpu")
    assert isinstance(loaded, tsc.SilentCipherModel)

    audio = np.zeros(24000, dtype=np.float32)
    marked = twm.watermark(loaded, audio, 24000, twm.CSM_1B_GH_WATERMARK)
    assert marked.shape == audio.shape
    assert isinstance(twm.verify(loaded, marked, 24000, twm.CSM_1B_GH_WATERMARK), bool)

    (native / "config.json").write_text(json.dumps({"native_format": True, **TINY,
                                                    "hidden": 16}))
    with pytest.raises(ValueError, match="does not match this architecture"):
        tsc.load_silentcipher(str(native), device="cpu")


def test_encode_wav_matches_jax(pair):
    """The watermarked audio within 1e-5 of the JAX package's."""
    jm, tm = pair
    audio = _audio(1)
    want, _, _ = jm.encode_wav(audio, 44100, KEY)
    got, _, _ = tm.encode_wav(audio, 44100, KEY)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("shift", [True, False], ids=["phase_shift", "no_shift"])
def test_decode_wav_matches_jax(pair, shift):
    """decode_wav on marked audio: messages and status equal, confidence
    within 1e-5 of the JAX package's."""
    jm, tm = pair
    marked, _, _ = tm.encode_wav(_audio(2), 44100, KEY)
    want = jm.decode_wav(marked, 44100, phase_shift_decoding=shift)
    got = tm.decode_wav(marked, 44100, phase_shift_decoding=shift)
    assert got["messages"] == want["messages"] and got["status"] == want["status"]
    assert abs(got["confidence"] - want["confidence"]) <= ATOL


def test_watermark_and_verify_match_jax(pair):
    """``watermark`` (24 kHz in, resampled to 44.1 kHz and back) and
    ``verify`` through the SilentCipher model: within 1e-5 of the JAX
    package's, the same verdict."""
    jm, tm = pair
    audio = _audio(3, 24000)
    want = jwm.watermark(jm, audio, 24000, KEY)
    got = twm.watermark(tm, audio, 24000, KEY)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert twm.verify(tm, got, 24000, KEY) == jwm.verify(jm, got, 24000, KEY)


def test_csm_watermark_follows_the_env_var(pair, tmp_path, monkeypatch):
    """The CSM model's own ``_watermark`` loads SilentCipher on its device
    from $MLX_AUDIO_TPU_SILENTCIPHER and marks as the JAX CSM's does."""
    from safetensors.numpy import save_file

    from mlx_audio_tpu.models.tts.sesame.model import Model as JaxModel
    from mlx_audio_tpu_torch.codec.mimi import Mimi
    from mlx_audio_tpu_torch.models.tts.sesame import Model
    from test_sesame import tiny_config
    from test_torch_mimi import port_config
    from test_mimi import tiny_mimi

    jm, _ = pair
    d = tmp_path / "sc"
    d.mkdir()
    (d / "config.json").write_text(json.dumps({"native_format": True, **TINY}))
    save_file(_named(jm), str(d / "model.safetensors"))
    monkeypatch.setenv("MLX_AUDIO_TPU_SILENTCIPHER", str(d))
    jax_mimi = tiny_mimi()
    jax_csm = JaxModel(tiny_config(), mimi=jax_mimi)
    csm = Model(tiny_config(), mimi=Mimi.build(port_config(jax_mimi.cfg), device="cpu"),
                device="cpu")
    audio = _audio(4, 24000)
    np.testing.assert_allclose(csm._watermark(audio), jax_csm._watermark(audio),
                               atol=ATOL, rtol=0)


def test_check_audio_from_file_and_main(tmp_path, monkeypatch, capsys):
    """``check_audio_from_file`` and the CLI ``main`` read a wav and print
    the verdict the JAX package's gives (the DSSS mark, no checkpoint)."""
    from mlx_audio_tpu_torch.utils.audio_io import save_audio

    monkeypatch.delenv("MLX_AUDIO_TPU_SILENTCIPHER", raising=False)
    audio = _audio(5, 48000)
    marked = twm.watermark(twm.Watermarker(), audio, 24000, twm.CSM_1B_GH_WATERMARK)
    for name, x in (("marked", marked), ("plain", audio)):
        path = str(tmp_path / f"{name}.wav")
        save_audio(path, x, 24000)
        want = jwm.check_audio_from_file(path, 24000)
        capsys.readouterr()
        assert twm.main(["--audio_path", path, "--device", "cpu"]) == want
        assert capsys.readouterr().out.strip() == ("Watermarked" if want else "Not watermarked")
    assert want is False


@pytest.mark.parametrize("n_fft,hop,window,center", [
    (512, 128, "hann_periodic", True), (400, 160, "hann", True), (2048, 512, "hamming", False)])
def test_stft_matches_jax(n_fft, hop, window, center):
    """The complex STFT: complex64 [..., frames, bins] within 1e-5 of the
    JAX package's, relative to the spectrum's peak magnitude (float32 sums
    of up to 2048 taps round at that scale: 28 here), batched too."""
    x = (np.random.default_rng(6).standard_normal((2, 9000)) * 0.3).astype(np.float32)
    want = np.asarray(jdsp.stft(jnp.asarray(x), n_fft, hop, window=window, center=center))
    got = tdsp.stft(torch.as_tensor(x), n_fft, hop, window=window, center=center)
    assert got.dtype == torch.complex64 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("kw,dtype", [
    (dict(kernel_size=3, padding=1), "float32"),
    (dict(kernel_size=(1, 5), stride=(1, 2), padding=0), "float32"),
    (dict(kernel_size=3, padding=2, dilation=2, bias=False), "float32"),
    (dict(kernel_size=3, stride=2, padding=(0, 1), groups=2), "float32"),
    (dict(kernel_size=3, padding=1), "bfloat16")])
def test_conv2d_matches_jax(kw, dtype):
    """``nn.layers.Conv2d`` over NHWC within 1e-5 of the JAX package's
    (weights crossed HWIO -> OIHW); a float32 input into bf16 weights
    promotes to float32 in both."""
    jax_layers._INIT_RNG = np.random.default_rng(2)
    jc = jnn.Conv2d(4, 6, **kw)
    tc = Conv2d(4, 6, **kw)
    named = _named(jc)
    tc.load_state_dict(params_from_jax(named, tc), strict=True)
    x = (np.random.default_rng(8).standard_normal((2, 11, 13, 4))).astype(np.float32)
    if dtype == "bfloat16":
        from mlx_audio_tpu.nn.module import map_arrays

        jc = map_arrays(jc, lambda p, a: a.astype(jnp.bfloat16))
        tc = tc.to(torch.bfloat16)
    want = np.asarray(jc(jnp.asarray(x)))
    got = tc(torch.as_tensor(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
