"""The port's DSP core (``mlx_audio_tpu_torch/dsp.py``) against the JAX
package's: the twins of tests/test_dsp.py, one a test, on the same seeded
numpy inputs and at that file's tolerances (STFT atol 2e-3, rtol 1e-4;
ISTFT atol 2e-3, rtol 1e-3; overlap-add 1e-5).  The windows are held to
the JAX package's in float64 to 1e-12, every name symmetric and periodic
at 1, 2, 8, 400 and 1024 points; the mel filters to its float32 ones
exactly; framing and the Kokoro source's integer resamplers as the JAX
tests hold theirs.
"""

import numpy as np
import pytest
import torch

import mlx_audio_tpu.dsp as jdsp
import mlx_audio_tpu_torch.dsp as tdsp
from test_dsp import np_istft, np_stft

WINDOWS = ("hann", "hanning", "hamming", "blackman", "bartlett")
WINDOW_ATOL = 1e-12


def _t(x):
    return torch.as_tensor(np.asarray(x))


@pytest.mark.parametrize(
    "n_fft,hop,win,window",
    [(800, 200, 800, "hann"), (400, 160, 400, "hann"), (1024, 256, 1024, "hamming"),
     (512, 128, 400, "blackman"), (256, 64, 256, "bartlett")],
)
def test_stft_matches_jax(n_fft, hop, win, window):
    x = np.random.default_rng(0).standard_normal(8000).astype(np.float32)
    ref = np.asarray(jdsp.stft(x, n_fft, hop, win, window))
    out = tdsp.stft(_t(x), n_fft, hop, win, window).numpy()
    assert out.shape == ref.shape == np_stft(x, n_fft, hop, win, window).shape
    np.testing.assert_allclose(out.real, ref.real, atol=2e-3, rtol=1e-4)
    np.testing.assert_allclose(out.imag, ref.imag, atol=2e-3, rtol=1e-4)


def test_stft_constant_pad():
    x = np.random.default_rng(1).standard_normal(4000).astype(np.float32)
    ref = np.asarray(jdsp.stft(x, 400, 100, 400, "hann", pad_mode="constant"))
    out = tdsp.stft(_t(x), 400, 100, 400, "hann", pad_mode="constant").numpy()
    np.testing.assert_allclose(out.real, ref.real, atol=2e-3)
    np.testing.assert_allclose(out.imag, ref.imag, atol=2e-3)


def test_stft_batched():
    x = np.random.default_rng(2).standard_normal((3, 4000)).astype(np.float32)
    ref = np.asarray(jdsp.stft(x, 400, 160))
    out = tdsp.stft(_t(x), 400, 160).numpy()
    assert out.shape == ref.shape
    for b in range(3):
        np.testing.assert_allclose(out[b].real, ref[b].real, atol=2e-3)
        np.testing.assert_allclose(out[b], tdsp.stft(_t(x[b]), 400, 160).numpy(), atol=1e-5)


@pytest.mark.parametrize("n_fft,hop,window", [(800, 200, "hann"), (400, 100, "blackman"),
                                              (512, 128, "bartlett")])
def test_istft_matches_jax(n_fft, hop, window):
    rng = np.random.default_rng(3)
    spec = (rng.standard_normal((n_fft // 2 + 1, 40))
            + 1j * rng.standard_normal((n_fft // 2 + 1, 40))).astype(np.complex64)
    ref = np.asarray(jdsp.istft(spec, hop, n_fft, window))
    out = tdsp.istft(_t(spec), hop, n_fft, window).numpy()
    assert out.shape == ref.shape == np_istft(spec, hop, n_fft, window).shape
    np.testing.assert_allclose(out, ref, atol=2e-3, rtol=1e-3)


def test_stft_istft_roundtrip():
    """The round trip scales the interior by sum(w^2)/sum(w) = 0.75 for
    hann at hop = n_fft/4 (window-sum normalisation), in both packages."""
    x = np.random.default_rng(4).standard_normal(6400).astype(np.float32)
    ref = np.asarray(jdsp.istft(np.asarray(jdsp.stft(x, 512, 128, 512, "hann")).T,
                                128, 512, "hann"))
    recon = tdsp.istft(tdsp.stft(_t(x), 512, 128, 512, "hann").T, 128, 512, "hann").numpy()
    np.testing.assert_allclose(recon, ref, atol=5e-3)
    n = min(len(recon), 6400)
    np.testing.assert_allclose(recon[512:n - 512], 0.75 * x[512:n - 512], atol=2e-2)


def test_overlap_add_matches_jax():
    frames = np.random.default_rng(5).standard_normal((2, 7, 100)).astype(np.float32)
    ref = np.asarray(jdsp.overlap_add(frames, 30))
    out = tdsp.overlap_add(_t(frames), 30).numpy()
    assert out.shape == ref.shape == (2, 6 * 30 + 100)
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_mel_filters_htk_and_slaney():
    for scale, norm in [("htk", None), ("slaney", "slaney")]:
        ref = np.asarray(jdsp.mel_filters(16000, 400, 80, mel_scale=scale, norm=norm))
        fb = tdsp.mel_filters(16000, 400, 80, mel_scale=scale, norm=norm).numpy()
        assert fb.shape == ref.shape == (80, 201)
        np.testing.assert_array_equal(fb, ref)
        assert fb.min() >= 0 and (fb.sum(axis=1) > 0).all()


def test_mel_filters_against_librosa_style_reference():
    ref = np.asarray(jdsp.mel_filters(22050, 1024, 40, mel_scale="slaney", norm="slaney",
                                      f_min=30.0, f_max=8000.0))
    fb = tdsp.mel_filters(22050, 1024, 40, mel_scale="slaney", norm="slaney",
                          f_min=30.0, f_max=8000.0).numpy()
    np.testing.assert_array_equal(fb, ref)
    assert (np.diff(fb.argmax(axis=1)) >= 0).all()


def test_log_mel_spectrogram_matches_jax():
    from mlx_audio_tpu.models.stt.whisper.audio import log_mel_spectrogram as jlog_mel
    from mlx_audio_tpu_torch.models.stt.whisper.audio import log_mel_spectrogram

    x = (np.random.default_rng(6).standard_normal(16000) * 0.1).astype(np.float32)
    ref = np.asarray(jlog_mel(x, n_mels=80))
    mel = log_mel_spectrogram(x, n_mels=80).numpy()
    assert mel.shape == ref.shape == (100, 80)
    np.testing.assert_allclose(mel, ref, atol=1e-4)
    assert log_mel_spectrogram(np.zeros(16000, np.float32), n_mels=80).isfinite().all()


@pytest.mark.parametrize("size", [1, 2, 8, 400, 1024])
def test_windows_match_reference_formulas(size):
    """Every window name, symmetric and periodic, through ``get_window`` and
    the four float32 window functions: the JAX package's values."""
    for name in WINDOWS:
        for spec in (name, name + "_periodic", name.upper()):
            np.testing.assert_allclose(tdsp.get_window(spec, size),
                                       jdsp.get_window(spec, size),
                                       atol=WINDOW_ATOL, rtol=0)
    for fn in ("hanning", "hamming", "blackman", "bartlett"):
        w = getattr(tdsp, fn)(size, device="cpu")
        assert w.dtype == torch.float32
        np.testing.assert_array_equal(w.numpy(), np.asarray(getattr(jdsp, fn)(size)))
    if size > 1:  # a one-point window is [1.0] whatever its name, as in JAX
        with pytest.raises(ValueError, match="Unknown window"):
            tdsp.get_window("kaiser", size)


def test_frame_signal_slice_path_matches_gather():
    """frame_length % hop == 0 takes the slice path, else the strided one;
    both equal the gather and the JAX package's framing."""
    x = np.random.default_rng(0).standard_normal((2, 1037)).astype(np.float32)
    for frame, hop in ((20, 5), (21, 5)):
        idx = np.arange(1 + (1037 - frame) // hop)[:, None] * hop + np.arange(frame)[None, :]
        out = tdsp.frame_signal(_t(x), frame, hop).numpy()
        np.testing.assert_array_equal(out, x[:, idx])
        np.testing.assert_array_equal(out, np.asarray(jdsp.frame_signal(x, frame, hop)))


def test_sinegen_resample_helpers_match_interpolate():
    """The port's integer-factor linear resamplers of Kokoro's source equal
    its ``nn.interpolate`` as the JAX package's equal its own: down exactly,
    up within 1e-6."""
    from mlx_audio_tpu_torch.models.tts.kokoro.istftnet import (
        _downsample_linear_int_last,
        _upsample_linear_int_last,
    )
    from mlx_audio_tpu_torch.nn.interpolate import interpolate

    rng = np.random.default_rng(1)
    for s in (2, 3, 5, 300, 600):
        x = torch.as_tensor(rng.standard_normal((2, 3, 7 * s)), dtype=torch.float32)
        ref = interpolate(x.transpose(1, 2), scale_factor=1 / s, mode="linear").transpose(1, 2)
        torch.testing.assert_close(_downsample_linear_int_last(x, s), ref, rtol=0, atol=0)
        xf = torch.as_tensor(rng.standard_normal((2, 3, 7)), dtype=torch.float32)
        ref_u = interpolate(xf.transpose(1, 2), scale_factor=s, mode="linear").transpose(1, 2)
        torch.testing.assert_close(_upsample_linear_int_last(xf, s), ref_u,
                                   rtol=1e-6, atol=1e-6)
