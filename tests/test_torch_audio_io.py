"""The port's ``utils.audio_io`` against the JAX package's: the twins of
tests/test_loader_cli.py's audio I/O tests.  Both are numpy and scipy, so
every array is held equal, not close.
"""

import numpy as np
import pytest

from mlx_audio_tpu.utils import audio_io as jio
from mlx_audio_tpu_torch.utils import audio_io as tio


def test_audio_io_roundtrip(tmp_path):
    x = np.sin(np.linspace(0, 100, 24000)).astype(np.float32) * 0.5
    p = tmp_path / "t.wav"
    tio.save_audio(p, x, 24000)
    jio.save_audio(tmp_path / "j.wav", x, 24000)
    assert p.read_bytes() == (tmp_path / "j.wav").read_bytes()
    y = tio.load_audio(p)
    assert y.shape == x.shape and y.dtype == np.float32
    np.testing.assert_allclose(y, x, atol=1e-3)
    np.testing.assert_array_equal(y, jio.load_audio(p))

    z = tio.load_audio(p, sample_rate=16000)
    assert abs(z.shape[0] - 16000) < 10
    np.testing.assert_array_equal(z, jio.load_audio(p, sample_rate=16000))
    r = tio.resample_audio(x, 24000, 8000)
    assert abs(r.shape[0] - 8000) < 10
    np.testing.assert_array_equal(r, jio.resample_audio(x, 24000, 8000))


def test_audio_io_reads_stereo_and_integer_wavs_as_jax_does(tmp_path):
    """Stereo int16 and uint8 wav: the mono mix, the int -> float scale."""
    from scipy.io import wavfile

    rng = np.random.default_rng(0)
    for name, data in (("s16.wav", rng.integers(-30000, 30000, (800, 2)).astype(np.int16)),
                       ("u8.wav", rng.integers(0, 255, 800).astype(np.uint8)),
                       ("i32.wav", rng.integers(-2 ** 30, 2 ** 30, 800).astype(np.int32))):
        wavfile.write(tmp_path / name, 22050, data)
        got = tio.load_audio(tmp_path / name, sample_rate=24000)
        np.testing.assert_array_equal(got, jio.load_audio(tmp_path / name, sample_rate=24000))
        assert got.ndim == 1 and got.dtype == np.float32


def test_audio_io_non_wav_formats_gated(tmp_path):
    """A non-wav container goes through the optional soundfile package, with
    the JAX package's error when it is absent; never wav bytes under .flac."""
    x = np.zeros(1000, dtype=np.float32)
    try:
        import soundfile  # noqa: F401

        p = tio.save_audio(tmp_path / "t.flac", x, 24000)
        assert tio.load_audio(p).shape[0] == 1000
    except ImportError:
        for io in (tio, jio):
            with pytest.raises(RuntimeError, match="soundfile") as err:
                io.save_audio(tmp_path / "t.flac", x, 24000)
            assert "writing .flac audio needs the optional 'soundfile'" in str(err.value)
        (tmp_path / "t.flac").write_bytes(b"fLaC....")
        for io in (tio, jio):
            with pytest.raises(RuntimeError, match="soundfile") as err:
                io.load_audio(tmp_path / "t.flac")
            assert "reading .flac audio needs the optional 'soundfile'" in str(err.value)
