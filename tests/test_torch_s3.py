"""The S3 speech tokenizers in the port against the JAX package (twins of
all of tests/test_s3.py), at its small config on the CPU.

The JAX model's weights cross with ``convert.params_from_jax``; its v1
codebook, zero at the JAX init (every code would tie), is redrawn as
Gaussian rows on the unit sphere first.  The JAX side runs at
``jax.default_matmul_precision("highest")``.  Log-mel within 1e-5; codes
and lengths equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import mlx_audio_tpu.nn.layers as jax_layers
from mlx_audio_tpu.codec import s3 as js3
from mlx_audio_tpu.nn.module import named_arrays, update_arrays
from mlx_audio_tpu_torch.codec import s3 as ts3
from mlx_audio_tpu_torch.convert import params_from_jax
from mlx_audio_tpu_torch.nn import kernels

ATOL = 1e-5


def small_cfg(mod, **kw):
    return mod.S3Config(**{**dict(n_mels=128, n_audio_ctx=1500, n_audio_state=64,
                                  n_audio_head=4, n_audio_layer=2, n_codebook_size=128),
                           **kw})


def pair(cls_name, name, **kw):
    """(JAX tokenizer, the port's with its weights)."""
    jm = getattr(js3, cls_name)(name, small_cfg(js3, **kw))
    if cls_name == "S3Tokenizer":
        rng = np.random.default_rng(7)
        embed = rng.standard_normal(np.shape(jm.quantizer.embed)).astype(np.float32)
        embed /= np.linalg.norm(embed, axis=-1, keepdims=True)
        jm = update_arrays(jm, {"quantizer.embed": embed})
    tm = getattr(ts3, cls_name)(name, small_cfg(ts3, **kw), device="cpu", seed=1)
    tm.load_state_dict(params_from_jax({k: np.asarray(v) for k, v in named_arrays(jm)}, tm),
                       strict=True)
    return jm, tm


def both(jm, tm, mel, lens):
    with jax.default_matmul_precision("highest"):
        jc, jl = jm(jnp.asarray(mel), jnp.asarray(lens))
    tc, tl = tm(mel, lens)
    return (np.asarray(jc), np.asarray(jl)), (tc.numpy(), tl.numpy())


def _mel(seed, shape, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.fixture(autouse=True)
def _seeded_jax_init():
    jax_layers._INIT_RNG = np.random.default_rng(0)


@pytest.mark.parametrize("signal,padding", [("noise", 0), ("silence", 480)])
def test_log_mel_matches_jax(signal, padding):
    """Twin of test_log_mel_shape: [128, frames], finite, within 1e-5 of
    the JAX package's on a seeded clip and on silence."""
    x = ((np.random.default_rng(3).standard_normal(16000) * 0.1).astype(np.float32)
         if signal == "noise" else np.zeros(16000, np.float32))
    want = np.asarray(js3.log_mel_spectrogram(x, padding=padding))
    got = ts3.log_mel_spectrogram(x, padding=padding).numpy()
    assert got.shape == want.shape and got.shape[0] == 128
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_v1_quantize_50hz():
    """Twin of test_v1_quantize_50hz: 200 mel frames -> 100 codes, equal to
    JAX's."""
    jm, tm = pair("S3Tokenizer", "speech_tokenizer_v1")
    (jc, jl), (tc, tl) = both(jm, tm, _mel(0, (1, 128, 200)), np.asarray([200]))
    assert tc.shape == (1, 100) and tl.tolist() == [100]
    assert (tc >= 0).all() and (tc < 128).all() and len(np.unique(tc)) > 8
    assert (tc == jc).all() and (tl == jl).all()


def test_v1_quantize_25hz():
    """Twin of test_v1_quantize_25hz: conv1 at stride 2, 200 -> 50 codes."""
    jm, tm = pair("S3Tokenizer", "speech_tokenizer_v1_25hz")
    (jc, jl), (tc, tl) = both(jm, tm, _mel(1, (1, 128, 200)), np.asarray([200]))
    assert tc.shape == (1, 50) and tl.tolist() == [50]
    assert (tc == jc).all() and (tl == jl).all()


def test_v2_fsq_codes():
    """Twin of test_v2_fsq_range: FSQ codes in [0, 3^8), equal to JAX's."""
    jm, tm = pair("S3TokenizerV2", "speech_tokenizer_v2_25hz")
    (jc, jl), (tc, tl) = both(jm, tm, _mel(0, (1, 128, 100), 0.1), np.asarray([100]))
    assert tc.shape == (1, 25)
    assert (tc >= 0).all() and (tc < 3 ** 8).all() and len(np.unique(tc)) > 4
    assert (tc == jc).all() and (tl == jl).all()


@pytest.mark.parametrize("cls_name,name", [("S3Tokenizer", "speech_tokenizer_v1"),
                                           ("S3TokenizerV2", "speech_tokenizer_v2_25hz")])
def test_padded_batch_lengths(cls_name, name):
    """Twin of test_padded_batch_lengths: a padded batch gives each row's
    length and JAX's codes (v2's FSMN conv masked too)."""
    jm, tm = pair(cls_name, name)
    (jc, jl), (tc, tl) = both(jm, tm, _mel(2, (2, 128, 200)), np.asarray([200, 120]))
    want = [100, 60] if name.endswith("v1") else [50, 30]
    assert tl.tolist() == want and (tl == jl).all()
    assert (tc == jc).all()


def test_s3_from_pretrained_roundtrip(tmp_path):
    """Twin of test_s3_from_pretrained_roundtrip: the port reads a named
    MLX-layout safetensors file (conv weights [O, K, I]) written from a JAX
    model and gives its codes; without the named file it reads every
    safetensors file of the directory."""
    from safetensors.numpy import save_file

    import chip_smoke

    name = "speech_tokenizer_v2_25hz"
    kw = dict(n_mels=8, n_audio_state=16, n_audio_head=2, n_audio_layer=1)
    jm = js3.S3TokenizerV2(name, config=js3.S3Config(**kw))
    weights = chip_smoke.s3_mlx_weights({k: np.asarray(v) for k, v in named_arrays(jm)})
    save_file(weights, str(tmp_path / f"{name}.safetensors"))
    loaded = ts3.S3TokenizerV2.from_pretrained(name=name, repo_id=str(tmp_path),
                                               config=ts3.S3Config(**kw), device="cpu")
    mel = _mel(0, (1, 8, 64), 1.0)
    (jc, jl), (tc, tl) = both(jm, loaded, mel, np.asarray([64]))
    assert (tc == jc).all() and (tl == jl).all()
    (tmp_path / f"{name}.safetensors").rename(tmp_path / "model.safetensors")
    again = ts3.S3TokenizerV2.from_pretrained(repo_id=str(tmp_path),
                                              config=ts3.S3Config(**kw), device="cpu")
    assert (again(mel, [64])[0].numpy() == jc).all()


@pytest.mark.parametrize("cls_name,name,calls", [
    ("S3Tokenizer", "speech_tokenizer_v1", 1),
    ("S3Tokenizer", "speech_tokenizer_v1_25hz", 0),
    ("S3TokenizerV2", "speech_tokenizer_v2_25hz", 0)])
def test_conv1_route(monkeypatch, cls_name, name, calls):
    """At 2100 mel frames and 128 channels v1 at 50 Hz sends conv1 to the
    ``dilated_conv1d`` wrapper once an encode (its plain version on the
    CPU), as Whisper's conv1; the strided and depthwise convs take the
    library."""
    seen = []
    dilated = kernels.dilated_conv1d

    def counting(x, w, dilation=1):
        seen.append(tuple(x.shape))
        return dilated(x, w, dilation)

    monkeypatch.setattr(kernels, "dilated_conv1d", counting)
    tm = getattr(ts3, cls_name)(name, small_cfg(ts3, n_audio_state=128, n_audio_head=2,
                                                n_audio_layer=1), device="cpu")
    _, lens = tm(_mel(4, (1, 128, 2100)), [2100])
    assert seen == [(1, 2100, 128)] * calls
    assert lens.tolist() == [1050 if name.endswith("v1") else 525]
