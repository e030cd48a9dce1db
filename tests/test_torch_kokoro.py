"""Kokoro in the port against the JAX package, end to end, at the tiny
config of tests/test_kokoro.py, float32 on the CPU.

The weights cross with ``convert.params_from_jax``; the source's random
draws are the JAX package's own (``_row_normals`` under the keys it splits),
fed to the port as inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_audio_tpu.models.tts.kokoro.istftnet import _row_normals
from mlx_audio_tpu.models.tts.kokoro.model import Model as JaxModel
from mlx_audio_tpu.models.tts.kokoro.model import _duration_stage, _synthesis_stage
from mlx_audio_tpu.nn.module import named_arrays
from mlx_audio_tpu_torch.convert import params_from_jax
from mlx_audio_tpu_torch.models.tts.kokoro import (
    Model,
    ModelConfig,
    duration_stage,
    sanitize,
    synthesis_stage,
)
from test_kokoro import tiny_config

# The first STFT frame of the source is reflect-padded about sample 0, so it
# is even-symmetric and its spectrum is real: the imaginary parts are pure
# rounding residue, and atan2 gives +pi or -pi for bins with a negative real
# part depending on the summation order (istftnet.py:167 in the JAX
# package).  The two frameworks round differently, so the first samples of
# each row may differ by a 2 pi jump in a phase input: observed up to 0.10
# in the first 820 samples, below 3e-4 after sample 2000.  The end-to-end
# comparison starts after HEAD samples; test_decoder_matches_with_reference_
# spectrum compares every sample with the spectrum taken from the reference.
HEAD = 2400
AUDIO_ATOL = 1e-3  # f32 phase cumsums over audio-rate samples differ by
#                    summation order (SineGen phase, ISTFT unwrap)
FLIP_TAIL_ATOL = 2e-3  # past HEAD, between batch shapes (test_generate_entry_points)


def _port_config():
    cfg = tiny_config()
    return ModelConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})


@pytest.fixture(scope="module")
def models():
    import mlx_audio_tpu.nn.layers as jax_layers

    # set up before conftest's per-test reseed: seed the JAX init here
    jax_layers._INIT_RNG = np.random.default_rng(0)
    jax_model = JaxModel(tiny_config())
    port = Model(_port_config(), device="cpu")
    port.load_state_dict(params_from_jax(
        {k: np.asarray(v) for k, v in named_arrays(jax_model)}, port))
    return jax_model, port



def test_models_fixture_does_not_depend_on_earlier_draws():
    """The module-scoped fixture seeds the JAX init itself, so the files a
    worker ran before this one (here: draws from the init RNG and a model
    built) leave its weights, on both sides, as a fresh build's."""
    import mlx_audio_tpu.nn.layers as jax_layers

    fresh_j, fresh_p = models.__wrapped__()
    for n in (7, 1000, 3):
        jax_layers._INIT_RNG.uniform(size=n)
    JaxModel(tiny_config())
    again_j, again_p = models.__wrapped__()
    a, b = dict(named_arrays(fresh_j)), dict(named_arrays(again_j))
    assert a.keys() == b.keys()
    assert all(np.array_equal(np.asarray(a[k]), np.asarray(b[k])) for k in a)
    pa, pb = fresh_p.state_dict(), again_p.state_dict()
    assert pa.keys() == pb.keys() and all(torch.equal(pa[k], pb[k]) for k in pa)

def _source_draws(key, b, frames):
    """The JAX Generator's draws for ``key``: SourceModuleHnNSF splits the
    key and hands the first half to SineGen, which splits it again."""
    k_sine, _ = jax.random.split(key)
    k_ini, k_noise = jax.random.split(k_sine)
    samples = frames * 600
    return (torch.tensor(np.asarray(_row_normals(k_ini, b, (9,)))),
            torch.tensor(np.asarray(_row_normals(k_noise, b, (samples, 9)))))


def _inputs():
    rng = np.random.default_rng(0)
    b, n = 2, 32
    lengths = np.array([29, 17])  # ragged, inside one phoneme bucket
    ids = rng.integers(1, 27, (b, n))
    ids[np.arange(n)[None, :] >= lengths[:, None]] = 0
    ref = (rng.standard_normal((b, 256)) * 0.1).astype(np.float32)
    speed = np.array([1.0, 1.3], np.float32)
    return ids, lengths, ref, speed


def test_slice_matches_jax(models):
    jax_model, port = models
    ids, lengths, ref, speed = _inputs()
    d_j, dur_j = _duration_stage(jax_model, jnp.asarray(ids, jnp.int32),
                                 jnp.asarray(lengths, jnp.int32),
                                 jnp.asarray(ref[:, 128:]), jnp.asarray(speed))
    d_t, dur_t = duration_stage(port, torch.as_tensor(ids),
                                torch.as_tensor(lengths),
                                torch.as_tensor(ref[:, 128:]),
                                torch.as_tensor(speed))
    np.testing.assert_array_equal(dur_t.numpy(), np.asarray(dur_j))

    # cap durations so both rows fit one 100-frame bucket, ragged
    dur = np.minimum(np.asarray(dur_j), 3)
    frames, key = 100, jax.random.PRNGKey(0)
    audio_j, total_j = _synthesis_stage(
        jax_model, jnp.asarray(ids, jnp.int32), jnp.asarray(lengths, jnp.int32),
        d_j, jnp.asarray(dur), jnp.asarray(ref), key,
        jnp.zeros((frames,), jnp.int32))
    rand_ini, noise = _source_draws(key, 2, frames)
    audio_t, total_t = synthesis_stage(
        port, torch.as_tensor(ids), torch.as_tensor(lengths), d_t,
        torch.as_tensor(dur), torch.as_tensor(ref), frames, rand_ini, noise)
    np.testing.assert_array_equal(total_t.numpy(), np.asarray(total_j))
    audio_j, audio_t = np.asarray(audio_j), audio_t.numpy()
    assert audio_t.shape == audio_j.shape == (2, frames * 600)
    assert np.isfinite(audio_t).all()
    # observed max error past HEAD: 2.9e-4
    np.testing.assert_allclose(audio_t[:, HEAD:], audio_j[:, HEAD:],
                               atol=AUDIO_ATOL, rtol=0)


def test_decoder_matches_with_reference_spectrum(models, monkeypatch):
    """Every sample of the decoder's audio, with the source spectrum taken
    from the reference so that the symmetric first frame's phase (see HEAD)
    is the same on both sides."""
    jax_model, port = models
    rng = np.random.default_rng(5)
    b, frames = 2, 60
    asr = (rng.standard_normal((b, frames, 64)) * 0.3).astype(np.float32)
    f0 = (np.abs(rng.standard_normal((b, 2 * frames))) * 100 + 40).astype(np.float32)
    n_curve = (rng.standard_normal((b, 2 * frames)) * 0.3).astype(np.float32)
    s = (rng.standard_normal((b, 128)) * 0.1).astype(np.float32)
    lengths = np.array([frames, 41])
    key = jax.random.PRNGKey(3)

    gen = jax_model.decoder.generator
    up = gen.total_upsample
    f0_up = jnp.repeat(jnp.asarray(f0), up, axis=1)[..., None]
    source = gen.m_source(f0_up, key)[0]
    source = jnp.where(jnp.arange(source.shape[1])[None, :, None]
                       < jnp.asarray(lengths)[:, None, None] * 2 * up, source, 0.0)
    mag, phase = gen.stft.transform(source[..., 0])
    monkeypatch.setattr(port.decoder.generator.stft, "transform",
                        lambda x: (torch.as_tensor(np.asarray(mag)),
                                   torch.as_tensor(np.asarray(phase))))

    ref = jax_model.decoder(jnp.asarray(asr), jnp.asarray(f0), jnp.asarray(n_curve),
                            jnp.asarray(s), key, frame_lengths=jnp.asarray(lengths))
    rand_ini, noise = _source_draws(key, b, frames)
    got = port.decoder(torch.as_tensor(asr), torch.as_tensor(f0),
                       torch.as_tensor(n_curve), torch.as_tensor(s), rand_ini,
                       noise, frame_lengths=torch.as_tensor(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=AUDIO_ATOL,
                               rtol=0)


def test_bucketing_is_exact(models, monkeypatch):
    """The same phonemes give the same audio whichever phoneme and frame
    bucket ran them: masks and the source's per-row draws are exact."""
    import mlx_audio_tpu_torch.models.tts.kokoro.model as km

    port = models[1]
    phonemes = "abc def"
    ref_s = np.random.default_rng(1).standard_normal(256).astype(np.float32) * 0.1
    audio_a, dur_a = port.synthesize(phonemes, ref_s)
    frame_bucket = km.pick_frame_bucket
    monkeypatch.setattr(km, "pick_phoneme_bucket", lambda n: 64)
    monkeypatch.setattr(km, "pick_frame_bucket", lambda t: frame_bucket(t) + 200)
    audio_b, dur_b = port.synthesize(phonemes, ref_s)
    np.testing.assert_array_equal(dur_a, dur_b)
    np.testing.assert_allclose(audio_a, audio_b, atol=2e-4)


def test_synthesize_batch_contract(models):
    port = models[1]
    rng = np.random.default_rng(3)
    ps = ["hello world", "abc", "a longer third phoneme string here"]
    refs = (rng.standard_normal((3, 256)) * 0.1).astype(np.float32)
    outs = port.synthesize_batch(ps, refs, speeds=4.0)
    for (audio, dur), p, r in zip(outs, ps, refs):
        assert dur.shape == (len(p) + 2,) and (dur >= 1).all()
        assert audio.shape == (int(dur.sum()) * 600,)
        assert np.isfinite(audio).all()
        _, dur_single = port.synthesize(p, r, speed=4.0)
        np.testing.assert_array_equal(dur, dur_single)


def test_synthesize_batch_row_alone_at_the_batch_buckets(models):
    """A row run alone at its batch's buckets, with its batch row's source
    draws (``buckets``, ``rows``), gives that row's durations and, past
    HEAD, its audio within FLIP_TAIL_ATOL."""
    import mlx_audio_tpu_torch.models.tts.kokoro.model as km

    port = models[1]
    rng = np.random.default_rng(5)
    ps = ["hello world", "abc", "a longer third phoneme string here"]
    refs = (rng.standard_normal((3, 256)) * 0.1).astype(np.float32)
    outs = port.synthesize_batch(ps, refs, speeds=4.0)
    buckets = (km.pick_phoneme_bucket(max(len(port.phonemes_to_ids(p)) + 2 for p in ps)),
               km.pick_frame_bucket(max(a.shape[0] for a, _ in outs) // 600))
    for i, (p, (audio, dur)) in enumerate(zip(ps, outs)):
        (alone, dur_alone), = port.synthesize_batch([p], refs[i:i + 1], speeds=4.0,
                                                    buckets=buckets, rows=[i])
        np.testing.assert_array_equal(dur_alone, dur)
        assert alone.shape == audio.shape
        np.testing.assert_allclose(alone[HEAD:], audio[HEAD:], atol=FLIP_TAIL_ATOL, rtol=0)
    # row 1's draws are not row 0's: without ``rows`` the row parts from its batch
    (default, _), = port.synthesize_batch([ps[1]], refs[1:2], speeds=4.0, buckets=buckets)
    assert np.abs(default[HEAD:] - outs[1][0][HEAD:]).max() > FLIP_TAIL_ATOL


def test_generate_entry_points(models, tmp_path):
    port = models[1]
    pack = (np.random.default_rng(4).standard_normal((510, 1, 256)) * 0.1
            ).astype(np.float32)
    voice = str(tmp_path / "voice.npy")
    np.save(voice, pack)
    segments = list(port.generate("hello there\n\nabc def", voice=voice,
                                  speed=4.0))
    (one_row,) = port.generate_batch(["hello there"], voice=voice, speed=4.0)
    batch = port.generate_batch(["hello there", "abc def"], voice=voice,
                                speed=4.0)
    assert len(segments) == 2 and len(batch) == 2
    for r in [*segments, one_row, *batch]:
        assert r.samples > 0 and r.samples % 600 == 0
        assert np.isfinite(r.audio).all()
    # generate runs each segment as a one-row batch: with the same batch
    # shape the source's first STFT frame rounds the same way, so every
    # sample agrees
    assert segments[0].samples == one_row.samples
    np.testing.assert_allclose(segments[0].audio, one_row.audio, atol=1e-6,
                               rtol=0)
    # each row of a two-row batch has the samples of its segment.  Row 0
    # draws the same source noise as a one-row batch, but the two-row batch
    # rounds differently upstream, which can flip the first frame's phase
    # between +pi and -pi (see HEAD).  Forcing a flip of every such bin on
    # this config changed samples 0-800 by up to 0.2, 800-2400 by up to
    # 1.3e-3 and later ones by up to 4.3e-4: past HEAD row 0 agrees to
    # FLIP_TAIL_ATOL, five times that tail
    assert [r.samples for r in batch] == [s.samples for s in segments]
    np.testing.assert_allclose(batch[0].audio[HEAD:], segments[0].audio[HEAD:],
                               atol=FLIP_TAIL_ATOL, rtol=0)
    # voice packs are local files: a bare voice name is refused, not fetched
    with pytest.raises(ValueError, match="local voice pack"):
        port.generate_batch(["abc"], voice="af_heart")


def test_sanitize_maps_a_torch_checkpoint_onto_the_model(models):
    """A torch-named checkpoint (LSTM weight_ih_l0..., gamma/beta, alpha
    [1, C, 1], duration_proj.linear_layer) sanitizes to the port's own
    state_dict, value for value; MLX [O, K, I] convs are transposed."""
    state = {k: v.numpy() for k, v in models[1].state_dict().items()}
    torch_names = {"Wx_backward": "weight_ih_l0_reverse",
                   "Wh_backward": "weight_hh_l0_reverse",
                   "bias_ih_backward": "bias_ih_l0_reverse",
                   "bias_hh_backward": "bias_hh_l0_reverse",
                   "Wx_forward": "weight_ih_l0", "Wh_forward": "weight_hh_l0",
                   "bias_ih_forward": "bias_ih_l0",
                   "bias_hh_forward": "bias_hh_l0"}
    ckpt = {"bert.embeddings.position_ids": np.zeros((1, 512))}
    for key, w in state.items():
        head, _, leaf = key.rpartition(".")
        if leaf in torch_names:
            key = f"{head}.{torch_names[leaf]}"
        elif ".alpha" in key:
            w = w.reshape(1, -1, 1)
        elif key == "text_encoder.cnn.0.1.weight":
            key = "text_encoder.cnn.0.1.gamma"
        elif key.startswith("predictor.duration_proj."):
            key = key.replace("duration_proj.", "duration_proj.linear_layer.")
        ckpt[key] = w
    out = sanitize(ckpt)
    assert sorted(out) == sorted(state)
    for key, w in state.items():
        np.testing.assert_array_equal(out[key], w, err_msg=key)
    mlx_conv = np.zeros((8, 3, 3), np.float32)
    mlx_conv[:, 1, 2] = 1.0  # [O, K, I]
    got = sanitize({"decoder.generator.noise_convs.0.weight": mlx_conv})
    assert got["decoder.generator.noise_convs.0.weight"][0, 2, 1] == 1.0


def test_model_runs_on_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(_port_config())
