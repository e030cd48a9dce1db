"""Spark-TTS in the port against the JAX package, float32 on the CPU: the port
twin of tests/test_spark.py, at its tiny BiCodec (``TINY_BICODEC``) and LM,
with its ``_FakeTokenizer``.

Weights cross with ``convert.params_from_jax`` and
``load_state_dict(strict=True)``.  At the JAX init a weight norm's ``g``
equals its norm and the batch norms' running statistics are 0 and 1, which
hide a wrong axis or a swapped buffer, so every JAX model here has both
drawn afresh before crossing (``redraw``).  Tokens (semantic, global, FSQ,
greedy LM tokens) are held equal to the JAX package's; audio, features and
latents to atol 1e-4 and rtol 1e-4.  The tokenizer's wav2vec2 is a small
one of 16 layers (hidden states 11, 14 and 16 are mixed), 32 wide, and
BiCodec's encoder takes 32 channels to match.  The tiny LM's embedding is
scaled by 0.05, as in tests/test_torch_outetts.py: at the JAX init a tied
tiny LM repeats one token.  The JAX PRNG cannot be reproduced, so sampled
runs are held to their own properties.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mlx_audio_tpu.models.lm.causal as jax_causal
import mlx_audio_tpu.models.tts.spark.spark as jax_spark
import mlx_audio_tpu.nn.layers as jax_layers
from mlx_audio_tpu.models.tts.spark import bicodec as jb_mod
from mlx_audio_tpu.models.tts.spark import modules as jm_mod
from mlx_audio_tpu.models.tts.spark import token_parser as jax_tp
from mlx_audio_tpu.models.tts.spark.audio_tokenizer import (
    audio_volume_normalize as jax_volume_normalize,
)
from mlx_audio_tpu.nn.module import named_arrays, update_arrays
from mlx_audio_tpu_torch.convert import params_from_jax
from mlx_audio_tpu_torch.models.stt.wav2vec import Wav2Vec2Model
from mlx_audio_tpu_torch.models.stt.wav2vec import ModelConfig as W2VConfig
from mlx_audio_tpu_torch.models.tts.spark import BiCodec, Model, ModelConfig
from mlx_audio_tpu_torch.models.tts.spark import bicodec as pb_mod
from mlx_audio_tpu_torch.models.tts.spark import modules as pm_mod
from mlx_audio_tpu_torch.models.tts.spark import spark as port_spark
from mlx_audio_tpu_torch.models.tts.spark import token_parser as port_tp
from mlx_audio_tpu_torch.models.tts.spark.audio_tokenizer import audio_volume_normalize
from mlx_audio_tpu_torch.nn.layers import conv1d_route
from test_spark import TINY_BICODEC, _FakeTokenizer
from test_wav2vec_voxtral import small_w2v

TOL = dict(atol=1e-4, rtol=1e-4)
EMBED_SCALE = 0.05
LM = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
          num_attention_heads=4, num_key_value_heads=2, vocab_size=256,
          max_position_embeddings=512)
# BiCodec's encoder takes the 32-wide wav2vec2 features of the tokenizer
BICODEC_W2V = dict(TINY_BICODEC, encoder=dict(TINY_BICODEC["encoder"], input_channels=32))
W2V = dict(num_hidden_layers=16, do_stable_layer_norm=True, feat_extract_norm="layer")
REF_SECONDS = 0.2  # the speaker reference clip: 3200 samples, 201 mel frames


def _seeded(build):
    saved = jax_layers._INIT_RNG
    jax_layers._INIT_RNG = np.random.default_rng(0)
    try:
        return build()
    finally:
        jax_layers._INIT_RNG = saved


def redraw(jax_module, seed: int = 1):
    """Every weight-norm ``g`` and every batch norm's running statistics
    drawn afresh."""
    rng = np.random.default_rng(seed)
    updates = {}
    for k, v in named_arrays(jax_module):
        v = np.asarray(v)
        if k.endswith(("weight_g", "running_var")):
            updates[k] = v * rng.uniform(0.5, 1.5, v.shape)
        elif k.endswith("running_mean"):
            updates[k] = v + rng.normal(0.0, 0.2, v.shape)
    return update_arrays(jax_module, updates)


def carry(jax_module, port):
    named = {k: np.asarray(v) for k, v in named_arrays(jax_module)}
    port.load_state_dict(params_from_jax(named, port), strict=True)
    return port


def twin(jax_build, port_build):
    jm = redraw(_seeded(jax_build))
    return jm, carry(jm, port_build())


def _x(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def close(port_out, jax_out):
    np.testing.assert_allclose(port_out.detach().numpy(), np.asarray(jax_out), **TOL)


def equal(port_out, jax_out):
    np.testing.assert_array_equal(port_out.numpy(), np.asarray(jax_out))


def jit(fn, *args):
    """``fn(*args)`` jitted: one compile, where eager JAX compiles op by op."""
    return jax.jit(fn)(*args)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw,length", [(dict(upsample_scale=2), 24),
                                       (dict(downsample_scale=2), 6),
                                       ({}, 12)], ids=["up", "down", "identity"])
def test_sampling_block_matches_jax(kw, length):
    """The depthwise WN transposed conv (g drawn afresh) and the grouped
    strided conv cross as torch's grouped layouts."""
    jm, pm = twin(lambda: jm_mod.SamplingBlock(dim=16, groups=16, **kw),
                  lambda: pm_mod.SamplingBlock(dim=16, groups=16, **kw))
    x = _x(0, (2, 12, 16))
    y = pm(torch.as_tensor(x))
    assert y.shape == (2, length, 16)
    close(y, jm(jnp.asarray(x)))
    if not kw:
        torch.testing.assert_close(y, 3 * torch.as_tensor(x))


def test_fsq_matches_jax():
    jm, pm = twin(lambda: jm_mod.FSQ(levels=[4, 4, 4]), lambda: pm_mod.FSQ(levels=[4, 4, 4]))
    z = _x(1, (2, 6, 3), 2.0)
    codes, idx = pm(torch.as_tensor(z))
    j_codes, j_idx = jm(jnp.asarray(z))
    equal(codes, j_codes)
    equal(idx, j_idx)
    assert int(idx.max()) < pm.codebook_size
    equal(pm.indices_to_codes(idx), jm.indices_to_codes(j_idx))
    torch.testing.assert_close(pm.indices_to_codes(idx), codes, atol=1e-6, rtol=0)


def test_residual_fsq_matches_jax():
    jm, pm = twin(lambda: jm_mod.ResidualFSQ(levels=[4, 4], num_quantizers=2),
                  lambda: pm_mod.ResidualFSQ(levels=[4, 4], num_quantizers=2))
    z = _x(2, (2, 5, 2))
    q, idx = pm(torch.as_tensor(z))
    (j_q, j_idx), j_out = jit(lambda m, a: (m(a), m.get_output_from_indices(m(a)[1])), jm, z)
    equal(idx, j_idx)
    close(q, j_q)
    close(pm.get_output_from_indices(idx), j_out)
    torch.testing.assert_close(pm.get_output_from_indices(idx), q, atol=1e-5, rtol=0)


def test_factorized_vq_matches_jax():
    jm, pm = twin(lambda: jm_mod.FactorizedVectorQuantize(16, 32, 4),
                  lambda: pm_mod.FactorizedVectorQuantize(16, 32, 4))
    z = _x(3, (2, 7, 16))
    idx = pm.tokenize(torch.as_tensor(z))
    assert idx.shape == (2, 7) and int(idx.max()) < 32
    j_idx, j_out = jit(lambda m, a: (m.tokenize(a), m.detokenize(m.tokenize(a))), jm, z)
    equal(idx, j_idx)
    out = pm.detokenize(idx)
    close(out, j_out)
    full = pm(torch.as_tensor(z))
    torch.testing.assert_close(out, full["z_q"], atol=1e-6, rtol=0)
    assert torch.equal(idx, full["indices"])


SPEAKER = dict(input_dim=16, out_dim=16, latent_dim=8, token_num=4, fsq_levels=[4, 4])


def test_speaker_encoder_matches_jax():
    """Global tokens equal, x- and d-vectors within the tolerance, with the
    batch norms' running statistics drawn afresh: they cross as buffers
    under their own names."""
    jm, pm = twin(lambda: jm_mod.SpeakerEncoder(**SPEAKER),
                  lambda: pm_mod.SpeakerEncoder(**SPEAKER))
    state = pm.state_dict()
    named = dict(named_arrays(jm))
    stats = [k for k in named if k.endswith(("running_mean", "running_var"))]
    assert len(stats) >= 2 * 20
    buffers = dict(pm.named_buffers())
    for k in stats:
        assert k in buffers
        np.testing.assert_array_equal(state[k].numpy(), np.asarray(named[k]))
    assert np.ptp(np.asarray(named["speaker_encoder.bn.running_var"])) > 0.1
    mel = _x(4, (2, 40, 16))
    tokens = pm.tokenize(torch.as_tensor(mel))
    assert tokens.shape == (2, 4)
    j_tokens, j_dvec, (j_x, j_d) = jit(
        lambda m, x: (m.tokenize(x), m.detokenize(m.tokenize(x)), m(x)), jm, mel)
    equal(tokens, j_tokens)
    close(pm.detokenize(tokens), j_dvec)
    x_vec, d_vec = pm(torch.as_tensor(mel))
    close(x_vec, j_x)
    close(d_vec, j_d)
    torch.testing.assert_close(pm.detokenize(tokens), d_vec, atol=1e-5, rtol=0)


def test_encoder_decoder_match_jax():
    je, pe = twin(lambda: jb_mod.Encoder(**TINY_BICODEC["encoder"]),
                  lambda: pb_mod.Encoder(**TINY_BICODEC["encoder"]))
    jd, pd = twin(lambda: jb_mod.Decoder(**TINY_BICODEC["prenet"]),
                  lambda: pb_mod.Decoder(**TINY_BICODEC["prenet"]))
    x, c = _x(5, (2, 20, 8)), _x(6, (2, 16))
    z = pe(torch.as_tensor(x))
    assert z.shape == (2, 5, 16)
    close(z, jit(lambda m, a: m(a), je, x))
    y = pd(z, torch.as_tensor(c))
    assert y.shape == (2, 20, 16)
    close(y, jit(lambda m, a, b: m(a, b), jd, z.numpy(), c))


def test_wave_generator_matches_jax():
    jm, pm = twin(lambda: jb_mod.WaveGenerator(**TINY_BICODEC["decoder"]),
                  lambda: pb_mod.WaveGenerator(**TINY_BICODEC["decoder"]))
    x = _x(7, (2, 10, 16))
    wav = pm(torch.as_tensor(x))
    assert wav.shape == (2, 40, 1) and float(wav.abs().max()) <= 1.0
    assert float(wav.abs().max()) > 1e-2
    close(wav, jit(lambda m, a: m(a), jm, x))


def test_mel_spectrogram_matches_jax():
    """win_length 32 < n_fft 64: the window is zero-padded on the right."""
    wav = _x(10, (2, 1600))
    kw = dict(n_mels=16, n_fft=64, hop_length=16, win_length=32)
    mel = pb_mod.mel_spectrogram(torch.as_tensor(wav), **kw)
    assert mel.shape == (2, 1600 // 16 + 1, 16)
    close(mel, jb_mod.mel_spectrogram(jnp.asarray(wav), **kw))


def test_wave_generator_routes_at_default_config():
    """DEFAULT_BICODEC_CONFIG's second decoder block, [1, 40 S, 384] for S
    semantic tokens: the dense conv takes banded_conv1d from S = 103 (and
    dilated_conv1d below), every conv takes dilated_conv1d from 40 S >= 2048
    unless banded; the other blocks' resblocks take the library."""
    def routes(s):
        return [conv1d_route(7, 384, 384, 40 * s, d, padding=3 * d) for d in (1, 3, 9)]

    assert routes(150) == ["banded", "shifted", "shifted"]
    assert routes(103) == ["banded", "shifted", "shifted"]
    assert routes(102) == ["shifted", "shifted", "shifted"]
    assert routes(51) == ["library"] * 3
    for c, per_token in ((768, 8), (192, 160), (96, 320)):
        assert {conv1d_route(7, c, c, per_token * 150, d, padding=3 * d)
                for d in (1, 3, 9)} == {"library"}


@pytest.fixture(scope="module")
def codecs():
    return twin(lambda: jb_mod.BiCodec(TINY_BICODEC), lambda: BiCodec(TINY_BICODEC, device="cpu"))


def test_bicodec_matches_jax(codecs):
    jb, pb = codecs
    feat, ref = _x(8, (1, 20, 8)), _x(9, (1, 1600), 0.1)
    semantic, global_ = pb.tokenize(torch.as_tensor(feat), ref)
    j_sem, j_glo = jb.tokenize(jnp.asarray(feat), jnp.asarray(ref))
    assert semantic.shape == (1, 5) and global_.shape == (1, 4)
    equal(semantic, j_sem)
    equal(global_, j_glo)
    wav = pb.detokenize(semantic, global_)
    assert wav.shape == (1, 80)
    close(wav, jb.detokenize(j_sem, j_glo))
    torch.testing.assert_close(pb.detokenize(semantic, global_[:, None, :]), wav,
                               atol=1e-6, rtol=0)
    out, j_out = pb(torch.as_tensor(feat), ref), jit(lambda m, a, b: m(a, b), jb, feat, ref)
    equal(out["indices"], j_out["indices"])
    for k in ("recons", "pred_feat", "x_vector", "d_vector"):
        close(out[k], j_out[k])


def test_bicodec_sanitize_matches_jax(codecs):
    """Torch BiCodec keys (the samplers' and the perceiver's Sequential
    indices, every layout) sanitize as in the JAX package, and the names
    exist in the port's state dict."""
    jb, pb = codecs
    rng = np.random.default_rng(11)
    w = {
        "speaker_encoder.perceiver_sampler.layers.0.1.0.weight": rng.standard_normal((6, 4)),
        "speaker_encoder.perceiver_sampler.layers.0.1.2.bias": rng.standard_normal((4,)),
        "prenet.downsample.0.0.de_conv_upsampler.1.weight_g": rng.standard_normal((16, 1, 1)),
        "prenet.downsample.0.0.de_conv_upsampler.1.weight_v": rng.standard_normal((16, 1, 4)),
        "encoder.downsample.0.0.conv_downsampler.1.weight": rng.standard_normal((16, 1, 4)),
        "decoder.model.1.block.1.weight_g": rng.standard_normal((32, 1, 1)),
        "decoder.model.1.block.1.weight_v": rng.standard_normal((32, 16, 4)),
        "decoder.model.0.weight_g": rng.standard_normal((32, 1, 1)),
        "decoder.model.1.block.0.alpha": rng.standard_normal((1, 32, 1)),
        "speaker_encoder.speaker_encoder.bn.num_batches_tracked": np.zeros(()),
    }
    got, want = pb.sanitize(w), jb.sanitize(w)
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    assert "speaker_encoder.perceiver_sampler.layers.0.1.w_in.weight" in got
    state = pb.state_dict()
    named = dict(named_arrays(jb))
    for k, v in got.items():
        if "perceiver" not in k:
            assert k in state and named[k].shape == v.shape, k
    port_sd = params_from_jax(got, pb)
    for k in got:
        if "perceiver" not in k:
            assert port_sd[k].shape == state[k].shape, k


# ---------------------------------------------------------------------------
# the tokenizer and the model
# ---------------------------------------------------------------------------


def _w2v_pair():
    return twin(lambda: small_w2v(**W2V),
                lambda: Wav2Vec2Model(W2VConfig(**vars(small_w2v(**W2V).config)),
                                      device="cpu"))


@pytest.fixture(scope="module")
def models():
    jb, pb = twin(lambda: jb_mod.BiCodec(BICODEC_W2V), lambda: BiCodec(BICODEC_W2V, device="cpu"))
    jw, pw = _w2v_pair()
    cfg = jax_spark.ModelConfig(**LM)
    jm = _seeded(lambda: jax_spark.Model(cfg, bicodec=jb, wav2vec2=jw,
                                         tokenizer=_FakeTokenizer()))
    jm.lm.model.embed_tokens.weight = jm.lm.model.embed_tokens.weight * EMBED_SCALE
    pm = Model(ModelConfig(**vars(cfg)), bicodec=pb, wav2vec2=pw,
               tokenizer=_FakeTokenizer(), device="cpu")
    carry(jm.lm, pm.lm)
    for m in (jm, pm):
        m._audio_tokenizer.config["ref_segment_duration"] = REF_SECONDS
    return jm, pm


def _ref_audio():
    return _x(12, (3200,), 0.1)


@pytest.fixture
def jax_features(monkeypatch):
    """The JAX package's jitted feature mix unpacks two of the three values
    its ``Wav2Vec2Model`` returns (``audio_tokenizer.py:126``), so its
    tokenizer raises before any token; the same mix, unpacked as three,
    stands in for it here."""
    import mlx_audio_tpu.models.tts.spark.audio_tokenizer as jax_tokenizer

    with pytest.raises(ValueError, match="too many values to unpack"):
        jax_tokenizer._w2v_features_jit(small_w2v(**W2V), jnp.zeros((1, 400)))

    @jax.jit
    def mix(model, wavs):
        _, _, hidden = model(wavs, output_hidden_states=True)
        return (hidden[11] + hidden[14] + hidden[16]) / 3

    monkeypatch.setattr(jax_tokenizer, "_w2v_features_jit", mix)


def test_bicodec_tokenizer_matches_jax(models, jax_features):
    """The (11 + 14 + 16) / 3 wav2vec2 mix within the tolerance; global and
    semantic tokens equal."""
    jm, pm = models
    jt, pt = jm._audio_tokenizer, pm._audio_tokenizer
    wav = _ref_audio()
    np.testing.assert_array_equal(audio_volume_normalize(wav), jax_volume_normalize(wav))
    p_wav, p_ref = pt.process_audio(wav)
    j_wav, j_ref = jt.process_audio(wav)
    np.testing.assert_array_equal(p_wav, j_wav)
    np.testing.assert_array_equal(p_ref, j_ref)
    assert p_ref.shape == (1, 3200)
    feat = pt.extract_wav2vec2_features(p_wav[None])
    close(feat, jt.extract_wav2vec2_features(j_wav[None]))
    assert feat.shape[-1] == 32
    glo, sem = pt.tokenize(wav)
    j_glo, j_sem = jt.tokenize(wav)
    assert glo.shape == (1, 4) and sem.shape == (1, 39)
    equal(glo, j_glo)
    equal(sem, j_sem)
    close(torch.as_tensor(pt.detokenize(glo, sem)), jt.detokenize(j_glo, j_sem))


def test_tokenizer_reads_a_wav_path_as_jax_does(models, monkeypatch, jax_features,
                                                tmp_path):
    """A reference wav path is read at 16 kHz: its global and semantic tokens
    equal the JAX package's on the same file, and so do a voice-clone
    generate's greedy tokens and audio.  (Both models generate the same
    text: the fake tokenizers give ids to characters as they meet them.)"""
    from mlx_audio_tpu_torch.utils.audio_io import save_audio

    jm, pm = models
    path = tmp_path / "ref.wav"
    save_audio(path, _ref_audio(), 16000)
    glo, sem = pm._audio_tokenizer.tokenize(str(path))
    j_glo, j_sem = jm._audio_tokenizer.tokenize(str(path))
    equal(glo, j_glo)
    equal(sem, j_sem)
    seen = _record(monkeypatch, "generate_tokens")
    kw = dict(ref_text="a reference", temperature=0.0, max_tokens=8)
    ours = list(pm.generate("hello", ref_audio=path, **kw))
    ref = list(jm.generate("hello", ref_audio=path, **kw))
    assert seen["port"] == seen["jax"] and len(ours) == len(ref) == 1
    np.testing.assert_allclose(ours[0].audio, np.asarray(ref[0].audio), **TOL)
    with pytest.raises(RuntimeError, match="soundfile"):
        pm._audio_tokenizer.tokenize(str(tmp_path / "ref.ogg"))


def _record(monkeypatch, name):
    """What each model's ``name`` (generate_tokens or generate_tokens_batch)
    returns, as token lists."""
    seen = {"jax": [], "port": []}
    # the JAX generate_batch imports generate_tokens_batch when called
    jax_owner = jax_spark if name == "generate_tokens" else jax_causal
    for module, key in ((port_spark, "port"), (jax_owner, "jax")):
        fn = getattr(module, name)
        if name == "generate_tokens":
            def wrapped(*a, f=fn, k=key, **kw):
                toks = []
                seen[k].append(toks)
                for chunk in f(*a, **kw):
                    toks.extend(int(t) for t in chunk)
                    yield chunk
        else:
            def wrapped(*a, f=fn, k=key, **kw):
                out = f(*a, **kw)
                seen[k].append([np.asarray(o).tolist() for o in out])
                return out
        monkeypatch.setattr(module, name, wrapped)
    return seen


@pytest.mark.parametrize("mode", ["control", "clone"])
def test_generate_greedy_matches_jax(models, monkeypatch, jax_features, mode):
    """Greedy tokens equal to the JAX package's; the audio (6 semantic
    tokens -> x4 -> x4 samples) within the tolerance.  Clone mode tokenizes
    the reference once for every segment."""
    jm, pm = models
    seen = _record(monkeypatch, "generate_tokens")
    kw = dict(temperature=0.0, max_tokens=8)
    if mode == "clone":
        kw.update(ref_audio=_ref_audio(), ref_text="a reference")
        calls = []
        tokenize = pm._audio_tokenizer.tokenize
        monkeypatch.setattr(pm._audio_tokenizer, "tokenize",
                            lambda a: (calls.append(1), tokenize(a))[1])
        text = "hello world\nand again"
    else:
        kw.update(gender="female", pitch=1.5, speed=0.5)
        text = "hello world"
    ours = list(pm.generate(text, **kw))
    ref = list(jm.generate(text, **kw))
    assert seen["port"] == seen["jax"] and len(seen["port"]) == len(ours)
    assert len(set(seen["port"][0])) > 1, seen["port"]
    assert len(ours) == len(ref) == (2 if mode == "clone" else 1)
    for r, j in zip(ours, ref):
        assert r.sample_rate == 16000 and r.audio.size == 6 * 4 * 4
        np.testing.assert_allclose(r.audio, np.asarray(j.audio), **TOL)
        assert float(np.abs(r.audio).max()) > 1e-2
    if mode == "clone":
        assert calls == [1]


def test_generate_batch_matches_jax(models, monkeypatch):
    jm, pm = models
    seen = _record(monkeypatch, "generate_tokens_batch")
    texts = ["hello world", "a second longer sentence"]
    kw = dict(gender="female", temperature=0.0, max_tokens=8)
    ours, ref = pm.generate_batch(texts, **kw), jm.generate_batch(texts, **kw)
    assert seen["port"] == seen["jax"]
    assert len(ours) == len(ref) == 2
    for r, j in zip(ours, ref):
        assert r.audio.ndim == 1 and r.audio.size == 6 * 4 * 4
        np.testing.assert_allclose(r.audio, np.asarray(j.audio), **TOL)


def test_sampled_batch_of_one_equals_single_and_seed_repeats(models, monkeypatch):
    _, pm = models
    seen = _record(monkeypatch, "generate_tokens")
    batch_seen = _record(monkeypatch, "generate_tokens_batch")
    kw = dict(gender="male", max_tokens=12, seed=5)
    single = list(pm.generate("hello world", **kw))
    again = list(pm.generate("hello world", **kw))
    one = pm.generate_batch(["hello world"], **kw)
    assert seen["port"][0] == seen["port"][1]
    assert batch_seen["port"][0][0] == seen["port"][0]
    np.testing.assert_array_equal(one[0].audio, single[0].audio)
    np.testing.assert_array_equal(again[0].audio, single[0].audio)


def test_tokenizer_loads_local_files_only(codecs):
    model = Model(ModelConfig(**LM, tokenizer_name="no/such-spark-tokenizer"),
                  bicodec=codecs[1], device="cpu")
    with pytest.raises(RuntimeError, match="tokenizer="):
        model.tokenizer


def test_sanitize_routes_prefixes_match_jax(models):
    jm, pm = models
    weights = {
        "model.layers.0.self_attn.q_proj.weight": np.zeros((32, 32)),
        "quantizer.codebook.weight": np.zeros((32, 4)),
        "encoder.project.weight": np.zeros((16, 16)),
        "encoder.encoder.embed.weight": np.zeros((16, 8, 7)),
        "prenet.downsample.0.0.de_conv_upsampler.1.weight_g": np.zeros((16, 1, 1)),
        "lm.model.norm.weight": np.zeros((32,)),
    }
    got, want = pm.sanitize(weights), jm.sanitize(weights)
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    assert got["bicodec.encoder.encoder.embed.weight"].shape == (7, 8, 16)
    assert got["bicodec.prenet.downsample.0.0.de_conv_upsampler.weight_g"].shape == (1, 16, 1)
    assert "lm.model.layers.0.self_attn.q_proj.weight" in got


def test_prompt_builders_and_parser_match_jax():
    for args, kw in ((("hi there", "female"), dict(pitch="high", speed="low")),
                     (("hola", "male"), {})):
        assert (port_tp.build_control_prompt(*args, **kw)
                == jax_tp.build_control_prompt(*args, **kw))
    for args in (("hello", "ref text", [1, 2], [3, 4, 5]), ("hello", None, [1], [3])):
        assert port_tp.build_clone_prompt(*args) == jax_tp.build_clone_prompt(*args)
    text = ("<|bicodec_semantic_5|><|bicodec_semantic_12|>"
            "<|bicodec_global_7|>junk<|bicodec_semantic_1|>")
    assert port_tp.parse_generated_tokens(text) == jax_tp.parse_generated_tokens(text)
    assert port_tp.parse_generated_tokens(text) == ([5, 12, 1], [7])


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BiCodec(TINY_BICODEC)
