"""The port's model registry, native checkpoints and CLIs (the twins of
tests/test_loader_cli.py), and native checkpoints across the two packages:
the JAX package's ``save_checkpoint`` read by the port's ``load_model`` and
the port's read by the JAX ``load_model``, bit for bit, for Kokoro at
tests/test_kokoro.py's tiny config; an int8, a mixed-recipe and a bf16
checkpoint of the tiny Orpheus through the port's converter; and every
family of ``models/tts`` and ``models/stt`` through the port's registry
at the tiny config its twin uses.  Everything runs on the CPU
(``device="cpu"``, ``--device cpu``).
"""

import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_audio_tpu.models.tts.kokoro.model import Model as JaxKokoro
from mlx_audio_tpu.models.tts.kokoro.model import _duration_stage, _synthesis_stage
from mlx_audio_tpu.nn.module import named_arrays
from mlx_audio_tpu.utils import loader as jax_loader
from mlx_audio_tpu_torch.convert import params_from_jax, params_to_jax
from mlx_audio_tpu_torch.models.tts.kokoro import (
    Model,
    ModelConfig,
    duration_stage,
    synthesis_stage,
)
from mlx_audio_tpu_torch.utils.loader import (
    MODEL_REMAPPING,
    get_available_models,
    get_model_and_args,
    load_model,
    save_checkpoint,
)
from test_kokoro import tiny_config
from test_torch_kokoro import AUDIO_ATOL, HEAD, _inputs, _source_draws

KOKORO_FIELDS = ("istftnet", "dim_in", "dropout", "hidden_dim", "max_conv_dim",
                 "max_dur", "multispeaker", "n_layer", "n_mels", "n_token",
                 "style_dim", "text_encoder_kernel_size", "plbert", "vocab")


def _named(jax_model) -> dict:
    return {k: np.asarray(v) for k, v in named_arrays(jax_model)}


def assert_state_equal(got: dict, want: dict):
    """Two state_dicts (or JAX named arrays): the same keys, every tensor
    equal bit for bit in value and dtype."""
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, torch.Tensor):
            assert g.dtype == w.dtype and torch.equal(g, w), k
        else:
            assert g.dtype == w.dtype and np.array_equal(
                np.asarray(g).view(np.uint8), np.asarray(w).view(np.uint8)), k


# ---------------------------------------------------------------------------
# the registry (tests/test_loader_cli.py:19, :27, :34)
# ---------------------------------------------------------------------------


def test_available_models():
    tts = get_available_models("tts")
    assert "kokoro" in tts
    assert "sesame" in tts
    stt = get_available_models("stt")
    assert "whisper" in stt
    # the port has every family the JAX registry reaches
    for domain in ("tts", "stt"):
        assert sorted(get_available_models(domain)) == sorted(
            jax_loader.get_available_models(domain))
    assert MODEL_REMAPPING == jax_loader.MODEL_REMAPPING


def test_model_remapping():
    arch, mt = get_model_and_args("csm", None)
    assert mt == "sesame"
    assert arch.__name__ == "mlx_audio_tpu_torch.models.tts.sesame"
    arch, mt = get_model_and_args("kokoro", ["kokoro", "82m"])
    assert mt == "kokoro"


def test_unknown_model_raises():
    with pytest.raises(ValueError):
        get_model_and_args("nonexistent_model_xyz", None)


def test_a_path_that_is_not_local_raises_and_nothing_is_fetched(monkeypatch):
    """Where the JAX package downloads a hub snapshot, the port raises
    FileNotFoundError naming the path."""
    import huggingface_hub

    def no_fetch(*a, **k):
        raise AssertionError("the port must not download")

    monkeypatch.setattr(huggingface_hub, "snapshot_download", no_fetch)
    with pytest.raises(FileNotFoundError, match="prince-canuma/Kokoro-82M"):
        load_model("prince-canuma/Kokoro-82M", device="cpu")


# ---------------------------------------------------------------------------
# Kokoro native checkpoints (:68, :80), within the port and across packages
# ---------------------------------------------------------------------------


def kokoro_config_dict(cfg) -> dict:
    return {"model_type": "kokoro", **{f: getattr(cfg, f) for f in KOKORO_FIELDS}}


@pytest.fixture(scope="module")
def jax_kokoro():
    return JaxKokoro(tiny_config())


@pytest.fixture(scope="module")
def kokoro_ckpt(tmp_path_factory, jax_kokoro):
    """The port's tiny Kokoro, carrying the JAX model's weights, written
    with the port's save_checkpoint into a directory named Kokoro-82M."""
    cfg = tiny_config()
    port = Model(ModelConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__}),
                 device="cpu")
    port.load_state_dict(params_from_jax(_named(jax_kokoro), port), strict=True)
    out = tmp_path_factory.mktemp("kokoro_ckpt") / "Kokoro-82M"
    save_checkpoint(port, out, kokoro_config_dict(cfg))
    return out, port


def test_native_roundtrip(kokoro_ckpt):
    path, orig = kokoro_ckpt
    assert json.loads((path / "config.json").read_text())["native_format"] is True
    loaded = load_model(str(path), domain="tts", device="cpu")
    assert isinstance(loaded, Model) and loaded._asset_dir == str(path)
    assert_state_equal(loaded.state_dict(), orig.state_dict())


def test_native_roundtrip_keeps_bf16(kokoro_ckpt, tmp_path):
    """save_checkpoint records a bf16 model's dtype, so load_model gives it
    back in bf16, bit for bit, with no dtype asked for; a model whose
    floating tensors mix dtypes records none and loads in float32."""
    path, orig = kokoro_ckpt
    cast = load_model(str(path), device="cpu").to(torch.bfloat16)
    out = tmp_path / "Kokoro-82M"
    save_checkpoint(cast, out, kokoro_config_dict(tiny_config()))
    assert json.loads((out / "config.json").read_text())["dtype"] == "bfloat16"
    loaded = load_model(str(out), device="cpu")
    assert_state_equal(loaded.state_dict(), cast.state_dict())
    assert json.loads((path / "config.json").read_text())["dtype"] == "float32"

    mixed = load_model(str(path), device="cpu")
    mixed.bert_encoder.to(torch.bfloat16)
    save_checkpoint(mixed, tmp_path / "mixed", kokoro_config_dict(tiny_config()))
    assert "dtype" not in json.loads((tmp_path / "mixed" / "config.json").read_text())
    back = load_model(str(tmp_path / "mixed"), device="cpu")
    assert {p.dtype for p in back.parameters()} == {torch.float32}


def test_tts_cli_end_to_end(kokoro_ckpt, tmp_path, monkeypatch):
    """The CLI writes the joined wav of the loaded model's own generate, as
    16-bit PCM."""
    path, _ = kokoro_ckpt
    pack = (np.random.default_rng(0).standard_normal((510, 1, 256)) * 0.1).astype(np.float32)
    voice_path = tmp_path / "voice.npy"
    np.save(voice_path, pack)

    monkeypatch.chdir(tmp_path)
    from mlx_audio_tpu_torch.tts.generate import main

    main([
        "--model", str(path),
        "--text", "hello world",
        "--voice", str(voice_path),
        "--file_prefix", "out",
        "--join_audio",
        "--device", "cpu",
    ])
    wav = tmp_path / "out.wav"
    assert wav.exists()
    from mlx_audio_tpu_torch.utils.audio_io import load_audio

    audio = load_audio(wav)
    assert audio.shape[0] > 1000
    assert np.isfinite(audio).all()
    model = load_model(str(path), device="cpu")
    want = np.concatenate([r.audio for r in model.generate(
        "hello world", voice=str(voice_path))])
    pcm = (np.clip(want, -1.0, 1.0) * 32767).astype(np.int16)
    np.testing.assert_array_equal(audio, pcm / 32768.0)


def test_jax_checkpoint_loads_in_the_port(jax_kokoro, tmp_path):
    """The JAX package's save_checkpoint -> the port's load_model: the
    state_dict equals params_from_jax(named_arrays), and the slice's audio
    (JAX's source draws fed in) agrees with the JAX model's past HEAD."""
    path = tmp_path / "Kokoro-82M"
    jax_loader.save_checkpoint(jax_kokoro, path, kokoro_config_dict(tiny_config()))
    port = load_model(path, device="cpu", strict=True)
    assert_state_equal(port.state_dict(), params_from_jax(_named(jax_kokoro), port))

    ids, lengths, ref, speed = _inputs()
    d_j, dur_j = _duration_stage(jax_kokoro, jnp.asarray(ids, jnp.int32),
                                 jnp.asarray(lengths, jnp.int32),
                                 jnp.asarray(ref[:, 128:]), jnp.asarray(speed))
    d_t, dur_t = duration_stage(port, torch.as_tensor(ids), torch.as_tensor(lengths),
                                torch.as_tensor(ref[:, 128:]), torch.as_tensor(speed))
    np.testing.assert_array_equal(dur_t.numpy(), np.asarray(dur_j))
    dur = np.minimum(np.asarray(dur_j), 3)
    frames, key = 100, jax.random.PRNGKey(0)
    audio_j, _ = _synthesis_stage(
        jax_kokoro, jnp.asarray(ids, jnp.int32), jnp.asarray(lengths, jnp.int32),
        d_j, jnp.asarray(dur), jnp.asarray(ref), key, jnp.zeros((frames,), jnp.int32))
    rand_ini, noise = _source_draws(key, 2, frames)
    audio_t, _ = synthesis_stage(port, torch.as_tensor(ids), torch.as_tensor(lengths), d_t,
                                 torch.as_tensor(dur), torch.as_tensor(ref), frames,
                                 rand_ini, noise)
    np.testing.assert_allclose(audio_t.numpy()[:, HEAD:], np.asarray(audio_j)[:, HEAD:],
                               atol=AUDIO_ATOL, rtol=0)


def test_port_checkpoint_loads_in_jax(kokoro_ckpt, jax_kokoro):
    """The port's save_checkpoint -> the JAX load_model: every named array
    equal, bit for bit, to the JAX model whose weights the port carries."""
    path, _ = kokoro_ckpt
    loaded = jax_loader.load_model(str(path), domain="tts", strict=True)
    assert_state_equal(_named(loaded), _named(jax_kokoro))


# ---------------------------------------------------------------------------
# the converter on the tiny Orpheus
# ---------------------------------------------------------------------------


@pytest.fixture
def tiny_snac_default(monkeypatch):
    """Both packages' Orpheus builds its default SNAC from
    snac_24khz_config(); in these tests that is test_orpheus.py's tiny SNAC."""
    import mlx_audio_tpu.models.tts.llama.llama as jax_llama
    import mlx_audio_tpu_torch.models.tts.llama.llama as port_llama
    from mlx_audio_tpu_torch.codec.snac import SNACConfig
    from test_orpheus import tiny_snac

    jcfg = tiny_snac().config
    monkeypatch.setattr(jax_llama, "snac_24khz_config", lambda: jcfg)
    monkeypatch.setattr(port_llama, "snac_24khz_config", lambda: SNACConfig(**vars(jcfg)))


@pytest.fixture
def orpheus_ckpt(tmp_path, tiny_snac_default):
    """The JAX package's tiny Orpheus written as a native checkpoint."""
    from test_orpheus import tiny_model

    jm = tiny_model()
    path = tmp_path / "orpheus-3b"
    jax_loader.save_checkpoint(jm, path, dataclasses.asdict(jm.config))
    return path


@pytest.mark.parametrize("mode", ["int8", "mixed_4_6", "bfloat16"])
def test_convert_round_trips_through_load_model(orpheus_ckpt, tmp_path, mode):
    """The port's convert writes what its load_model reads back bit for bit
    (uint8 codes, scales and biases; a mixed recipe's 4- and 6-bit modules;
    bf16 weights), and what the JAX load_model reads as the same arrays
    (the JAX package casts a bf16 checkpoint to its float32 leaves).  An
    int8 checkpoint dequantizes back to dense weights."""
    from mlx_audio_tpu_torch.nn.quantize import QuantizedLinear
    from mlx_audio_tpu_torch.tts.convert import convert

    out = tmp_path / f"orpheus-{mode}"
    if mode == "bfloat16":
        convert(str(orpheus_ckpt), str(out), dtype="bfloat16", device="cpu")
    else:
        convert(str(orpheus_ckpt), str(out), quantize=True, q_group_size=16, q_bits=8,
                quant_predicate=None if mode == "int8" else mode, device="cpu")
    config = json.loads((out / "config.json").read_text())
    loaded = load_model(out, device="cpu", strict=True)
    from safetensors.numpy import load_file

    written = load_file(str(out / "weights.safetensors"))
    assert_state_equal(params_to_jax(loaded.state_dict(), loaded), written)
    q = [m for m in loaded.modules() if isinstance(m, QuantizedLinear)]
    if mode == "bfloat16":
        assert config["dtype"] == "bfloat16" and not q
        assert all(p.dtype == torch.bfloat16 for p in loaded.parameters())
    elif mode == "int8":
        assert config["quantization"] == {"group_size": 16, "bits": 8}
        assert q and {m.bits for m in q} == {8}
        assert written["lm.model.layers.0.self_attn.q_proj.weight"].dtype == np.uint8
        dense = tmp_path / "orpheus-dense"
        convert(str(out), str(dense), dequantize=True, device="cpu")
        back = load_model(dense, device="cpu", strict=True)
        assert not any(isinstance(m, QuantizedLinear) for m in back.modules())
        np.testing.assert_array_equal(
            back.lm.model.layers[0].self_attn.q_proj.weight.detach().numpy(),
            loaded.lm.model.layers[0].self_attn.q_proj.to_linear().weight.detach().numpy())
    else:
        assert config["quantization"]["recipe"] == mode
        assert {m.bits for m in q} == {4, 6}
        return  # the JAX loader re-applies one bit width: it cannot read a mix
    jm = jax_loader.load_model(str(out), domain="tts", strict=True)
    jax_named = _named(jm)
    for k, w in written.items():
        np.testing.assert_array_equal(jax_named[k], w.astype(jax_named[k].dtype), err_msg=k)


def test_convert_upload_raises_naming_the_folder(orpheus_ckpt, tmp_path):
    from mlx_audio_tpu_torch.tts.convert import convert

    with pytest.raises(RuntimeError, match="push the written folder manually"):
        convert(str(orpheus_ckpt), str(tmp_path / "up"), dtype="float32",
                upload_repo="someone/orpheus", device="cpu")
    assert (tmp_path / "up" / "weights.safetensors").exists()


# ---------------------------------------------------------------------------
# every family through the registry
# ---------------------------------------------------------------------------


def _seeded(build):
    import mlx_audio_tpu.nn.layers as jax_layers

    saved = jax_layers._INIT_RNG
    jax_layers._INIT_RNG = np.random.default_rng(0)
    try:
        return build()
    finally:
        jax_layers._INIT_RNG = saved


def _kokoro(mp):
    cfg = tiny_config()
    return JaxKokoro(cfg), kokoro_config_dict(cfg)


def _sesame(mp):
    import mlx_audio_tpu_torch.models.tts.sesame.model as port_sesame
    from mlx_audio_tpu.models.tts.sesame import Model as JaxCsm
    from test_mimi import tiny_mimi
    from test_sesame import tiny_config as csm_config
    from test_torch_mimi import port_config

    mimi = tiny_mimi(nq=4)
    mp.setattr(port_sesame, "mimi_202407", lambda n: port_config(mimi.cfg))
    return JaxCsm(csm_config(), mimi=mimi), csm_config()


def _orpheus(mp):
    import mlx_audio_tpu_torch.models.tts.llama.llama as port_llama
    from mlx_audio_tpu_torch.codec.snac import SNACConfig
    from test_orpheus import tiny_model, tiny_snac

    jcfg = tiny_snac().config
    mp.setattr(port_llama, "snac_24khz_config", lambda: SNACConfig(**vars(jcfg)))
    jm = tiny_model()
    return jm, dataclasses.asdict(jm.config)


def _outetts(mp):
    from mlx_audio_tpu.models.tts.outetts import Model as JaxOuteTTS
    from test_outetts import tiny_model

    cfg = tiny_model().config
    return JaxOuteTTS(cfg), dataclasses.asdict(cfg)


def _dia(mp):
    from mlx_audio_tpu.models.tts.dia import Model as JaxDia
    from test_dia import tiny_dia

    cfg = tiny_dia().config
    return JaxDia(cfg), dataclasses.asdict(cfg)


def _bark(mp):
    from mlx_audio_tpu.models.tts.bark import Model as JaxBark
    from mlx_audio_tpu.models.tts.bark import ModelConfig as JaxBarkConfig
    from test_torch_bark import _configs

    return JaxBark(JaxBarkConfig(**_configs())), {"model_type": "bark", **_configs()}


def _spark(mp):
    import mlx_audio_tpu.models.tts.spark.spark as jax_spark
    import mlx_audio_tpu_torch.models.tts.spark.spark as port_spark
    from mlx_audio_tpu.models.tts.spark import bicodec as jb_mod
    from mlx_audio_tpu_torch.models.tts.spark import BiCodec
    from test_spark import TINY_BICODEC
    from test_torch_spark import LM

    mp.setattr(port_spark, "BiCodec", lambda device, seed: BiCodec(
        TINY_BICODEC, device=device, seed=seed))
    cfg = jax_spark.ModelConfig(**LM)
    return jax_spark.Model(cfg, bicodec=jb_mod.BiCodec(TINY_BICODEC)), dict(vars(cfg))


def _indextts(mp):
    from mlx_audio_tpu.models.tts.indextts import Model as JaxIndexTTS
    from test_indextts import tiny_model_config

    cfg = tiny_model_config()
    return JaxIndexTTS(cfg), dataclasses.asdict(cfg)


def _whisper(mp):
    from mlx_audio_tpu.models.stt.whisper import Model as JaxWhisper
    from test_whisper import tiny_dims, tiny_encoding

    dims = tiny_dims(types.SimpleNamespace(encoding=tiny_encoding()))
    return JaxWhisper(dims), dict(vars(dims))


def _voxtral(mp):
    from mlx_audio_tpu.models.stt.voxtral import Model as JaxVoxtral
    from mlx_audio_tpu.models.stt.voxtral import ModelConfig as JaxVoxtralConfig
    from test_torch_voxtral import AUDIO, TEXT

    cfg = dict(model_type="voxtral", audio_config=AUDIO, text_config=TEXT,
               audio_token_id=24)
    return JaxVoxtral(JaxVoxtralConfig(**cfg)), cfg


def _parakeet(mp):
    from mlx_audio_tpu.models.stt.parakeet import BaseParakeet
    from test_parakeet import tdt_config

    return BaseParakeet.from_config(tdt_config()), tdt_config()


def _wav2vec(mp):
    from test_wav2vec_voxtral import small_w2v

    jm = small_w2v()
    return jm, dict(vars(jm.config))


# family -> (domain, checkpoint directory name, the function that makes the
# JAX model at its twin's tiny config and its config.json)
FAMILIES = {
    "kokoro": ("tts", "Kokoro-82M", _kokoro),
    "sesame": ("tts", "csm-1b", _sesame),
    "llama": ("tts", "orpheus-3b-0.1-ft", _orpheus),
    "outetts": ("tts", "Llama-OuteTTS-1.0-1B", _outetts),
    "dia": ("tts", "Dia-1.6B", _dia),
    "bark": ("tts", "bark-small", _bark),
    "spark": ("tts", "Spark-TTS-0.5B", _spark),
    "indextts": ("tts", "IndexTTS-1.5", _indextts),
    "whisper": ("stt", "whisper-large-v3-turbo", _whisper),
    "voxtral": ("stt", "Voxtral-Mini-3B-2507", _voxtral),
    "parakeet": ("stt", "parakeet-tdt-0.6b-v2", _parakeet),
    "wav2vec": ("stt", "wav2vec2-large-xlsr-53", _wav2vec),
}


def test_families_cover_the_registry():
    assert sorted(FAMILIES) == sorted(get_available_models("tts")
                                      + get_available_models("stt"))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_registry_loads_each_family(family, tmp_path, monkeypatch):
    """The JAX package's native checkpoint of the family's tiny model ->
    the port's load_model: the registry finds the family from the config
    and the directory name, builds it from config.json alone, and every
    array of the checkpoint lands bit for bit (strict: none is left over).
    Sub-models the config does not describe (Orpheus's SNAC, Spark's
    BiCodec, CSM's Mimi) are built at their defaults, which these tests set
    to their twins' tiny configs."""
    domain, name, build = FAMILIES[family]
    jm, config = _seeded(lambda: build(monkeypatch))
    path = tmp_path / name
    jax_loader.save_checkpoint(jm, path, config)
    port = load_model(path, domain=domain, device="cpu", strict=True)
    assert type(port).__module__.startswith(f"mlx_audio_tpu_torch.models.{domain}.{family}")
    state = port.state_dict()
    want = params_from_jax(_named(jm), port)
    assert set(want) <= set(state)
    assert_state_equal({k: state[k] for k in want}, want)


# ---------------------------------------------------------------------------
# host tools (:121, :154, :164)
# ---------------------------------------------------------------------------


def test_codec_package_exports():
    """The port's codec package exports DAC, Encodec, Mimi, SNAC, Vocos and
    BigVGAN lazily, as the JAX package's does (S3 is not ported)."""
    import mlx_audio_tpu_torch.codec as codec

    for name in ("DAC", "Encodec", "Mimi", "SNAC", "Vocos", "BigVGAN"):
        assert callable(getattr(codec, name)), name
        assert getattr(codec, name).__module__.startswith("mlx_audio_tpu_torch.codec.")
    assert "Mimi" in dir(codec)


def test_audio_player_headless():
    from mlx_audio_tpu_torch.tts.audio_player import AudioPlayer

    p = AudioPlayer(sample_rate=24000)
    p.queue_audio(np.zeros(2400, dtype=np.float32))
    assert p.wait_for_drain(timeout=5)
    p.flush()
    p.stop()


def test_stt_cli_writers_accept_parakeet_result(tmp_path, monkeypatch):
    """The STT CLI handles Parakeet's AlignedResult (text and sentences, no
    .segments or .language)."""
    from mlx_audio_tpu_torch.models.stt.parakeet.alignment import (
        AlignedResult,
        AlignedSentence,
        AlignedToken,
    )
    from mlx_audio_tpu_torch.stt import generate as G

    tok = AlignedToken(0, text="hi", start=0.0, duration=0.5)
    res = AlignedResult(text="hi", sentences=[AlignedSentence(text="hi", tokens=[tok])])

    class FakeModel:
        def generate(self, path, **kw):
            return res

    monkeypatch.setattr("mlx_audio_tpu_torch.utils.loader.load_model",
                        lambda *a, **k: FakeModel())
    from mlx_audio_tpu_torch.utils.audio_io import save_audio

    wav = tmp_path / "a.wav"
    save_audio(str(wav), np.zeros(1600, dtype=np.float32), 16000)
    out = G.generate("any", str(wav), str(tmp_path), "srt", device="cpu")
    assert out.text == "hi"
    srt = next(tmp_path.glob("*.srt"))
    assert "hi" in srt.read_text()


def test_profiling_is_a_no_op_without_a_card(tmp_path):
    from mlx_audio_tpu_torch.utils.profiling import annotate, trace

    with trace(str(tmp_path / "trace")), annotate("phase"):
        x = torch.ones(3).sum()
    assert float(x) == 3.0
    with trace(None):
        pass
