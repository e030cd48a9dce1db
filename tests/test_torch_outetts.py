"""OuteTTS in the port against the JAX package, float32 on the CPU: the port
twin of tests/test_outetts.py, at its tiny model.

The prompt grammar, token extraction, text chunking and the numpy features
are copies and are held equal to the JAX package's (pitch and loudness to
atol 1e-6).  Weights cross with ``convert.params_from_jax``.  Greedy tokens
(dense, and int8 in groups of 16 through ``quantized_matmul``) are held
equal to the JAX package's, the decoded audio to atol 1e-4.  The JAX PRNG
cannot be reproduced, so sampled runs are held to their own properties.
The JAX init RNG is reset for each model built here, and the LM's embedding
scaled by 0.05; greedy runs take a repetition penalty of 1.3: at the JAX
init (or the default penalty of 1.1) the tiny LM repeats one token, and
then emits no c2 codes.
"""

import json

import numpy as np
import pytest
import torch

import mlx_audio_tpu.models.tts.outetts.outetts as jax_outetts
import mlx_audio_tpu.nn.layers as jax_layers
from mlx_audio_tpu.models.tts.outetts import PromptProcessor as JaxPromptProcessor
from mlx_audio_tpu.models.tts.outetts.audio_processor import AudioProcessor as JaxAudioProcessor
from mlx_audio_tpu.models.tts.outetts.audio_processor import Features as JaxFeatures
from mlx_audio_tpu.models.tts.outetts.audio_processor import calculate_pitch as jax_pitch
from mlx_audio_tpu.models.tts.outetts.audio_processor import (
    process_audio_array as jax_process_audio,
)
from mlx_audio_tpu.nn.module import named_arrays
from mlx_audio_tpu.nn.quantize import quantize_model as jax_quantize_model
from mlx_audio_tpu_torch.codec.dac import DAC, DACConfig
from mlx_audio_tpu_torch.convert import params_from_jax
from mlx_audio_tpu_torch.models.tts import outetts
from mlx_audio_tpu_torch.models.tts.outetts import (
    AudioProcessor,
    Model,
    ModelConfig,
    PromptProcessor,
)
from mlx_audio_tpu_torch.models.tts.outetts.audio_processor import (
    DacInterface,
    Features,
    calculate_pitch,
    dac_24khz_speech_config,
    process_audio_array,
)
from mlx_audio_tpu_torch.nn import kernels
from mlx_audio_tpu_torch.nn.quantize import quantize_model
from test_outetts import FakeTokenizer, tiny_model

AUDIO_ATOL = 1e-4
EMBED_SCALE = 0.05
SPEAKER = {
    "text": "hello there",
    "words": [
        {"word": "hello", "duration": 0.5, "c1": [1, 2], "c2": [3, 4],
         "features": {"energy": 50, "spectral_centroid": 40, "pitch": 30}},
        {"word": "there", "duration": 0.25, "c1": [5], "c2": [6]},
    ],
    "global_features": {"energy": 50, "spectral_centroid": 40, "pitch": 30},
}


def _seeded(build):
    saved = jax_layers._INIT_RNG
    jax_layers._INIT_RNG = np.random.default_rng(0)
    try:
        return build()
    finally:
        jax_layers._INIT_RNG = saved


def _carry(jax_module, port_module):
    named = {k: np.asarray(v) for k, v in named_arrays(jax_module)}
    port_module.load_state_dict(params_from_jax(named, port_module), strict=True)
    return port_module


def _pair(bits=None):
    jm = _seeded(tiny_model)
    jm.lm.model.embed_tokens.weight = jm.lm.model.embed_tokens.weight * EMBED_SCALE
    jd = jm._dac_model
    td = _carry(jd, DAC(DACConfig(**vars(jd.config)), device="cpu"))
    tm = Model(ModelConfig(**vars(jm.config)), dac_model=td,
               tokenizer=FakeTokenizer(), device="cpu")
    _carry(jm.lm, tm.lm)
    if bits:
        jax_quantize_model(jm.lm, group_size=16, bits=bits)
        quantize_model(tm.lm, group_size=16, bits=bits)
    return jm, tm


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _record(monkeypatch, name):
    """Record what each model's ``name`` (generate_tokens or
    generate_tokens_batch) returns, as token lists."""
    seen = {"jax": [], "port": []}
    # the JAX generate_batch imports generate_tokens_batch when called
    targets = [(outetts.outetts, "port")]
    if name == "generate_tokens":
        targets.append((jax_outetts, "jax"))
    for module, key in targets:
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
                seen[k].append([o.tolist() for o in out])
                return out
        monkeypatch.setattr(module, name, wrapped)
    if name == "generate_tokens_batch":
        import mlx_audio_tpu.models.lm.causal as jax_causal

        fn = jax_causal.generate_tokens_batch

        def jax_batch(*a, f=fn, **kw):
            out = f(*a, **kw)
            seen["jax"].append([np.asarray(o).tolist() for o in out])
            return out

        monkeypatch.setattr(jax_causal, "generate_tokens_batch", jax_batch)
    return seen


def test_prompt_with_speaker_codes_matches_jax():
    pp, ref = PromptProcessor(FakeTokenizer()), JaxPromptProcessor(FakeTokenizer())
    for text, speaker in (("good morning", SPEAKER), ("good  morning…", None),
                          ("日本語", dict(SPEAKER, text="こんにちは。"))):
        prompt = pp.get_completion_prompt(text, speaker)
        assert prompt == ref.get_completion_prompt(text, speaker)
    prompt = pp.get_completion_prompt("good morning", SPEAKER)
    assert "<|word_start|>" in prompt and "<|c1_1|>" in prompt and "<|c2_4|>" in prompt
    assert pp.get_global_features(SPEAKER["global_features"]) == \
        ref.get_global_features(SPEAKER["global_features"])
    assert pp.c1 == ref.c1 and pp.c2 == ref.c2 and len(pp.c1) == 1025


def test_extract_audio_tokens_roundtrip():
    pp, ref = PromptProcessor(FakeTokenizer()), JaxPromptProcessor(FakeTokenizer())
    ids = FakeTokenizer().encode("<|c1_5|><|c2_7|><|c1_9|><|c2_11|>x<|c1_3|>")
    assert pp.extract_audio_from_tokens(ids) == [[5, 9], [7, 11]]
    assert pp.extract_audio_from_tokens(ids) == ref.extract_audio_from_tokens(ids)


def test_chunk_text_matches_jax(pair):
    jm, tm = pair
    text = (" ".join(["word"] * 100) + ". " + " ".join(["more"] * 10) + "! "
            + "short one? and. " * 8)
    chunks = tm.chunk_text(text, max_words=30)
    assert chunks == jm.chunk_text(text, max_words=30)
    assert len(chunks[0].split()) == 100


def test_pitch_loudness_and_features_match_jax():
    sr = 24000
    t = np.arange(sr) / sr
    tone = (np.sin(2 * np.pi * 220 * t) * 0.3).astype(np.float32)
    noisy = tone + np.random.default_rng(0).standard_normal(sr).astype(np.float32) * 0.05
    for audio in (tone, noisy):
        np.testing.assert_allclose(calculate_pitch(audio, sr), jax_pitch(audio, sr),
                                   atol=1e-6, rtol=0)
        np.testing.assert_allclose(process_audio_array(audio, sr),
                                   jax_process_audio(audio, sr), atol=1e-6, rtol=0)
        assert (Features().extract_audio_features(audio[None], sr)
                == JaxFeatures().extract_audio_features(audio[None], sr))
    voiced = calculate_pitch(tone, sr)
    assert abs(np.median(voiced[voiced > 0]) - 220) < 20


def test_speaker_from_dict_matches_jax(pair):
    """The same audio through the same DAC weights: codes and features
    equal, word for word."""
    jm, tm = pair
    audio = (np.sin(np.linspace(0, 300, 24000)) * 0.3).astype(np.float32)
    data = {"audio": {"bytes": audio.reshape(1, 1, -1)}, "text": "one two",
            "words": [{"word": "one", "start": 0.0, "end": 0.5},
                      {"word": "two", "start": 0.5, "end": 1.0}]}
    got = AudioProcessor(tm._dac_model, device="cpu").create_speaker_from_dict(data)
    ref = JaxAudioProcessor(jm._dac_model).create_speaker_from_dict(data)
    assert json.loads(json.dumps(got)) == json.loads(json.dumps(ref))
    assert len(got["words"]) == 2 and len(got["words"][0]["c1"]) > 0


GREEDY = dict(temperature=0.0, repetition_penalty=1.3)
TWO_CHUNKS = "hi there. " + " ".join(["word"] * 30)


def _greedy(jm, tm, monkeypatch, text=TWO_CHUNKS, **kw):
    seen = _record(monkeypatch, "generate_tokens")
    decoded = {"jax": [], "port": []}
    for proc, key in ((jm.audio_processor, "jax"), (tm.audio_processor, "port")):
        fn = proc.audio_codec.decode
        monkeypatch.setattr(proc.audio_codec, "decode", lambda c, f=fn, k=key:
                            (decoded[k].append(np.asarray(c).tolist()), f(c))[1])
    kw = dict(max_tokens=48, **GREEDY, **kw)
    ref = list(jm.generate(text, **kw))
    got = list(tm.generate(text, **kw))
    return seen, decoded, ref, got


def test_generate_greedy_matches_jax(pair, monkeypatch):
    """Greedy generate of two text chunks: every chunk's tokens and the
    codes handed to the DAC equal the JAX package's, the audio within atol
    1e-4."""
    jm, tm = pair
    seen, decoded, ref, got = _greedy(jm, tm, monkeypatch)
    assert seen["port"] == seen["jax"] and len(seen["port"]) == 2
    assert all(len(t) > 8 for t in seen["port"])
    assert decoded["port"] == decoded["jax"] and len(decoded["port"]) == len(got)
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        assert g.token_count == r.token_count
        np.testing.assert_allclose(g.audio, np.asarray(r.audio), atol=AUDIO_ATOL, rtol=0)


def test_quantized_generate_matches_jax_and_takes_the_kernel_route(monkeypatch):
    """int8 in groups of 16: greedy tokens equal to the JAX package's
    quantized model; the tied head (a QuantizedEmbedding's as_linear) goes
    to kernels.quantized_matmul at one row a decode step."""
    jm, tm = _pair(bits=8)
    calls = []
    qmm = kernels.quantized_matmul

    def counting(x, codes, *a):
        calls.append((x.shape[0], codes.shape[0]))
        return qmm(x, codes, *a)

    monkeypatch.setattr(kernels, "quantized_matmul", counting)
    seen, decoded, ref, got = _greedy(jm, tm, monkeypatch, text="hi there")
    assert seen["port"] == seen["jax"] and len(seen["port"]) == 1
    assert decoded["port"] == decoded["jax"]
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.audio, np.asarray(r.audio), atol=AUDIO_ATOL, rtol=0)
    vocab = tm.config.vocab_size
    heads = [c for c in calls if c[1] == vocab]
    assert len(heads) >= len(seen["port"][0]) and all(rows == 1 for rows, _ in heads)
    assert len(calls) > 7 * len(heads)


def test_generate_batch_greedy_matches_jax(pair, monkeypatch):
    """Greedy generate_batch of two texts (three chunks): each row's tokens
    equal to the JAX package's batch, each text's audio within atol 1e-4."""
    jm, tm = pair
    seen = _record(monkeypatch, "generate_tokens_batch")
    texts = [TWO_CHUNKS, "another line"]
    kw = dict(max_tokens=32, **GREEDY)
    ref = jm.generate_batch(texts, **kw)
    got = tm.generate_batch(texts, **kw)
    assert seen["port"] == seen["jax"] and len(seen["port"][0]) == 3
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        assert g.token_count == r.token_count
        np.testing.assert_allclose(g.audio, np.asarray(r.audio), atol=AUDIO_ATOL, rtol=0)


def test_generate_batch_plumbing(pair, monkeypatch):
    """generate_batch: chunks joined per text in order, one result per text,
    an empty one for a text whose rows hold no codes."""
    tm = pair[1]
    tok = FakeTokenizer()
    fake = [np.asarray(tok.encode("<|c1_1|><|c2_2|><|c1_3|><|c2_4|>")),
            np.asarray(tok.encode("<|c1_5|><|c2_6|>")),
            np.asarray(tok.encode("no codes"))]
    monkeypatch.setattr(outetts.outetts, "generate_tokens_batch", lambda *a, **k: fake)
    results = tm.generate_batch([TWO_CHUNKS, "third"])
    hop = tm.audio_processor.audio_codec.model.hop_length
    assert [r.samples for r in results][1] == 0
    assert results[0].samples > 0 and results[0].token_count == len(fake[0]) + len(fake[1])
    one = tm._decode([[1, 3], [2, 4]])
    np.testing.assert_array_equal(results[0].audio[:one.shape[0]], one)
    assert abs(results[0].samples - 3 * hop) < hop


def test_streamed_chunks_match_jax_and_cover_the_whole(pair, monkeypatch):
    """stream=True, a decode every int(0.2 * 137.5) = 27 tokens, looked at
    when the loop hands over a chunk of 64: the chunks equal the JAX
    package's streamed chunks (audio within atol 1e-4), and together are as
    long as the whole run, whose tail the last one is."""
    jm, tm = pair
    kw = dict(max_tokens=150, **GREEDY)
    ref = list(jm.generate("hi there", stream=True, streaming_interval=0.2, **kw))
    got = list(tm.generate("hi there", stream=True, streaming_interval=0.2, **kw))
    whole = list(tm.generate("hi there", **kw))
    assert len(got) == len(ref) > 1 and len(whole) == 1
    for g, r in zip(got, ref):
        assert g.token_count == r.token_count
        np.testing.assert_allclose(g.audio, np.asarray(r.audio), atol=AUDIO_ATOL, rtol=0)
    assert sum(g.samples for g in got) == whole[0].samples
    # tokens after the last decode that complete no code pair yield nothing
    assert sum(g.token_count for g in got) <= whole[0].token_count
    head = whole[0].samples - got[-1].samples
    np.testing.assert_allclose(got[-1].audio, whole[0].audio[head:], atol=AUDIO_ATOL, rtol=0)


def test_sampled_batch_of_one_equals_single_and_seed_repeats(pair, monkeypatch):
    tm = pair[1]
    seen = _record(monkeypatch, "generate_tokens")
    batch = _record(monkeypatch, "generate_tokens_batch")
    kw = dict(max_tokens=40, seed=5)  # temperature 0.4, top-p 0.9, penalty 1.1
    a = list(tm.generate("hi there", **kw))
    b = list(tm.generate("hi there", **kw))
    assert seen["port"][0] == seen["port"][1] and len(seen["port"][0]) > 0
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.audio, y.audio)
    one = tm.generate_batch(["hi there"], **kw)
    assert batch["port"][0][0] == seen["port"][0]
    np.testing.assert_array_equal(one[0].audio, a[0].audio)


class _GreedyWhisper:
    """A Whisper model whose generate decodes greedily over ASCII letters and
    spaces (a sampled fallback draws from each package's own PRNG, and the
    tiny vocabulary's other bytes decode to no words)."""

    SUPPRESS = [i for i in range(256) if not ((i < 128 and chr(i).isalpha()) or i == 32)]

    def __init__(self, model):
        self.model = model

    def generate(self, audio, **kw):
        return self.model.generate(audio, temperature=0.0, suppress_tokens=self.SUPPRESS, **kw)


def test_whisper_speaker_matches_jax(pair, monkeypatch):
    """create_speaker_from_whisper with a given tiny Whisper (the twins' of
    tests/test_torch_whisper.py): the words, their timings and codes, and
    the whole speaker dict equal the JAX package's."""
    import test_torch_whisper as tw
    from test_whisper import tiny_dims, tiny_encoding

    from mlx_audio_tpu.models.stt.whisper.tokenizer import Tokenizer as JaxTokenizer
    from mlx_audio_tpu_torch.models.stt.whisper.tokenizer import Tokenizer

    enc = tiny_encoding()
    kw = dict(num_languages=4, language="en", task="transcribe")
    jt, pt = JaxTokenizer(encoding=enc, **kw), Tokenizer(encoding=enc, **kw)
    monkeypatch.setattr(tw.jtr.Model, "_tokenizer", lambda self, language=None, task=None: jt)
    monkeypatch.setattr(tw.transcribe.Model, "_tokenizer",
                        lambda self, language=None, task=None: pt)
    jw, pw = tw.pair_of(tiny_dims(jt), tw.jtr.Model, tw.transcribe.Model)
    jm, tm = pair
    audio = (np.random.default_rng(7).standard_normal(24000) * 0.1).astype(np.float32)
    want = jm.audio_processor.create_speaker_from_whisper(audio, _GreedyWhisper(jw))
    got = tm.audio_processor.create_speaker_from_whisper(audio, _GreedyWhisper(pw))
    assert got == want
    assert [w["word"] for w in got["words"]] and all(w["c1"] for w in got["words"])


class _FixedWhisper:
    """A Whisper stand-in whose generate returns the same two timed words
    for any audio, and keeps the 16 kHz audio it was given."""

    def __init__(self):
        self.heard = []

    def generate(self, audio, **kw):
        import types

        self.heard.append(np.asarray(audio))
        words = [{"word": " hello", "start": 0.1, "end": 0.4},
                 {"word": " there", "start": 0.5, "end": 0.9}]
        return types.SimpleNamespace(text=" Hello there.", segments=[{"words": words}])


def test_speaker_from_audio_path_reads_it_and_without_whisper_raises(pair, tmp_path):
    """A reference wav path is read at 24 kHz and loudness-normalised as the
    JAX package reads it, and the speaker built from it equals the JAX
    package's; loading the default Whisper needs utils/loader, which the
    port does not have yet."""
    from mlx_audio_tpu_torch.utils.audio_io import save_audio

    jm, tm = pair
    with pytest.raises(NotImplementedError, match="Whisper model.*queue 1 item 11"):
        next(tm.generate("hi", ref_audio=np.zeros(24000, np.float32)))
    wav = str(tmp_path / "speech.wav")
    save_audio(wav, np.random.default_rng(8).standard_normal(24000) * 0.2, 22050)
    got = tm.audio_processor.audio_codec.load_audio(wav)
    assert got.shape == (1, 1, 26123)
    np.testing.assert_array_equal(got, jm.audio_processor.audio_codec.load_audio(wav))
    jw, tw = _FixedWhisper(), _FixedWhisper()
    want = jm.audio_processor.create_speaker_from_whisper(wav, jw)
    assert tm.audio_processor.create_speaker_from_whisper(wav, tw) == want
    np.testing.assert_array_equal(tw.heard[0], jw.heard[0])
    with pytest.raises(NotImplementedError, match="Whisper model.*queue 1 item 11"):
        tm.audio_processor.create_speaker_from_whisper(wav)


def test_speaker_file_round_trip(pair, tmp_path):
    tm = pair[1]
    path = str(tmp_path / "voices" / "speaker.json")
    tm.audio_processor.save_speaker(SPEAKER, path)
    assert tm.get_speaker(path) == SPEAKER
    with pytest.raises(FileNotFoundError):
        tm.get_speaker(str(tmp_path / "missing.json"))


@pytest.mark.parametrize("model_type", ["llama", "qwen2", "qwen3"])
def test_to_llama_matches_jax(model_type):
    cfg = dict(model_type=model_type, hidden_size=64, num_hidden_layers=2,
               intermediate_size=128, num_attention_heads=4, num_key_value_heads=2)
    got = ModelConfig(**cfg).to_llama()
    ref = jax_outetts.ModelConfig(**cfg).to_llama()
    for field in ("qkv_bias", "use_qk_norm", "head_dim", "num_key_value_heads",
                  "vocab_size", "rope_theta", "max_position_embeddings",
                  "tie_word_embeddings"):
        assert getattr(got, field) == getattr(ref, field), field
    assert got.qkv_bias == (model_type == "qwen2")
    assert got.use_qk_norm == (model_type == "qwen3")


def test_default_dac_is_the_24khz_speech_codec():
    cfg = dac_24khz_speech_config()
    assert (cfg.encoder_rates, cfg.decoder_rates, cfg.n_codebooks,
            cfg.codebook_size, cfg.sample_rate) == ([2, 4, 5, 8], [8, 5, 4, 2],
                                                    2, 1024, 24000)


@pytest.mark.parametrize("build", [
    lambda: Model(ModelConfig(hidden_size=32, num_hidden_layers=1, intermediate_size=64,
                              num_attention_heads=2, num_key_value_heads=1, vocab_size=64),
                  dac_model=object(), tokenizer=FakeTokenizer()),
    lambda: DacInterface(),
], ids=["outetts", "dac-24khz"])
def test_default_device_is_cuda(build, monkeypatch):
    """Built with no device argument, the model and its codec ask for the
    card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build()


def test_tokenizer_loads_a_local_path_only(pair, tmp_path):
    cfg = ModelConfig(hidden_size=32, num_hidden_layers=1, intermediate_size=64,
                      num_attention_heads=2, num_key_value_heads=1, vocab_size=64,
                      tokenizer_name=str(tmp_path / "missing"))
    m = Model(cfg, dac_model=pair[1]._dac_model, device="cpu")
    with pytest.raises(FileNotFoundError):
        m._get_tokenizer()


def test_sanitize_matches_jax(pair):
    jm, tm = pair
    w = {"model.model.norm.weight": np.ones(2), "model.lm_head.weight": np.ones(2),
         "model.layers.0.mlp.up_proj.weight": np.ones(2), "lm_head.weight": np.ones(2),
         "layers.1.x": np.ones(2), "lm.model.y": np.ones(2)}
    assert sorted(tm.sanitize(w)) == sorted(jm.sanitize(w))
    assert "lm.model.norm.weight" in tm.sanitize(w)
