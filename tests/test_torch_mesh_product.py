"""The port's mesh-wired product paths: the twin of tests/test_mesh_product.py.

Every test runs the port sharded against the port unsharded, on a CPU mesh
(``activate_mesh(..., devices=[cpu] * 8)``, the port's counterpart of the
8 virtual CPU devices the JAX tests run on; a device may repeat).  The
unsharded port is held to the JAX package by the other twin files.

Tolerances, as the JAX tests state them unless said here:
- token, code and frame counts are equal, sampled and greedy (a row draws
  as in the whole batch under ``row_offset``);
- audio within atol 1e-4 (1e-5 for Spark and OuteTTS);
- Kokoro: durations equal, and audio past the first ``HEAD`` samples within
  ``FLIP_TAIL_ATOL``, the port's bound between batch shapes
  (tests/test_torch_kokoro.py: the source's first STFT frame is real, and
  its phase may flip between +pi and -pi when a batch of another shape
  rounds otherwise; a dp replica runs a batch of another shape); repeat
  runs on one mesh are equal bit for bit.
"""

from pathlib import Path
import sys

import numpy as np
import pytest
import torch

import mlx_audio_tpu.nn.layers as jax_layers
from mlx_audio_tpu.nn.module import named_arrays
from mlx_audio_tpu_torch.convert import params_from_jax
from mlx_audio_tpu_torch.models.base import init_weights
from mlx_audio_tpu_torch.parallel.context import (
    activate_mesh,
    active_mesh,
    deactivate_mesh,
    parse_mesh_spec,
)

sys.path.insert(0, str(Path(__file__).parent))

CPU8 = [torch.device("cpu")] * 8
HEAD = 2400
FLIP_TAIL_ATOL = 2e-3


def mesh(spec=None, **kw):
    return activate_mesh(spec, devices=CPU8, **kw)


@pytest.fixture(autouse=True)
def _clean_mesh():
    deactivate_mesh()
    yield
    deactivate_mesh()


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


def _same_rows(base, other, atol):
    assert len(base) == len(other)
    for a, b in zip(base, other):
        assert a.samples == b.samples
        np.testing.assert_allclose(np.asarray(a.audio), np.asarray(b.audio), atol=atol)


def test_parse_mesh_spec():
    assert parse_mesh_spec("dp=4") == (4, 1)
    assert parse_mesh_spec("dp=4,tp=2") == (4, 2)
    assert parse_mesh_spec("tp=2") == (0, 2)
    assert parse_mesh_spec("8") == (8, 1)
    assert parse_mesh_spec("") == (1, 1)
    with pytest.raises(ValueError):
        parse_mesh_spec("pp=2")


def test_activate_mesh_tiling():
    ctx = mesh("dp=4,tp=2")
    assert ctx.mesh.shape == {"data": 4, "model": 2}
    ctx = mesh("tp=2")  # dp fills the remaining devices
    assert ctx.dp == 4 and ctx.tp == 2
    with pytest.raises(ValueError):
        mesh("dp=16")
    deactivate_mesh()
    assert active_mesh() is None


# ---------------------------------------------------------------------------
# Kokoro DP
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def kokoro():
    from mlx_audio_tpu_torch.models.tts.kokoro import Model
    from test_torch_kokoro import _port_config

    return Model(_port_config(), device="cpu")


PS4 = ["hello world", "abc", "a longer third phoneme string", "def ghi"]
SPEED = 4.0  # random-weight durations stay short


def _kokoro_rows_match(base, other):
    for (a0, d0), (a1, d1) in zip(base, other):
        np.testing.assert_array_equal(d0, d1)
        assert a0.shape == a1.shape
        np.testing.assert_allclose(a0[HEAD:], a1[HEAD:], atol=FLIP_TAIL_ATOL, rtol=0)


def test_kokoro_dp4_matches_unsharded(kokoro):
    """dp=4 against unsharded: integer durations equal, audio past HEAD
    within FLIP_TAIL_ATOL; repeat runs on the mesh equal bit for bit."""
    refs = (np.random.default_rng(0).standard_normal((4, 256)) * 0.1).astype(np.float32)
    base = kokoro.synthesize_batch(PS4, refs, speeds=SPEED)
    mesh("dp=4")
    dp = kokoro.synthesize_batch(PS4, refs, speeds=SPEED)
    dp_again = kokoro.synthesize_batch(PS4, refs, speeds=SPEED)
    _kokoro_rows_match(base, dp)
    for (a1, _), (a2, _) in zip(dp, dp_again):
        np.testing.assert_array_equal(a1, a2)


def test_kokoro_dp_padding_is_exact(kokoro):
    """b=3 pads to 4 under dp=4; the real rows keep their own source draws:
    a row run alone at the dp replica's buckets is that replica's row."""
    refs = (np.random.default_rng(1).standard_normal((3, 256)) * 0.1).astype(np.float32)
    ps = PS4[:3]
    base = kokoro.synthesize_batch(ps, refs, speeds=SPEED)
    mesh("dp=4")
    dp = kokoro.synthesize_batch(ps, refs, speeds=SPEED)
    assert len(dp) == 3
    _kokoro_rows_match(base, dp)
    deactivate_mesh()
    # each replica holds one row: alone at the batch's buckets with its
    # batch row's draws, a row is bit for bit the replica's
    from mlx_audio_tpu_torch.models.tts.kokoro.model import (
        pick_frame_bucket,
        pick_phoneme_bucket,
    )

    buckets = (pick_phoneme_bucket(max(len(kokoro.phonemes_to_ids(p)) + 2 for p in ps)),
               pick_frame_bucket(max(a.shape[0] for a, _ in dp) // 600))
    for i, p in enumerate(ps):
        (alone, dur), = kokoro.synthesize_batch([p], refs[i:i + 1], speeds=SPEED,
                                                buckets=buckets, rows=[i])
        np.testing.assert_array_equal(alone, dp[i][0])
        np.testing.assert_array_equal(dur, dp[i][1])


def test_kokoro_dp_batch_actually_splits():
    """Each of the 4 data replicas gets exactly b/4 rows of a batch, on its
    own device."""
    ctx = mesh("dp=4")
    slices = ctx.shard_batch(torch.zeros(8, 16))
    assert [tuple(s.shape) for s in slices] == [(2, 16)] * 4
    assert all(s.device == ctx.home(r) for r, s in enumerate(slices))
    assert ctx.row_slices(8) == [(0, 2), (2, 4), (4, 6), (6, 8)]


def _voice(tmp_path, seed):
    pack = (np.random.default_rng(seed).standard_normal((510, 1, 256)) * 0.1).astype(np.float32)
    path = str(tmp_path / "voice.npy")
    np.save(path, pack)
    return path


def test_kokoro_generate_dp2_vs_dp4_identical(kokoro, tmp_path):
    """The CLI surface: multi-segment generate under a mesh goes through one
    batched dp pass; the dp degree keeps every duration and, past HEAD,
    the audio."""
    vpath = _voice(tmp_path, 2)
    text = "hello there\nsecond segment\nthird one\nfourth bit"
    mesh("dp=2")
    r2 = list(kokoro.generate(text, voice=vpath))
    mesh("dp=4")
    r4 = list(kokoro.generate(text, voice=vpath))
    assert len(r2) == len(r4) == 4
    for a, b in zip(r2, r4):
        aa, bb = np.asarray(a.audio), np.asarray(b.audio)
        assert aa.shape == bb.shape
        np.testing.assert_allclose(aa[HEAD:], bb[HEAD:], atol=FLIP_TAIL_ATOL, rtol=0)
    # and the batched pass is the model's own synthesize_batch under dp=4
    assert [r.samples for r in r4] == [r.samples for r in kokoro.generate_batch(
        text.split("\n"), voice=vpath)]


def test_cli_mesh_flag(kokoro, tmp_path, monkeypatch):
    """generate_audio(mesh=..., device="cpu") activates a CPU mesh of
    dp*tp devices and synthesizes."""
    from mlx_audio_tpu_torch.tts.generate import generate_audio

    vpath = _voice(tmp_path, 3)
    monkeypatch.chdir(tmp_path)
    results = generate_audio(
        "hello\nworld", model=kokoro, voice=vpath, mesh="dp=4", device="cpu",
        verbose=False, join_audio=True, file_prefix=str(tmp_path / "out"))
    ctx = active_mesh()
    assert ctx is not None and ctx.dp == 4 and ctx.mesh.shape == {"data": 4, "model": 1}
    assert len(results) == 2
    assert (tmp_path / "out.wav").exists()


# ---------------------------------------------------------------------------
# Parakeet chunked DP
# ---------------------------------------------------------------------------


def test_parakeet_chunk_dp_matches_no_mesh(monkeypatch):
    from mlx_audio_tpu_torch.models.stt.parakeet.parakeet import BaseParakeet
    from test_parakeet import ctc_config

    model = BaseParakeet.from_config(ctc_config(), device="cpu")
    audio = np.random.default_rng(5).standard_normal(6 * 16000).astype(np.float32) * 0.1
    calls = []
    decode = type(model).decode

    def counted(self, mel):
        calls.append(mel.shape[0])
        return decode(self, mel)

    monkeypatch.setattr(type(model), "decode", counted)
    base = model.generate(audio, chunk_duration=2.0, overlap_duration=1.0)
    n_base = list(calls)
    calls.clear()
    mesh("dp=4")
    dp = model.generate(audio, chunk_duration=2.0, overlap_duration=1.0)
    assert dp.text == base.text
    assert [[t.id for t in s.tokens] for s in dp.sentences] == [
        [t.id for t in s.tokens] for s in base.sentences]
    # five full chunks pad to 8: the replicas decode 2 rows each
    assert n_base[0] == 5 and calls[:4] == [2, 2, 2, 2]


# ---------------------------------------------------------------------------
# CSM under TP and DP
# ---------------------------------------------------------------------------


def csm_model(quantized: bool = True):
    """The tiny CSM of tests/test_sesame.py with a tiny Mimi, random
    weights, int8 (group 16) by default."""
    from mlx_audio_tpu_torch.codec.mimi import Mimi
    from mlx_audio_tpu_torch.models.tts.sesame import Model
    from mlx_audio_tpu_torch.nn.quantize import quantize_model
    from test_mimi import tiny_mimi
    from test_sesame import FakeTokenizer, tiny_config
    from test_torch_mimi import port_config

    mimi = Mimi(port_config(_seeded(lambda: tiny_mimi(nq=4)).cfg))
    init_weights(mimi, torch.Generator().manual_seed(1))
    m = Model(tiny_config(), mimi=mimi, text_tokenizer=FakeTokenizer(), device="cpu")
    if quantized:
        quantize_model(m.model, group_size=16, bits=8)
    return m


@pytest.fixture(scope="module")
def csm():
    return csm_model()


CSM_TEXTS = ["hello world", "a second utterance", "third", "one more line"]
CSM_REF = (np.random.default_rng(0).standard_normal(1920) * 0.1).astype(np.float32)


def _csm_batch(model, texts, **kw):
    return model.generate_batch(texts, ref_audio=CSM_REF, ref_text="hi",
                                max_audio_length_ms=800, seed=3, **kw)


def test_csm_generate_tp2_matches_replicated(csm):
    """One text under dp=4,tp=2: the tensor-parallel backbone and depth
    decoder (the int8 shards through quantized_matmul) give the
    unsharded run's audio."""
    base = list(csm.generate("hello", ref_audio=CSM_REF, ref_text="hi",
                             max_audio_length_ms=800, seed=3))
    mesh("dp=4,tp=2")
    tp = list(csm.generate("hello", ref_audio=CSM_REF, ref_text="hi",
                           max_audio_length_ms=800, seed=3))
    _same_rows(base, tp, 1e-4)


def test_csm_generate_routes_multisegment_through_dp_batch(csm):
    mesh("dp=4")
    routed = list(csm.generate("hello there\nsecond segment", ref_audio=CSM_REF,
                               ref_text="hi", max_audio_length_ms=800, seed=3))
    batch = _csm_batch(csm, ["hello there", "second segment"])
    assert len(routed) == len(batch) == 2
    for a, b in zip(routed, batch):
        np.testing.assert_array_equal(np.asarray(a.audio), np.asarray(b.audio))


def test_csm_generate_batch_dp4_matches_unsharded(csm):
    """CSM's batched loop under dp=4, sampled: frame counts equal, audio
    within 1e-4."""
    base = _csm_batch(csm, CSM_TEXTS)
    mesh("dp=4")
    _same_rows(base, _csm_batch(csm, CSM_TEXTS), 1e-4)


def test_csm_generate_batch_dp_padding(csm):
    """b=3 pads to 4 under dp=4; the real rows keep their draws."""
    base = _csm_batch(csm, CSM_TEXTS[:3])
    mesh("dp=4")
    dp = _csm_batch(csm, CSM_TEXTS[:3])
    assert len(dp) == 3
    _same_rows(base, dp, 1e-4)


def test_csm_generate_batch_dp2_tp2_composes(csm):
    """dp=2,tp=2 on one model: the batch over 'data', the weights over
    'model'; and tp=2 alone."""
    base = _csm_batch(csm, CSM_TEXTS)
    mesh("dp=2,tp=2")
    _same_rows(base, _csm_batch(csm, CSM_TEXTS), 1e-4)
    mesh(dp=1, tp=2)
    _same_rows(base, _csm_batch(csm, CSM_TEXTS), 1e-4)


# ---------------------------------------------------------------------------
# The causal-LM loop (Orpheus, OuteTTS, Spark, ChatLM, Voxtral's LM)
# ---------------------------------------------------------------------------


def tiny_causal_lm(quantized: bool = False):
    """The JAX test's tiny causal LM, random port weights, the embedding
    scaled by 0.05 so that decoding does not collapse to one token."""
    from mlx_audio_tpu_torch.models.lm.causal import LlamaForCausalLM
    from mlx_audio_tpu_torch.models.lm.llama import LlamaConfig
    from mlx_audio_tpu_torch.nn.quantize import quantize_model

    lm = LlamaForCausalLM(LlamaConfig(
        num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=2,
        head_dim=8, hidden_size=16, intermediate_size=32, rms_norm_eps=1e-5,
        vocab_size=64, max_position_embeddings=256, tie_word_embeddings=True))
    init_weights(lm, torch.Generator().manual_seed(0))
    with torch.no_grad():
        lm.model.embed_tokens.weight.mul_(0.05)
    if quantized:
        quantize_model(lm, group_size=8, bits=8)
    return lm


PROMPTS = [np.arange(5), np.arange(3, 12), np.arange(7), np.arange(2, 6)]


def _batch(lm, prompts, **kw):
    from mlx_audio_tpu_torch.models.lm.causal import generate_tokens_batch

    return [r.tolist() for r in generate_tokens_batch(lm, prompts, **kw)]


@pytest.mark.parametrize("temp,top_k", [(0.0, 0), (0.9, 8)])
def test_causal_lm_dp4_matches_unsharded(temp, top_k):
    """The shared causal-LM batch loop under dp=4: every row's tokens equal
    the unsharded run's, greedy and sampled."""
    lm = tiny_causal_lm()
    kw = dict(max_tokens=12, temperature=temp, top_k=top_k, chunk=8, seed=11)
    base = _batch(lm, PROMPTS, **kw)
    assert len({tuple(r) for r in base}) > 1
    mesh("dp=4")
    assert _batch(lm, PROMPTS, **kw) == base


def test_causal_lm_dp_padding_is_exact():
    """b=3 pads to 4 under dp=4; sampled rows keep their tokens."""
    lm = tiny_causal_lm()
    prompts = [np.arange(4), np.arange(2, 10), np.arange(6)]
    kw = dict(max_tokens=10, temperature=0.8, top_k=16, chunk=8, seed=4)
    base = _batch(lm, prompts, **kw)
    mesh("dp=4")
    dp = _batch(lm, prompts, **kw)
    assert len(dp) == 3 and dp == base


@pytest.fixture(scope="module")
def orpheus():
    from mlx_audio_tpu_torch.codec.snac import SNAC, SNACConfig
    from mlx_audio_tpu_torch.models.tts.llama import Model, ModelConfig
    from test_orpheus import FakeTokenizer, tiny_model

    jm = _seeded(tiny_model)
    js = jm._snac
    ts = _carry(js, SNAC(SNACConfig(**vars(js.config)), device="cpu"))
    tm = Model(ModelConfig(**vars(jm.config)), snac=ts, tokenizer=FakeTokenizer(),
               device="cpu")
    _carry(jm.lm, tm.lm)
    return tm


def test_generate_routes_multisegment_through_dp_batch(orpheus):
    """Under a dp > 1 mesh a multi-segment generate goes through the
    batched dp pass and yields generate_batch's audio."""
    mesh("dp=4")
    routed = list(orpheus.generate("one\ntwo\nthree", voice="tara", max_tokens=21))
    batch = orpheus.generate_batch(["one", "two", "three"], voice="tara", max_tokens=21)
    assert len(routed) == len(batch) == 3
    for a, b in zip(routed, batch):
        np.testing.assert_array_equal(np.asarray(a.audio), np.asarray(b.audio))


def test_orpheus_generate_batch_under_dp(orpheus):
    """Orpheus generate_batch under dp=4 returns per-text audio, as the
    unsharded run's."""
    texts = ["first text", "second", "third", "fourth"]
    base = orpheus.generate_batch(texts, voice="tara", max_tokens=21)
    mesh("dp=4")
    results = orpheus.generate_batch(texts, voice="tara", max_tokens=21)
    assert len(results) == 4
    for r in results:
        assert np.asarray(r.audio).ndim == 1
    _same_rows(base, results, 1e-4)


@pytest.mark.parametrize("temp,top_k", [(0.0, 0), (0.9, 8)])
def test_causal_lm_tp2_matches_unsharded(temp, top_k):
    """dp=2,tp=2 splits the LM by tp_rules_llama and its batch over two
    replicas: greedy and sampled rows equal the unsharded run's (the
    row-parallel sums round otherwise; no token here is a near tie)."""
    lm = tiny_causal_lm()
    kw = dict(max_tokens=12, temperature=temp, top_k=top_k, chunk=8, seed=11)
    base = _batch(lm, PROMPTS, **kw)
    mesh("dp=2,tp=2")
    assert _batch(lm, PROMPTS, **kw) == base


def test_causal_lm_tp_only_single_stream():
    """tp=2 with dp=1 (one stream, the weights split): the streaming
    single-prompt loop equals the unsharded one."""
    from mlx_audio_tpu_torch.models.lm.causal import generate_tokens

    lm = tiny_causal_lm()
    ids = np.arange(2, 9)
    kw = dict(max_tokens=10, temperature=0.0, chunk=4, seed=5)
    base = np.concatenate(list(generate_tokens(lm, ids, **kw)))
    mesh(dp=1, tp=2)
    np.testing.assert_array_equal(np.concatenate(list(generate_tokens(lm, ids, **kw))), base)


# ---------------------------------------------------------------------------
# Bark, IndexTTS and Dia under DP (and Dia under TP)
# ---------------------------------------------------------------------------


def test_bark_generate_batch_dp4_matches_unsharded():
    from mlx_audio_tpu.models.tts.bark.bark import Model as JaxBark
    from mlx_audio_tpu.models.tts.bark.bark import ModelConfig as JaxModelConfig
    from mlx_audio_tpu_torch.models.tts.bark import Model, ModelConfig
    from test_bark import FakeBertTokenizer
    from test_torch_bark import _configs
    from test_torch_encodec import build_jax as build_jax_encodec
    from test_torch_encodec import port_of as port_encodec

    je = build_jax_encodec()
    jm = _seeded(lambda: JaxBark(JaxModelConfig(**_configs()), codec=je,
                                 tokenizer=FakeBertTokenizer()))
    model = _carry(jm, Model(ModelConfig(**_configs()), codec=port_encodec(je),
                             tokenizer=FakeBertTokenizer(), device="cpu"))
    texts = ["hi there", "second text", "third"]    # b=3 pads to 4
    kw = dict(temperature=0.7, seed=1, max_steps=24)
    base = model.generate_batch(texts, **kw)
    mesh("dp=4")
    _same_rows(base, model.generate_batch(texts, **kw), 1e-4)


def test_indextts_generate_batch_dp4_matches_unsharded():
    from mlx_audio_tpu.models.tts.indextts.indextts import Model as JaxModel
    from mlx_audio_tpu_torch.models.tts.indextts.indextts import Model
    from test_indextts import _FakeSpm, tiny_model_config
    from test_torch_indextts import carry, port_config, randomized

    jm = randomized(_seeded(lambda: JaxModel(tiny_model_config(), tokenizer=_FakeSpm())))
    model = carry(jm, Model(port_config(tiny_model_config()), tokenizer=_FakeSpm(),
                            device="cpu"))
    ref_mel = np.random.default_rng(5).standard_normal((1, 21, 16)).astype(np.float32)
    texts = ["hello world", "a second one", "third"]  # b=3 pads to 4
    kw = dict(ref_mel=ref_mel, max_tokens=12, chunk=4, temperature=0.8, seed=0)
    base = model.generate_batch(texts, **kw)
    mesh("dp=4")
    _same_rows(base, model.generate_batch(texts, **kw), 1e-4)


@pytest.fixture(scope="module")
def dia():
    from test_dia import tiny_dia
    from test_torch_dia import port_pair

    return port_pair(_seeded(tiny_dia))


DIA_TEXTS = ["[S1] hi [S2] hello", "[S1] another [S2] line", "[S1] third [S2] text"]


def test_dia_generate_batch_dp4_matches_unsharded(dia):
    """Dia's CFG row pairs under dp=4, b=3 padded to 4: frame counts equal,
    audio within 1e-4."""
    base = dia.generate_batch(DIA_TEXTS, max_tokens=24, temperature=1.0, seed=2)
    mesh("dp=4")
    _same_rows(base, dia.generate_batch(DIA_TEXTS, max_tokens=24, temperature=1.0,
                                        seed=2), 1e-4)


def test_dia_generate_batch_tp2_matches_unsharded(dia):
    """dp=2,tp=2: the DenseGeneral projections split by tp_rules_dia."""
    base = dia.generate_batch(DIA_TEXTS, max_tokens=24, temperature=1.0, seed=2)
    mesh("dp=2,tp=2")
    _same_rows(base, dia.generate_batch(DIA_TEXTS, max_tokens=24, temperature=1.0,
                                        seed=2), 1e-4)


def test_dia_single_text_tp_only(dia):
    """tp=2 with one text through the public generate: the unsharded audio."""
    kw = dict(max_tokens=16, temperature=1.0, seed=4)
    base = list(dia.generate("[S1] solo [S2] reply", **kw))
    mesh(dp=1, tp=2)
    tp = list(dia.generate("[S1] solo [S2] reply", **kw))
    assert len(base) == len(tp) == 1
    _same_rows(base, tp, 1e-4)


# ---------------------------------------------------------------------------
# The server's micro-batcher over the mesh
# ---------------------------------------------------------------------------


def _state(kokoro, tmp_path):
    from mlx_audio_tpu_torch.server import ServerState

    state = ServerState(output_folder=str(tmp_path), device="cpu")
    state.tts_model = kokoro
    state.tts_repo = "local/kokoro"
    return state


def test_server_batcher_runs_dp_batched_pass(kokoro, tmp_path):
    """Concurrent /tts requests coalesce into one generate_batch that
    splits over the active mesh; every request gets a wav."""
    from mlx_audio_tpu_torch.server import DynamicBatcher

    vpath = _voice(tmp_path, 6)
    state = _state(kokoro, tmp_path)
    mesh("dp=4")
    batcher = DynamicBatcher(state, max_batch=8, max_wait_ms=300.0)
    try:
        futs = [batcher.submit("local/kokoro", f"hello request {i}", vpath, "1.0", "a")
                for i in range(4)]
        results = [f.result(timeout=600) for f in futs]
    finally:
        batcher.close()
    assert batcher.last_batch_size == 4
    for r in results:
        assert r.get("status", 200) == 200, r
        assert (tmp_path / r["filename"]).stat().st_size > 0


def test_server_batcher_flushes_in_dp_multiples(kokoro, tmp_path):
    """dp=4, 6 concurrent requests, max_batch=8: a 4-row pass, then a 2-row
    pass, not one 6-row pass padded to 8."""
    from mlx_audio_tpu_torch.server import DynamicBatcher

    vpath = _voice(tmp_path, 7)
    state = _state(kokoro, tmp_path)
    mesh("dp=4")
    sizes = []
    batcher = DynamicBatcher(state, max_batch=8, max_wait_ms=300.0)
    orig = batcher._run_group

    def record(key, group):
        sizes.append(len(group))
        return orig(key, group)

    batcher._run_group = record
    try:
        futs = [batcher.submit("local/kokoro", f"request number {i}", vpath, "1.0", "a")
                for i in range(6)]
        results = [f.result(timeout=600) for f in futs]
    finally:
        batcher.close()
    for r in results:
        assert r.get("status", 200) == 200, r
    assert sizes == [4, 2], sizes


# ---------------------------------------------------------------------------
# Voxtral (TP and DP windows), Spark, OuteTTS and Whisper
# ---------------------------------------------------------------------------


def _voxtral(layers: int):
    from test_torch_voxtral import pair_of

    audio = dict(num_mel_bins=80, d_model=32, encoder_layers=layers,
                 encoder_attention_heads=4, encoder_ffn_dim=64,
                 intermediate_size=128, max_source_positions=64)
    text = dict(vocab_size=128, hidden_size=32, intermediate_size=64,
                num_hidden_layers=layers, num_attention_heads=4, num_key_value_heads=2,
                head_dim=8, max_position_embeddings=1024, tie_word_embeddings=True)
    return pair_of(audio=audio, text=text)[1]


def _same_transcript(base, other):
    assert [s["tokens"] for s in other.segments] == [s["tokens"] for s in base.segments]
    assert other.text == base.text


def test_voxtral_tp2_matches_replicated():
    """Voxtral under dp=2,tp=2 (one window: tp alone): the Llama LM and the
    audio tower's matching projections split by tp_rules_llama; the greedy
    transcript is the unsharded one."""
    model = _voxtral(2)
    audio = np.random.default_rng(2).standard_normal(4 * 16000).astype(np.float32) * 0.1
    kw = dict(max_tokens=6, temperature=0.0, eos_token_ids=(2,))
    base = model.generate(audio, **kw)
    mesh("dp=2,tp=2")
    _same_transcript(base, model.generate(audio, **kw))


def test_voxtral_dp4_windows_match_unsharded():
    """Voxtral's windows (3 pad to 4) under dp=4: the unsharded tokens."""
    model = _voxtral(1)
    audio = np.random.default_rng(3).standard_normal(3 * 16000).astype(np.float32) * 0.1
    kw = dict(max_tokens=6, temperature=0.0, eos_token_ids=(2,))
    base = model.generate(audio, **kw)
    assert len(base.segments) == 3
    mesh("dp=4")
    _same_transcript(base, model.generate(audio, **kw))


def test_spark_generate_batch_dp4_matches_unsharded():
    """Spark's product path (prompt, the shared LM loop, token parse,
    grouped BiCodec detokenize) under dp=4, 3 texts padded to 4."""
    import mlx_audio_tpu.models.tts.spark.bicodec as jb_mod
    from mlx_audio_tpu_torch.models.tts.spark.bicodec import BiCodec
    from mlx_audio_tpu_torch.models.tts.spark.spark import Model, ModelConfig
    from test_spark import TINY_BICODEC, _FakeTokenizer
    from test_torch_spark import twin

    _, pb = twin(lambda: jb_mod.BiCodec(TINY_BICODEC),
                 lambda: BiCodec(TINY_BICODEC, device="cpu"))
    model = Model(ModelConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                              num_attention_heads=4, num_key_value_heads=2,
                              vocab_size=256, max_position_embeddings=512),
                  bicodec=pb, tokenizer=_FakeTokenizer(), device="cpu")
    texts = ["hello world", "a second utterance", "third"]
    kw = dict(gender="female", temperature=0.8, top_k=16, max_tokens=8, seed=6)
    base = model.generate_batch(texts, **kw)
    mesh("dp=4")
    _same_rows(base, model.generate_batch(texts, **kw), 1e-5)


def test_outetts_generate_batch_dp4_matches_unsharded():
    """OuteTTS's product path (prompt template, the shared LM loop, token
    extraction, DAC decode) under dp=4, 3 texts padded to 4."""
    from test_torch_outetts import _pair

    model = _pair()[1]
    texts = ["hello world", "second text", "third"]
    kw = dict(temperature=0.7, max_tokens=24, seed=7)
    base = model.generate_batch(texts, **kw)
    mesh("dp=4")
    _same_rows(base, model.generate_batch(texts, **kw), 1e-5)


def test_whisper_decode_dp4_matches_unsharded():
    """Whisper's window batch (6 windows pad to 8) under dp=4: every
    window's tokens and text are the unsharded run's."""
    from mlx_audio_tpu_torch.models.stt.whisper import api
    from mlx_audio_tpu_torch.models.stt.whisper.decoding import DecodingOptions
    from mlx_audio_tpu_torch.models.stt.whisper.model import ModelDimensions, WhisperModel
    from mlx_audio_tpu_torch.models.stt.whisper.tokenizer import Tokenizer
    from test_whisper import tiny_encoding

    enc = tiny_encoding()
    tokenizer = Tokenizer(encoding=enc, num_languages=4, language="en", task="transcribe")
    dims = ModelDimensions(n_mels=80, n_audio_ctx=100, n_audio_state=32, n_audio_head=2,
                           n_audio_layer=2, n_vocab=enc.n_vocab, n_text_ctx=128,
                           n_text_state=32, n_text_head=2, n_text_layer=2)
    model = WhisperModel(dims, device="cpu")
    mel = (np.random.default_rng(0).standard_normal((6, 200, 80)) * 0.1).astype(np.float32)
    opts = DecodingOptions(language="en", sample_len=8, temperature=0.0)
    base = api.decode(model, mel, opts, tokenizer=tokenizer)
    mesh("dp=4")
    dp = api.decode(model, mel, opts, tokenizer=tokenizer)
    assert len(base) == len(dp) == 6
    for a, b in zip(base, dp):
        assert list(a.tokens) == list(b.tokens)
        assert a.text == b.text
