"""The port's speech-to-speech half of serving (``sts/voice_pipeline.py``,
``sts/webrtc.py``, the server's ``/ws/sts``, ``/webrtc/offer`` and
``--prewarm``): the twins of tests/test_server_sts.py's STS tests, on the
CPU, with that file's fakes.  Where both packages can run on the same
fakes, each twin runs both and holds what comes out equal: VAD decisions,
utterances, events (kinds, sentences, audio), websocket messages (JSON keys
and values, binary chunks).  The chat LM is the JAX package's tiny chat LM
carried across with ``convert.params_from_jax``.

Divergences, each with a test: the prewarm runs one call of each stage
(the JAX package warms a graph a shape bucket), warns when no chat LM is
configured, and lets a stage's failure raise; a chat path that is not a
local directory raises and fetches nothing (tests/test_torch_chat.py); a
decode that its prompt's bucket takes past the RoPE table computes the
rows there (the JAX package reads NaN); /ws/sts drops the silent tail of
an early-committed turn from its speculative tracker (the JAX package
keeps it and transcribes the next turn twice).
"""

import asyncio
import dataclasses
import json
import logging
import sys
from pathlib import Path

import numpy as np
import pytest

import mlx_audio_tpu.models.lm.chat as jax_chat
import mlx_audio_tpu.server as jax_server
import mlx_audio_tpu.sts.voice_pipeline as jax_vp
import mlx_audio_tpu.sts.webrtc as jax_webrtc
from mlx_audio_tpu.nn.module import named_arrays, update_arrays
import mlx_audio_tpu_torch.server as port_server
from mlx_audio_tpu_torch.models.lm import chat
from mlx_audio_tpu_torch.models.lm.causal import LlamaForCausalLM
from mlx_audio_tpu_torch.models.lm.llama import LlamaConfig
from mlx_audio_tpu_torch.sts import voice_pipeline as vp
from mlx_audio_tpu_torch.sts import webrtc
from test_server_sts import (
    FakeChatTokenizer,
    FakeSTT,
    FakeTTSModel,
    _BridgeSTT,
    _CountingTTS,
    _frames,
    _SentenceLLM,
    tiny_chat_lm,
)
from test_torch_orpheus import _carry

STT_REPO = "mlx-community/whisper-large-v3-turbo"
TTS_REPO = "prince-canuma/Kokoro-82M"
PACKAGES = {"jax": (jax_server, jax_vp, jax_webrtc), "port": (port_server, vp, webrtc)}


def chat_pair():
    """The JAX package's tiny chat LM of tests/test_server_sts.py and the
    port's carrying its weights."""
    jllm = tiny_chat_lm()
    model = _carry(jllm.model, LlamaForCausalLM(LlamaConfig(**vars(jllm.model.config))))
    return jllm, chat.ChatLM(model, FakeChatTokenizer(), max_tokens=8, temperature=0.0)


def pipelines(config=None, **stages):
    """The same VoicePipeline in both packages: {"jax": ..., "port": ...};
    each stage is shared, or a (jax, port) pair."""
    out = {}
    for i, name in enumerate(("jax", "port")):
        kw = {k: (v[i] if isinstance(v, tuple) else v) for k, v in stages.items()}
        if name == "port":
            kw["device"] = "cpu"
        out[name] = PACKAGES[name][1].VoicePipeline(config, **kw)
    return out


def _state(package, tmp_path, stt=None, tts=None, options=None):
    server = PACKAGES[package][0]
    kw = {"device": "cpu"} if package == "port" else {}
    state = server.ServerState(output_folder=str(tmp_path / package), **kw)
    state.stt_model, state.stt_repo = stt or FakeSTT(), STT_REPO
    state.tts_model, state.tts_repo = tts or FakeTTSModel(), TTS_REPO
    state.sts_options = dict(options or {})
    return state


def _serve(package, state, client_fn):
    """``client_fn(client)`` against the package's app behind aiohttp's
    test server."""
    from aiohttp.test_utils import TestClient, TestServer

    async def run():
        async with TestClient(TestServer(PACKAGES[package][0].create_app(state))) as client:
            return await client_fn(client)

    return asyncio.run(run())


async def _messages(ws, finals: int = 1, timeout: float = 120):
    """The websocket's messages until ``finals`` final JSONs (those with
    "transcript"): ("json", dict) or ("bytes", payload)."""
    out = []
    while True:
        msg = await ws.receive(timeout=timeout)
        if msg.type.name == "BINARY":
            out.append(("bytes", bytes(msg.data)))
            continue
        data = json.loads(msg.data)
        out.append(("json", data))
        if "transcript" in data:
            finals -= 1
            if not finals:
                return out


def _with_llm(monkeypatch, llm_of):
    """Both packages' VoicePipeline.init_models inject ``llm_of(package)``
    (the JAX test's way of giving /ws/sts a chat stage)."""
    for name in PACKAGES:
        mod = PACKAGES[name][1]
        orig = mod.VoicePipeline.init_models

        def init(self, orig=orig, name=name):
            self._llm = self._llm or llm_of(name)
            return orig(self)

        monkeypatch.setattr(mod.VoicePipeline, "init_models", init)


# ---------------------------------------------------------------------------
# VAD, endpointing, turns (tests/test_server_sts.py:133, :143, :164)
# ---------------------------------------------------------------------------


def test_energy_vad():
    rng = np.random.default_rng(0)
    silence = np.zeros(480, dtype=np.float32)
    speech = rng.standard_normal(480).astype(np.float32) * 0.3
    frames = [silence, speech] + [silence] * 10 + [speech * 0.02, speech, silence]
    vads = [jax_vp.EnergyVAD(threshold=0.01), vp.EnergyVAD(threshold=0.01)]
    decisions = [[v.is_speech(f) for f in frames] for v in vads]
    assert decisions[1] == decisions[0]
    # silence, speech, then the hangover keeps a few frames active
    assert decisions[1][:3] == [False, True, True] and not decisions[1][11]


def test_endpointing_produces_utterance():
    cfg = dict(silence_duration=0.09, frame_duration_ms=30)
    pipes = {"jax": jax_vp.VoicePipeline(jax_vp.VoicePipelineConfig(**cfg)),
             "port": vp.VoicePipeline(vp.VoicePipelineConfig(**cfg), device="cpu")}
    sr = 16000
    speech = np.random.default_rng(1).standard_normal(sr // 2).astype(np.float32) * 0.3
    silence = np.zeros(sr // 2, dtype=np.float32)
    # a partial frame between calls is carried over
    blocks = [speech[:1000], speech[1000:], silence[:333], silence[333:]]
    outs = {k: [p.feed_frames(b) for b in blocks] for k, p in pipes.items()}
    assert [o is None for o in outs["port"]] == [o is None for o in outs["jax"]]
    assert outs["port"][:3] == [None] * 3  # still inside the utterance
    got, want = outs["port"][3], outs["jax"][3]
    np.testing.assert_array_equal(got, want)
    assert len(got) > len(speech) * 0.9


def test_process_turn_end_to_end():
    pipes = pipelines(vp.VoicePipelineConfig(), stt_model=FakeSTT(),
                      llm=lambda t: f"echo: {t}", tts_model=FakeTTSModel())
    out = {k: asyncio.run(p.process_turn(np.zeros(16000, dtype=np.float32)))
           for k, p in pipes.items()}
    text, audio = out["port"]
    assert text == "echo: hello there" == out["jax"][0]
    assert audio is not None and audio.shape[0] == 2400
    np.testing.assert_array_equal(audio, out["jax"][1])


# ---------------------------------------------------------------------------
# the chat stage (:262, :273, :292, :313, :341, :353, :387)
# ---------------------------------------------------------------------------


def test_chat_lm_respond_generates_text():
    jllm, llm = chat_pair()
    out = llm.respond("hello assistant")
    assert isinstance(out, str) and out and out == jllm.respond("hello assistant")
    assert FakeChatTokenizer.template_calls >= 1
    # greedy, fixed seed: deterministic; and the callable VoicePipeline uses
    assert llm.respond("hello assistant") == out
    assert llm("hello assistant") == out


def test_chat_prewarm_covers_prompt_buckets():
    """Divergence: the JAX package warms a prefill and decode graph a
    reachable 64-token bucket (here 64 and 128 of a 248-token budget: 2),
    so that no live turn compiles; eager PyTorch compiles nothing a shape,
    and the port's prewarm runs one turn.  A live streamed turn after it is
    the turn without it, and the JAX package's."""
    jllm, llm = chat_pair()
    before = "".join(llm.respond_stream("hello assistant"))
    assert jllm.prewarm(buckets=(64, 128, 256)) == 2
    assert llm.prewarm() == 1
    after = "".join(llm.respond_stream("hello assistant"))
    assert after == before == "".join(jllm.respond_stream("hello assistant"))


class _WarmableTTS(_CountingTTS):
    """A TTS with the JAX package's optional prewarm hook."""

    def prewarm(self, max_phonemes=128):
        self.warmed = max_phonemes
        return 5


class _LenSTT:
    def __init__(self):
        self.seen = []

    def generate(self, audio, **kw):
        self.seen.append(np.asarray(audio).size)
        return type("R", (), {"text": "ok"})()


def test_voice_pipeline_prewarm_warms_all_stages():
    """The JAX package's prewarm: the TTS model's own prewarm (5), the chat
    LM's buckets (64, 128, 192 of a 248-token budget: 3) and 5 STT length
    buckets, 13.  The port's: one short synthesis, one 1 s STT window and
    one chat turn, 3; the TTS model's prewarm hook is not called."""
    jllm, llm = chat_pair()
    jtts, tts = _WarmableTTS(), _WarmableTTS()
    jstt, stt = _LenSTT(), _LenSTT()
    assert jax_vp.VoicePipeline(stt_model=jstt, llm=jllm, tts_model=jtts).prewarm(
        max_phonemes=64) == 13
    assert jtts.warmed == 64 and len(jstt.seen) == 5
    assert vp.VoicePipeline(stt_model=stt, llm=llm, tts_model=tts, device="cpu").prewarm() == 3
    assert tts.calls == ["Hello."] and not hasattr(tts, "warmed")
    assert stt.seen == [16000]


def test_prewarm_without_a_chat_lm_warns_and_counts_two(caplog):
    """With no chat LM configured the port's prewarm warns that the chat
    stage was not warmed (the JAX package says nothing) and issues 2."""
    tts, stt = _CountingTTS(), _LenSTT()
    with caplog.at_level(logging.WARNING):
        assert jax_vp.VoicePipeline(stt_model=_LenSTT(), tts_model=_CountingTTS()).prewarm() == 5
        assert "chat stage was not warmed" not in caplog.text
        assert vp.VoicePipeline(stt_model=stt, tts_model=tts, device="cpu").prewarm() == 2
    assert "chat stage was not warmed" in caplog.text
    assert tts.calls == ["Hello."] and stt.seen == [16000]


def test_prewarm_raises_what_a_stage_raises():
    """The JAX package logs an STT failure in its prewarm and goes on; the
    port's raises it."""

    class BrokenSTT:
        def generate(self, audio, **kw):
            raise RuntimeError("no STT here")

    assert jax_vp.VoicePipeline(stt_model=BrokenSTT(), tts_model=_CountingTTS()).prewarm() == 0
    with pytest.raises(RuntimeError, match="no STT here"):
        vp.VoicePipeline(stt_model=BrokenSTT(), tts_model=_CountingTTS(),
                         device="cpu").prewarm()


def test_server_prewarm_flag_warms_the_servers_models(tmp_path, monkeypatch, caplog):
    """``--prewarm`` runs the pipeline's prewarm on the server's models
    before the app runs; without a chat LM configured it warns."""
    from aiohttp import web

    tts, stt = _CountingTTS(), _LenSTT()
    ran = []

    class State(port_server.ServerState):
        def __init__(self, device):
            super().__init__(output_folder=str(tmp_path), device=device)
            self.stt_model, self.stt_repo = stt, STT_REPO
            self.tts_model, self.tts_repo = tts, TTS_REPO

    monkeypatch.setattr(port_server, "ServerState", State)
    monkeypatch.setattr(web, "run_app", lambda app, **kw: ran.append((tts.calls[:], kw)))
    with caplog.at_level(logging.WARNING):
        port_server.main(["--prewarm", "--device", "cpu", "--max-batch", "0"])
    assert ran == [(["Hello."], {"host": "0.0.0.0", "port": 8000})]
    assert stt.seen == [16000] and "chat stage was not warmed" in caplog.text


def test_transcribe_buckets_audio_length():
    seen = {}
    for name in PACKAGES:
        stt = _LenSTT()
        kw = {"device": "cpu"} if name == "port" else {}
        pipe = PACKAGES[name][1].VoicePipeline(stt_model=stt, llm=lambda t: t,
                                               tts_model=object(), **kw)
        sr = pipe.config.sample_rate
        for secs in (2.55, 2.70, 2.55, 3.95, 0.2, 31):
            assert pipe.transcribe(np.zeros(int(secs * sr), dtype=np.float32)) == "ok"
        seen[name] = stt.seen
    assert seen["port"] == seen["jax"] == [4 * sr] * 4 + [sr // 2, 31 * sr]


def test_chat_lm_hf_config_mapping():
    cfg = {"model_type": "qwen2", "hidden_size": 32, "num_attention_heads": 4,
           "num_hidden_layers": 2, "intermediate_size": 64, "vocab_size": 128,
           "tie_word_embeddings": True}
    got = chat.llama_config_from_hf(cfg)
    assert vars(got) == vars(jax_chat.llama_config_from_hf(cfg))
    assert got.qkv_bias and not got.use_qk_norm
    assert got.head_dim == 8 and got.tie_word_embeddings


def test_chat_lm_drop_oldest_eviction():
    """A history past the context budget drops the OLDEST turns (system and
    the current message stay) as the JAX package's does, to the same
    prompt.  Divergence: the prompt fits the budget, but its 64-token
    bucket takes the decode past the 256-row RoPE table; the JAX package
    reads NaN rows there and decodes token 0, the port computes the rows
    and replies as the JAX model with a longer table does."""
    from mlx_audio_tpu.models.lm.causal import generate_tokens_batch
    kept = {}

    def tokenizer(name):
        class Counting(FakeChatTokenizer):
            def apply_chat_template(self, messages, tokenize=True, add_generation_prompt=True):
                kept[name] = [dict(m) for m in messages]
                return [3 + (ord(c) % 60) for c in " ".join(m["content"] for m in messages)]

        return Counting()

    jllm, llm = chat_pair()
    jllm.tokenizer, llm.tokenizer = tokenizer("jax"), tokenizer("port")
    history = [{"role": "user" if i % 2 == 0 else "assistant",
                "content": f"turn {i} " + "x" * 40} for i in range(30)]
    out = llm.respond("the current question", history=history)
    jllm.respond("the current question", history=history)
    assert kept["port"] == kept["jax"]
    ids = llm._build_prompt_ids("the current question", history)
    assert ids == jllm._build_prompt_ids("the current question", history)
    longer = jllm.model.tree_replace(model=type(jllm.model.model)(
        dataclasses.replace(jllm.model.config, max_position_embeddings=512)))
    longer = update_arrays(longer, {k: v for k, v in named_arrays(jllm.model)
                                    if "rope_" not in k})
    want = generate_tokens_batch(longer, [np.asarray(ids, np.int32)], max_tokens=8,
                                 temperature=0.0, stop_tokens=llm._stop_tokens())[0]
    assert isinstance(out, str) and out == FakeChatTokenizer().decode(want.tolist())
    msgs = kept["port"]
    assert msgs[0]["role"] == "system" and msgs[-1]["content"] == "the current question"
    contents = [m["content"] for m in msgs]
    assert not any(c.startswith("turn 0 ") for c in contents)
    assert any(c.startswith("turn 29 ") for c in contents)
    assert len(llm._tokenize_messages(msgs)) <= 256 - llm.max_tokens


def test_voice_pipeline_accumulates_history():
    seen = {"jax": [], "port": []}

    def history_llm(name):
        class HistoryLLM:
            def __call__(self, text, history=None):
                seen[name].append(list(history or []))
                return f"reply to {text}"

        return HistoryLLM()

    pipes = pipelines(stt_model=object(), llm=(history_llm("jax"), history_llm("port")),
                      tts_model=object())
    for p in pipes.values():
        assert p.respond("one") == "reply to one"
        assert p.respond("two") == "reply to two"
    assert seen["port"] == seen["jax"]
    assert seen["port"][0] == []
    assert seen["port"][1] == [{"role": "user", "content": "one"},
                               {"role": "assistant", "content": "reply to one"}]


# ---------------------------------------------------------------------------
# /ws/sts (:408, :624, :873, :923)
# ---------------------------------------------------------------------------


async def _one_turn(client):
    async with client.ws_connect("/ws/sts") as ws:
        await ws.send_bytes(np.zeros(16000, dtype=np.float32).tobytes())
        await ws.send_str("flush")
        return await _messages(ws)


def test_ws_sts_end_to_end_with_llm(monkeypatch, tmp_path):
    """mic frames -> /ws/sts -> STT -> the tiny chat LM (loaded through the
    session's llm_model) -> TTS -> audio back: the header (user transcript,
    rate), one chunk, the final JSON with the reply; the same messages as
    the JAX package's app."""
    jllm, llm = chat_pair()
    for mod, model in ((jax_chat, jllm), (chat, llm)):
        monkeypatch.setattr(mod.ChatLM, "from_pretrained",
                            classmethod(lambda cls, path, m=model, **kw: m))
    out = {name: _serve(name, _state(name, tmp_path,
                                     options={"llm_model": "tiny/random-chat-lm"}), _one_turn)
           for name in PACKAGES}
    assert out["port"] == out["jax"]
    (k0, header), (k1, audio), (k2, final) = out["port"]
    assert (k0, k1, k2) == ("json", "bytes", "json")
    assert header == {"user_transcript": "hello there", "sample_rate": 24000}
    assert final["transcript"] == llm.respond("hello there")
    assert len(audio) == 2400 * 4  # FakeTTSModel's 2400 float32 samples


def test_ws_sts_uses_speculative_transcript(tmp_path):
    """Speech, then endpoint silence streamed as a browser does: the STT
    runs once, during the silence, and its transcript is used at the
    commit."""
    import time as _t

    calls = {}

    def counting(name):
        class CountingSTT:
            sample_rate = 16000

            def generate(self, audio, **kw):
                calls.setdefault(name, []).append(len(np.asarray(audio).reshape(-1)))
                _t.sleep(0.05)      # make the overlap observable
                return type("R", (), {"text": "counted hello"})()

        return CountingSTT()

    async def client_fn(client):
        async with client.ws_connect("/ws/sts") as ws:
            await ws.send_bytes(_frames("speech", 0.6).tobytes())
            for _ in range(4):
                await ws.send_bytes(_frames("silence", 0.15).tobytes())
                await asyncio.sleep(0.05)
            await asyncio.sleep(0.2)   # the speculative task finishes
            await ws.send_str("flush")
            return await _messages(ws, timeout=30)

    out = {name: _serve(name, _state(name, tmp_path, stt=counting(name)), client_fn)
           for name in PACKAGES}
    assert out["port"] == out["jax"]
    assert out["port"][0][1]["user_transcript"] == "counted hello"
    assert [k for k, _ in out["port"]] == ["json", "bytes", "json"]
    assert out["port"][-1][1]["transcript"]
    assert len(calls["port"]) == 1 and calls["port"] == calls["jax"]


def test_ws_sts_streams_sentence_chunks(monkeypatch, tmp_path):
    """/ws/sts sends the header, one binary chunk a sentence, then the
    final JSON with the reply, as the JAX package's does."""
    _with_llm(monkeypatch, lambda name: _SentenceLLM())
    tts = {name: _CountingTTS() for name in PACKAGES}
    out = {name: _serve(name, _state(name, tmp_path, tts=tts[name]), _one_turn)
           for name in PACKAGES}
    assert out["port"] == out["jax"]
    assert out["port"][0][1]["user_transcript"] == "hello there"
    assert [k for k, _ in out["port"]] == ["json"] + ["bytes"] * 3 + ["json"]
    assert out["port"][-1][1]["transcript"] == _SentenceLLM.REPLY
    assert tts["port"].calls == tts["jax"].calls


def test_ws_sts_adaptive_endpoint_commits_before_flush(monkeypatch, tmp_path):
    """Speech, then silence without a flush: once the speculative
    transcript is ready and adaptive_min_silence has passed, the server
    replies; the late flush is a no-op."""
    _with_llm(monkeypatch, lambda name: _SentenceLLM())

    async def client_fn(client):
        speech = (np.random.default_rng(0).standard_normal(8000) * 0.3).astype(np.float32)
        sil = np.zeros(2400, dtype=np.float32)  # 150 ms frames
        async with client.ws_connect("/ws/sts") as ws:
            await ws.send_bytes(speech.tobytes())
            header = None
            for _ in range(40):
                await ws.send_bytes(sil.tobytes())
                try:
                    header = await ws.receive_json(timeout=0.2)
                    break
                except asyncio.TimeoutError:
                    continue
            assert header is not None, "no early commit happened"
            rest = await _messages(ws)
            # the late client flush must not start a second turn
            await ws.send_str("flush")
            await ws.send_bytes(sil.tobytes())
            with pytest.raises(asyncio.TimeoutError):
                await ws.receive(timeout=0.5)
            return [("json", header)] + rest

    out = {name: _serve(name, _state(name, tmp_path, tts=_CountingTTS(),
                                     options={"adaptive_min_silence": 0.3}), client_fn)
           for name in PACKAGES}
    assert out["port"] == out["jax"]
    assert out["port"][0][1]["user_transcript"] == "hello there"
    assert [k for k, _ in out["port"]].count("bytes") == 3
    assert out["port"][-1][1]["transcript"] == _SentenceLLM.REPLY


# ---------------------------------------------------------------------------
# WebRTC (:469, :480, :511, :532, :677)
# ---------------------------------------------------------------------------


def _bridge_pipelines():
    cfg = dict(silence_duration=0.2, silence_threshold=0.015)
    return {"jax": jax_vp.VoicePipeline(config=jax_vp.VoicePipelineConfig(**cfg),
                                        stt_model=_BridgeSTT(), llm=None,
                                        tts_model=FakeTTSModel()),
            "port": vp.VoicePipeline(config=vp.VoicePipelineConfig(**cfg),
                                     stt_model=_BridgeSTT(), llm=None,
                                     tts_model=FakeTTSModel(), device="cpu")}


def test_webrtc_bridge_resample_normalizes_input():
    pipes = _bridge_pipelines()
    stereo = (np.ones((2, 4800)) * 16384).astype(np.int16)
    rng = np.random.default_rng(3)
    blocks = [stereo, (rng.standard_normal((960, 2)) * 0.2).astype(np.float32),
              rng.standard_normal(4801)]
    for block in blocks:
        got = webrtc.PcmAssistantBridge(pipes["port"], in_rate=48000)._to_pipeline_rate(block)
        want = jax_webrtc.PcmAssistantBridge(pipes["jax"], in_rate=48000)._to_pipeline_rate(block)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    out = webrtc.PcmAssistantBridge(pipes["port"], in_rate=48000)._to_pipeline_rate(stereo)
    assert out.shape == (1600,)  # 48 kHz -> 16 kHz
    assert abs(float(out[800]) - 0.5) < 0.01


def test_webrtc_bridge_end_to_end_turn():
    """48 kHz speech and silence through feed() run a whole turn; the reply
    comes out of pull() at the peer clock, equal to the JAX package's."""

    async def run(name, pipeline):
        texts = []
        b = PACKAGES[name][2].PcmAssistantBridge(pipeline, in_rate=48000, out_rate=48000,
                                                 on_transcript=texts.append)
        rng = np.random.default_rng(0)
        await b.feed((rng.standard_normal(48000 // 2) * 0.3).astype(np.float32))
        for _ in range(3):
            await b.feed(np.zeros(48000 // 2, dtype=np.float32))
        assert b._turn_task is not None
        await b._turn_task
        pending = b.pending_samples
        first = await b.pull(960)
        rest = await b.pull(48000)     # past the end: zeros
        return texts, pending, first, rest, b.pending_samples

    out = {name: asyncio.run(run(name, p)) for name, p in _bridge_pipelines().items()}
    texts, pending, first, rest, left = out["port"]
    assert texts == ["bridge hello"] == out["jax"][0]
    # FakeTTS's 2400 zeros at 24 kHz -> 4800 samples at 48 kHz
    assert pending == 4800 == out["jax"][1] and left == 0
    assert first.shape == (960,) and rest.shape == (48000,)
    np.testing.assert_array_equal(first, out["jax"][2])
    np.testing.assert_array_equal(rest, out["jax"][3])


def test_webrtc_bridge_barge_in_flushes_output():
    async def run(name, pipeline):
        b = PACKAGES[name][2].PcmAssistantBridge(pipeline, in_rate=48000)
        b._out = np.ones(9600, dtype=np.float32)  # a finished turn's reply
        pipeline._speak_task = asyncio.create_task(asyncio.sleep(10))  # speaking
        speech = (np.random.default_rng(1).standard_normal(48000 // 4) * 0.3).astype(np.float32)
        await b.feed(speech)  # new speech: barge-in
        pipeline._speak_task.cancel()
        return b.pending_samples, pipeline.cancel_event.is_set()

    out = {name: asyncio.run(run(name, p)) for name, p in _bridge_pipelines().items()}
    assert out["port"] == out["jax"] == (0, False)


def test_webrtc_offer_501_without_aiortc(tmp_path):
    """Without aiortc the signaling route answers 501 with the install
    hint, as the JAX package's does."""
    if webrtc.have_aiortc():
        pytest.skip("aiortc installed; the 501 path is not reachable")

    async def post(client):
        resp = await client.post("/webrtc/offer", json={"sdp": "x", "type": "offer"})
        return resp.status, await resp.json()

    out = {name: _serve(name, _state(name, tmp_path), post) for name in PACKAGES}
    assert out["port"] == out["jax"]
    status, body = out["port"]
    assert status == 501 and "aiortc" in body["error"]


def test_webrtc_offer_executes_peer_glue(monkeypatch, tmp_path):
    """With the fake aiortc of tests/fake_aiortc.py the port's signaling
    and track glue run end to end: POST offer -> SDP answer, microphone
    frames -> resampler -> bridge -> STS turn, the reply back through the
    outgoing track's recv(), then barge-in silences it mid-reply and the
    failed connection is closed and dropped."""
    sys.path.insert(0, str(Path(__file__).parent))
    import fake_aiortc

    fake_aiortc.install(monkeypatch)
    assert webrtc.have_aiortc()

    class LongTTS:
        """2 s of non-zero reply at 24 kHz, so barge-in lands mid-reply."""

        sample_rate = 24000

        def generate(self, text=None, **kwargs):
            yield type("R", (), {"audio": np.full(48000, 0.5, dtype=np.float32)})()

    state = _state("port", tmp_path, tts=LongTTS(),
                   options={"silence_duration": 0.2, "silence_threshold": 0.015})

    async def client_fn(client):
        resp = await client.post("/webrtc/offer", json={"sdp": "v=0 offer", "type": "offer"})
        assert resp.status == 200
        body = await resp.json()
        assert body["type"] == "answer" and "fake-answer" in body["sdp"]
        pc = fake_aiortc.RTCPeerConnection.instances[-1]
        assert pc in state.webrtc_pcs and pc.remoteDescription.sdp == "v=0 offer"
        mic, track = pc.remote_audio_track, pc.local_tracks[0]
        assert track.kind == "audio"
        rng = np.random.default_rng(0)
        mic.push((rng.standard_normal(48000 // 2) * 0.3).astype(np.float32))
        for _ in range(4):
            mic.push(np.zeros(48000 // 2, dtype=np.float32))
        reply = None
        for _ in range(200):
            frame = await asyncio.wait_for(track.recv(), timeout=10)
            pcm = frame.to_ndarray().reshape(-1)
            assert frame.sample_rate == 48000 and pcm.shape == (960,)
            if np.abs(pcm).max() > 1000:   # the s16 reply, not idle zeros
                reply = pcm
                break
        assert reply is not None, "the assistant's reply never arrived"
        mic.push((rng.standard_normal(48000 // 4) * 0.3).astype(np.float32))
        await asyncio.sleep(0.1)
        tail = []
        for _ in range(5):
            frame = await asyncio.wait_for(track.recv(), timeout=10)
            tail.append(np.abs(frame.to_ndarray()).max())
        assert min(tail) == 0, tail     # emptied to zeros
        pc.connectionState = "failed"
        await pc.fire("connectionstatechange")
        assert pc not in state.webrtc_pcs
        mic.end()

    _serve("port", state, client_fn)


# ---------------------------------------------------------------------------
# speculative STT during the endpoint silence window (:566, :592, :607)
# ---------------------------------------------------------------------------


def _spec_run(scenario):
    """``scenario(package's SpeculativeTranscriber class)`` in both
    packages: the results must be equal."""
    out = {name: asyncio.run(scenario(PACKAGES[name][1].SpeculativeTranscriber))
           for name in PACKAGES}
    assert out["port"] == out["jax"]
    return out["port"]


def test_speculative_transcriber_launch_and_take():
    async def scenario(cls):
        calls = []

        def fake_stt(audio):
            calls.append(len(audio))
            return "spec text"

        spec = cls(fake_stt, spec_silence=0.25)
        speech = _frames("speech", 0.5)
        spec.feed(speech)
        launches = [spec.launches]          # still speaking
        spec.feed(_frames("silence", 0.3))
        launches.append(spec.launches)      # launched in the silence
        text = await spec.take(np.concatenate([speech, _frames("silence", 1.2)]))
        return launches, text, calls, spec.launches

    assert _spec_run(scenario) == ([0, 1], "spec text", [12800], 0)


def test_speculative_transcriber_invalidated_by_resumed_speech():
    async def scenario(cls):
        spec = cls(lambda a: "stale", spec_silence=0.25)
        spec.feed(_frames("speech", 0.5))
        spec.feed(_frames("silence", 0.3))
        launched = spec.launches
        spec.feed(_frames("speech", 0.3, np.random.default_rng(1)))
        return launched, await spec.take(_frames("speech", 1.1, np.random.default_rng(2)))

    assert _spec_run(scenario) == (1, None)   # speech resumed: dropped


def test_speculative_transcriber_take_rejects_speech_tail():
    async def scenario(cls):
        spec = cls(lambda a: "stale", spec_silence=0.25)
        spec.feed(_frames("speech", 0.5))
        spec.feed(_frames("silence", 0.3))
        # the committed audio holds speech the tracker never saw
        full = np.concatenate([_frames("speech", 0.5), _frames("silence", 0.3),
                               _frames("speech", 0.4, np.random.default_rng(3))])
        return await spec.take(full)

    assert _spec_run(scenario) is None


# ---------------------------------------------------------------------------
# streamed sentences (:781, :827, :852)
# ---------------------------------------------------------------------------


def test_split_sentences():
    table = ["Hello there. How are", "One. Two! Three? tail", "Hi. Good to see you. more",
             "no terminator yet", "", "A full sentence here. Another one too. ",
             "Ok. Ok. Ok.", "Wait...   what?! yes", "Hi. A."]
    for text in table:
        assert vp.split_sentences(text) == jax_vp.split_sentences(text), text
    assert vp.split_sentences("Hello there. How are") == (["Hello there."], "How are")
    assert vp.split_sentences("One. Two! Three? tail") == (["One.", "Two!", "Three?"], "tail")
    # fragments under 4 characters merge forward
    assert vp.split_sentences("Hi. Good to see you. more") == (["Hi. Good to see you."], "more")
    assert vp.split_sentences("no terminator yet") == ([], "no terminator yet")
    assert vp.split_sentences("") == ([], "")
    assert vp.split_sentences("A full sentence here. Another one too. ") == (
        ["A full sentence here.", "Another one too."], "")


def _events(pipes, seconds: float = 1.0):
    async def run(p):
        return [ev async for ev in p.process_turn_streaming(
            np.zeros(int(16000 * seconds), dtype=np.float32))]

    out = {name: asyncio.run(run(p)) for name, p in pipes.items()}
    assert [k for k, _ in out["port"]] == [k for k, _ in out["jax"]]
    for (_, a), (_, b) in zip(out["port"], out["jax"]):
        if isinstance(a, str):
            assert a == b
        else:
            np.testing.assert_array_equal(a, b)
    return out["port"]


def test_process_turn_streaming_sentence_pipeline():
    """The user's transcript first, one audio chunk a sentence (the TTS
    ran 3 times, once a boundary), then the whole reply; the history gets
    the exchange."""
    tts = (_CountingTTS(), _CountingTTS())
    pipes = pipelines(vp.VoicePipelineConfig(), stt_model=_BridgeSTT(), llm=_SentenceLLM(),
                      tts_model=tts)
    events = _events(pipes)
    kinds = [k for k, _ in events]
    assert kinds[0] == "transcript" and events[0][1] == "bridge hello"
    assert kinds.count("audio") == 3 and kinds[-1] == "done"
    assert events[-1][1] == _SentenceLLM.REPLY
    assert tts[1].calls == tts[0].calls == ["First sentence here.", "Second one follows.",
                                            "And a tail"]
    assert pipes["port"]._history == pipes["jax"]._history == [
        {"role": "user", "content": "bridge hello"},
        {"role": "assistant", "content": _SentenceLLM.REPLY}]


def test_process_turn_streaming_nonstreaming_llm_still_chunks():
    """A plain callable LLM (no respond_stream) still has its finished
    reply cut into sentences."""
    tts = (_CountingTTS(), _CountingTTS())
    pipes = pipelines(vp.VoicePipelineConfig(), stt_model=_BridgeSTT(),
                      llm=lambda text: "Alpha beta gamma. Delta epsilon.", tts_model=tts)
    events = _events(pipes, 0.5)
    assert [k for k, _ in events].count("audio") == 2
    assert tts[1].calls == tts[0].calls == ["Alpha beta gamma.", "Delta epsilon."]


def test_server_routes_serve_sts(tmp_path):
    """The port's app has the JAX package's routes, the STS ones too."""
    routes = {}
    for name in PACKAGES:
        app = PACKAGES[name][0].create_app(_state(name, tmp_path))
        routes[name] = {(r.method, r.resource.canonical) for r in app.router.routes()
                        if r.resource is not None}
    assert routes["port"] == routes["jax"]
    assert {("GET", "/ws/sts"), ("POST", "/webrtc/offer")} <= routes["port"]


def test_ws_sts_next_turn_reuses_its_speculative_transcript(monkeypatch, tmp_path):
    """Divergence, a repair: two turns, each committed early (adaptive
    endpointing) before the client's window ends.  The silent tail that
    follows an early commit stays in the JAX package's speculative tracker,
    so that the next turn's snapshot is longer than its audio: its
    transcript is thrown away and made again.  The port drops the tail at
    the flush: one STT call a turn, the same messages."""
    _with_llm(monkeypatch, lambda name: _SentenceLLM())
    calls = {name: [] for name in PACKAGES}

    def stt(name):
        class CountingSTT:
            def generate(self, audio, **kw):
                calls[name].append(len(np.asarray(audio).reshape(-1)))
                return type("R", (), {"text": f"turn {len(calls[name])}"})()

        return CountingSTT()

    async def client_fn(client):
        speech = (np.random.default_rng(0).standard_normal(8000) * 0.3).astype(np.float32)
        sil = np.zeros(2400, dtype=np.float32)
        out = []
        async with client.ws_connect("/ws/sts") as ws:
            for _ in range(2):
                await ws.send_bytes(speech.tobytes())
                for _ in range(8):
                    await ws.send_bytes(sil.tobytes())
                    await asyncio.sleep(0.05)
                out += await _messages(ws)
                await ws.send_str("flush")
        return out

    out = {name: _serve(name, _state(name, tmp_path, stt=stt(name), tts=_CountingTTS(),
                                     options={"adaptive_min_silence": 0.3}), client_fn)
           for name in PACKAGES}
    assert [k for k, _ in out["port"]] == ["json"] + ["bytes"] * 3 + ["json"] + [
        "json"] + ["bytes"] * 3 + ["json"]
    assert len(calls["port"]) == 2 and len(calls["jax"]) == 3
    # the JAX package's second turn is transcribed twice: its first
    # (speculative) transcript is dropped, the header carries the second
    assert out["port"][0][1]["user_transcript"] == out["jax"][0][1]["user_transcript"] == "turn 1"
    assert out["port"][5][1]["user_transcript"] == "turn 2"
    assert out["jax"][5][1]["user_transcript"] == "turn 3"
