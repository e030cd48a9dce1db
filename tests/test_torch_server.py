"""The port's HTTP server (the twins of tests/test_server_sts.py's server
tests; those of its speech-to-speech tests are in tests/test_torch_sts.py):
the per-model shims held to the JAX package's on a table of inputs,
``synthesize_to_file`` and the ``DynamicBatcher`` with the same fake
models, the routes, the session
options; the batcher's repair of the JAX package's padding past
``max_batch`` (``mlx_audio_tpu/server.py:332``); and the whole app on the
CPU behind aiohttp's test server, serving the tiny Kokoro of
tests/test_kokoro.py from a native checkpoint.
"""

import asyncio

import numpy as np
import pytest

import mlx_audio_tpu.server as jax_server
import mlx_audio_tpu_torch.server as port_server
from mlx_audio_tpu_torch.models.base import make_generation_result
from mlx_audio_tpu_torch.server import (
    DynamicBatcher,
    ServerState,
    _parse_speed,
    build_gen_params,
    create_app,
    synthesize_to_file,
)

MODELS = ["SparkAudio/Spark-TTS-0.5B", "prince-canuma/Kokoro-82M",
          "mlx-community/csm-1b", "sesame/csm-1b", "mlx-community/Dia-1.6B"]
SPEEDS = ["high", "very_low", "moderate", "0.7", "1.5", "abc", "1.2", "5.0", "0.5",
          "2.0", "0.49", None]


@pytest.mark.parametrize("model", MODELS)
def test_speed_shims(model):
    for speed in SPEEDS:
        assert _parse_speed(model, speed) == jax_server._parse_speed(model, speed), speed
    assert _parse_speed("Spark-TTS", "high") == (1.5, None)
    assert _parse_speed("Spark-TTS", "0.7") == (1.0, None)
    assert _parse_speed("Kokoro-82M", "1.2")[0] == pytest.approx(1.2)
    assert _parse_speed("Kokoro-82M", "5.0")[1] is not None
    assert _parse_speed("Kokoro-82M", "abc")[1] is not None


@pytest.mark.parametrize("model", MODELS)
def test_gen_params_shims(model):
    table = [
        ("hi", None, 1.0, "a", "high", "male", None, None),
        ("hi", "af_heart", 1.0, "french", None, None, None, None),
        ("hi", "bf_emma", 0.8, "unknown_language", None, None, None, None),
        ("hi", "  ", 1.2, "b", "low", "robot", "/tmp/ref.wav", None),
        ("hi", None, 1.0, "a", None, "female", "/tmp/ref.wav", "the reference"),
    ]
    for args in table:
        assert build_gen_params(model, *args) == jax_server.build_gen_params(model, *args)
    p = build_gen_params("SparkAudio/Spark-TTS-0.5B", "hi", None, 1.0, "a", "high",
                         "male", None)
    assert p["pitch"] == 1.5 and p["gender"] == "male"
    p = build_gen_params("prince-canuma/Kokoro-82M", "hi", "af_heart", 1.0, "french",
                         None, None, None)
    assert p["lang_code"] == "f"
    p = build_gen_params("mlx-community/csm-1b", "hi", None, 1.0, "a", None, None,
                         "/tmp/ref.wav")
    assert p["ref_audio"] == "/tmp/ref.wav"


class FakeTTSModel:
    sample_rate = 24000
    generated_with = None

    def generate(self, text=None, **kwargs):
        FakeTTSModel.generated_with = kwargs
        yield make_generation_result(np.zeros(2400, dtype=np.float32), 24000, 0, 5, 0.1)


def test_synthesize_to_file(tmp_path):
    state = ServerState(output_folder=str(tmp_path), device="cpu")
    state.tts_model = FakeTTSModel()
    state.tts_repo = "fake/model"
    result = synthesize_to_file(state, "fake/model", "hello world")
    assert result["status"] == 200
    assert (tmp_path / result["filename"]).exists()
    assert FakeTTSModel.generated_with == {"speed": 1.0, "verbose": False,
                                           "max_tokens": 8000}


class FakeBatchTTSModel(FakeTTSModel):
    batch_calls = []

    def generate_batch(self, texts, voice=None, speed=1.0, lang_code="a", **kwargs):
        FakeBatchTTSModel.batch_calls.append(list(texts))
        return [make_generation_result(np.zeros(2400, dtype=np.float32), 24000, i, 5, 0.1)
                for i, _ in enumerate(texts)]


def _run_batcher(module, n: int, max_batch: int, tmp_path):
    """``n`` concurrent same-key requests through ``module``'s
    DynamicBatcher over FakeBatchTTSModel: (results, generate_batch calls,
    last_batch_size)."""
    state = module.ServerState(output_folder=str(tmp_path))
    state.tts_model = FakeBatchTTSModel()
    state.tts_repo = "fake/model"
    FakeBatchTTSModel.batch_calls = []
    batcher = module.DynamicBatcher(state, max_batch=max_batch, max_wait_ms=2000)
    try:
        futs = [batcher.submit("fake/model", f"text {i}", "af_heart", "1.0", "a")
                for i in range(n)]
        results = [f.result(timeout=30) for f in futs]
    finally:
        batcher.close()
    assert not batcher._thread.is_alive()
    return results, FakeBatchTTSModel.batch_calls, batcher.last_batch_size


def test_dynamic_batcher_coalesces(tmp_path):
    """Concurrent same-key requests share one generate_batch call of
    exactly their texts."""
    results, calls, last = _run_batcher(port_server, 3, 4, tmp_path)
    assert all(r["status"] == 200 for r in results)
    assert all((tmp_path / r["filename"]).exists() for r in results)
    assert calls == [["text 0", "text 1", "text 2"]]
    assert last == 3


def test_dynamic_batcher_runs_no_more_rows_than_max_batch(tmp_path):
    """The repair of mlx_audio_tpu/server.py:332: 5 requests under
    max_batch=6 run as one generate_batch of the 5 texts.  The JAX
    package pads them to the next power of two, 8 rows, past max_batch."""
    _, calls, last = _run_batcher(port_server, 5, 6, tmp_path / "port")
    assert calls == [[f"text {i}" for i in range(5)]] and last == 5
    _, jax_calls, jax_last = _run_batcher(jax_server, 5, 6, tmp_path / "jax")
    assert jax_last == 5 and len(jax_calls) == 1 and len(jax_calls[0]) == 8 > 6


def test_dynamic_batcher_sequential_fallback(tmp_path):
    """Models without generate_batch fall back to per-request synthesis."""
    state = ServerState(output_folder=str(tmp_path), device="cpu")
    state.tts_model = FakeTTSModel()
    state.tts_repo = "fake/model"
    batcher = DynamicBatcher(state, max_batch=4, max_wait_ms=50)
    try:
        futs = [batcher.submit("fake/model", f"t{i}", None, "1.0", "a") for i in range(2)]
        results = [f.result(timeout=30) for f in futs]
    finally:
        batcher.close()
    assert all(r["status"] == 200 for r in results)


def test_synthesize_empty_text(tmp_path):
    state = ServerState(output_folder=str(tmp_path), device="cpu")
    result = synthesize_to_file(state, "fake/model", "   ")
    assert result["status"] == 400


def test_synthesize_unknown_model_is_a_500_and_fetches_nothing(tmp_path):
    state = ServerState(output_folder=str(tmp_path), device="cpu")
    result = synthesize_to_file(state, "someone/not-here", "hello")
    assert result["status"] == 500 and "not-here" in result["error"]


def test_server_routes_exist(tmp_path):
    app = create_app(ServerState(output_folder=str(tmp_path), device="cpu"))
    routes = {r.resource.canonical for r in app.router.routes() if r.resource is not None}
    for path in ["/tts", "/audio/{filename}", "/stt", "/play", "/stop", "/languages",
                 "/models", "/open_output_folder", "/speech_to_speech_input", "/ws/sts",
                 "/webrtc/offer", "/"]:
        assert path in routes, path


def test_speech_to_speech_input_sets_session_options(tmp_path):
    from aiohttp.test_utils import TestClient, TestServer

    state = ServerState(output_folder=str(tmp_path), device="cpu")
    app = create_app(state)

    async def run():
        async with TestClient(TestServer(app)) as client:
            resp = await client.post(
                "/speech_to_speech_input",
                json={"voice": "af_sky", "speed": 1.25,
                      "model": "prince-canuma/Kokoro-82M", "language": "b"},
            )
            assert resp.status == 200
            assert (await resp.json())["status"] == "success"
            for route, payload in (("/languages", jax_server.LANGUAGES_PAYLOAD),
                                   ("/models", jax_server.MODELS_PAYLOAD)):
                resp = await client.get(route)
                assert await resp.json() == payload
            resp = await client.get("/")
            assert resp.status == 200 and "<html" in await resp.text()

    asyncio.run(run())
    assert state.sts_options == {
        "tts_voice": "af_sky", "tts_speed": 1.25,
        "tts_model": "prince-canuma/Kokoro-82M", "tts_language": "b",
    }


def test_stt_route_transcribes_the_upload(tmp_path):
    """/stt hands the uploaded file to the STT model's generate and returns
    its text, segments and language; the upload is removed."""
    from aiohttp import FormData
    from aiohttp.test_utils import TestClient, TestServer

    seen = []

    class FakeSTT:
        def generate(self, path, **kw):
            seen.append(open(path, "rb").read())
            return type("R", (), {"text": "hello", "segments": [{"text": "hello"}],
                                  "language": "en"})()

    state = ServerState(output_folder=str(tmp_path), device="cpu")
    state.stt_model, state.stt_repo = FakeSTT(), "mlx-community/whisper-large-v3-turbo"

    async def run():
        async with TestClient(TestServer(create_app(state))) as client:
            form = FormData()
            form.add_field("audio", b"RIFF0000", filename="a.wav")
            resp = await client.post("/stt", data=form)
            assert resp.status == 200
            return await resp.json()

    out = asyncio.run(run())
    assert out == {"text": "hello", "segments": [{"text": "hello"}], "language": "en"}
    assert seen == [b"RIFF0000"]
    assert not list(tmp_path.glob("stt_*"))


# ---------------------------------------------------------------------------
# the app end to end on the CPU: the tiny Kokoro from a native checkpoint
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def kokoro_dir(tmp_path_factory):
    from mlx_audio_tpu_torch.models.tts.kokoro import Model, ModelConfig
    from mlx_audio_tpu_torch.utils.loader import save_checkpoint
    from test_kokoro import tiny_config
    from test_torch_loader_cli import kokoro_config_dict

    cfg = tiny_config()
    model = Model(ModelConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__}),
                  device="cpu")
    root = tmp_path_factory.mktemp("served")
    save_checkpoint(model, root / "Kokoro-82M", kokoro_config_dict(cfg))
    voice = root / "voice.npy"
    np.save(voice, (np.random.default_rng(0).standard_normal((510, 1, 256)) * 0.1
                    ).astype(np.float32))
    return root / "Kokoro-82M", voice


def test_concurrent_tts_requests_are_served_as_one_batch(kokoro_dir, tmp_path):
    """3 concurrent /tts requests with different texts, a batcher of
    max_batch 3: one generate_batch of 3 rows, each response's wav the
    16-bit PCM of its row of the loaded model's own generate_batch; then
    /audio serves it."""
    from aiohttp.test_utils import TestClient, TestServer

    from mlx_audio_tpu_torch.utils.audio_io import load_audio

    path, voice = kokoro_dir
    texts = ["hello there", "abc def", "a third line"]
    state = ServerState(output_folder=str(tmp_path), device="cpu")
    state.batcher = DynamicBatcher(state, max_batch=3, max_wait_ms=5000)

    async def run():
        async with TestClient(TestServer(create_app(state))) as client:
            async def one(text):
                resp = await client.post("/tts", data={
                    "text": text, "model": str(path), "voice": str(voice),
                    "speed": "1.5"})
                assert resp.status == 200, await resp.text()
                return (await resp.json())["filename"]

            names = await asyncio.gather(*(one(t) for t in texts))
            resp = await client.get(f"/audio/{names[0]}")
            assert resp.status == 200 and (await resp.read())[:4] == b"RIFF"
            return names

    try:
        names = asyncio.run(run())
    finally:
        state.batcher.close()
    assert state.batcher.last_batch_size == 3
    want = state.tts_model.generate_batch(texts, voice=str(voice), speed=1.5)
    for name, r in zip(names, want):
        pcm = (np.clip(r.audio, -1.0, 1.0) * 32767).astype(np.int16)
        np.testing.assert_array_equal(load_audio(tmp_path / name), pcm / 32768.0)
