"""REST TTS/STT server on aiohttp (counterpart of ``mlx_audio_tpu/server.py``).

Endpoints: POST /tts, GET /audio/{filename}, POST /stt, POST /play,
POST /stop, GET /languages, GET /models, POST /open_output_folder,
POST /speech_to_speech_input and GET / (the web player).  The
speech-to-speech routes (/ws/sts, /webrtc/offer) and ``--prewarm`` are not
ported yet.

Models load through the port's registry (``utils.loader.load_model``) from
local checkpoint directories, on the server's device, and are hot-swapped
per model path.  Concurrent /tts requests that share (model, voice, speed,
language) are coalesced by :class:`DynamicBatcher` into one
``generate_batch`` of exactly the rows it gathered, never more than
``max_batch``: the JAX package pads a group to the next power of two to
bound its jit keys (``mlx_audio_tpu/server.py:332``), which can exceed
``max_batch``; eager PyTorch has no jit key to bound.
"""

from __future__ import annotations

import argparse
import asyncio
import inspect
import logging
import os
import tempfile
import threading
import time
import uuid
from concurrent.futures import Future
from pathlib import Path
from typing import Optional

import numpy as np

logger = logging.getLogger("mlx_audio_tpu_torch.server")

OUTPUT_FOLDER = os.path.expanduser("~/.mlx_audio_tpu_torch/outputs")

LANGUAGE_MAP = {
    "american_english": "a", "british_english": "b", "spanish": "e",
    "french": "f", "hindi": "h", "italian": "i", "portuguese": "p",
    "japanese": "j", "mandarin_chinese": "z",
    "a": "a", "b": "b", "e": "e", "f": "f", "h": "h", "i": "i", "p": "p",
    "j": "j", "z": "z",
}

SPARK_LEVEL_MAP = {"very_low": 0.0, "low": 0.5, "moderate": 1.0,
                   "high": 1.5, "very_high": 2.0}

STT_DEFAULT = "mlx-community/whisper-large-v3-turbo"


class ServerState:
    """The server's models, player, batcher and output folder.  Models are
    built on ``device`` ("cuda" unless the caller asks for "cpu")."""

    def __init__(self, output_folder: str = OUTPUT_FOLDER, device: str = "cuda"):
        self.device = device
        self.tts_model = None
        self.tts_repo: Optional[str] = None
        self.stt_model = None
        self.stt_repo: Optional[str] = None
        self.player = None
        self.batcher = None  # set to a DynamicBatcher to enable micro-batching
        self.sts_options: dict = {}  # set via POST /speech_to_speech_input
        self._model_lock = threading.Lock()  # hot-swap check-then-set
        try:
            os.makedirs(output_folder, exist_ok=True)
            self.output_folder = output_folder
        except OSError:
            self.output_folder = os.path.join(tempfile.gettempdir(),
                                              "mlx_audio_tpu_torch_outputs")
            os.makedirs(self.output_folder, exist_ok=True)

    def get_tts(self, repo: str):
        # locked: concurrent executor threads hot-swapping different repos
        # could otherwise interleave model/repo assignment (and double-load)
        with self._model_lock:
            if self.tts_model is None or self.tts_repo != repo:
                from mlx_audio_tpu_torch.utils.loader import load_model

                logger.info(f"Loading TTS model {repo}")
                self.tts_model = load_model(repo, domain="tts", device=self.device)
                self.tts_repo = repo
            return self.tts_model

    def get_stt(self, repo: str):
        with self._model_lock:
            if self.stt_model is None or self.stt_repo != repo:
                from mlx_audio_tpu_torch.utils.loader import load_model

                logger.info(f"Loading STT model {repo}")
                self.stt_model = load_model(repo, domain="stt", device=self.device)
                self.stt_repo = repo
            return self.stt_model


def _parse_speed(model: str, speed: str):
    """Per-model speed shims: Spark's named levels, else 0.5-2.0."""
    if "spark" in model.lower():
        if speed in SPARK_LEVEL_MAP:
            return SPARK_LEVEL_MAP[speed], None
        try:
            v = float(speed)
            return v if v in (0.0, 0.5, 1.0, 1.5, 2.0) else 1.0, None
        except (TypeError, ValueError):
            return 1.0, None
    try:
        v = float(speed)
    except (TypeError, ValueError):
        return None, "Invalid speed value"
    if v < 0.5 or v > 2.0:
        return None, "Speed must be between 0.5 and 2.0"
    return v, None


def build_gen_params(model: str, text: str, voice: Optional[str], speed,
                     language: str, pitch: Optional[str],
                     gender: Optional[str], ref_audio_path: Optional[str],
                     ref_text: Optional[str] = None):
    """Assemble the per-model generation kwargs of one request."""
    params = {"text": text, "speed": speed, "verbose": False,
              "max_tokens": 8000}
    lname = model.lower()
    if "spark" in lname:
        params["pitch"] = SPARK_LEVEL_MAP.get(pitch, 1.0) if pitch else 1.0
        params["gender"] = gender if gender in ("female", "male") else "female"
    if voice and voice.strip():
        params["voice"] = voice
    if "kokoro" in lname:
        params["lang_code"] = LANGUAGE_MAP.get(
            language.lower(), voice[0] if voice else "a"
        )
    if ref_audio_path and ("csm" in lname or "sesame" in lname):
        params["ref_audio"] = ref_audio_path
        if ref_text:
            params["ref_text"] = ref_text
    return params


def synthesize_to_file(state: ServerState, model_repo: str, text: str,
                       voice: Optional[str] = None, speed: str = "1.0",
                       language: str = "a", pitch: Optional[str] = None,
                       gender: Optional[str] = None,
                       ref_audio_path: Optional[str] = None,
                       ref_text: Optional[str] = None) -> dict:
    """Core /tts behavior, transport-independent (so tests can drive it
    without sockets)."""
    if not text.strip():
        return {"error": "Text is empty", "status": 400}
    speed_value, err = _parse_speed(model_repo, speed)
    if err:
        return {"error": err, "status": 400}
    try:
        model = state.get_tts(model_repo)
    except Exception as e:  # noqa: BLE001 — reported to the client
        return {"error": f"Failed to load model: {e}", "status": 500}

    gen_params = build_gen_params(model_repo, text, voice, speed_value,
                                  language, pitch, gender, ref_audio_path,
                                  ref_text)
    sample_rate = getattr(model, "sample_rate", 24000)
    if ref_audio_path is not None and "ref_audio" in gen_params:
        from mlx_audio_tpu_torch.utils.audio_io import load_audio

        gen_params["ref_audio"] = load_audio(ref_audio_path, sample_rate)
        if "ref_text" not in gen_params:
            # CSM needs the reference transcript: transcribe it as the CLI
            # does instead of failing the request
            try:
                from mlx_audio_tpu_torch.utils.audio_io import resample_audio

                stt = state.get_stt(STT_DEFAULT)
                gen_params["ref_text"] = stt.generate(resample_audio(
                    gen_params["ref_audio"], sample_rate, 16000)).text.strip()
            except Exception as e:  # noqa: BLE001 — reported to the client
                return {"error": "ref_text missing and auto-transcription "
                                 f"failed: {e}", "status": 400}

    try:
        segments = [np.asarray(r.audio).reshape(-1)
                    for r in model.generate(**gen_params)]
    except Exception as e:  # noqa: BLE001 — reported to the client
        return {"error": f"Generation failed: {e}", "status": 500}
    if not segments:
        return {"error": "No audio generated", "status": 500}
    return _write_wav(state, np.concatenate(segments), sample_rate)


def _accepts_server_batch_kwargs(fn) -> bool:
    """True if a generate_batch implementation takes the server's keyword
    set (explicit parameters or **kwargs), checked by signature so that a
    TypeError raised inside synthesis is never taken for an incompatible
    API."""
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):  # pragma: no cover
        return False
    params = sig.parameters.values()
    if any(p.kind == inspect.Parameter.VAR_KEYWORD for p in params):
        return True
    return {"voice", "speed", "lang_code", "max_tokens"} <= {p.name for p in params}


def _write_wav(state: ServerState, audio: np.ndarray, sample_rate: int) -> dict:
    from mlx_audio_tpu_torch.utils.audio_io import save_audio

    filename = f"tts_{uuid.uuid4()}.wav"
    out_path = os.path.join(state.output_folder, filename)
    save_audio(out_path, audio, sample_rate)
    if not os.path.exists(out_path) or os.path.getsize(out_path) == 0:
        return {"error": "Failed to create audio file", "status": 500}
    return {"filename": filename, "status": 200}


class DynamicBatcher:
    """Coalesce concurrent /tts requests into one batched device pass.

    Requests that share (model, voice, speed, language) and arrive within
    ``max_wait_ms`` of the first are synthesized together by one
    ``model.generate_batch`` of exactly the texts gathered, at most
    ``max_batch`` of them (no padding rows).  Models without a compatible
    batch path fall back to sequential synthesis.  A worker thread owns
    the device work; ``close`` stops it and fails what is still queued.
    """

    def __init__(self, state: ServerState, max_batch: int = 8,
                 max_wait_ms: float = 30.0):
        self.state = state
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1000.0
        self._cond = threading.Condition()
        self._pending: list = []   # (key, text, Future, arrival_time)
        self._stop = False
        self.last_batch_size = 0   # observability / tests
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def submit(self, model_repo: str, text: str, voice: Optional[str],
               speed: str, language: str) -> Future:
        fut: Future = Future()
        key = (model_repo, voice or "", str(speed), language or "a")
        with self._cond:
            self._pending.append((key, text, fut, time.monotonic()))
            self._cond.notify_all()
        return fut

    def close(self):
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self._thread.join(timeout=5)

    def _worker(self):
        while True:
            with self._cond:
                while not self._pending and not self._stop:
                    self._cond.wait()
                if self._stop:
                    for _, _, fut, _arr in self._pending:
                        fut.set_exception(RuntimeError("server shutting down"))
                    self._pending.clear()
                    return
                key0 = self._pending[0][0]
                # the wait window anchors to the first request's arrival
                deadline = self._pending[0][3] + self.max_wait
                while (sum(1 for k, _, _, _ in self._pending if k == key0)
                       < self.max_batch and not self._stop):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cond.wait(timeout=remaining)
                group = [p for p in self._pending if p[0] == key0][: self.max_batch]
                for g in group:
                    self._pending.remove(g)
            self._run_group(key0, group)

    def _run_group(self, key, group):
        model_repo, voice, speed, language = key
        texts = [t for _, t, _, _ in group]
        futs = [f for _, _, f, _ in group]
        self.last_batch_size = len(group)
        try:
            speed_value, err = _parse_speed(model_repo, speed)
            if err:
                raise ValueError(err)
            model = self.state.get_tts(model_repo)
            sr = getattr(model, "sample_rate", 24000)
            results = None
            batch_fn = getattr(model, "generate_batch", None)
            if batch_fn is not None and _accepts_server_batch_kwargs(batch_fn):
                # as build_gen_params, so that batched and sequential
                # requests synthesize alike (Spark's gender default, the
                # token budget, the language fallback)
                kwargs = {"max_tokens": 8000}
                if "spark" in model_repo.lower():
                    kwargs["gender"] = "female"
                results = batch_fn(
                    texts, voice=voice or None, speed=speed_value,
                    lang_code=LANGUAGE_MAP.get(
                        language.lower(), voice[0] if voice else "a"
                    ),
                    **kwargs,
                )
            if results is not None and len(results) == len(texts):
                for fut, r in zip(futs, results):
                    audio = np.asarray(r.audio).reshape(-1)
                    if audio.size == 0:
                        fut.set_result({"error": "No audio generated",
                                        "status": 500})
                    else:
                        fut.set_result(_write_wav(self.state, audio, sr))
                return
            # sequential fallback (no compatible batch path)
            for fut, text in zip(futs, texts):
                fut.set_result(synthesize_to_file(
                    self.state, model_repo, text, voice or None, speed,
                    language,
                ))
        except Exception as e:  # noqa: BLE001 — propagate per request
            logger.exception("batched synthesis failed")
            for fut in futs:
                if not fut.done():
                    fut.set_result({"error": str(e), "status": 500})


def transcribe_file(state: ServerState, model_repo: str, audio_path: str,
                    **kwargs) -> dict:
    model = state.get_stt(model_repo)
    output = model.generate(audio_path, **kwargs)
    return {"text": output.text,
            "segments": getattr(output, "segments", None),
            "language": getattr(output, "language", None), "status": 200}


LANGUAGES_PAYLOAD = {
    "languages": [
        {"code": c, "name": n} for c, n in [
            ("a", "American English"), ("b", "British English"),
            ("e", "Spanish"), ("f", "French"), ("h", "Hindi"),
            ("i", "Italian"), ("p", "Portuguese"), ("j", "Japanese"),
            ("z", "Mandarin Chinese"),
        ]
    ]
}

MODELS_PAYLOAD = {
    "models": [
        "prince-canuma/Kokoro-82M", "mlx-community/csm-1b",
        "mlx-community/orpheus-3b-0.1-ft-bf16", "mlx-community/Dia-1.6B",
        "OuteAI/Llama-OuteTTS-1.0-1B", "SparkAudio/Spark-TTS-0.5B",
        "mlx-community/whisper-large-v3-turbo",
    ]
}


def create_app(state: Optional[ServerState] = None):
    from aiohttp import web

    state = state or ServerState()
    app = web.Application(client_max_size=64 * 1024 * 1024)

    async def tts(request):
        form = await request.post()
        ref_audio_path = None
        ref = form.get("reference_audio")
        if ref is not None and hasattr(ref, "file"):
            ref_audio_path = os.path.join(
                state.output_folder, f"temp_ref_{uuid.uuid4()}.wav"
            )
            with open(ref_audio_path, "wb") as f:
                f.write(ref.file.read())
        model_repo = form.get("model", "prince-canuma/Kokoro-82M")
        text = form.get("text", "")
        batcher = state.batcher
        try:
            if (batcher is not None and ref_audio_path is None
                    and not form.get("pitch") and not form.get("gender")
                    and text.strip()):
                # micro-batch: concurrent same-key requests share one pass
                result = await asyncio.wrap_future(batcher.submit(
                    model_repo, text, form.get("voice"),
                    form.get("speed", "1.0"), form.get("language", "a"),
                ))
            else:
                result = await asyncio.get_running_loop().run_in_executor(
                    None,
                    lambda: synthesize_to_file(
                        state, model_repo, text, form.get("voice"),
                        form.get("speed", "1.0"), form.get("language", "a"),
                        form.get("pitch"), form.get("gender"),
                        ref_audio_path, form.get("ref_text"),
                    ),
                )
        finally:
            if ref_audio_path and os.path.exists(ref_audio_path):
                os.remove(ref_audio_path)
        status = result.pop("status", 200)
        return web.json_response(result, status=status)

    async def audio(request):
        filename = request.match_info["filename"]
        path = os.path.join(state.output_folder, os.path.basename(filename))
        if not os.path.exists(path):
            return web.json_response({"error": "File not found"}, status=404)
        return web.FileResponse(path)

    async def stt(request):
        form = await request.post()
        upload = form.get("audio")
        if upload is None:
            return web.json_response({"error": "No audio uploaded"}, status=400)
        tmp = os.path.join(state.output_folder, f"stt_{uuid.uuid4()}.wav")
        with open(tmp, "wb") as f:
            f.write(upload.file.read())
        try:
            result = await asyncio.get_running_loop().run_in_executor(
                None,
                lambda: transcribe_file(state, form.get("model", STT_DEFAULT), tmp),
            )
        finally:
            os.remove(tmp)
        status = result.pop("status", 200)
        return web.json_response(result, status=status)

    async def play(request):
        form = await request.post()
        filename = form.get("filename")
        path = os.path.join(state.output_folder, os.path.basename(filename or ""))
        if not filename or not os.path.exists(path):
            return web.json_response({"error": "File not found"}, status=404)
        from mlx_audio_tpu_torch.tts.audio_player import AudioPlayer
        from mlx_audio_tpu_torch.utils.audio_io import load_audio

        if state.player is None:
            state.player = AudioPlayer()
        # resampled to the player's rate: Spark writes 16 kHz, Dia 44.1 kHz
        state.player.queue_audio(load_audio(path, state.player.sample_rate))
        return web.json_response({"status": "playing", "filename": filename})

    async def stop(request):
        if state.player is not None:
            state.player.flush()
        return web.json_response({"status": "stopped"})

    async def languages(request):
        return web.json_response(LANGUAGES_PAYLOAD)

    async def models(request):
        return web.json_response(MODELS_PAYLOAD)

    async def open_output_folder(request):
        # a headless host reports the path instead of opening a file manager
        return web.json_response({"folder": state.output_folder})

    async def speech_to_speech_input(request):
        """Record the speech-to-speech session options (voice, speed,
        model, language, llm_model) for the STS routes to come."""
        ctype = request.content_type
        data = (await request.post()
                if ctype.startswith(("multipart", "application/x-www-form"))
                else await request.json())
        opts = {}
        if data.get("voice"):
            opts["tts_voice"] = str(data["voice"])
        if data.get("speed") is not None:
            try:
                opts["tts_speed"] = float(data["speed"])
            except (TypeError, ValueError):
                pass
        if data.get("model"):
            opts["tts_model"] = str(data["model"])
        if data.get("language"):
            opts["tts_language"] = str(data["language"])
        if data.get("llm_model"):
            opts["llm_model"] = str(data["llm_model"])
        state.sts_options.update(opts)
        return web.json_response({"status": "success"})

    app.router.add_post("/tts", tts)
    app.router.add_get("/audio/{filename}", audio)
    app.router.add_post("/stt", stt)
    app.router.add_post("/play", play)
    app.router.add_post("/stop", stop)
    app.router.add_get("/languages", languages)
    app.router.add_get("/models", models)
    app.router.add_post("/open_output_folder", open_output_folder)
    app.router.add_post("/speech_to_speech_input", speech_to_speech_input)

    ui = Path(__file__).parent / "tts" / "audio_player.html"
    if ui.exists():
        async def index(request):
            return web.FileResponse(ui)

        app.router.add_get("/", index)
    return app


def main(argv=None):
    from aiohttp import web

    parser = argparse.ArgumentParser(description="mlx_audio_tpu_torch server")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--verbose", action="store_true")
    parser.add_argument("--max-batch", type=int, default=8,
                        help="most /tts requests one batched pass takes "
                             "(0 disables dynamic batching)")
    parser.add_argument("--batch-window-ms", type=float, default=30.0,
                        help="how long to wait coalescing concurrent requests")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device the models run on (cuda, or cpu)")
    args = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(name)s [%(funcName)s:%(lineno)d] %(message)s",
    )
    state = ServerState(device=args.device)
    if args.max_batch > 0:
        state.batcher = DynamicBatcher(state, max_batch=args.max_batch,
                                       max_wait_ms=args.batch_window_ms)
    try:
        web.run_app(create_app(state), host=args.host, port=args.port)
    finally:
        if state.batcher is not None:
            state.batcher.close()


if __name__ == "__main__":
    main()
