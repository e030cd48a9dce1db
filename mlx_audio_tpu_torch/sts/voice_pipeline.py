"""The realtime speech-to-speech assistant: microphone -> VAD -> STT -> chat
LM -> TTS -> speaker, with barge-in (counterpart of
``mlx_audio_tpu/sts/voice_pipeline.py``).

* The VAD is energy-based with hangover frames.
* Every stage is pluggable, so the pipeline runs headless behind the
  server's ``/ws/sts`` and WebRTC transports as well as against a
  microphone.
* The models load through the server's cache or the port's
  ``utils.loader.load_model`` on the pipeline's device, "cuda" unless the
  caller asks for "cpu".
* :meth:`VoicePipeline.prewarm` warms the stages in the JAX package's
  order: the TTS model's stage grid (Kokoro's ``prewarm``), the chat LM,
  and 5 STT lengths.  Eager PyTorch compiles nothing a shape, so what a
  first live turn would otherwise pay for is the kernels' first build or
  load, the libraries' handles and the allocator's growth.  A stage that
  fails to warm raises (the JAX package logs an STT failure and goes
  on).
"""

from __future__ import annotations

import asyncio
import inspect
import logging
import re
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np

logger = logging.getLogger("mlx_audio_tpu_torch.sts")


@dataclass
class VoicePipelineConfig:
    sample_rate: int = 16000
    frame_duration_ms: int = 30
    silence_threshold: float = 0.015     # energy VAD threshold
    silence_duration: float = 1.5        # endpoint after this much silence
    max_utterance_seconds: float = 30.0
    # adaptive endpointing: once the speculative transcript is ready and
    # this much trailing silence has passed, the server commits the turn
    # without waiting out the client's full endpoint window
    adaptive_endpoint: bool = True
    adaptive_min_silence: float = 0.5
    stt_model: str = "mlx-community/whisper-large-v3-turbo"
    llm_model: Optional[str] = None
    tts_model: str = "prince-canuma/Kokoro-82M"
    tts_voice: str = "af_heart"
    tts_speed: float = 1.0
    tts_language: str = "a"


def _rms(frame: np.ndarray) -> float:
    return float(np.sqrt(np.mean(frame.astype(np.float64) ** 2)))


class EnergyVAD:
    """Frame-level energy VAD with an adaptive noise floor."""

    def __init__(self, threshold: float = 0.015, hangover: int = 8):
        self.threshold = threshold
        self.hangover = hangover
        self._noise_ema = 1e-4
        self._active = 0

    def is_speech(self, frame: np.ndarray) -> bool:
        energy = _rms(frame)
        self._noise_ema = 0.98 * self._noise_ema + 0.02 * min(energy, self.threshold)
        if energy > max(self.threshold, 4 * self._noise_ema):
            self._active = self.hangover
            return True
        if self._active > 0:
            self._active -= 1
            return True
        return False


class SpeculativeTranscriber:
    """Hide the STT stage inside the endpointing silence window.

    A client waits out a silence window before it decides the user has
    finished.  This tracker watches the incoming frames and, once
    ``spec_silence`` seconds of silence follow speech, starts transcribing
    the audio so far in an executor.  If no speech follows, the endpoint's
    transcript is ready (or under way) when the turn is committed; if speech
    resumes, the result is dropped and the watcher re-arms.  The result is
    used only when the committed audio differs from the snapshot by
    trailing sub-threshold samples alone.
    """

    def __init__(self, transcribe_fn, sample_rate: int = 16000,
                 silence_threshold: float = 0.015, spec_silence: float = 0.25,
                 frame_duration_ms: int = 30):
        self.transcribe_fn = transcribe_fn
        self.sample_rate = sample_rate
        self.threshold = silence_threshold
        self.spec_silence = spec_silence
        self.frame_len = int(sample_rate * frame_duration_ms / 1000)
        self.reset()

    def reset(self):
        self._n_fed = 0
        self._buffer: list = []
        self._silent_run = 0.0       # trailing silence, seconds
        self._seen_speech = False
        self._task = None
        self._cov = 0                # samples the launched task covers
        self.launches = 0

    @property
    def seen_speech(self) -> bool:
        """Speech since the last reset: an utterance is pending commit."""
        return self._seen_speech

    @property
    def ready(self) -> bool:
        """The speculative transcription has finished."""
        return self._task is not None and self._task.done()

    @property
    def trailing_silence(self) -> float:
        """Seconds of silence since the last speech frame."""
        return self._silent_run

    def feed(self, frames: np.ndarray, loop=None):
        """Track the stream; launch or invalidate the speculative task."""
        frames = np.asarray(frames, dtype=np.float32).reshape(-1)
        self._buffer.append(frames)
        self._n_fed += len(frames)
        for start in range(0, len(frames) - self.frame_len + 1, self.frame_len):
            if _rms(frames[start:start + self.frame_len]) > self.threshold:
                self._seen_speech = True
                self._silent_run = 0.0
                if self._task is not None:
                    # speech after the snapshot: its transcript is stale
                    self._task = None
                    self._cov = 0
            else:
                self._silent_run += self.frame_len / self.sample_rate
        if (self._task is None and self._seen_speech
                and self._silent_run >= self.spec_silence):
            snapshot = np.concatenate(self._buffer)
            self._cov = len(snapshot)
            lp = loop or asyncio.get_event_loop()
            self._task = lp.run_in_executor(None, self.transcribe_fn, snapshot)
            self.launches += 1

    async def take(self, audio: np.ndarray) -> Optional[str]:
        """The speculative transcript for ``audio`` if it is valid (it
        covers a prefix and the rest is sub-threshold), else None.  Resets
        the tracker either way: the turn is committed."""
        task, cov = self._task, self._cov
        self.reset()
        if task is None:
            return None
        audio = np.asarray(audio, dtype=np.float32).reshape(-1)
        if cov > len(audio):
            return None
        tail = audio[cov:]
        if len(tail) and _rms(tail) > self.threshold:
            return None
        return await task

    async def take_latest(self) -> Optional[str]:
        """As :meth:`take`, for callers whose utterance excludes leading
        silence (the pipeline's endpointer): ``feed`` drops a task that
        speech followed, and an endpointed utterance ends in that same
        silence, so no prefix check is possible or needed."""
        task = self._task
        self.reset()
        if task is None:
            return None
        return await task


_SENTENCE_BOUNDARY = re.compile(r"(?<=[.!?])\s+")


def split_sentences(text: str):
    """(complete sentences, rest): split at [.!?]+ followed by whitespace.
    A fragment shorter than 4 characters merges forward (a lone "Hi." is
    not worth a TTS call of its own)."""
    parts = _SENTENCE_BOUNDARY.split(text)
    rest = parts.pop()               # no terminator and space yet
    merged = []
    for p in parts:
        if merged and len(merged[-1]) < 4:
            merged[-1] = merged[-1] + " " + p
        else:
            merged.append(p)
    if merged and len(merged[-1]) < 4:
        rest = (merged.pop() + " " + rest).strip()
    return merged, rest


class VoicePipeline:
    """The STS stages and their task graph.  Models are loaded on
    ``device``: the server's when a ``server_state`` is given, else "cuda"
    unless the caller asks for "cpu"."""

    # Geometric utterance-length buckets for the STT stage: the JAX package
    # pads to them so that turn-to-turn jitter of one frame does not make a
    # new jit shape.  Kept in the port, so that an utterance is transcribed
    # from the same samples in both: zeros are the silence the endpointer
    # sends anyway, and Whisper pads every window to 30 s.
    STT_LEN_BUCKETS = (0.5, 1.0, 2.0, 4.0, 8.0, 16.0, 30.0)

    def __init__(self, config: Optional[VoicePipelineConfig] = None,
                 stt_model=None, llm=None, tts_model=None, player=None,
                 server_state=None, device: Optional[str] = None):
        self.config = config or VoicePipelineConfig()
        self._stt = stt_model
        self._llm = llm
        self._tts = tts_model
        self._player = player
        self._server_state = server_state
        self.device = device or getattr(server_state, "device", "cuda")
        self.vad = EnergyVAD(self.config.silence_threshold)

        self.transcription_queue: asyncio.Queue = asyncio.Queue()
        self.response_queue: asyncio.Queue = asyncio.Queue()
        self.output_audio_queue: asyncio.Queue = asyncio.Queue()
        self.cancel_event = asyncio.Event()
        self._speak_task: Optional[asyncio.Task] = None
        self._running = False
        # multi-turn memory; ChatLM evicts the oldest turns past its context
        self._history: list = []
        # the endpointer's state (feed_frames)
        self._utt_buffer: list = []
        self._silence_frames = 0
        self._in_speech = False
        self._frame_remainder = np.zeros(0, dtype=np.float32)

    # -- model access ------------------------------------------------------

    def init_models(self):
        """Load the stages not given: STT and TTS through the server's cache
        or ``load_model``, the chat LM when ``llm_model`` names one."""
        if self._stt is None:
            if self._server_state is not None:
                self._stt = self._server_state.get_stt(self.config.stt_model)
            else:
                from mlx_audio_tpu_torch.utils.loader import load_model

                self._stt = load_model(self.config.stt_model, domain="stt",
                                       device=self.device)
        if self._llm is None and self.config.llm_model:
            from mlx_audio_tpu_torch.models.lm.chat import ChatLM

            logger.info(f"Loading chat LLM {self.config.llm_model}")
            self._llm = ChatLM.from_pretrained(self.config.llm_model, device=self.device)
        if self._tts is None:
            if self._server_state is not None:
                self._tts = self._server_state.get_tts(self.config.tts_model)
            else:
                from mlx_audio_tpu_torch.utils.loader import load_model

                self._tts = load_model(self.config.tts_model, domain="tts",
                                       device=self.device)
        return self

    # the STT lengths the prewarm transcribes: the conversational buckets
    # (an utterance past 8 s is rare enough to take its first use live)
    PREWARM_STT_SECONDS = (0.5, 1.0, 2.0, 4.0, 8.0)

    def prewarm(self, max_phonemes: int = 128) -> int:
        """Warm each configured stage before serving, in the JAX package's
        order: the TTS model's own ``prewarm(max_phonemes=...)`` when it has
        one (Kokoro's stage grid), else one short synthesis; the chat LM's
        ``prewarm`` (one turn), or one plain call; one STT window at each of
        PREWARM_STT_SECONDS.  Logs a warning when no chat LM is configured:
        the chat stage is then not warmed.  Returns the calls issued."""
        self.init_models()
        t0 = time.perf_counter()
        tts_warm = getattr(self._tts, "prewarm", None)
        if callable(tts_warm):
            issued = tts_warm(max_phonemes=max_phonemes)
        else:
            list(self.speak("Hello."))
            issued = 1
        if self._llm is None:
            logger.warning("prewarm: no chat LM is configured (llm_model); the chat "
                           "stage was not warmed")
        else:
            warm = getattr(self._llm, "prewarm", None)
            if callable(warm):
                issued += warm()
            else:
                self._llm("Hello.")
                issued += 1
        for secs in self.PREWARM_STT_SECONDS:
            self.transcribe(np.zeros(int(secs * self.config.sample_rate), dtype=np.float32))
            issued += 1
        logger.info("prewarm: %d calls in %.1f s", issued, time.perf_counter() - t0)
        return issued

    # -- stage functions ---------------------------------------------------

    def _bucket_stt_audio(self, audio: np.ndarray) -> np.ndarray:
        sr = self.config.sample_rate
        secs = audio.size / sr
        for b in self.STT_LEN_BUCKETS:
            if secs <= b:
                pad = int(b * sr) - audio.size
                return np.pad(audio, (0, pad)) if pad > 0 else audio
        return audio        # past 30 s: the STT stack windows at 30 s anyway

    def transcribe(self, audio: np.ndarray) -> str:
        self.init_models()
        audio = self._bucket_stt_audio(np.asarray(audio, dtype=np.float32).reshape(-1))
        out = self._stt.generate(audio)
        return out.text.strip() if hasattr(out, "text") else str(out)

    def respond(self, text: str) -> str:
        """The chat LM's reply; the transcript itself when no LM is
        configured.  A stage that takes ``history`` gets the conversation
        so far and the exchange is recorded; a plain callable stays
        (text) -> text."""
        self.init_models()
        if self._llm is None:
            return text
        if not callable(self._llm):
            raise ValueError("llm must be a callable(text)->text")
        try:
            takes_history = "history" in inspect.signature(self._llm).parameters
        except (TypeError, ValueError):
            takes_history = False
        if not takes_history:
            return self._llm(text)
        reply = self._llm(text, history=self._history)
        self._remember(text, reply)
        return reply

    def _remember(self, text: str, reply: str) -> None:
        self._history += [{"role": "user", "content": text},
                          {"role": "assistant", "content": reply}]
        # the stored transcript is bounded too (ChatLM evicts by tokens)
        del self._history[:-40]

    def speak(self, text: str):
        """TTS of a reply: yields audio chunks, stopping on barge-in."""
        self.init_models()
        for result in self._tts.generate(text, voice=self.config.tts_voice,
                                         speed=self.config.tts_speed,
                                         lang_code=self.config.tts_language):
            if self.cancel_event.is_set():
                break
            yield np.asarray(result.audio).reshape(-1)

    async def process_turn(self, audio: np.ndarray, text: Optional[str] = None):
        """One whole STS turn -> (reply, audio or None).  ``text`` skips
        the STT stage when a SpeculativeTranscriber already has the
        transcript."""
        loop = asyncio.get_event_loop()
        if text is None:
            text = await loop.run_in_executor(None, self.transcribe, audio)
        if not text:
            return "", None
        response = await loop.run_in_executor(None, self.respond, text)
        chunks = await loop.run_in_executor(None, lambda: list(self.speak(response)))
        return response, (np.concatenate(chunks) if chunks else None)

    async def process_turn_streaming(self, audio: np.ndarray, text: Optional[str] = None):
        """One STS turn as an async event stream: ("transcript", text), an
        ("audio", chunk) a synthesized chunk of each sentence, then
        ("done", reply).

        An LM with ``respond_stream`` has its reply cut at sentence
        boundaries, each sentence synthesized while the LM decodes the
        next; a plain LM's finished reply is cut the same way.  Barge-in
        (``cancel_event``) stops between chunks."""
        loop = asyncio.get_event_loop()
        if text is None:
            text = await loop.run_in_executor(None, self.transcribe, audio)
        if not text:
            yield ("done", "")
            return
        yield ("transcript", text)

        self.init_models()
        stream_fn = getattr(self._llm, "respond_stream", None)
        if stream_fn is None:
            response = await loop.run_in_executor(None, self.respond, text)
            sentences, rest = split_sentences(response)
            if rest:
                sentences.append(rest)
            for sent in sentences:
                if self.cancel_event.is_set():
                    break
                chunks = await loop.run_in_executor(None, lambda s=sent: list(self.speak(s)))
                for c in chunks:
                    yield ("audio", c)
            yield ("done", response)
            return

        q: asyncio.Queue = asyncio.Queue()

        def produce():
            emitted = 0
            snapshot = ""
            try:
                for snapshot in stream_fn(text, history=self._history):
                    if self.cancel_event.is_set():
                        break
                    sents, _rest = split_sentences(snapshot)
                    while emitted < len(sents):
                        # only new complete sentences, never one again
                        loop.call_soon_threadsafe(q.put_nowait, ("sent", sents[emitted]))
                        emitted += 1
                # whatever never got a terminator
                sents, rest = split_sentences(snapshot)
                tail = " ".join(sents[emitted:] + ([rest] if rest else []))
                if tail.strip() and not self.cancel_event.is_set():
                    loop.call_soon_threadsafe(q.put_nowait, ("sent", tail.strip()))
            finally:
                loop.call_soon_threadsafe(q.put_nowait, ("end", snapshot))

        producer = loop.run_in_executor(None, produce)
        response = ""
        while True:
            kind, payload = await q.get()
            if kind == "end":
                response = payload
                break
            if self.cancel_event.is_set():
                continue             # drain without synthesizing
            chunks = await loop.run_in_executor(None, lambda s=payload: list(self.speak(s)))
            for c in chunks:
                yield ("audio", c)
        await producer
        if response:
            self._remember(text, response)
        yield ("done", response)

    # -- streaming endpointing --------------------------------------------

    def feed_frames(self, frames: np.ndarray):
        """The endpointer: feed audio frames; returns an utterance when the
        silence window closes, else None.  A trailing partial frame is
        carried into the next call."""
        cfg = self.config
        frame_len = int(cfg.sample_rate * cfg.frame_duration_ms / 1000)
        frames = np.concatenate([self._frame_remainder, np.asarray(frames)])
        n_full = (len(frames) // frame_len) * frame_len
        self._frame_remainder = frames[n_full:]
        out = None
        for start in range(0, n_full, frame_len):
            frame = frames[start:start + frame_len]
            if self.vad.is_speech(frame):
                if not self._in_speech and self._speak_task is not None:
                    # barge-in: the assistant stops speaking
                    self.cancel_event.set()
                    if self._player is not None:
                        self._player.flush()
                self._in_speech = True
                self._silence_frames = 0
                self._utt_buffer.append(frame)
            elif self._in_speech:
                self._silence_frames += 1
                self._utt_buffer.append(frame)
                if self._silence_frames * cfg.frame_duration_ms / 1000 >= cfg.silence_duration:
                    out = np.concatenate(self._utt_buffer)
                    self._utt_buffer = []
                    self._in_speech = False
                    self._silence_frames = 0
        max_len = int(cfg.max_utterance_seconds * cfg.sample_rate)
        if self._utt_buffer and sum(len(f) for f in self._utt_buffer) > max_len:
            out = np.concatenate(self._utt_buffer)
            self._utt_buffer = []
            self._in_speech = False
        return out

    # -- the async task graph ---------------------------------------------

    async def start(self, frame_source=None):
        """Run the pipeline over ``frame_source``, an async iterator of
        numpy frames (the microphone when None)."""
        self._running = True
        self.init_models()
        tasks = [
            asyncio.create_task(self._listener(frame_source)),
            asyncio.create_task(self._process_audio()),
            asyncio.create_task(self._response_processor()),
            asyncio.create_task(self._audio_output_processor()),
        ]
        try:
            await asyncio.gather(*tasks)
        finally:
            self._running = False
            for t in tasks:
                t.cancel()

    async def stop(self):
        self._running = False

    async def _listener(self, frame_source):
        if frame_source is None:
            frame_source = self._microphone_frames()
        async for frames in frame_source:
            if not self._running:
                break
            utterance = self.feed_frames(np.asarray(frames))
            if utterance is not None:
                await self.transcription_queue.put(utterance)

    async def _microphone_frames(self):  # pragma: no cover - needs hardware
        import sounddevice as sd

        q: asyncio.Queue = asyncio.Queue()
        loop = asyncio.get_event_loop()
        frame_len = int(self.config.sample_rate * self.config.frame_duration_ms / 1000)

        def callback(indata, frames, time_info, status):
            loop.call_soon_threadsafe(q.put_nowait, indata[:, 0].copy())

        with sd.InputStream(samplerate=self.config.sample_rate, channels=1,
                            blocksize=frame_len, callback=callback):
            while self._running:
                yield await q.get()

    async def _process_audio(self):
        loop = asyncio.get_event_loop()
        while self._running:
            audio = await self.transcription_queue.get()
            text = await loop.run_in_executor(None, self.transcribe, audio)
            if text:
                logger.info(f"User: {text}")
                await self.response_queue.put(text)

    async def _response_processor(self):
        loop = asyncio.get_event_loop()
        while self._running:
            text = await self.response_queue.get()
            response = await loop.run_in_executor(None, self.respond, text)
            logger.info(f"Assistant: {response}")
            # retire the previous reply BEFORE clearing the cancel flag, so
            # that a speak() still running cannot miss the barge-in and
            # interleave its chunks with the new reply
            if self._speak_task is not None and not self._speak_task.done():
                self._speak_task.cancel()
                try:
                    await self._speak_task
                except asyncio.CancelledError:
                    pass
            self.cancel_event.clear()
            self._speak_task = asyncio.create_task(self._speak(response))

    async def _speak(self, response: str):
        loop = asyncio.get_event_loop()
        for chunk in await loop.run_in_executor(None, lambda: list(self.speak(response))):
            if self.cancel_event.is_set():
                break
            await self.output_audio_queue.put(chunk)

    async def _audio_output_processor(self):
        while self._running:
            chunk = await self.output_audio_queue.get()
            if self._player is None:
                from mlx_audio_tpu_torch.tts.audio_player import AudioPlayer

                self._player = AudioPlayer(sample_rate=getattr(self._tts, "sample_rate", 24000))
            self._player.queue_audio(chunk)


def main(argv=None):  # pragma: no cover - needs a microphone
    import argparse

    parser = argparse.ArgumentParser(description="Realtime STS assistant")
    parser.add_argument("--stt", default="mlx-community/whisper-large-v3-turbo")
    parser.add_argument("--tts", default="prince-canuma/Kokoro-82M")
    parser.add_argument("--voice", default="af_heart")
    parser.add_argument("--llm-model", default=None,
                        help="chat LM checkpoint directory (HF llama/qwen layout); "
                             "without one, replies echo the transcript")
    parser.add_argument("--device", default="cuda",
                        help="torch device the models run on (cuda, or cpu)")
    args = parser.parse_args(argv)
    cfg = VoicePipelineConfig(stt_model=args.stt, tts_model=args.tts,
                              tts_voice=args.voice, llm_model=args.llm_model)
    asyncio.run(VoicePipeline(cfg, device=args.device).start())


if __name__ == "__main__":
    main()
