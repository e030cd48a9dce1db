"""The WebRTC transport of the speech-to-speech pipeline (counterpart of
``mlx_audio_tpu/sts/webrtc.py``).

* :class:`PcmAssistantBridge`: PCM glue independent of the transport.
  Incoming samples at any rate are downmixed and resampled to the
  pipeline's 16 kHz, run through the same VAD, endpointing and barge-in
  :class:`VoicePipeline` as ``/ws/sts``, and the synthesized replies are
  resampled into a buffer the outgoing track pulls in 20 ms frames
  (zeros when idle, emptied on barge-in).
* :func:`webrtc_offer`: HTTP signaling over aiortc: POST an SDP offer, get
  the answer; the peer's audio track feeds the bridge and an outgoing
  track plays its output.

aiortc is optional: without it the signaling route answers 501, and
``/ws/sts`` is the transport that is always there.
"""

from __future__ import annotations

import asyncio
import fractions
import logging
import time
from typing import Optional

import numpy as np

from mlx_audio_tpu_torch.utils.audio_io import resample_audio

logger = logging.getLogger("mlx_audio_tpu_torch.sts.webrtc")

OUT_RATE = 48_000  # the WebRTC / Opus clock
FRAME_MS = 20


def have_aiortc() -> bool:
    try:
        import aiortc  # noqa: F401

        return True
    except ImportError:
        return False


class PcmAssistantBridge:
    """An assistant endpoint in PCM around a VoicePipeline: ``feed`` takes
    sample blocks of any length at ``in_rate``; ``pull(n)`` returns exactly
    n outgoing samples at ``out_rate``."""

    def __init__(self, pipeline, in_rate: int = OUT_RATE, out_rate: int = OUT_RATE,
                 on_transcript=None):
        from mlx_audio_tpu_torch.sts.voice_pipeline import SpeculativeTranscriber

        self.pipeline = pipeline
        self.in_rate = in_rate
        self.out_rate = out_rate
        self.on_transcript = on_transcript
        self._out = np.zeros(0, dtype=np.float32)
        self._lock = asyncio.Lock()
        self._turn_task: Optional[asyncio.Task] = None
        # STT starts inside the endpointing silence window, as on /ws/sts
        self._spec = SpeculativeTranscriber(
            pipeline.transcribe, sample_rate=pipeline.config.sample_rate,
            silence_threshold=pipeline.config.silence_threshold)

    # -- incoming ----------------------------------------------------------

    def _to_pipeline_rate(self, samples: np.ndarray) -> np.ndarray:
        samples = np.asarray(samples)
        if np.issubdtype(samples.dtype, np.integer):
            samples = samples.astype(np.float32) / 32768.0
        if samples.ndim == 2:  # [channels, n] or [n, channels] -> mono
            samples = samples.mean(axis=0 if samples.shape[0] <= 2 else 1)
        samples = samples.astype(np.float32)
        sr = self.pipeline.config.sample_rate
        if self.in_rate != sr:
            samples = resample_audio(samples, self.in_rate, sr)
        return samples

    async def feed(self, samples: np.ndarray):
        """Push incoming samples: endpointing runs, and a closed utterance's
        turn runs in the background, so the media loop never blocks."""
        pcm = self._to_pipeline_rate(samples)
        self._spec.feed(pcm)
        utterance = self.pipeline.feed_frames(pcm)
        if self.pipeline.cancel_event.is_set():
            # barge-in: drop the queued reply and the turn under way
            async with self._lock:
                self._out = np.zeros(0, dtype=np.float32)
            if self._turn_task is not None and not self._turn_task.done():
                self._turn_task.cancel()
            self.pipeline.cancel_event.clear()
        if utterance is not None:
            if self._turn_task is not None and not self._turn_task.done():
                self._turn_task.cancel()
            self._turn_task = asyncio.create_task(self._run_turn(utterance))
            # the active speech, so that the endpointer's barge-in branch
            # engages on new speech
            self.pipeline._speak_task = self._turn_task

    async def _run_turn(self, utterance: np.ndarray):
        try:
            pre_text = await self._spec.take_latest()
            text, audio = await self.pipeline.process_turn(utterance, text=pre_text)
        except asyncio.CancelledError:
            raise
        except Exception:  # pragma: no cover - a model's failure
            logger.exception("STS turn failed")
            return
        if self.on_transcript is not None and text:
            try:
                res = self.on_transcript(text)
                if asyncio.iscoroutine(res):
                    await res
            except Exception:  # pragma: no cover
                logger.exception("transcript callback failed")
        if audio is None or not len(audio):
            return
        tts_rate = getattr(self.pipeline._tts, "sample_rate", 24_000)
        if tts_rate != self.out_rate:
            audio = resample_audio(np.asarray(audio, dtype=np.float32), tts_rate,
                                   self.out_rate)
        async with self._lock:
            self._out = np.concatenate([self._out, audio.astype(np.float32)])

    # -- outgoing ----------------------------------------------------------

    async def pull(self, n: int) -> np.ndarray:
        """Exactly n outgoing samples, zeros past the queued reply."""
        async with self._lock:
            take = self._out[:n]
            self._out = self._out[len(take):]
        if len(take) < n:
            take = np.pad(take, (0, n - len(take)))
        return take

    @property
    def pending_samples(self) -> int:
        return len(self._out)


# ---------------------------------------------------------------------------
# aiortc wiring (imported when a peer connects)
# ---------------------------------------------------------------------------


def _make_track(bridge):
    from aiortc.mediastreams import AudioStreamTrack
    from av import AudioFrame

    class AssistantAudioTrack(AudioStreamTrack):
        """The outgoing 48 kHz mono track, paced at 20 ms frames."""

        def __init__(self):
            super().__init__()
            self._pts = 0
            self._start = None

        async def recv(self):
            n = OUT_RATE * FRAME_MS // 1000
            if self._start is None:
                self._start = time.monotonic()
            # aiortc tracks are pulled: pace them to the wall clock
            delay = self._start + self._pts / OUT_RATE - time.monotonic()
            if delay > 0:
                await asyncio.sleep(delay)
            pcm = await bridge.pull(n)
            frame = AudioFrame.from_ndarray(
                (np.clip(pcm, -1, 1) * 32767).astype(np.int16)[None, :],
                format="s16", layout="mono")
            frame.sample_rate = OUT_RATE
            frame.pts = self._pts
            frame.time_base = fractions.Fraction(1, OUT_RATE)
            self._pts += n
            return frame

    return AssistantAudioTrack()


async def webrtc_offer(request, state):
    """POST {sdp, type} -> the SDP answer; one peer connection a call, its
    pipeline on the server's models (``VoicePipeline(server_state=)``).
    501 without aiortc."""
    from aiohttp import web

    if not have_aiortc():
        return web.json_response(
            {"error": "WebRTC transport needs the optional 'aiortc' package "
                      "(pip install aiortc); /ws/sts is the built-in fallback "
                      "transport"},
            status=501)

    from aiortc import RTCPeerConnection, RTCSessionDescription

    from mlx_audio_tpu_torch.sts.voice_pipeline import VoicePipeline, VoicePipelineConfig

    params = await request.json()
    offer = RTCSessionDescription(sdp=params["sdp"], type=params["type"])
    cfg = VoicePipelineConfig(**getattr(state, "sts_options", {}))
    bridge = PcmAssistantBridge(VoicePipeline(config=cfg, server_state=state),
                                in_rate=OUT_RATE, out_rate=OUT_RATE)

    pc = RTCPeerConnection()
    pcs = getattr(state, "webrtc_pcs", None)
    if pcs is None:
        pcs = state.webrtc_pcs = set()
    pcs.add(pc)

    @pc.on("connectionstatechange")
    async def on_state():
        if pc.connectionState in ("failed", "closed"):
            await pc.close()
            pcs.discard(pc)

    @pc.on("track")
    def on_track(track):
        if track.kind != "audio":
            return

        async def reader():
            from av.audio.resampler import AudioResampler

            # whatever the browser sends (48 kHz stereo Opus) as mono s16
            # at the peer clock
            resampler = AudioResampler(format="s16", layout="mono", rate=OUT_RATE)
            while True:
                try:
                    frame = await track.recv()
                except Exception:
                    break
                for out in resampler.resample(frame):
                    await bridge.feed(out.to_ndarray().reshape(-1))

        asyncio.ensure_future(reader())

    pc.addTrack(_make_track(bridge))
    await pc.setRemoteDescription(offer)
    answer = await pc.createAnswer()
    await pc.setLocalDescription(answer)
    return web.json_response({"sdp": pc.localDescription.sdp,
                              "type": pc.localDescription.type})
