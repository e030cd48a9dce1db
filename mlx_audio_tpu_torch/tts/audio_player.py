"""Buffered audio playback (counterpart of
``mlx_audio_tpu/tts/audio_player.py``, copied: it imports no JAX).

Threaded output with a deque buffer, arrival-rate EMA to gate playback
start, and `flush()` for barge-in.  sounddevice is optional (absent on
headless GPU hosts): without it the player degrades to a no-op sink that
still tracks buffering (so pipeline code runs unchanged).
"""

from __future__ import annotations

import threading
import time
from collections import deque

import numpy as np

try:
    import sounddevice as sd

    _HAS_AUDIO = True
except Exception:  # pragma: no cover - environment without audio
    sd = None
    _HAS_AUDIO = False


class AudioPlayer:
    def __init__(self, sample_rate: int = 24000, buffer_size: int = 2048,
                 verbose: bool = False):
        self.sample_rate = sample_rate
        self.buffer_size = buffer_size
        self.audio_buffer = deque()
        self.buffer_lock = threading.Lock()
        self.playing = False
        self.drain_event = threading.Event()
        self.drain_event.set()
        self.stream = None
        self.verbose = verbose

        # arrival-rate EMA controls the start gate (reference :79-98)
        self._last_arrival = None
        self._interval_ema = None
        self._target_buffer_seconds = 1.5

    # -- internals ---------------------------------------------------------

    def _buffered_seconds(self) -> float:
        with self.buffer_lock:
            total = sum(len(c) for c in self.audio_buffer)
        return total / self.sample_rate

    def _should_start(self) -> bool:
        if self._interval_ema is None:
            return self._buffered_seconds() >= self._target_buffer_seconds
        # start once buffered audio covers the expected production gap
        return self._buffered_seconds() >= min(
            self._target_buffer_seconds, 3 * self._interval_ema
        )

    def callback(self, outdata, frames, time_info, status):  # pragma: no cover
        outdata.fill(0)
        filled = 0
        with self.buffer_lock:
            while filled < frames and self.audio_buffer:
                chunk = self.audio_buffer[0]
                take = min(len(chunk), frames - filled)
                outdata[filled:filled + take, 0] = chunk[:take]
                if take == len(chunk):
                    self.audio_buffer.popleft()
                else:
                    self.audio_buffer[0] = chunk[take:]
                filled += take
            if not self.audio_buffer:
                self.drain_event.set()

    def _ensure_stream(self):  # pragma: no cover
        if not _HAS_AUDIO or self.stream is not None:
            return
        self.stream = sd.OutputStream(
            samplerate=self.sample_rate, channels=1, dtype="float32",
            blocksize=self.buffer_size, callback=self.callback,
        )
        self.stream.start()

    # -- public API (reference-compatible) ---------------------------------

    def queue_audio(self, samples):
        samples = np.asarray(samples, dtype=np.float32).reshape(-1)
        now = time.time()
        if self._last_arrival is not None:
            interval = now - self._last_arrival
            self._interval_ema = (
                interval if self._interval_ema is None
                else 0.8 * self._interval_ema + 0.2 * interval
            )
        self._last_arrival = now

        with self.buffer_lock:
            self.audio_buffer.append(samples)
            self.drain_event.clear()
        if not self.playing and self._should_start():
            self.playing = True
            self._ensure_stream()
        if not _HAS_AUDIO:
            # headless: drop the audio immediately (consumed at infinity speed)
            with self.buffer_lock:
                self.audio_buffer.clear()
                self.drain_event.set()

    def wait_for_drain(self, timeout: float = 60.0) -> bool:
        # the producer is done: start playback even if the buffered audio
        # never reached the 1.5 s start gate (a single short segment would
        # otherwise sit unplayed until the timeout and then be discarded)
        if not self.playing and self._buffered_seconds() > 0:
            self.playing = True
            self._ensure_stream()
        if not _HAS_AUDIO:
            # headless: nothing will ever consume the buffer
            self.drain_event.set()
        return self.drain_event.wait(timeout)

    def flush(self):
        """Barge-in: discard everything queued (reference flush)."""
        with self.buffer_lock:
            self.audio_buffer.clear()
            self.drain_event.set()

    def stop(self):  # pragma: no cover
        if self.stream is not None:
            self.stream.stop()
            self.stream.close()
            self.stream = None
        self.playing = False
