"""Profiling and tracing hooks (counterpart of
``mlx_audio_tpu/utils/profiling.py``).

``trace(logdir)`` records the CUDA activity of everything run inside the
block with ``torch.profiler`` and writes a Chrome/Perfetto trace into
``logdir``; ``annotate(name)`` marks a host-side phase on that timeline.
Only CUDA activity is recorded: the CPU ops' events multiply the profile's
size and the time to write it, and the device time is what the trace is
for.  On a machine without a card, or where the profiler is unavailable,
both are no-ops.
"""

from __future__ import annotations

import contextlib
import logging
import os
from typing import Iterator, Optional

import torch

log = logging.getLogger(__name__)


@contextlib.contextmanager
def trace(logdir: Optional[str]) -> Iterator[None]:
    """Record a device trace into ``logdir/trace.json``; ``logdir=None``
    disables tracing."""
    if not logdir:
        yield
        return
    if not torch.cuda.is_available():
        log.warning("trace: no CUDA device, nothing recorded")
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA])
    try:
        prof.__enter__()
    except RuntimeError as e:  # pragma: no cover - runtime-dependent
        log.warning("profiler trace unavailable: %s", e)
        yield
        return
    try:
        yield
    finally:
        torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        os.makedirs(logdir, exist_ok=True)
        path = os.path.join(logdir, "trace.json")
        prof.export_chrome_trace(path)
        log.info("device trace written to %s", path)


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named host span on the profiler timeline."""
    with torch.profiler.record_function(name):
        yield
