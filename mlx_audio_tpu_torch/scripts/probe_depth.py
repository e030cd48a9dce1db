#!/usr/bin/env python
"""Time one depth-draft step's weight stream apart from its batch-1 int8
arithmetic, each alone in a kernel shaped like the draft (4 layers x
1024 x 28672 weights, 117 MB int8 a step, 30 steps a run).  Counterpart of
``scripts/probe_depth.py``, with the same flags and data.

    python -m mlx_audio_tpu_torch.scripts.probe_depth [--modes dma,mxu,...]
        [--iters 10] [--steps 30] [--chunk 4096] [--dtype int8|bf16]
        [--kcols 28] [--device cuda|cpu]

Modes (comma-separated in --modes, all in one process; ``nn/kernels.py``
has the kernels):
  dma    strided column-slice chunks, 2 stages in flight (tensor-map copies)
  dmac   contiguous pre-chunked layout, 2 stages in flight
  dma8   contiguous, 8 stages in flight
  dmabig contiguous, the largest stages, 2 in flight
  mxu    s8 tensor-core dots on a resident chunk, a step's dot count
  vpu    CUDA-core int8 (dp4a) matvec on a resident chunk
  auto   compiler-pipelined read-only loads, no explicit async copy

Each line gives the median time of a run, the time a step, the rate, the
result (an exact int64 of every streamed byte or computed product; every
stream mode gives the same one), its share of the H100's 3.35 TB/s, and
the card's name and power limit.  ``--device cpu`` runs the kernels' plain
PyTorch versions, and its times are the CPU's.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import time

import numpy as np
import torch

from mlx_audio_tpu_torch.nn import kernels

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
MODES = ("dma", "dmac", "dma8", "dmabig", "mxu", "vpu", "auto")


def card_line(device: torch.device) -> str:
    """``nvidia-smi``'s name and power limit of the card, or the CPU."""
    if device.type != "cuda":
        return "cpu (plain PyTorch versions)"
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=60,
        ).stdout.strip().splitlines()[device.index or 0]
    except (OSError, subprocess.SubprocessError):
        return f"{torch.cuda.get_device_name(device)}, power limit not read"


def make_data(n_layers: int, dm: int, kcols: int, chunk: int, dtype: str,
              device: torch.device):
    """The JAX script's draws: w [L, dm, kcols * 1024] in [-127, 127) (as
    int8, or as bf16 through float16, both exact), its chunked layout, and
    x int8 [1, dm].  Returns (rng, w_strided, w_chunked, x)."""
    cols = kcols * 1024
    if cols % chunk:
        raise SystemExit(f"--chunk {chunk} must divide {cols} columns")
    rng = np.random.default_rng(0)
    w_np = rng.integers(-127, 127, size=(n_layers, dm, cols))
    if dtype == "int8":
        w = torch.as_tensor(w_np.astype(np.int8), device=device)
    else:
        w = torch.as_tensor(w_np.astype(np.float16), device=device).to(torch.bfloat16)
    del w_np
    x = torch.as_tensor(rng.integers(-127, 127, size=(1, dm), dtype=np.int8),
                        device=device)
    return rng, w, kernels.chunked_layout(w, chunk), x


def _timed(fn, iters: int, device: torch.device):
    """(first-call seconds, median ms of ``iters`` further calls, result);
    on the card each call is timed with CUDA events."""
    t0 = time.perf_counter()
    result = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    first_s = time.perf_counter() - t0
    times = []
    for _ in range(iters):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
    return first_s, statistics.median(times), result


def run(modes, iters: int = 10, steps: int = 30, chunk: int = 4096,
        dtype: str = "int8", kcols: int = 28, device: str = "cuda",
        n_layers: int = 4, dm: int = 1024) -> list:
    """Run the probes; print one line each and return their records.
    ``n_layers`` and ``dm`` are the draft's (the JAX script fixes them);
    the CPU tests pass smaller ones."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("probe_depth: no CUDA device; pass --device cpu to run "
                         "the plain versions on the CPU")
    for mode in modes:
        if mode not in MODES:
            raise SystemExit(f"unknown mode {mode!r}; modes: {', '.join(MODES)}")
        if mode == "mxu" and dtype != "int8":
            raise SystemExit("mxu mode probes s8 dot throughput; use int8")
    rng, w, w_chunked, x = make_data(n_layers, dm, kcols, chunk, dtype, device)
    card = card_line(device)
    itemsize = w.element_size()
    reps = w_chunked.shape[0]  # matvecs a step in the dot probes
    streamed = n_layers * dm * kcols * 1024 * itemsize * steps
    records = []
    for mode in modes:
        if mode == "vpu":
            x3 = torch.as_tensor(rng.integers(-127, 127, size=(dm // 8, 8, 128),
                                              dtype=np.int8), device=device)
            w3 = w_chunked[0].to(torch.int8).reshape(dm // 8, 8, -1)
            fn = lambda: kernels.probe_vpu(w3, x3, steps, reps)  # noqa: E731
        elif mode == "auto":
            fn = lambda: kernels.probe_auto(w_chunked, steps)  # noqa: E731
        elif mode == "dma":
            fn = lambda: kernels.probe_depth(w, x, mode, steps, chunk)  # noqa: E731
        else:
            fn = lambda m=mode: kernels.probe_depth(w_chunked, x, m, steps)  # noqa: E731
        first_s, med_ms, result = _timed(fn, iters, device)
        rate = streamed / (med_ms * 1e-3)
        unit = "GB/s-equiv" if mode in ("mxu", "vpu") else "GB/s"
        share = (f"{rate / PEAK_BYTES_PER_S:.1%} of 3.35 TB/s"
                 if device.type == "cuda" and mode not in ("mxu", "vpu")
                 else "share of 3.35 TB/s not measured" if device.type != "cuda"
                 else "resident data, no stream")
        print(f"{mode}: median {med_ms:.2f} ms ({med_ms / steps * 1e3:.0f} us/step, "
              f"{rate / 1e9:.0f} {unit})  checksum {int(result)}  {share}  "
              f"[first call {first_s:.1f}s]  {dtype}  on {card}", flush=True)
        records.append({"mode": mode, "dtype": dtype, "median_ms": med_ms,
                        "us_per_step": med_ms / steps * 1e3,
                        "bytes_per_s": rate, "checksum": int(result),
                        "first_call_s": first_s, "device": card})
    return records


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--modes", default="dma,dmac,dma8,dmabig,mxu,vpu")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--chunk", type=int, default=4096)
    ap.add_argument("--dtype", default="int8", choices=["int8", "bf16"])
    ap.add_argument("--kcols", type=int, default=28,
                    help="streamed cols = kcols*1024 per layer")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    return run(args.modes.split(","), args.iters, args.steps, args.chunk,
               args.dtype, args.kcols, args.device)


if __name__ == "__main__":
    main()
