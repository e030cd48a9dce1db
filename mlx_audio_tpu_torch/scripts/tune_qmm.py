#!/usr/bin/env python
"""Time the tuning variants of ``csrc/quantized_matmul.cu`` on the card:
the stored columns a part (``QMM_PART_COLS`` 512, 1024 or 2048), the
output columns a warp (``QMM_WARP_COLS`` 2 or 4) and the steps of code
loads a lane keeps in flight (``QMM_DEPTH`` 2 or 4).  Each variant is
built by ``nvcc -D...`` into a directory of its own, all builds started
together, and loaded apart from the port's own build.

    python -m mlx_audio_tpu_torch.scripts.tune_qmm [--out DIR] [--rounds 2]

Every variant is held against ``quantized_matmul_plain`` (atol/rtol 1e-4)
and timed at CSM-1B's projections, int8 in groups of 128, at decode row
counts and at the 32-row verify, with its operands cold in L2 (distinct
copies taken in turn, the calls queued behind a sleeping kernel, CUDA
events around all of them).  The variants run in one order, then in the
reverse one, so that a drift of the card shows.  Prints one line a
variant, shape and round, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import subprocess
import tempfile
from pathlib import Path

import torch

from mlx_audio_tpu_torch import build
from mlx_audio_tpu_torch.nn import kernels
from mlx_audio_tpu_torch.nn.layers import Linear
from mlx_audio_tpu_torch.nn.quantize import QuantizedLinear
from mlx_audio_tpu_torch.scripts.probe_depth import card_line

VARIANTS = tuple(itertools.product((512, 1024, 2048), (2, 4), (2, 4)))
# (rows, I, O): CSM-1B's projections at one row, a batch of 8 and the
# 32-row verify
SHAPES = ((1, 2048, 512), (1, 1024, 1024), (1, 2048, 2048), (1, 2048, 8192),
          (1, 8192, 1024), (1, 8192, 2048), (8, 2048, 2048), (32, 1024, 8192),
          (32, 2048, 2048))
GROUP = 128
COLD_BYTES = 2 * 50 * 2 ** 20  # twice the H100's L2


def build_variants(out: Path) -> dict:
    """One shared library a variant, the nvcc processes run together."""
    src = build.CSRC / "quantized_matmul.cu"
    procs = {}
    for p, c, d in VARIANTS:
        lib = out / f"qmm_p{p}_c{c}_d{d}.so"
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, f"-DQMM_PART_COLS={p}",
               f"-DQMM_WARP_COLS={c}", f"-DQMM_DEPTH={d}", "-o", str(lib),
               str(src)]
        procs[(p, c, d)] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT,
                                             text=True), lib)
    libs = {}
    for key, (proc, lib) in procs.items():
        log, _ = proc.communicate(timeout=build.NVCC_TIMEOUT_S)
        if proc.returncode:
            raise RuntimeError(f"variant {key} did not build:\n{log}")
        spills = sorted({line.strip() for line in log.splitlines()
                         if "spill" in line and not line.strip().startswith("0 bytes stack")})
        regs = [int(w) for line in log.splitlines() if "registers" in line
                for w, nxt in zip(line.split(), line.split()[1:]) if nxt == "registers,"]
        print(f"built P {key[0]} cols/warp {key[1]} depth {key[2]}: registers "
              f"{min(regs)}-{max(regs)}" + (f"; {spills}" if spills else "; no spills"),
              flush=True)
        dll = ctypes.CDLL(str(lib))
        fn = dll.quantized_matmul_forward
        fn.argtypes = kernels._SIGNATURES["quantized_matmul"][1]
        fn.restype = ctypes.c_int
        libs[key] = dll
    return libs


def queued_ms(fns, reps: int = 20) -> float:
    """Device time of one call: the calls on distinct operand copies taken
    in turn, queued behind a sleeping kernel, CUDA events around them."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    calls = max(reps, len(fns))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for n in range(calls):
        fns[n % len(fns)]()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="directory for the variants' libraries (a temporary one by default)")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(args.out or tmp)
        out.mkdir(parents=True, exist_ok=True)
        libs = build_variants(out)
        gen = torch.Generator(device="cuda").manual_seed(0)
        cases = []
        for rows, i, o in SHAPES:
            lin = Linear(i, o, bias=False)
            lin.weight.data = torch.randn(o, i, generator=gen, device="cuda") * i ** -0.5
            q = QuantizedLinear.from_linear(lin, group_size=GROUP, bits=8)
            nbytes = q.weight.numel() + 4 * (q.scales.numel() + q.biases.numel())
            sets = [(q.weight.clone(), q.scales.clone(), q.biases.clone())
                    for _ in range(max(1, -(-COLD_BYTES // nbytes)))]
            x = torch.randn(rows, i, generator=gen, device="cuda")
            ref = kernels.quantized_matmul_plain(x, *sets[0], GROUP)
            cases.append((rows, i, o, x, sets, ref))
        stream = torch.cuda.current_stream().cuda_stream
        for rnd in range(args.rounds):
            order = VARIANTS if rnd % 2 == 0 else VARIANTS[::-1]
            for key in order:
                dll = libs[key]
                for rows, i, o, x, sets, ref in cases:
                    parts = dll.quantized_matmul_parts(i, o, GROUP, 0)
                    y = torch.empty(rows, o, device="cuda")
                    ws = torch.empty(parts, rows, o, device="cuda") if parts > 1 else None

                    def call(w, y=y, ws=ws, x=x, rows=rows, i=i, o=o):
                        code = dll.quantized_matmul_forward(
                            x.data_ptr(), w[0].data_ptr(), w[1].data_ptr(),
                            w[2].data_ptr(), y.data_ptr(),
                            None if ws is None else ws.data_ptr(), rows, i, o,
                            GROUP, 0, stream)
                        if code:
                            raise RuntimeError(f"variant {key}: CUDA error {code}")

                    call(sets[0])
                    torch.cuda.synchronize()
                    err = float((y - ref).abs().max())
                    if not torch.allclose(y, ref, atol=1e-4, rtol=1e-4):
                        raise SystemExit(f"variant {key} B={rows} I={i} O={o}: "
                                         f"max_abs_err {err:.3e}")
                    ms = queued_ms([lambda w=w: call(w) for w in sets])
                    print(f"round {rnd} P {key[0]:4d} cols/warp {key[1]} depth "
                          f"{key[2]}  B={rows:2d} I={i:4d} O={o:4d} parts {parts}: "
                          f"{ms:.4f} ms  max_abs_err {err:.2e}", flush=True)
    print(card_line(torch.device("cuda", 0)))


if __name__ == "__main__":
    main()
