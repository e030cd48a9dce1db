#!/usr/bin/env python
"""Time the build variants of ``csrc/lstm.cu`` on the card at Kokoro's two
LSTM shapes (B=8, H=256, T=512 and T=1300): CTAs a cluster
(``LSTM_CLUSTER`` 8, 4 or 16), the recurrent weight in registers or in
shared memory (``LSTM_WH_REGS``), and ``LSTM_SYNC_ONLY``, which keeps the
DSMEM exchange and the barriers and drops the arithmetic: its time over T
is the least a step of this design can take.  Each variant is built by
``nvcc -D...`` into a directory of its own, all builds started together,
and loaded apart from the port's own build.

    python -m mlx_audio_tpu_torch.scripts.tune_lstm [--out DIR] [--rounds 2]

Beside them it times the row kernel (the one-block-a-row route, as the
default build launches it) and cuDNN's LSTM on the same function.  Every
variant but the sync-only one is held against ``lstm_plain`` (atol/rtol
1e-4).  A variant whose cluster cannot be resident
(``cudaOccupancyMaxActiveClusters`` 0) or that does not take H=256 is
reported and skipped.  The variants run in one order, then in the reverse
one, so that a drift of the card shows.  Prints one line a variant, shape
and round, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import tempfile
from pathlib import Path

import torch

from mlx_audio_tpu_torch import build
from mlx_audio_tpu_torch.nn import kernels
from mlx_audio_tpu_torch.scripts.probe_depth import card_line

# name -> -D flags; "cs8-regs" is the default build
VARIANTS = {
    "cs8-regs": (),
    "cs8-smem": ("-DLSTM_WH_REGS=0",),
    # 1024 threads a CTA leave 64 registers a thread: half of a thread's 64
    # weights in registers, half in shared memory
    "cs4-half": ("-DLSTM_CLUSTER=4", "-DLSTM_WH_REGS=32"),
    "cs16-regs": ("-DLSTM_CLUSTER=16",),
    "cs8-sync-only": ("-DLSTM_SYNC_ONLY",),
}
B, H = 8, 256
TS = (512, 1300)
TOL = {"atol": 1e-4, "rtol": 1e-4}


def build_variants(out: Path) -> dict:
    """One shared library a variant, the nvcc processes run together."""
    src = build.CSRC / "lstm.cu"
    procs = {}
    for name, flags in VARIANTS.items():
        lib = out / f"lstm_{name}.so"
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, *flags, "-o", str(lib),
               str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate(timeout=build.NVCC_TIMEOUT_S)
        if proc.returncode:
            raise RuntimeError(f"variant {name} did not build:\n{log}")
        for line in log.splitlines():
            if "lstm_cluster_kernel" in line or "registers" in line or "spill" in line:
                print(f"built {name}: {line.strip()}", flush=True)
        dll = ctypes.CDLL(str(lib))
        dll.lstm_forward.argtypes = kernels._SIGNATURES["lstm"][1]
        dll.lstm_forward.restype = ctypes.c_int
        dll.lstm_max_active_clusters.argtypes = [ctypes.c_int,
                                                 ctypes.POINTER(ctypes.c_int)]
        libs[name] = dll
    return libs


def events_ms(fn, reps: int = 10) -> float:
    """Device time of one call: ``reps`` calls between two CUDA events,
    after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="directory for the variants' libraries (a temporary one by default)")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(args.out or tmp)
        out.mkdir(parents=True, exist_ok=True)
        libs = build_variants(out)
        runnable = []
        for name, dll in libs.items():
            clusters = ctypes.c_int(0)
            code = dll.lstm_max_active_clusters(H, ctypes.byref(clusters))
            cs = dll.lstm_cluster_size()
            if code or not dll.lstm_route(H) or clusters.value == 0:
                print(f"variant {name}: CS {cs}, skipped: lstm_route({H}) "
                      f"{dll.lstm_route(H)}, max active clusters "
                      f"{clusters.value} (CUDA error {code})", flush=True)
                continue
            print(f"variant {name}: CS {cs}, max active clusters "
                  f"{clusters.value}", flush=True)
            runnable.append(name)
        gen = torch.Generator(device="cuda").manual_seed(0)
        cases = []
        for t in TS:
            xp = torch.randn(B, t, 4 * H, generator=gen, device="cuda") * 0.3
            w_h = torch.randn(4 * H, H, generator=gen, device="cuda") * 0.1
            wh = w_h.t().contiguous()
            h0 = torch.zeros(B, H, device="cuda")
            ref = kernels.lstm_plain(xp, wh, h0, h0)
            lib = torch.nn.LSTM(4 * H, H, batch_first=True).cuda()
            with torch.no_grad():
                lib.weight_ih_l0.copy_(torch.eye(4 * H))
                lib.weight_hh_l0.copy_(w_h)
                lib.bias_ih_l0.zero_()
                lib.bias_hh_l0.zero_()
            cases.append((t, xp, wh, h0, ref, lib))
        stream = torch.cuda.current_stream().cuda_stream
        runs = [(name, 1) for name in runnable] + [("cs8-regs", 0), ("cudnn", None)]
        for rnd in range(args.rounds):
            for name, cluster in (runs if rnd % 2 == 0 else runs[::-1]):
                for t, xp, wh, h0, ref, lib in cases:
                    if name == "cudnn":
                        with torch.no_grad():
                            ms = events_ms(lambda lib=lib, xp=xp: lib(xp))
                        print(f"round {rnd} cuDNN LSTM           B={B} T={t:4d} H={H}: "
                              f"{ms:.4f} ms ({1e3 * ms / t:.3f} us a step)", flush=True)
                        continue
                    dll = libs[name]
                    hs = torch.empty(B, t, H, device="cuda")
                    cs = torch.empty_like(hs)
                    hl = torch.empty(B, H, device="cuda")
                    cl = torch.empty_like(hl)

                    def call(dll=dll, xp=xp, wh=wh, h0=h0, hs=hs, cs=cs, hl=hl,
                             cl=cl, t=t, cluster=cluster):
                        code = dll.lstm_forward(
                            xp.data_ptr(), wh.data_ptr(), h0.data_ptr(),
                            h0.data_ptr(), hs.data_ptr(), cs.data_ptr(),
                            hl.data_ptr(), cl.data_ptr(), B, t, H, cluster, stream)
                        if code:
                            raise RuntimeError(f"variant {name}: CUDA error {code}")

                    call()
                    torch.cuda.synchronize()
                    err = max(float((g - r).abs().max()) for g, r in
                              zip((hs, cs, hl, cl), (ref[0], ref[1], *ref[2])))
                    check = "not the LSTM (sync only)"
                    if not name.endswith("sync-only"):
                        if not all(torch.allclose(g, r, **TOL) for g, r in zip(
                                (hs, cs, hl, cl), (ref[0], ref[1], *ref[2]))):
                            raise SystemExit(f"variant {name} T={t}: max_abs_err {err:.3e}")
                        check = f"max_abs_err {err:.2e}"
                    ms = events_ms(call)
                    label = name if cluster else "row route"
                    print(f"round {rnd} {label:20s} B={B} T={t:4d} H={H}: {ms:.4f} ms "
                          f"({1e3 * ms / t:.3f} us a step)  {check}", flush=True)
    print(card_line(torch.device("cuda", 0)))


if __name__ == "__main__":
    main()
