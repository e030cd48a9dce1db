#!/usr/bin/env python
"""Where the 3xTF32 conv kernels' error comes from, on the card: the port's
builds of ``csrc/dilated_conv1d.cu`` and ``csrc/banded_conv1d.cu`` (each
tap's products in an accumulator of their own, folded into the running sum
in float32) beside two variants of each (``csrc/mma_tf32.cuh``):

* ``one-chain``: ``-DCONV_ONE_CHAIN``, one tensor-core accumulator for every
  product, as the kernels had it before the fold;
* ``one-pass``: ``-DCONV_ONE_PASS``, the big products alone (one TF32 pass).

    python -m mlx_audio_tpu_torch.scripts.tune_conv [--out DIR] [--rounds 2]

At DAC-44kHz's routed resblock shapes (K=7, one 3 s clip) and Kokoro-82M's
(batch 2), each variant's output is held against the plain version in
float64 (its max abs error) and against the float32 plain version with the
tolerance ``chip_smoke.py`` uses (atol = rtol = 1e-4: "TOL ok" or "TOL
FAILS"), and timed.  A variant is not held to the tolerance: the point is
to see which of them it tells apart.  The variants run in one order, then
in the reverse one.  Prints one line a kernel, variant, shape and round,
then the card's name and power limit.
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
from mlx_audio_tpu_torch.nn.layers import _dilated_conv1d_residue
from mlx_audio_tpu_torch.scripts.probe_depth import card_line
from mlx_audio_tpu_torch.scripts.tune_lstm import events_ms

VARIANTS = {"default": (), "one-chain": ("-DCONV_ONE_CHAIN",),
            "one-pass": ("-DCONV_ONE_PASS",)}
# (kernel, [B, L, C], K, d): DAC-44kHz's resblock convs on the route each
# takes for a 3 s clip (banded with d > 1 through the residue fold), then
# one Kokoro-82M shape of each kernel
SHAPES = (
    ("dilated_conv1d", (1, 2072, 512), 7, 1), ("dilated_conv1d", (1, 2072, 512), 7, 9),
    ("dilated_conv1d", (1, 2072, 768), 7, 1), ("dilated_conv1d", (1, 2072, 768), 7, 3),
    ("dilated_conv1d", (1, 2072, 768), 7, 9), ("dilated_conv1d", (1, 16576, 384), 7, 9),
    ("dilated_conv1d", (1, 16576, 256), 7, 9), ("dilated_conv1d", (2, 26000, 256), 3, 1),
    ("banded_conv1d", (1, 66304, 128), 7, 1), ("banded_conv1d", (1, 16576, 256), 7, 1),
    ("banded_conv1d", (1, 16576, 384), 7, 1), ("banded_conv1d", (1, 16576, 384), 7, 3),
    ("banded_conv1d", (2, 26000, 256), 7, 1),
)
TOL = {"atol": 1e-4, "rtol": 1e-4}


def build_variants(out: Path) -> dict:
    """(kernel, variant) -> a shared library; every nvcc runs together."""
    procs = {}
    for kernel in ("dilated_conv1d", "banded_conv1d"):
        for name, flags in VARIANTS.items():
            lib = out / f"{kernel}_{name}.so"
            cmd = [build.nvcc_path(), *build.NVCC_FLAGS, *flags, "-I", str(build.CSRC),
                   "-o", str(lib), str(build.CSRC / f"{kernel}.cu")]
            procs[kernel, name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for (kernel, name), (proc, lib) in procs.items():
        log, _ = proc.communicate(timeout=build.NVCC_TIMEOUT_S)
        if proc.returncode:
            raise RuntimeError(f"{kernel} variant {name} did not build:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"built {kernel} {name}: {line.strip()}", flush=True)
        libs[kernel, name] = ctypes.CDLL(str(lib))
    return libs


def variant_fn(kernel: str, lib, d: int):
    """f(x, w): the conv through the variant's library (launches not counted),
    the banded kernel with d > 1 through the residue fold, as the port does."""
    def launch(x, w, dilation=1):
        b, l, c = x.shape
        k, _, c_out = w.shape
        out = torch.empty((b, l, c_out), device=x.device)
        args = [x.data_ptr(), w.data_ptr(), out.data_ptr(), b, l, c, c_out, k]
        if kernel == "dilated_conv1d":
            args.append(dilation)
        kernels._launch(kernel, x.device, *args, variant=lib)
        return out

    if kernel == "dilated_conv1d":
        return lambda x, w: launch(x, w, d)
    if d == 1:
        return launch
    return lambda x, w: _dilated_conv1d_residue(x, w, d, launch)


def plain_fn(kernel: str, d: int, dtype):
    if kernel == "dilated_conv1d":
        return lambda x, w: kernels.dilated_conv1d_plain(x.to(dtype), w.to(dtype), d)
    return lambda x, w: _dilated_conv1d_residue(x.to(dtype), w.to(dtype), d,
                                                kernels.banded_conv1d_plain)


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
        gen = torch.Generator(device="cuda").manual_seed(0)
        cases = []
        for kernel, (b, l, c), k, d in SHAPES:
            x = torch.randn(b, l, c, generator=gen, device="cuda") * 0.3
            w = torch.randn(k, c, c, generator=gen, device="cuda") * 0.05
            ref64 = plain_fn(kernel, d, torch.float64)(x, w)
            ref32 = plain_fn(kernel, d, torch.float32)(x, w)
            plain_err = float((ref32.double() - ref64).abs().max())
            print(f"{kernel} [{b}, {l}, {c}] K={k} d={d} (C K = {c * k}): max |out| "
                  f"{float(ref64.abs().max()):.3f}; float32 plain against float64 "
                  f"{plain_err:.3e}", flush=True)
            cases.append((kernel, (b, l, c), k, d, x, w, ref64, ref32))
        names = list(VARIANTS)
        for rnd in range(args.rounds):
            for name in (names if rnd % 2 == 0 else names[::-1]):
                for kernel, (b, l, c), k, d, x, w, ref64, ref32 in cases:
                    fn = variant_fn(kernel, libs[kernel, name], d)
                    got = fn(x, w)
                    torch.cuda.synchronize()
                    err64 = float((got.double() - ref64).abs().max())
                    ok = torch.allclose(got, ref32, **TOL)
                    ms = events_ms(lambda fn=fn, x=x, w=w: fn(x, w))
                    print(f"round {rnd} {kernel:14s} {name:8s} [{b}, {l}, {c}] K={k} "
                          f"d={d}: {ms:.4f} ms, against float64 {err64:.3e}, "
                          f"TOL {'ok' if ok else 'FAILS'}", flush=True)
                    del got
    print(card_line(torch.device("cuda", 0)))


if __name__ == "__main__":
    main()
