#!/usr/bin/env python
"""Where the 3xTF32 conv kernels' error comes from, on the card: the port's
builds of ``csrc/dilated_conv1d.cu`` and ``csrc/banded_conv1d.cu`` (each
tap's products in an accumulator of their own, folded into the running sum
in float32) beside two variants of each (``csrc/mma_tf32.cuh``):

* ``one-chain``: ``-DCONV_ONE_CHAIN``, one tensor-core accumulator for every
  product, as the kernels had it before the fold;
* ``one-pass``: ``-DCONV_ONE_PASS``, the big products alone (one TF32 pass).

    python -m mlx_audio_tpu_torch.scripts.tune_conv [--out DIR] [--rounds 2] [--bf16]

At DAC-44kHz's routed resblock shapes (K=7, one 3 s clip) and Kokoro-82M's
(batch 2), each variant's output is held against the plain version in
float64 (its max abs error) and against the float32 plain version with the
tolerance ``chip_smoke.py`` uses (atol = rtol = 1e-4: "TOL ok" or "TOL
FAILS"), and timed.  A variant is not held to the tolerance: the point is
to see which of them it tells apart.  The variants run in one order, then
in the reverse one.  Prints one line a kernel, variant, shape and round,
then the card's name and power limit.

With ``--bf16`` it builds ``csrc/conv1d_bf16.cu``, the kernel both convs
launch on bf16 operands, at three fold depths (``CONV_BF16_FOLD``: a
partial sum over 64 channels of one tap, the port's build, or over 32 or
16) and holds each at Kokoro-82M's shapes and BigVGAN-v2's and DAC-44kHz's
widest: each output's error against the plain version in float64, in bf16
steps (``kernels.bf16_steps``; "step ok" at most one step), and its time.
Then it times the port's build at Kokoro's K = 7 and K = 11 with d = 3 and
5 at its own d (the dilated entry point) against the residue fold around
its d = 1 launch (``nn.layers.conv1d``'s route for those).  cuDNN's conv on
the same operands and the bound stand beside every case.
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
# the same for the bf16 kernel: Kokoro-82M's shapes as chip_smoke.py's
# phase 2 holds them (batch 2), BigVGAN-v2's widest resblocks (K = 11, d =
# 5: the fold depth's limit) and DAC-44kHz's C = 768 (C K = 8448 and 5376,
# the longest sums)
SHAPES_BF16 = (
    ("dilated_conv1d", (2, 26000, 256), 3, 1), ("dilated_conv1d", (2, 26000, 256), 3, 3),
    ("dilated_conv1d", (2, 26000, 256), 3, 5), ("dilated_conv1d", (2, 156001, 128), 3, 1),
    ("dilated_conv1d", (1, 3752, 768), 11, 5), ("dilated_conv1d", (1, 15008, 384), 11, 5),
    ("dilated_conv1d", (1, 2072, 768), 7, 1),
    ("banded_conv1d", (2, 26000, 256), 7, 1), ("banded_conv1d", (2, 156001, 128), 11, 1),
    ("banded_conv1d", (2, 26000, 256), 7, 3), ("banded_conv1d", (1, 15008, 384), 11, 1),
)
# csrc/conv1d_bf16.cu's fold depths: CONV_BF16_FOLD channels of one tap (64,
# the port's build)
BF16_VARIANTS = {"fold-64": (), "fold-32": ("-DCONV_BF16_FOLD=32",),
                 "fold-16": ("-DCONV_BF16_FOLD=16",)}
# Kokoro-82M's banded shapes at d = 3 and 5: the kernel at its own d against
# the residue fold around its d = 1 launch
DIRECT_BF16 = tuple(((2, 26000, 256), 7, d) for d in (3, 5)) + tuple(
    ((2, 156001, 128), 11, d) for d in (3, 5))
# one H100 SXM's dense bf16 and TF32 tensor-core peaks and HBM3 rate (the
# 3xTF32 kernels take three TF32 products a multiply-add)
PEAK_BF16_FLOPS, PEAK_TF32_FLOPS, PEAK_BYTES_PER_S = 989e12, 495e12, 3.35e12
TOL = {"atol": 1e-4, "rtol": 1e-4}


def build_variants(out: Path, bf16: bool = False) -> dict:
    """(kernel, variant) -> a shared library; every nvcc runs together.  In
    bf16 both kernels map to the one build of conv1d_bf16.cu."""
    sources = {"conv1d_bf16": BF16_VARIANTS} if bf16 else {
        "dilated_conv1d": VARIANTS, "banded_conv1d": VARIANTS}
    procs = {}
    for source, variants in sources.items():
        for name, flags in variants.items():
            lib = out / f"{source}_{name}.so"
            cmd = [build.nvcc_path(), *build.NVCC_FLAGS, *flags, "-I", str(build.CSRC),
                   "-o", str(lib), str(build.CSRC / f"{source}.cu")]
            procs[source, name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for (source, name), (proc, lib) in procs.items():
        log, _ = proc.communicate(timeout=build.NVCC_TIMEOUT_S)
        if proc.returncode:
            raise RuntimeError(f"{source} variant {name} did not build:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"built {source} {name}: {line.strip()}", flush=True)
        for kernel in (("dilated_conv1d", "banded_conv1d") if bf16 else (source,)):
            libs[kernel, name] = ctypes.CDLL(str(lib))
    return libs


def variant_fn(kernel: str, lib, d: int):
    """f(x, w): the conv through the variant's library (launches not counted),
    the banded kernel with d > 1 through the residue fold, as the port does;
    bf16 operands take conv1d_bf16's entry point (d = 1 for the banded
    kernel)."""
    def launch(x, w, dilation=1):
        b, l, c = x.shape
        k, _, c_out = w.shape
        out = torch.empty((b, l, c_out), device=x.device, dtype=x.dtype)
        args = [x.data_ptr(), w.data_ptr(), out.data_ptr(), b, l, c, c_out, k]
        if kernel == "dilated_conv1d" or x.dtype == torch.bfloat16:
            args.append(dilation)
        name = f"{kernel}_bf16" if x.dtype == torch.bfloat16 else kernel
        kernels._launch(name, x.device, *args, variant=lib)
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


def library_fn(x, w, d: int):
    """cuDNN's conv on the same operands (NCL, [Cout, C, K]), 'same' padded."""
    x_ncl, w_lib = x.transpose(1, 2).contiguous(), w.permute(2, 1, 0).contiguous()
    pad = (w.shape[0] - 1) * d // 2
    return lambda: torch.nn.functional.conv1d(x_ncl, w_lib, None, 1, pad, d)


def bound_ms(b: int, l: int, c: int, c_out: int, k: int, size: int, peak: float) -> tuple:
    """(ms, "bytes" or "operations"): the larger of the conv's operations at
    ``peak`` and its bytes (x and w read once, out written once) at HBM3's."""
    ops = 2.0 * b * l * c * c_out * k / peak * 1e3
    moved = size * (b * l * (c + c_out) + k * c * c_out) / PEAK_BYTES_PER_S * 1e3
    return (ops, "operations") if ops >= moved else (moved, "bytes")


def direct_against_fold(libs: dict, gen) -> None:
    """The port's build at Kokoro's K = 7 and 11 with d = 3 and 5: at its own
    d against the residue fold around its d = 1 launch, cuDNN beside."""
    for (b, l, c), k, d in DIRECT_BF16:
        x = (torch.randn(b, l, c, generator=gen, device="cuda") * 0.3).to(torch.bfloat16)
        w = (torch.randn(k, c, c, generator=gen, device="cuda") * 0.05).to(torch.bfloat16)
        ref64 = plain_fn("dilated_conv1d", d, torch.float64)(x, w)
        line = []
        for label, kernel in (("own d", "dilated_conv1d"), ("residue fold", "banded_conv1d")):
            fn = variant_fn(kernel, libs[kernel, "fold-64"], d)
            steps = kernels.bf16_steps(fn(x, w), ref64)
            ms = events_ms(lambda fn=fn: fn(x, w))
            line.append(f"{label} {ms:.4f} ms ({steps:.3f} bf16 steps)")
        lib_ms = events_ms(library_fn(x, w, d))
        bound, by = bound_ms(b, l, c, c, k, 2, PEAK_BF16_FLOPS)
        print(f"direct [{b}, {l}, {c}] K={k} d={d}: " + ", ".join(line)
              + f"; cuDNN bf16 {lib_ms:.4f} ms; bound {bound:.4f} ms ({by})", flush=True)
        del ref64


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="directory for the variants' libraries (a temporary one by default)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--bf16", action="store_true",
                    help="hold conv1d_bf16.cu's fold depths against each other")
    args = ap.parse_args()
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(args.out or tmp)
        out.mkdir(parents=True, exist_ok=True)
        libs = build_variants(out, args.bf16)
        gen = torch.Generator(device="cuda").manual_seed(0)
        cases = []
        for kernel, (b, l, c), k, d in (SHAPES_BF16 if args.bf16 else SHAPES):
            x = (torch.randn(b, l, c, generator=gen, device="cuda") * 0.3).to(dtype)
            w = (torch.randn(k, c, c, generator=gen, device="cuda") * 0.05).to(dtype)
            ref64 = plain_fn(kernel, d, torch.float64)(x, w)
            ref32 = plain_fn(kernel, d, torch.float32)(x, w)
            plain_err = float((ref32.double() - ref64).abs().max())
            lib_ms = events_ms(library_fn(x, w, d))
            bound, by = bound_ms(b, l, c, c, k, x.element_size(),
                                 PEAK_BF16_FLOPS if args.bf16 else PEAK_TF32_FLOPS / 3)
            print(f"{kernel} [{b}, {l}, {c}] K={k} d={d} (C K = {c * k}): max |out| "
                  f"{float(ref64.abs().max()):.3f}; float32 plain against float64 "
                  f"{plain_err:.3e}; cuDNN {lib_ms:.4f} ms; bound {bound:.4f} ms ({by})",
                  flush=True)
            cases.append((kernel, (b, l, c), k, d, x, w, ref64, ref32))
        names = list(BF16_VARIANTS if args.bf16 else VARIANTS)
        for rnd in range(args.rounds):
            for name in (names if rnd % 2 == 0 else names[::-1]):
                for kernel, (b, l, c), k, d, x, w, ref64, ref32 in cases:
                    fn = variant_fn(kernel, libs[kernel, name], d)
                    got = fn(x, w)
                    torch.cuda.synchronize()
                    err64 = float((got.double() - ref64).abs().max())
                    if args.bf16:
                        steps = kernels.bf16_steps(got, ref64)
                        check = (f"{steps:.3f} bf16 steps, step "
                                 f"{'ok' if steps <= 1 else 'FAILS'}")
                    else:
                        ok = torch.allclose(got, ref32, **TOL)
                        check = f"TOL {'ok' if ok else 'FAILS'}"
                    ms = events_ms(lambda fn=fn, x=x, w=w: fn(x, w))
                    print(f"round {rnd} {kernel:14s} {name:8s} [{b}, {l}, {c}] K={k} "
                          f"d={d}: {ms:.4f} ms, against float64 {err64:.3e}, "
                          f"{check}", flush=True)
                    del got
        del cases
        if args.bf16:
            direct_against_fold(libs, gen)
    print(card_line(torch.device("cuda", 0)))


if __name__ == "__main__":
    main()
