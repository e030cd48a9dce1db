#!/usr/bin/env python3
"""Drive the PyTorch port (``mlx_audio_tpu_torch``) on one NVIDIA GPU:
Kokoro-82M synthesis, CSM-1B speech through int8 decode (whole and
streamed), the depth-draft probes, and check its hand-written CUDA
kernels.

    python3 chip_smoke.py

Phases; the failure of any one ends the script with a non-zero exit:

1. print the card (``nvidia-smi``), torch and CUDA versions; build the eight
   kernels from ``mlx_audio_tpu_torch/csrc/`` with ``nvcc`` for ``sm_90a``
   into ``mlx_audio_tpu_torch/csrc/build/`` (one ``nvcc`` each, together);
2. hold every kernel against its plain PyTorch version on the card at the
   main paths' shapes (float32, TF32 off): the three Kokoro-82M kernels
   (``dilated_conv1d`` and ``banded_conv1d`` compute in 3xTF32 on the
   tensor cores and print that bound beside the float32-FMA one, and their
   error against a float64 run of the plain version),
   ``quantized_matmul`` at every projection of CSM-1B's path (int8, 1 to
   128 rows; int4 at the llama-1B ones) and ``depth_draft`` on a full
   llama-100M pack (greedy and sampled, tokens equal), and the three
   depth-draft probes at the full probe shape (4 layers x 1024 x 28672,
   chunks of 4096, 30 steps; every mode in int8, the stream modes in bf16
   too; results equal); time kernel, plain version and one library call
   (``quantized_matmul``'s operands cold in L2), check that every row of
   a 2-, 8- and 32-row ``quantized_matmul`` equals the 1-row call on it bit
   for bit, and print where the kernel and the dequantize-and-matmul path
   cross;
   then run the probes' entry point (``scripts/probe_depth.py``, every
   mode, int8 and bf16);
3. run Kokoro-82M's ``Model.generate``, ``Model.generate_batch`` and
   ``Model.synthesize_batch`` at full width with seeded random weights;
4. run the Kokoro bench-shaped pass (batch 8, phoneme bucket 512, frame
   bucket 1300, durations capped at alternating 2/3) through
   ``duration_stage`` and ``synthesis_stage``, median of 5 synced
   iterations, then one more iteration under ``torch.profiler``;
5. CSM-1B at full width (llama-1B backbone, llama-100M depth decoder,
   Mimi with 32 codebooks, seeded random weights, ``quantize_model`` to
   int8 in groups of 128, a stub tokenizer, 2 s of seeded reference audio):
   greedy ``generate`` without and with ``enable_spec_decode()`` (the frames
   must be equal), the same with ``stream=True`` (chunks of 3, 4, then 6
   frames through the stateful Mimi decoder; frames equal, audio within
   1e-3; time to first audio and each chunk's real-time factor),
   ``generate_batch`` of 4 texts, and one sampled ``generate`` with spec
   decode; ``quantized_matmul`` held against its
   plain version on the operands of its first call at each (rows, I, O)
   these runs gave it; then a timed breakdown (prefill, frame loop, Mimi)
   and a ``torch.profiler`` view of the spec-decode frame loop, with
   ``quantized_matmul``'s calls and device time in it;
6. print one ``{"kernels": [...]}`` line, then the device line last.

Launch counters are set to 0 just before each run of the probes' entry
point and of phases 3 to 5, and read just after: each kernel of a run's
path must have launched in it.  Needs
one CUDA card and the repository checkout around this file; it imports
nothing of JAX.
"""

from __future__ import annotations

import itertools
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# Published peaks of one H100 SXM (NVIDIA data sheet): float32 outside the
# tensor cores, dense TF32 and int8 tensor-core operations, and HBM3
# bandwidth.  The port's kernels run float32 FMAs, depth_draft int8 dot
# products, and the two conv kernels 3xTF32: three TF32 products a float32
# multiply-add, so their float32 rate is a third of the TF32 peak.
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_3XTF32_FLOPS = PEAK_TF32_FLOPS / 3
PEAK_INT8_OPS = 1979e12
PEAK_BYTES_PER_S = 3.35e12

TOL = {"atol": 1e-4, "rtol": 1e-4}  # as tests/test_pallas_ops.py uses

KERNEL_INFO = {
    "lstm": ("mlx_audio_tpu_torch/csrc/lstm.cu",
             "mlx_audio_tpu/nn/pallas_ops.py:70"),
    "dilated_conv1d": ("mlx_audio_tpu_torch/csrc/dilated_conv1d.cu",
                       "mlx_audio_tpu/nn/pallas_ops.py:259"),
    "banded_conv1d": ("mlx_audio_tpu_torch/csrc/banded_conv1d.cu",
                      "mlx_audio_tpu/nn/pallas_ops.py:353"),
    "quantized_matmul": ("mlx_audio_tpu_torch/csrc/quantized_matmul.cu",
                         "mlx_audio_tpu/nn/pallas_ops.py:170"),
    "depth_draft": ("mlx_audio_tpu_torch/csrc/depth_draft.cu",
                    "mlx_audio_tpu/nn/pallas_depth.py:424"),
    "probe_depth": ("mlx_audio_tpu_torch/csrc/probe_depth.cu",
                    "scripts/probe_depth.py:63"),
    "probe_vpu": ("mlx_audio_tpu_torch/csrc/probe_vpu.cu",
                  "scripts/probe_depth.py:148"),
    "probe_auto": ("mlx_audio_tpu_torch/csrc/probe_auto.cu",
                   "scripts/probe_depth.py:177"),
}
# the kernels each main-path run must launch
KOKORO_KERNELS = ("lstm", "dilated_conv1d", "banded_conv1d")
PROBE_KERNELS = ("probe_depth", "probe_vpu", "probe_auto")

# Kokoro phoneme alphabet text: the pipeline's fallback G2P passes it
# through unchanged.
TEXT = ("həlˈoʊ wˈɜɹld. ðɪs ɪz ɐ tˈɛst ʌv ðə pˈɔɹt.\n\n"
        "kəkˈoʊɹoʊ spˈiːks ɪn tˈuː pˈæɹəɡɹæfs, ænd ðə sˈɛkənd ɪz lˈɔŋɡɚ "
        "ðæn ðə fˈɜːst wˌʌn.")
BATCH_TEXTS = [
    "ɐ ʃˈɔːɹt wˈʌn.",
    "ðə mˈiːdiəm sˈɛntəns hæz mˈɔːɹ wˈɜːdz ɪn ɪt.",
    "ðɪs ɪz ðə lˈɔŋɡəst ʌv ðə θɹˈiː tˈɛksts, wɪð kˈɑːməz ænd ɐ pˈiːɹiəd.",
]
SPEED = 8.0  # random-weight durations stay inside a few hundred frames
BENCH_BATCH, N_BUCKET, F_BUCKET = 8, 512, 1300  # bench.py's shape


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def median_ms(fn, reps: int) -> float:
    """Median device time of ``fn`` in ms, CUDA events around each call,
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def queued_ms(fns, reps: int) -> float:
    """Device time of one call in ms: at least ``reps`` calls queued behind
    a sleeping kernel, so that the host's launch cost does not leave the
    card idle between them, and CUDA events around the whole run.  ``fns``
    is one call, or a list of the same call on distinct copies of its
    operands, taken in turn (each once per round), so that a call finds
    its operands cold in L2 as a decode step does."""
    fns = list(fns) if isinstance(fns, (list, tuple)) else [fns]
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


# an operand set of at least this many bytes, read in turn, leaves none of
# it in the H100's 50 MB L2 when its turn comes again
COLD_BYTES = 2 * 50 * 2 ** 20


def cold_copies(nbytes: int) -> int:
    return max(1, -(-COLD_BYTES // nbytes))


def bound_ms(flops: float, nbytes: float,
             peak_ops: float = PEAK_F32_FLOPS) -> tuple[float, str]:
    t_ops = flops / peak_ops
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------


def build_kernels() -> None:
    from mlx_audio_tpu_torch import build

    t0 = time.perf_counter()
    logs = build.build()
    print(f"built {', '.join(logs)} in {time.perf_counter() - t0:.1f} s "
          f"into {build.BUILD_DIR.relative_to(ROOT)}")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------


def _lstm_cases(gen):
    from mlx_audio_tpu_torch.nn import kernels

    b, h = 8, 256
    for t in (512, 1300):
        for reverse in (False, True):
            x_proj = torch.randn(b, t, 4 * h, generator=gen, device="cuda") * 0.3
            w_h = torch.randn(4 * h, h, generator=gen, device="cuda") * 0.1
            # the reverse direction is the forward recurrence over flipped
            # time, as nn.recurrent.lstm_scan runs it
            xp = (x_proj.flip(1) if reverse else x_proj).contiguous()
            wh = w_h.t().contiguous()
            h0 = torch.zeros(b, h, device="cuda")
            lib = torch.nn.LSTM(4 * h, h, batch_first=True).cuda()
            with torch.no_grad():
                # identity input weight: the library LSTM then computes the
                # same function of x_proj
                lib.weight_ih_l0.copy_(torch.eye(4 * h))
                lib.weight_hh_l0.copy_(w_h)
                lib.bias_ih_l0.zero_()
                lib.bias_hh_l0.zero_()
            yield {
                "kernel": "lstm",
                "shape": f"B={b} T={t} H={h} {'reverse' if reverse else 'forward'}",
                "kernel_fn": lambda xp=xp, wh=wh, h0=h0: kernels.lstm(xp, wh, h0, h0),
                "plain_fn": lambda xp=xp, wh=wh, h0=h0:
                    kernels.lstm_plain(xp, wh, h0, h0),
                "library_fn": lambda lib=lib, xp=xp: lib(xp),
                "flops": 2.0 * b * t * h * 4 * h,
                "bytes": 4.0 * (b * t * 4 * h + 4 * h * h + 2 * b * h
                                + 2 * b * t * h + 2 * b * h),
            }


def _conv_cases(gen):
    import torch.nn.functional as F

    from mlx_audio_tpu_torch.nn import kernels
    from mlx_audio_tpu_torch.nn.layers import _dilated_conv1d_residue

    shifted = [((2, 26000, 256), 3, d) for d in (1, 3, 5)]
    shifted.append(((2, 156001, 128), 3, 1))
    banded = [((2, 26000, 256), 7, 1), ((2, 156001, 128), 11, 1),
              ((2, 26000, 256), 7, 3), ((2, 156001, 128), 11, 3)]
    cases = [("dilated_conv1d", s, k, d) for s, k, d in shifted]
    cases += [("banded_conv1d", s, k, d) for s, k, d in banded]
    for name, (b, l, c), k, d in cases:
        x = torch.randn(b, l, c, generator=gen, device="cuda") * 0.3
        w = torch.randn(k, c, c, generator=gen, device="cuda") * 0.05
        x_ncl = x.transpose(1, 2).contiguous()
        w_lib = w.permute(2, 1, 0).contiguous()
        pad = (k - 1) * d // 2
        if name == "dilated_conv1d":
            def kern(x=x, w=w, d=d):
                return kernels.dilated_conv1d(x, w, d)

            def plain(x=x, w=w, d=d):
                return kernels.dilated_conv1d_plain(x, w, d)
        elif d == 1:
            def kern(x=x, w=w):
                return kernels.banded_conv1d(x, w)

            def plain(x=x, w=w):
                return kernels.banded_conv1d_plain(x, w)
        else:
            def kern(x=x, w=w, d=d):
                return _dilated_conv1d_residue(x, w, d, kernels.banded_conv1d)

            def plain(x=x, w=w, d=d):
                return _dilated_conv1d_residue(x, w, d,
                                               kernels.banded_conv1d_plain)
        yield {
            "kernel": name,
            "shape": f"[{b}, {l}, {c}] K={k} d={d}"
                     + (" residue fold" if name == "banded_conv1d" and d > 1 else ""),
            "kernel_fn": kern, "plain_fn": plain,
            "library_fn": lambda x=x_ncl, w=w_lib, p=pad, d=d:
                F.conv1d(x, w, None, 1, p, d),
            "flops": 2.0 * b * l * c * c * k,
            "bytes": 4.0 * (2 * b * l * c + k * c * c),
            # both conv kernels run 3xTF32 on the tensor cores: the
            # float32-FMA bound is printed beside that one, and the kernel's
            # error and the plain version's against the plain version in
            # float64
            "peak_ops": PEAK_3XTF32_FLOPS, "f32_fma_bound": True,
            "float64_fn": (
                (lambda x=x, w=w, d=d: kernels.dilated_conv1d_plain(
                    x.double(), w.double(), d))
                if name == "dilated_conv1d" else
                (lambda x=x, w=w, d=d: _dilated_conv1d_residue(
                    x.double(), w.double(), d, kernels.banded_conv1d_plain))),
        }


# (I, O) of every QuantizedLinear on CSM-1B's path: the llama-1B backbone's
# and the llama-100M depth decoder's projections (q, k, v and o apart), the
# backbone-to-decoder projection and the codebook-0 head (2051 columns, the
# last tile part empty)
QMM_SHAPES = (((2048, 2048), "llama-1B q, o"), ((2048, 512), "llama-1B k, v"),
              ((2048, 8192), "llama-1B gate, up"), ((8192, 2048), "llama-1B down"),
              ((1024, 1024), "llama-100M q, o"), ((1024, 256), "llama-100M k, v"),
              ((1024, 8192), "llama-100M gate, up"), ((8192, 1024), "llama-100M down"),
              ((2048, 1024), "projection"), ((2048, 2051), "codebook0_head"))
# decode steps (1 row a step, 2 at a frame's first depth step, 4 and 8 in a
# batch of 4), the 32-row verify pass, and enough row counts between them
# and a 128-row prefill to place the kernel's crossover with the plain path
QMM_ROWS = (1, 8, 16, 32, 48, 64, 128)
QMM_ROWS_INT4 = (1, 8, 128)


def _qmm_cases(gen):
    """quantized_matmul at every (I, O) of CSM-1B's path in int8, and at
    the llama-1B ones in int4, groups of 128.  Timed calls take the codes
    (and the library's dense weight) from enough distinct copies to be
    cold in L2.  The library call is one cuBLAS matmul against the weight
    dequantized ahead of time."""
    from mlx_audio_tpu_torch.nn import kernels
    from mlx_audio_tpu_torch.nn.layers import Linear
    from mlx_audio_tpu_torch.nn.quantize import QuantizedLinear

    for (i, o), role in QMM_SHAPES:
        for bits in (8, 4):
            if bits == 4 and not role.startswith("llama-1B"):
                continue
            lin = Linear(i, o, bias=False)
            lin.weight.data = torch.randn(o, i, generator=gen, device="cuda") * i ** -0.5
            q = QuantizedLinear.from_linear(lin, group_size=128, bits=bits)
            dense = q.to_linear().weight.data.cuda()
            qbytes = q.weight.numel() + 4 * (q.scales.numel() + q.biases.numel())
            sets = [(q.weight.clone(), q.scales.clone(), q.biases.clone())
                    for _ in range(cold_copies(qbytes))]
            denses = [dense.clone() for _ in range(cold_copies(4 * dense.numel()))]
            parts, _ = kernels.quantized_matmul_parts(i, o, 128, q.packed)
            for b in (QMM_ROWS if bits == 8 else QMM_ROWS_INT4):
                x = torch.randn(b, i, generator=gen, device="cuda")
                kern = [lambda a=(x, *w, 128, q.packed): kernels.quantized_matmul(*a)
                        for w in sets]
                plain = [lambda a=(x, *w, 128, q.packed): kernels.quantized_matmul_plain(*a)
                         for w in sets]
                lib = [lambda x=x, w=w: x @ w.t() for w in denses]
                yield {
                    "kernel": "quantized_matmul", "queued": True, "rows": b,
                    "bits": bits, "io": (i, o),
                    "shape": f"B={b} I={i} O={o} int{bits} gs128 parts {parts} ({role})",
                    "kernel_fn": kern[0], "plain_fn": plain[0], "library_fn": lib[0],
                    "timed": (kern, plain, lib),
                    "flops": 2.0 * b * i * o,
                    "bytes": qbytes + 4 * b * (i + o),
                }


def qmm_row_independence(gen) -> None:
    """Each row of a 2-, 8- and 32-row quantized_matmul equals, bit for bit,
    the 1-row call on that row (the kernel sums in one order whatever the
    row count), at every int8 shape of QMM_SHAPES and at llama-1B's q, o in
    int4, groups of 128."""
    from mlx_audio_tpu_torch.nn import kernels
    from mlx_audio_tpu_torch.nn.layers import Linear
    from mlx_audio_tpu_torch.nn.quantize import QuantizedLinear

    shapes = [(io, 8) for io, _ in QMM_SHAPES] + [(QMM_SHAPES[0][0], 4)]
    for (i, o), bits in shapes:
        lin = Linear(i, o, bias=False)
        lin.weight.data = torch.randn(o, i, generator=gen, device="cuda") * i ** -0.5
        q = QuantizedLinear.from_linear(lin, group_size=128, bits=bits)
        w = (q.weight, q.scales, q.biases, 128, q.packed)
        x = torch.randn(32, i, generator=gen, device="cuda")
        ones = torch.cat([kernels.quantized_matmul(x[r:r + 1], *w) for r in range(32)])
        for rows in (2, 8, 32):
            got = kernels.quantized_matmul(x[:rows], *w)
            if not torch.equal(got, ones[:rows]):
                n = int((got != ones[:rows]).any(1).sum())
                fail(f"quantized_matmul I={i} O={o} int{bits}: {n} of {rows} "
                     "rows differ from the 1-row calls on them")
    print("quantized_matmul rows independent: every row of 2-, 8- and 32-row "
          "calls equals the 1-row call bit for bit, at "
          + ", ".join(f"I={i} O={o} int{b}" for (i, o), b in shapes), flush=True)


def _draft_cases(gen):
    """depth_draft on a full llama-100M pack (CSM's depth decoder: 4 layers,
    Dm 1024, F 8192, 8 query and 2 key/value heads of 128, 31 heads of 2051
    codes), greedy and at temperature 0.9 / top-k 50 on fixed noise."""
    from mlx_audio_tpu_torch.models.lm.llama import LLAMA_FLAVORS, LlamaModel
    from mlx_audio_tpu_torch.models.sampling import gumbel
    from mlx_audio_tpu_torch.nn import kernels
    from mlx_audio_tpu_torch.nn.pallas_depth import depth_draft_plain, pack_depth

    cfg = LLAMA_FLAVORS["llama-100M"]
    nc, vocab, db = 32, 2051, 2048
    with torch.device("cuda"):
        dec = LlamaModel(cfg, use_embed_tokens=False)
    for m in dec.modules():
        if hasattr(m, "init_weights"):
            m.init_weights(gen)
    dm = cfg.hidden_size
    packed = pack_depth(
        dec, torch.randn(db, dm, generator=gen, device="cuda") * db ** -0.5,
        torch.randn(nc - 1, dm, vocab, generator=gen, device="cuda") * dm ** -0.5,
        torch.rand(nc * vocab, db, generator=gen, device="cuda") * 2 - 1, vocab)
    del dec
    shape = (cfg.num_hidden_layers, cfg.num_key_value_heads, 40, cfg.head_dim)
    kc, vc = torch.zeros(shape, device="cuda"), torch.zeros(shape, device="cuda")
    kc[:, :, :2] = torch.randn(*shape[:2], 2, shape[3], generator=gen, device="cuda")
    vc[:, :, :2] = torch.randn(*shape[:2], 2, shape[3], generator=gen, device="cuda")
    n_steps, vpad = nc - 2, packed.heads.shape[1]
    c1 = torch.tensor(17, device="cuda")
    weights = sum(t.numel() * t.element_size() for t in (
        packed.wqkv, packed.sqkv, packed.wo, packed.so, packed.wgu, packed.sgu,
        packed.wdown, packed.sdown, packed.norms, packed.final_norm))
    head = (packed.heads[0].numel() + 4 * packed.sheads[0].numel()
            + 2 * packed.emb_proj.shape[-1])
    macs = (packed.wqkv.numel() + packed.wo.numel() + packed.wgu.numel()
            + packed.wdown.numel() + packed.heads[0].numel())
    for temp, top_k in ((0.0, 0), (0.9, 50)):
        noise = (gumbel((n_steps, vpad), gen, "cuda") if temp > 0
                 else torch.zeros(n_steps, vpad, device="cuda"))
        args = (packed, kc, vc, c1, noise, vocab, temp, top_k)
        yield {
            "kernel": "depth_draft", "exact": True, "queued": True,
            "plain_host_bound": True,  # thousands of small launches
            "shape": f"llama-100M, {n_steps} steps, temp {temp} top_k {top_k}",
            "kernel_fn": lambda a=args: kernels.depth_draft(*a),
            "plain_fn": lambda a=args: depth_draft_plain(*a),
            "library_fn": None,
            # every step streams all layers' int8 weights and scales, one
            # head and one embedding row; the caches, noise and tokens once
            "flops": 2.0 * macs * n_steps,
            "bytes": (n_steps * (weights + head) + 2 * 4 * kc.numel()
                      + 4 * noise.numel() + 4 * n_steps),
            "peak_ops": PEAK_INT8_OPS,
        }


# The depth-draft probes' shape (scripts/probe_depth.py's defaults): one
# draft step streams 4 layers of [1024, 28 * 1024] weights in chunks of 4096
# columns, 30 steps a run
PROBE_LAYERS, PROBE_DM, PROBE_COLS, PROBE_CHUNK, PROBE_STEPS = 4, 1024, 28 * 1024, 4096, 30
# CUDA-core int8 rate, derived: the data sheet's 67 TFLOP/s of float32 FMAs
# is one FMA a lane a clock; one dp4a (4 multiply-adds, 8 operations) a lane
# a clock is assumed, four times that rate
PEAK_DP4A_OPS = 4 * PEAK_F32_FLOPS


def _probe_cases(gen):
    """The three probe kernels at the full probe shape: the stream modes in
    int8 and bf16, mxu and vpu in int8; results equal to the plain
    versions'.  Library calls, each timed once and counted as many times as
    the probe repeats its work: an int64 torch.sum over one step's weights
    (x 30, the stream modes), torch._int_mm of x padded to 32 rows with the
    resident chunk (x 840, mxu), an f32 torch.matmul of x with it (x 840,
    vpu)."""
    from mlx_audio_tpu_torch.nn import kernels

    w8 = torch.randint(-127, 127, (PROBE_LAYERS, PROBE_DM, PROBE_COLS),
                       generator=gen, device="cuda", dtype=torch.int8)
    x = torch.randint(-127, 127, (1, PROBE_DM), generator=gen, device="cuda",
                      dtype=torch.int8)
    x3 = torch.randint(-127, 127, (PROBE_DM // 8, 8, 128), generator=gen,
                       device="cuda", dtype=torch.int8)
    steps, reps = PROBE_STEPS, PROBE_LAYERS * PROBE_COLS // PROBE_CHUNK
    for dtype in (torch.int8, torch.bfloat16):
        w = w8 if dtype == torch.int8 else w8.to(dtype)
        chunked = kernels.chunked_layout(w, PROBE_CHUNK)
        streamed = steps * w.numel() * w.element_size()
        plain = lambda c=chunked: kernels.probe_stream_plain(c, steps)  # noqa: E731
        library = lambda w=w: w.sum(dtype=torch.int64)  # noqa: E731
        name = "int8" if dtype == torch.int8 else "bf16"
        for mode in ("dma", "dmac", "dma8", "dmabig", "auto"):
            if mode == "auto":
                kern = lambda c=chunked: kernels.probe_auto(c, steps)  # noqa: E731
            elif mode == "dma":
                kern = lambda w=w: kernels.probe_depth(w, None, "dma", steps, PROBE_CHUNK)  # noqa: E731
            else:
                kern = lambda c=chunked, m=mode: kernels.probe_depth(c, None, m, steps)  # noqa: E731
            yield {
                "kernel": "probe_auto" if mode == "auto" else "probe_depth",
                "exact": True, "rule": "results equal", "shape": f"{mode} {name}, 4 x 1024 x 28672, 30 steps",
                "kernel_fn": kern, "plain_fn": plain, "library_fn": library,
                "library_repeat": steps, "flops": 0.0, "bytes": float(streamed)}
        del chunked
    chunked = kernels.chunked_layout(w8, PROBE_CHUNK)
    chunk0 = chunked[0].contiguous()
    xvec = x3[:, :, 0].reshape(-1)
    dot_ops = 2.0 * PROBE_DM * PROBE_CHUNK * reps * steps
    x32 = torch.zeros(32, PROBE_DM, device="cuda", dtype=torch.int8)
    x32[0] = x[0]
    yield {
        "kernel": "probe_depth", "exact": True, "rule": "results equal",
        "shape": f"mxu int8, {reps} matvecs [1, 1024] @ [1024, 4096] a step, 30 steps",
        "kernel_fn": lambda: kernels.probe_depth(chunked, x, "mxu", steps),
        "plain_fn": lambda: kernels.probe_dot_plain(chunk0, x, reps * steps),
        "library_fn": lambda: torch._int_mm(x32, chunk0), "library_repeat": reps * steps,
        "flops": dot_ops, "bytes": float(chunk0.numel() + PROBE_DM + 8),
        "peak_ops": PEAK_INT8_OPS}
    xf, cf = xvec.float()[None], chunk0.float()
    w3 = chunk0.reshape(PROBE_DM // 8, 8, PROBE_CHUNK)
    yield {
        "kernel": "probe_vpu", "exact": True, "rule": "results equal",
        "shape": f"vpu int8, {reps} matvecs [1, 1024] @ [1024, 4096] a step, 30 steps",
        "kernel_fn": lambda: kernels.probe_vpu(w3, x3, steps, reps),
        "plain_fn": lambda: kernels.probe_dot_plain(chunk0, xvec, reps * steps),
        "library_fn": lambda: torch.matmul(xf, cf), "library_repeat": reps * steps,
        "flops": dot_ops, "bytes": float(chunk0.numel() + PROBE_DM + 8),
        "peak_ops": PEAK_DP4A_OPS}


def _outputs(res):
    if isinstance(res, torch.Tensor):
        return [res]
    out = []
    for r in res:
        out.extend(_outputs(r))
    return out


def check_kernels() -> dict:
    """Phase 2: every kernel against its plain version at the main path's
    shapes.  Returns per-kernel records for the kernels line."""
    from mlx_audio_tpu_torch.nn import kernels

    gen = torch.Generator(device="cuda").manual_seed(0)
    records = {name: [] for name in KERNEL_INFO}
    bad = []
    cases = itertools.chain(_lstm_cases(gen), _conv_cases(gen), _qmm_cases(gen),
                            _draft_cases(gen), _probe_cases(gen))
    for case in cases:
        name = case["kernel"]
        before = kernels.LAUNCHES[name]
        got = _outputs(case["kernel_fn"]())
        torch.cuda.synchronize()
        if kernels.LAUNCHES[name] == before:
            bad.append(f"{name} {case['shape']}: kernel not launched")
        ref = _outputs(case["plain_fn"]())
        err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        if case.get("exact"):
            ok = all(torch.equal(g, r) for g, r in zip(got, ref))
        else:
            ok = all(torch.allclose(g, r, **TOL) for g, r in zip(got, ref))
        # short kernels are timed queued (device time); the Kokoro cases keep
        # the per-call median of earlier runs
        timer = queued_ms if case.get("queued") else median_ms
        kern_t, plain_t, lib_t = case.get(
            "timed", (case["kernel_fn"], case["plain_fn"], case["library_fn"]))
        ms = timer(kern_t, 10)
        plain_ms = (median_ms if case.get("plain_host_bound") else timer)(
            plain_t, 3)
        library_ms = None
        if lib_t is not None:
            with torch.no_grad():
                library_ms = timer(lib_t, 10) * case.get("library_repeat", 1)
        bms, by = bound_ms(case["flops"], case["bytes"],
                           case.get("peak_ops", PEAK_F32_FLOPS))
        rec = {"shape": case["shape"], "max_abs_err": err, "ok": ok,
               "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
               "bound_by": by, "library_ms": library_ms,
               **{k: case[k] for k in ("rows", "bits", "io") if k in case}}
        bound = f"bound {bms:.4f} ms ({by})"
        if case.get("f32_fma_bound"):
            rec["bound_f32_fma_ms"] = bound_ms(case["flops"], case["bytes"])[0]
            bound = (f"bound 3xTF32 {bms:.4f} ms ({by}), float32 FMA "
                     f"{rec['bound_f32_fma_ms']:.4f} ms")
        if "float64_fn" in case:
            exact = case["float64_fn"]()
            rec["max_abs_err_f64"] = float((got[0].double() - exact).abs().max())
            rec["plain_max_abs_err_f64"] = float((ref[0].double() - exact).abs().max())
            bound += (f"; against float64: kernel {rec['max_abs_err_f64']:.3e}, "
                      f"plain {rec['plain_max_abs_err_f64']:.3e}")
            del exact
        records[name].append(rec)
        lib = "—" if library_ms is None else f"{library_ms:.3f} ms"
        rule = case.get("rule", "tokens equal") if case.get("exact") else \
            f"atol {TOL['atol']}, rtol {TOL['rtol']}"
        print(f"{name:16s} {case['shape']:52s} max_abs_err {err:.3e} "
              f"({rule}) {'ok' if ok else 'DISAGREES'}  kernel {ms:.3f} ms  "
              f"plain {plain_ms:.3f} ms  library {lib}  {bound}", flush=True)
        if not ok:
            bad.append(f"{name} {case['shape']}: max_abs_err {err:.3e}")
        del got, ref, case
        torch.cuda.empty_cache()
    if bad:
        fail("kernel check: " + "; ".join(bad))
    qmm_row_independence(gen)
    qmm_crossover(records["quantized_matmul"])
    return records


def qmm_crossover(recs) -> None:
    """Where QuantizedLinear's two paths cross on this card: per int8 shape,
    the most rows at which the kernel is no slower than the plain path it
    takes above ``KERNEL_MAX_ROWS`` (dequantize, then one matmul)."""
    from mlx_audio_tpu_torch.nn.quantize import KERNEL_MAX_ROWS

    wins = {}
    for r in recs:
        if r["bits"] == 8:
            rows = wins.setdefault(r["io"], [])
            if r["ms"] <= r["plain_ms"]:
                rows.append(r["rows"])
    best = {io: max(rows, default=0) for io, rows in wins.items()}
    print("quantized_matmul crossover (int8, most rows at which the kernel is "
          "no slower than dequantize-and-matmul): "
          + ", ".join(f"I={i} O={o}: {n}" for (i, o), n in best.items())
          + f"; every shape: {min(best.values())}; KERNEL_MAX_ROWS "
          f"{KERNEL_MAX_ROWS}", flush=True)


def drive_probes(launches: dict) -> None:
    """The probes' entry point (``mlx_audio_tpu_torch.scripts.probe_depth``)
    at its defaults: every mode in int8, then every mode but mxu in bf16.
    Every stream mode must give one result in both runs (same draws)."""
    from mlx_audio_tpu_torch.nn import kernels
    from mlx_audio_tpu_torch.scripts import probe_depth

    stream_sums = set()
    for dtype in ("int8", "bf16"):
        modes = [m for m in probe_depth.MODES if dtype == "int8" or m != "mxu"]
        torch.cuda.synchronize()
        kernels.reset_launches()
        records = probe_depth.run(modes, iters=5, dtype=dtype, device="cuda")
        torch.cuda.synchronize()
        launches[f"probes_{dtype}"] = dict(kernels.LAUNCHES)
        missing = [k for k in PROBE_KERNELS if launches[f"probes_{dtype}"][k] == 0]
        if missing:
            fail(f"probe entry point ({dtype}): kernels never launched: {missing}")
        stream_sums |= {r["checksum"] for r in records if r["mode"] not in ("mxu", "vpu")}
    if len(stream_sums) != 1:
        fail(f"probe entry point: stream modes disagree: {sorted(stream_sums)}")


# ---------------------------------------------------------------------------
# phases 3 and 4
# ---------------------------------------------------------------------------


def drive_entry_points(model, voice_path: str) -> None:
    """Phase 3: the user-facing entry points at full width."""
    results = list(model.generate(TEXT, voice=voice_path, speed=SPEED))
    if len(results) != 2:
        fail(f"generate: expected 2 segments, got {len(results)}")
    for r in results:
        if not (r.samples > 0 and r.samples % 600 == 0
                and np.isfinite(r.audio).all()):
            fail(f"generate: segment {r.segment_idx} has {r.samples} samples")
    batch = model.generate_batch(BATCH_TEXTS, voice=voice_path, speed=SPEED)
    if len(batch) != len(BATCH_TEXTS):
        fail("generate_batch: one result per text expected")
    for r in batch:
        if not (r.samples > 0 and r.samples % 600 == 0
                and np.isfinite(r.audio).all()):
            fail(f"generate_batch: text {r.segment_idx} has {r.samples} samples")
    pack = np.load(voice_path)
    refs = np.stack([pack[len(t) - 1].reshape(-1) for t in BATCH_TEXTS])
    outs = model.synthesize_batch(BATCH_TEXTS, refs, speeds=SPEED)
    for (audio, dur), r in zip(outs, batch):
        frames = int(dur.sum())
        if audio.shape != (frames * 600,) or not np.isfinite(audio).all():
            fail(f"synthesize_batch: {audio.shape} samples for {frames} frames")
        if audio.shape[0] != r.samples:
            fail("synthesize_batch and generate_batch disagree on length")
    print("entry points: generate "
          + ", ".join(f"{r.samples} samples" for r in results)
          + "; generate_batch "
          + ", ".join(f"{r.samples} samples" for r in batch), flush=True)


def bench_runner(model):
    """The shape bench.py measures, in float32: returns run_once(seed) ->
    (audio, total, duration-stage seconds, synthesis-stage seconds)."""
    from mlx_audio_tpu_torch.models.tts.kokoro.model import (
        duration_stage,
        synthesis_stage,
    )

    rng = np.random.default_rng(0)
    dev = model.device
    input_ids = torch.as_tensor(
        rng.integers(1, model.config.n_token, size=(BENCH_BATCH, N_BUCKET)),
        dtype=torch.long, device=dev)
    lengths = torch.full((BENCH_BATCH,), N_BUCKET, dtype=torch.long, device=dev)
    ref_s = torch.as_tensor(rng.standard_normal((BENCH_BATCH, 256)) * 0.1,
                            dtype=torch.float32, device=dev)
    speed = torch.ones(BENCH_BATCH, device=dev)
    # alternating 2/3 frames per phoneme: 1280 frames in the 1300 bucket
    caps = 2 + (torch.arange(N_BUCKET, device=dev) % 2)[None, :]

    @torch.no_grad()
    def run_once(seed):
        t0 = time.perf_counter()
        d, pred_dur = duration_stage(model, input_ids, lengths,
                                     ref_s[:, 128:], speed)
        pred_dur = torch.minimum(pred_dur, caps)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        audio, total = synthesis_stage(model, input_ids, lengths, d, pred_dur,
                                       ref_s, F_BUCKET, seed=seed)
        torch.cuda.synchronize()
        return audio, total, t1 - t0, time.perf_counter() - t1

    return run_once


def bench_pass(run_once, iters: int = 5) -> dict:
    """Phase 4: one warm-up call, then the median of ``iters`` synced
    iterations."""
    audio, total, _, _ = run_once(1_000_001)
    if not (audio.shape == (BENCH_BATCH, F_BUCKET * 600)
            and bool(torch.isfinite(audio).all())):
        fail(f"bench pass: audio {tuple(audio.shape)} not finite or misshaped")
    per_iter, stages = [], []
    for i in range(iters):
        t0 = time.perf_counter()
        audio, total, t_dur, t_syn = run_once(i)
        per_iter.append(time.perf_counter() - t0)
        stages.append((t_dur, t_syn))
    audio_s = float(total.sum()) * 600 / 24000
    med = statistics.median(per_iter)
    return {"calls": iters + 1, "audio_seconds_per_iter": audio_s,
            "iter_s": per_iter,
            "median_s": med, "audio_seconds_per_second": audio_s / med,
            "duration_stage_s": statistics.median(t for t, _ in stages),
            "synthesis_stage_s": statistics.median(t for _, t in stages),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}


KERNEL_GROUPS = (("lstm_kernel", "lstm (this repo)"),
                 ("dilated_conv1d_kernel", "dilated_conv1d (this repo)"),
                 ("banded_conv1d_kernel", "banded_conv1d (this repo)"),
                 ("gemm", "cuBLAS / cuDNN"), ("xmma", "cuBLAS / cuDNN"),
                 ("conv", "cuBLAS / cuDNN"), ("elementwise", "elementwise"),
                 ("scan", "scan (cumsum)"), ("reduce", "reduction"))


def device_time(prof):
    """From a torch.profiler run: (device-busy us, us from the first kernel's
    start to the last one's end, {kernel name: (ms, launches)})."""
    from torch.autograd import DeviceType

    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        tot, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + (end - start) / 1e3, n + 1)
    if not spans:
        return 0.0, 0.0, {}
    spans.sort()
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s_, e_ in spans[1:]:
        if s_ > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s_, e_
        else:
            cur_e = max(cur_e, e_)
    busy += cur_e - cur_s
    return busy, spans[-1][1] - spans[0][0], by_name


def profile_pass(run_once) -> None:
    """One bench iteration under torch.profiler: device time by kernel
    group and by kernel, and the device's idle share between the first and
    the last kernel."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_once(7)
        wall = time.perf_counter() - t0
    busy, window, by_name = device_time(prof)
    if not by_name:
        print("profile: the profiler recorded no device time (not measured)")
        return
    groups = {}
    for name, (ms, n) in by_name.items():
        group = next((g for key, g in KERNEL_GROUPS if key in name), "other")
        groups[group] = groups.get(group, 0.0) + ms
    device_ms = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    print(f"profile of one bench iteration: wall {1e3 * wall:.1f} ms, device "
          f"busy {busy / 1e3:.1f} ms of a {window / 1e3:.1f} ms kernel window "
          f"(idle share {1 - busy / window:.4f})")
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {group:28s} {ms:10.2f} ms  {ms / device_ms:7.2%}")
    for name, (ms, n) in top:
        print(f"  {ms:10.2f} ms {n:6d}x  {name[:90]}")


# ---------------------------------------------------------------------------
# phase 5: CSM-1B
# ---------------------------------------------------------------------------

CSM_CONFIG = {"backbone_flavor": "llama-1B", "decoder_flavor": "llama-100M",
              "text_vocab_size": 128_256, "audio_vocab_size": 2051,
              "audio_num_codebooks": 32}
CSM_FRAMES = 25  # 2 s of audio a greedy generate
CSM_TEXT = "The port speaks with a borrowed voice."
CSM_BATCH_TEXTS = ["One short line.", "A second line, a little longer.",
                   "Three.", "And the fourth line closes the batch."]
CSM_REF_TEXT = "This is the reference voice."
CSM_KERNEL_GROUPS = (("qmm_kernel", "quantized_matmul (this repo)"),
                     ("depth_draft_kernel", "depth_draft (this repo)"),
                     ("gemm", "cuBLAS"), ("xmma", "cuBLAS"),
                     ("elementwise", "elementwise"), ("reduce", "reduction"),
                     ("index", "gather / scatter"), ("softmax", "softmax"))


class StubTokenizer:
    """Llama-3-sized token ids from characters (no tokenizer files ship)."""

    def encode(self, text: str) -> list:
        return [128_000] + [1_000 + (ord(c) * 7_919) % 120_000 for c in text] + [128_001]


def build_csm():
    from mlx_audio_tpu_torch.models.tts.sesame import Model
    from mlx_audio_tpu_torch.nn.quantize import quantize_model

    t0 = time.perf_counter()
    model = Model(CSM_CONFIG, text_tokenizer=StubTokenizer(), device="cuda")
    # codes past Mimi's 2048 bins (the audio vocabulary has 2051) decode to
    # NaN; a trained CSM does not emit them, so neither do these random
    # weights: their logits are held at 0, below the top of 2048 random ones
    bins = model.mimi.cfg.quantizer_bins
    with torch.no_grad():
        model.model.codebook0_head.weight[bins:] = 0
        model.model.audio_head[..., bins:] = 0
    quantize_model(model.model, group_size=128, bits=8)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    nbytes = sum(t.numel() * t.element_size() for t in model.model.state_dict().values())
    print(f"CSM-1B built and quantized (int8, groups of 128) in "
          f"{time.perf_counter() - t0:.1f} s; LM state {nbytes / 1e9:.3f} GB",
          flush=True)
    return model


def _check_results(name, results, frames=None):
    if not results:
        fail(f"{name}: no audio")
    for r in results:
        if not (r.samples == 1920 * r.token_count and r.token_count > 0
                and np.isfinite(r.audio).all()):
            fail(f"{name}: {r.samples} samples for {r.token_count} frames")
        if frames is not None and r.token_count != frames:
            fail(f"{name}: {r.token_count} frames, expected {frames}")


def csm_runs(model, launches: dict) -> dict:
    """The entry points: greedy generate without and with spec decode (the
    frames must be equal), generate_batch, sampled generate with spec."""
    from mlx_audio_tpu_torch.nn import kernels

    ref = (np.random.default_rng(0).standard_normal(48_000) * 0.1).astype(np.float32)
    kw = dict(ref_audio=ref, ref_text=CSM_REF_TEXT,
              max_audio_length_ms=CSM_FRAMES * 80)
    decoded = []
    decode = model.mimi.decode

    def recording_decode(codes):
        decoded.append(codes.clone())
        return decode(codes)

    model.mimi.decode = recording_decode
    streamed_codes = []
    decode_stateful = model.mimi.decode_frames_stateful

    def recording_stateful(codes, state):
        streamed_codes.append(codes.clone())
        return decode_stateful(codes, state)

    model.mimi.decode_frames_stateful = recording_stateful

    def stream_run():
        t0, out = time.perf_counter(), []
        for r in model.generate(CSM_TEXT, temperature=0.0, stream=True, **kw):
            out.append((r, time.perf_counter() - t0))
        return out

    # the operands of quantized_matmul's first call at each shape the path
    # gives it, to hold the kernel against its plain version there
    path_calls = {}
    qmm = kernels.quantized_matmul

    def recording_qmm(x, codes, scales, biases, group_size, packed=False):
        key = (x.shape[0], x.shape[1], codes.shape[0], group_size, packed)
        if key not in path_calls:
            path_calls[key] = (x.clone(), codes, scales, biases, group_size, packed)
        return qmm(x, codes, scales, biases, group_size, packed)

    kernels.quantized_matmul = recording_qmm
    wall = {}

    def run(name, fn):
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall[name] = time.perf_counter() - t0
        launches[name] = dict(kernels.LAUNCHES)
        return out

    try:
        plain = run("csm_generate", lambda: list(
            model.generate(CSM_TEXT, temperature=0.0, **kw)))
        model.model.enable_spec_decode()
        model.model.spec_stats = [0, 0]
        spec = run("csm_generate_spec", lambda: list(
            model.generate(CSM_TEXT, temperature=0.0, **kw)))
        accept = model.model.spec_stats[:]
        stream = run("csm_generate_spec_stream", stream_run)
        batch = run("csm_generate_batch", lambda: model.generate_batch(
            CSM_BATCH_TEXTS, temperature=0.0, **kw))
        sampled = run("csm_generate_spec_sampled", lambda: list(
            model.generate(CSM_TEXT, temperature=0.9, top_k=50, seed=3, **kw)))
    finally:
        model.mimi.decode = decode
        model.mimi.decode_frames_stateful = decode_stateful
        kernels.quantized_matmul = qmm
    _check_results("csm generate", plain, CSM_FRAMES)
    _check_results("csm generate (spec)", spec, CSM_FRAMES)
    _check_results("csm generate_batch", batch)
    _check_results("csm generate (spec, sampled)", sampled)
    if not torch.equal(decoded[0], decoded[1]):
        n = int((decoded[0] != decoded[1]).sum())
        fail(f"csm: greedy frames differ with spec decode ({n} codes)")
    stream_info = check_stream(stream, streamed_codes, decoded[1], spec[0].audio)
    for name, need in (("csm_generate", ("quantized_matmul",)),
                       ("csm_generate_spec", ("quantized_matmul", "depth_draft")),
                       ("csm_generate_spec_stream", ("quantized_matmul", "depth_draft")),
                       ("csm_generate_batch", ("quantized_matmul",)),
                       ("csm_generate_spec_sampled", ("quantized_matmul", "depth_draft"))):
        missing = [k for k in need if launches[name][k] == 0]
        if missing:
            fail(f"{name}: kernels never launched: {missing}")
    path_err, bad = 0.0, []
    for key, args in sorted(path_calls.items()):
        got, ref = qmm(*args), kernels.quantized_matmul_plain(*args)
        err = float((got - ref).abs().max())
        path_err = max(path_err, err)
        if not torch.allclose(got, ref, **TOL):
            bad.append(f"rows {key[0]} I={key[1]} O={key[2]}: {err:.3e}")
    if bad:
        fail("quantized_matmul disagrees with its plain version at the CSM "
             "path's shapes: " + "; ".join(bad))
    print(f"quantized_matmul at the {len(path_calls)} (rows, I, O) the CSM "
          f"path gave it, on the path's own operands: max_abs_err "
          f"{path_err:.3e} (atol {TOL['atol']}, rtol {TOL['rtol']}) ok; rows "
          + ", ".join(str(n) for n in sorted({k[0] for k in path_calls}))
          + "; (I, O) " + ", ".join(f"({i}, {o})" for i, o in
                                   sorted({k[1:3] for k in path_calls})), flush=True)
    print(f"csm: greedy frames equal with and without spec decode "
          f"({CSM_FRAMES} frames x 32 codebooks); draft accepted "
          f"{accept[0]} of {accept[1]} tokens ({accept[0] / max(accept[1], 1):.4f}); "
          f"wall s: " + ", ".join(f"{k} {v:.3f}" for k, v in wall.items())
          + "; generate_batch frames "
          + ", ".join(str(r.token_count) for r in batch), flush=True)
    return {"accept": accept, "wall": wall, "qmm_path_err": path_err,
            "qmm_path_shapes": len(path_calls), "stream": stream_info}


# the first chunk, the ramp chunk, then streaming_interval 0.5 s = 6 frames
STREAM_SCHEDULE = (3, 4) + (6,) * 10


def check_stream(stream, streamed_codes, whole_codes, whole_audio) -> dict:
    """The streamed greedy run against the whole one: chunk sizes 3, 4, then
    6; the same frames; audio within atol 1e-3.  Prints the time to first
    audio and each chunk's frames, wall seconds and real-time factor."""
    sizes = [r.token_count for r, _ in stream]
    want, left = [], CSM_FRAMES
    for n in STREAM_SCHEDULE:
        if left <= 0:
            break
        want.append(min(n, left))
        left -= n
    if sizes != want:
        fail(f"csm stream: chunks of {sizes} frames, expected {want}")
    frames = torch.cat([c[..., :n] for c, n in zip(streamed_codes, sizes)], dim=-1)
    if not torch.equal(frames, whole_codes):
        n = int((frames != whole_codes).sum()) if frames.shape == whole_codes.shape else -1
        fail(f"csm stream: streamed frames differ from the whole generate's ({n} codes)")
    audio = np.concatenate([r.audio for r, _ in stream])
    if audio.shape != whole_audio.shape or not np.isfinite(audio).all():
        fail(f"csm stream: audio {audio.shape}, whole {whole_audio.shape}")
    err = float(np.abs(audio - whole_audio).max())
    if err > 1e-3:
        fail(f"csm stream: audio differs from the whole generate's by {err:.3e}")
    ends = [t for _, t in stream]
    walls = [ends[0]] + [b - a for a, b in zip(ends, ends[1:])]
    rtf = [w / (n * 0.08) for w, n in zip(walls, sizes)]
    steady = sum(walls[1:]) / (0.08 * sum(sizes[1:]))
    print(f"csm stream (batch 1, greedy, spec decode, int8, streaming_interval "
          f"0.5): time to first audio {ends[0]:.4f} s; chunks (frames, wall s, RTF) "
          + ", ".join(f"({n}, {w:.4f}, {x:.4f})" for n, w, x in zip(sizes, walls, rtf))
          + f"; after the first chunk RTF {steady:.4f}; frames equal to the whole "
          f"generate's, audio max abs diff {err:.3e} (atol 1e-3); on {gpu_line()}",
          flush=True)
    return {"ttfa_s": ends[0], "chunk_frames": sizes, "chunk_wall_s": walls,
            "chunk_rtf": rtf, "steady_rtf": steady, "audio_err": err}


def csm_breakdown(model) -> dict:
    """One spec-decode batch-1 generation through the model's own steps,
    synced between them: prefill, frame loop, Mimi; then a profiled frame
    loop."""
    from torch.profiler import ProfilerActivity, profile

    from mlx_audio_tpu_torch.models.tts.sesame import Segment
    from mlx_audio_tpu_torch.nn import kernels

    ref = (np.random.default_rng(1).standard_normal(48_000) * 0.1).astype(np.float32)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prompt = model._prompt(CSM_TEXT, [Segment(0, CSM_REF_TEXT, ref)], 0, True)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with torch.no_grad():
        caches, pad_len, last_h = model._prefill([prompt], CSM_FRAMES)
        first = model.model.first_frame(last_h, 0.0, 0, model.generator)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        rest = model._frame_chunk(caches, pad_len, first, CSM_FRAMES - 1, 0.0, 0)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        codes = torch.cat([first[None], rest]).permute(1, 2, 0)
        audio = model.mimi.decode(codes)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
    audio_s = audio.shape[-1] / 24_000
    out = {"ref_encode_s": t1 - t0, "prefill_s": t2 - t1, "frame_loop_s": t3 - t2,
           "mimi_decode_s": t4 - t3, "frames": CSM_FRAMES,
           "frames_per_s": (CSM_FRAMES - 1) / (t3 - t2),
           "real_time_factor": (t4 - t0) / audio_s,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    print("csm breakdown (batch 1, greedy, spec decode, int8): " + ", ".join(
        f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}" for k, v in out.items()),
        flush=True)

    with torch.no_grad():
        caches, pad_len, last_h = model._prefill([prompt], CSM_FRAMES)
        first = model.model.first_frame(last_h, 0.0, 0, model.generator)
        model._frame_chunk(caches, pad_len, first, 2, 0.0, 0)  # warm
        torch.cuda.synchronize()
        kernels.reset_launches()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model._frame_chunk(caches, pad_len, first, 4, 0.0, 0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        qmm_calls = kernels.LAUNCHES["quantized_matmul"]
    busy, window, by_name = device_time(prof)
    if not by_name:
        print("csm profile: the profiler recorded no device time (not measured)")
        return out
    groups = {}
    for name, (ms, n) in by_name.items():
        group = next((g for key, g in CSM_KERNEL_GROUPS if key in name), "other")
        groups[group] = groups.get(group, 0.0) + ms
    device_ms = sum(ms for ms, _ in by_name.values())
    print(f"csm profile of 4 spec-decode frames: wall {1e3 * wall:.1f} ms, device "
          f"busy {busy / 1e3:.1f} ms of a {window / 1e3:.1f} ms kernel window "
          f"(idle share {1 - busy / window:.4f}), {sum(n for _, n in by_name.values())} "
          f"kernels")
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {group:28s} {ms:10.3f} ms  {ms / device_ms:7.2%}")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        print(f"  {ms:10.3f} ms {n:6d}x  {name[:90]}")
    part_ms, sum_ms, sums = 0.0, 0.0, 0
    for name, (ms, n) in by_name.items():
        if "qmm_kernel_sum" in name:
            sum_ms, sums = sum_ms + ms, sums + n
        elif "qmm_kernel_part" in name:
            part_ms += ms
    print(f"  quantized_matmul in the 4 frames: {qmm_calls} calls, device "
          f"{part_ms + sum_ms:.3f} ms (part kernels {part_ms:.3f} ms, {sums} "
          f"sums {sum_ms:.3f} ms); on {gpu_line()}")
    out["profile_idle_share"] = 1 - busy / window
    return out


def csm_stream_breakdown(model) -> dict:
    """Where a streamed generate's time goes: the same greedy streamed run
    again (warm), the stateful Mimi decode of 25 frames alone against the
    batch decode of the same codes, and a profile of one 6-frame stateful
    decode."""
    from torch.profiler import ProfilerActivity, profile

    ref = (np.random.default_rng(0).standard_normal(48_000) * 0.1).astype(np.float32)
    t0, ends = time.perf_counter(), []
    for r in model.generate(CSM_TEXT, temperature=0.0, stream=True, ref_audio=ref,
                            ref_text=CSM_REF_TEXT, max_audio_length_ms=CSM_FRAMES * 80):
        ends.append((r.token_count, time.perf_counter() - t0))
    mimi = model.mimi
    gen = torch.Generator(device="cuda").manual_seed(5)
    codes = torch.randint(0, mimi.cfg.quantizer_bins, (1, mimi.cfg.quantizer_nq, CSM_FRAMES),
                          generator=gen, device="cuda")
    times = {}
    for name, fn in (("stateful", lambda: mimi.decode_frames_stateful(codes, mimi.init_state(1))),
                     ("batch", lambda: mimi.decode(codes))):
        fn()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t1
    state = mimi.init_state(1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        mimi.decode_frames_stateful(codes[..., :6], state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
    busy, window, by_name = device_time(prof)
    out = {"warm_ttfa_s": ends[0][1], "warm_total_s": ends[-1][1],
           "mimi_stateful_ms_per_frame": 1e3 * times["stateful"] / CSM_FRAMES,
           "mimi_batch_ms_per_frame": 1e3 * times["batch"] / CSM_FRAMES}
    print("csm stream breakdown: warm streamed run, time to first audio "
          f"{ends[0][1]:.4f} s, all {sum(n for n, _ in ends)} frames {ends[-1][1]:.4f} s; "
          f"Mimi over {CSM_FRAMES} frames: stateful {times['stateful']:.4f} s "
          f"({out['mimi_stateful_ms_per_frame']:.2f} ms a frame), batch "
          f"{times['batch']:.4f} s; on {gpu_line()}", flush=True)
    if by_name:
        print(f"  profile of a 6-frame stateful decode: wall {1e3 * wall:.1f} ms, "
              f"device busy {busy / 1e3:.2f} ms of a {window / 1e3:.1f} ms window, "
              f"{sum(n for _, n in by_name.values())} kernels")
        for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]:
            print(f"  {ms:10.3f} ms {n:6d}x  {name[:90]}")
        out["mimi_profile_busy_ms"] = busy / 1e3
        out["mimi_profile_wall_ms"] = 1e3 * wall
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # the port, and the kernel sources it builds, come from this checkout
    sys.path.insert(0, str(ROOT))
    try:
        from mlx_audio_tpu_torch.nn import kernels
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here: {exc}",
              file=sys.stderr)
        return 2
    if ROOT not in Path(kernels.__file__).resolve().parents:
        print(f"chip_smoke: the port was imported from {kernels.__file__}, "
              f"not from the checkout at {ROOT}", file=sys.stderr)
        return 2
    from mlx_audio_tpu_torch.models.tts.kokoro import Model
    from mlx_audio_tpu_torch.models.tts.kokoro.presets import kokoro_82m_config

    t_start = time.perf_counter()
    card = gpu_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)
    # f32 means f32: cuDNN convolutions default to TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    build_kernels()
    records = check_kernels()
    launches = {}
    drive_probes(launches)

    model = Model(kokoro_82m_config(), device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        voice = str(Path(tmp) / "voice.npy")
        pack = np.random.default_rng(0).standard_normal((510, 1, 256)) * 0.1
        np.save(voice, pack.astype(np.float32))
        kernels.reset_launches()
        with torch.no_grad():
            drive_entry_points(model, voice)
        launches["entry_points"] = dict(kernels.LAUNCHES)

    run_once = bench_runner(model)
    kernels.reset_launches()
    bench = bench_pass(run_once)
    launches["bench"] = dict(kernels.LAUNCHES)
    per_call = {k: v // bench["calls"] for k, v in launches["bench"].items()}
    for phase in ("entry_points", "bench"):
        missing = [k for k in KOKORO_KERNELS if launches[phase][k] == 0]
        if missing:
            fail(f"phase {phase}: kernels never launched: {missing}")
    print(f"launches: {json.dumps(launches)}; per bench synthesis call "
          f"{json.dumps(per_call)}")
    print(f"bench pass (batch {BENCH_BATCH}, {N_BUCKET} phonemes, "
          f"{F_BUCKET} frames, f32): "
          f"{bench['audio_seconds_per_second']:.2f} audio-s/s, median "
          f"{bench['median_s']:.4f} s per iteration, "
          f"{bench['audio_seconds_per_iter']:.1f} audio-s per iteration, "
          f"(duration stage {bench['duration_stage_s']:.4f} s, synthesis "
          f"stage {bench['synthesis_stage_s']:.4f} s; iterations "
          f"{', '.join(f'{t:.4f}' for t in bench['iter_s'])} s), peak {bench['peak_memory_gb']:.2f} GB, on {card}")
    profile_pass(run_once)
    del model, run_once
    torch.cuda.empty_cache()

    csm = build_csm()
    csm_run = csm_runs(csm, launches)
    csm_breakdown(csm)
    csm_stream_breakdown(csm)
    csm_phases = [k for k in launches if k.startswith("csm_")]
    print(f"csm launches: {json.dumps({k: launches[k] for k in csm_phases})}; "
          f"per spec-decode frame: " + json.dumps({
              k: launches["csm_generate_spec"][k] / CSM_FRAMES
              for k in ("quantized_matmul", "depth_draft")}))

    kernel_line = []
    for name, (source, replaces) in KERNEL_INFO.items():
        cases = records[name]
        head = max(cases, key=lambda r: r["bound_ms"])
        main = (("entry_points", "bench") if name in KOKORO_KERNELS
                else ("probes_int8", "probes_bf16") if name in PROBE_KERNELS
                else csm_phases)
        entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(launches[p][name] for p in main),
            "max_abs_err": max(r["max_abs_err"] for r in cases),
            "shape": head["shape"], "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "cases": len(cases),
            **{k: head[k] for k in ("bound_f32_fma_ms", "max_abs_err_f64",
                                    "plain_max_abs_err_f64") if k in head},
        }
        if name == "quantized_matmul":
            entry["max_abs_err"] = max(entry["max_abs_err"], csm_run["qmm_path_err"])
            entry["path_shapes"] = csm_run["qmm_path_shapes"]
        if name in KOKORO_KERNELS:
            entry["launches_per_synthesis"] = per_call[name]
        elif name not in PROBE_KERNELS:
            entry["launches_per_spec_frame"] = (
                launches["csm_generate_spec"][name] / CSM_FRAMES)
        kernel_line.append(entry)
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernel_line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
