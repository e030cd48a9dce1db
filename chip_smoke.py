#!/usr/bin/env python3
"""Drive the PyTorch port of Kokoro-82M (``mlx_audio_tpu_torch``) on one
NVIDIA GPU, and check its hand-written CUDA kernels.

    python3 chip_smoke.py

Phases; the failure of any one ends the script with a non-zero exit:

1. print the card (``nvidia-smi``), torch and CUDA versions; build the
   three kernels from ``mlx_audio_tpu_torch/csrc/`` with ``nvcc`` for
   ``sm_90a`` into ``mlx_audio_tpu_torch/csrc/build/``;
2. hold every kernel against its plain PyTorch version on the card at the
   Kokoro-82M shapes (float32, TF32 off), and time kernel, plain version
   and one library call;
3. run ``Model.generate``, ``Model.generate_batch`` and
   ``Model.synthesize_batch`` at the full Kokoro-82M width with seeded
   random weights;
4. run the bench-shaped pass (batch 8, phoneme bucket 512, frame bucket
   1300, durations capped at alternating 2/3) through ``duration_stage``
   and ``synthesis_stage``, median of 5 synced iterations, then one more
   iteration under ``torch.profiler`` for the device time by kernel;
5. print one ``{"kernels": [...]}`` line, then the device line last.

Launch counters are set to 0 just before phases 3 and 4 and read just
after: each kernel must have launched in each.  Needs one CUDA card and
the repository checkout around this file; it imports nothing of JAX.
"""

from __future__ import annotations

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
# tensor cores, and HBM3 bandwidth.  The port's kernels run float32 FMAs.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

TOL = {"atol": 1e-4, "rtol": 1e-4}  # as tests/test_pallas_ops.py uses

KERNEL_INFO = {
    "lstm": ("mlx_audio_tpu_torch/csrc/lstm.cu",
             "mlx_audio_tpu/nn/pallas_ops.py:70"),
    "dilated_conv1d": ("mlx_audio_tpu_torch/csrc/dilated_conv1d.cu",
                       "mlx_audio_tpu/nn/pallas_ops.py:259"),
    "banded_conv1d": ("mlx_audio_tpu_torch/csrc/banded_conv1d.cu",
                      "mlx_audio_tpu/nn/pallas_ops.py:353"),
}

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


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops = flops / PEAK_F32_FLOPS
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
        }


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
    for case in (*_lstm_cases(gen), *_conv_cases(gen)):
        name = case["kernel"]
        before = kernels.LAUNCHES[name]
        got = _outputs(case["kernel_fn"]())
        torch.cuda.synchronize()
        if kernels.LAUNCHES[name] == before:
            bad.append(f"{name} {case['shape']}: kernel not launched")
        ref = _outputs(case["plain_fn"]())
        err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        ok = all(torch.allclose(g, r, **TOL) for g, r in zip(got, ref))
        ms = median_ms(case["kernel_fn"], 10)
        plain_ms = median_ms(case["plain_fn"], 3)
        with torch.no_grad():
            library_ms = median_ms(case["library_fn"], 10)
        bms, by = bound_ms(case["flops"], case["bytes"])
        rec = {"shape": case["shape"], "max_abs_err": err, "ok": ok,
               "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
               "bound_by": by, "library_ms": library_ms}
        records[name].append(rec)
        print(f"{name:15s} {case['shape']:40s} max_abs_err {err:.3e} "
              f"(atol {TOL['atol']}, rtol {TOL['rtol']}) "
              f"{'ok' if ok else 'DISAGREES'}  kernel {ms:.3f} ms  "
              f"plain {plain_ms:.3f} ms  library {library_ms:.3f} ms  "
              f"bound {bms:.4f} ms ({by})", flush=True)
        if not ok:
            bad.append(f"{name} {case['shape']}: max_abs_err {err:.3e}")
        del got, ref
        torch.cuda.empty_cache()
    if bad:
        fail("kernel check: " + "; ".join(bad))
    return records


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


def profile_pass(run_once) -> None:
    """One bench iteration under torch.profiler: device time by kernel
    group and by kernel, and the device's idle share between the first and
    the last kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_once(7)
        wall = time.perf_counter() - t0
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        tot, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + (end - start) / 1e3, n + 1)
    if not spans:
        print("profile: the profiler recorded no device time (not measured)")
        return
    spans.sort()
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s_, e_ in spans[1:]:
        if s_ > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s_, e_
        else:
            cur_e = max(cur_e, e_)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
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

    model = Model(kokoro_82m_config(), device="cuda")
    launches = {}
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
    for phase, counts in launches.items():
        missing = [k for k, v in counts.items() if v == 0]
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

    kernel_line = []
    for name, (source, replaces) in KERNEL_INFO.items():
        cases = records[name]
        head = max(cases, key=lambda r: r["bound_ms"])
        kernel_line.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": launches["entry_points"][name] + launches["bench"][name],
            "launches_per_synthesis": per_call[name],
            "max_abs_err": max(r["max_abs_err"] for r in cases),
            "shape": head["shape"], "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "cases": cases,
        })
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernel_line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
