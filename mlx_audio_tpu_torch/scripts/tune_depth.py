#!/usr/bin/env python
"""Time the build variants of ``csrc/depth_draft.cu`` on the card, on a full
llama-100M pack (CSM's depth decoder: 4 layers, Dm 1024, F 8192, 8 query
and 2 key/value heads of 128, 31 heads of 2051 codes; 30 steps a frame),
greedy and at temperature 0.9 / top-k 50.

    python -m mlx_audio_tpu_torch.scripts.tune_depth [--out DIR] [--rounds 2]

Variants, each built by ``nvcc -D...`` into a directory of its own (all
builds started together) and loaded apart from the port's own build:

* ``ring``: the default build of ``depth_draft.cu`` (a producer warp fills
  a ring of shared-memory stages with bulk copies, the scales through it);
* ``ring-clocks``: ``-DDRAFT_PHASE_CLOCKS``; after its run the script prints
  where CTA 0's time goes in steps 0, 15 and 29 (16 intervals a layer, 3 in
  the head and sample; clock64, scaled to the step's %globaltimer span),
  the time its thread 0 waited for tiles, and every CTA's polling for the
  other CTAs' outputs, by phase;
* ``ring-no-stream``: ``-DDRAFT_NO_STREAM``, the producer copies nothing and
  zeroes the scales: the serial path alone, timed (its tokens are all 0,
  not the draft's).

Every variant's tokens must equal ``depth_draft_plain``'s.  Beside them the
sync-only floor: one launch at the draft's shape that passes the draft's
510 synchronisations of every CTA and does no work, by the draft's own
exchange of tagged words, by a grid barrier of one counter, and by
``cooperative_groups``' ``grid.sync()``.  The variants run in one
order, then in the reverse one, so that a drift of the card shows.  Prints
one line a variant, case and round, then the card's name and power limit.
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

# name -> (source, -D flags)
VARIANTS = {
    "ring": ("depth_draft.cu", ()),
    "ring-clocks": ("depth_draft.cu", ("-DDRAFT_PHASE_CLOCKS",)),
    "ring-no-stream": ("depth_draft.cu", ("-DDRAFT_NO_STREAM",)),
}
# variants whose tokens are not the draft's
UNCHECKED = ("ring-no-stream",)
CASES = ((0.0, 0), (0.9, 50))
KINDS = ("q/k/v", "o", "gate/up", "down", "head")


def build_variants(out: Path) -> dict:
    """One shared library a variant, the nvcc processes run together."""
    procs = {}
    for name, (source, flags) in VARIANTS.items():
        lib = out / f"depth_draft_{name}.so"
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS,
               *build.EXTRA_FLAGS["depth_draft"], *flags, "-I", str(build.CSRC),
               "-o", str(lib), str(build.CSRC / source)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate(timeout=build.NVCC_TIMEOUT_S)
        if proc.returncode:
            raise RuntimeError(f"variant {name} did not build:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"built {name}: {line.strip()}", flush=True)
        dll = ctypes.CDLL(str(lib))
        # the ring at llama-100M, 30 steps
        print(f"variant {name}: {dll.depth_draft_stages(1024, 8, 2, 128, 8192, 40)} "
              "ring stages", flush=True)
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


# csrc/depth_draft.cu's stamps: each names the interval that ends at it
LAYER_STAMPS = ("q/k/v rms+quant", "q/k/v dots", "attention prefetch",
                "q/k/v exchange", "attention rope", "attention scores",
                "attention softmax", "attention output", "o quant", "o dots",
                "o exchange", "gate/up rms+quant", "gate/up dots",
                "gate/up exchange + down quant", "down dots", "down exchange")
HEAD_STAMPS = ("head rms+quant", "head dots", "head exchange + sample")
CLOCK_LAYERS, CLOCK_CTAS = 8, 256


def print_clocks(dll, call, n_layers: int, ctas: int) -> None:
    """Where CTA 0's time goes in one launch of the clocked variant, and how
    long every CTA's thread 0 polls for the other CTAs' outputs."""
    slots, rows = 1 + len(LAYER_STAMPS) * CLOCK_LAYERS + len(HEAD_STAMPS), 3
    stamps = (ctypes.c_ulonglong * (rows * slots * 2))()
    waits = (ctypes.c_ulonglong * 5)()
    xwait = (ctypes.c_ulonglong * (CLOCK_CTAS * 5))()
    compute = (ctypes.c_ulonglong * 10)()
    timeline = (ctypes.c_ulonglong * (96 * 4))()
    call()
    torch.cuda.synchronize()
    code = dll.depth_draft_clocks(stamps, waits, xwait, compute, timeline)
    if code:
        raise RuntimeError(f"depth_draft_clocks: CUDA error {code}")
    used = ([1 + len(LAYER_STAMPS) * l + k for l in range(n_layers)
             for k in range(len(LAYER_STAMPS))]
            + [1 + len(LAYER_STAMPS) * n_layers + k for k in range(len(HEAD_STAMPS))])
    names = list(LAYER_STAMPS) * n_layers + list(HEAD_STAMPS)
    ghz = 0.0
    for row, step in enumerate(("0", "S/2", "S-1")):
        ns = [stamps[(row * slots + i) * 2] for i in [0] + used]
        cyc = [stamps[(row * slots + i) * 2 + 1] for i in [0] + used]
        total_ns, total_cyc = ns[-1] - ns[0], cyc[-1] - cyc[0]
        ghz = total_cyc / max(total_ns, 1)
        per = {}
        for i, name in enumerate(names):
            per[name] = per.get(name, 0.0) + (cyc[i + 1] - cyc[i]) / ghz / 1e3
        print(f"  clocks step {step}: {total_ns / 1e3:.3f} us ({total_cyc} cycles, "
              f"{ghz:.3f} GHz); us by interval, all layers (clock64 at that rate): "
              + ", ".join(f"{k} {v:.3f}" for k, v in per.items()), flush=True)
    print("  CTA 0's thread 0 waiting for tiles over the launch, us: "
          + ", ".join(f"{k} {w / ghz / 1e3:.3f}" for k, w in zip(KINDS, waits)), flush=True)
    print("  CTA 0's teams computing a tile, us (tiles over the launch): "
          + ", ".join(f"{k} {compute[2 * i] / max(compute[2 * i + 1], 1) / ghz / 1e3:.3f} "
                      f"({compute[2 * i + 1]})" for i, k in enumerate(KINDS)), flush=True)
    start = stamps[(1 * slots) * 2 + 1]  # step S/2's first stamp
    tiles = [tuple(timeline[4 * k:4 * k + 4]) for k in range(96)]
    print("  step S/2, CTA 0's tiles (kind, team's first warp, us from the step's "
          "start when it found the tile full, us computing it): " + "; ".join(
              f"{KINDS[t[0]]} w{t[1]} {(t[2] - start) / ghz / 1e3:.2f} +{(t[3] - t[2]) / ghz / 1e3:.2f}"
              for t in tiles if t[3] > t[2]), flush=True)
    for kind, name in enumerate(KINDS):
        us = sorted((xwait[c * 5 + kind] / ghz / 1e3, c) for c in range(min(ctas, CLOCK_CTAS)))
        print(f"  {name} outputs, thread 0 polling for them over the launch, us: least "
              f"{us[0][0]:.3f} (CTA {us[0][1]}), median {us[len(us) // 2][0]:.3f}, "
              f"most {us[-1][0]:.3f} (CTA {us[-1][1]})", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="directory for the variants' libraries (a temporary one by default)")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    from mlx_audio_tpu_torch.models.sampling import gumbel
    from mlx_audio_tpu_torch.nn.pallas_depth import (depth_draft_plain, draft_exchanges,
                                                     draft_inputs)

    with tempfile.TemporaryDirectory() as tmp:
        out = Path(args.out or tmp)
        out.mkdir(parents=True, exist_ok=True)
        libs = build_variants(out)
        libs["ring-clocks"].depth_draft_clocks.argtypes = [ctypes.c_void_p] * 5
        gen = torch.Generator(device="cuda").manual_seed(0)
        packed, kc, vc, c1, vocab = draft_inputs(gen)
        n_steps, vpad = packed.heads.shape[:2]
        n_layers = packed.wqkv.shape[0]
        cases = []
        for temp, top_k in CASES:
            noise = (gumbel((n_steps, vpad), gen, "cuda") if temp > 0
                     else torch.zeros(n_steps, vpad, device="cuda"))
            a = (packed, kc, vc, c1, noise, vocab, temp, top_k)
            cases.append((temp, top_k, a, depth_draft_plain(*a)))
        rounds = draft_exchanges(packed)
        names = list(libs) + [f"sync-only {m}" for m in kernels.DRAFT_SYNC_MODES]
        for rnd in range(args.rounds):
            for name in (names if rnd % 2 == 0 else names[::-1]):
                if name.startswith("sync-only"):
                    mode = name.split()[1]
                    ms = events_ms(lambda m=mode: kernels.depth_draft_sync_only(
                        rounds, m, torch.device("cuda")))
                    print(f"round {rnd} {name:22s} {rounds} rounds: {ms:.4f} ms "
                          f"({1e3 * ms / rounds:.3f} us a round)", flush=True)
                    continue
                for temp, top_k, a, ref in cases:
                    # one launch of the variant through the port's wrapper
                    def call(a=a, dll=libs[name]):
                        return kernels._depth_draft(*a, variant=dll)

                    tokens = call()
                    torch.cuda.synchronize()
                    if name not in UNCHECKED and not torch.equal(tokens, ref):
                        n = int((tokens != ref).sum())
                        raise SystemExit(f"variant {name} temp {temp} top_k {top_k}: "
                                         f"{n} of {n_steps} tokens differ from the plain draft")
                    ms = events_ms(call)
                    check = ("tokens not checked (timing variant)" if name in UNCHECKED
                             else "tokens equal to the plain draft")
                    print(f"round {rnd} {name:22s} temp {temp} top_k {top_k:2d}: "
                          f"{ms:.4f} ms, {check}", flush=True)
                    if name == "ring-clocks" and temp == 0.0:
                        print_clocks(libs[name], call, n_layers,
                                     torch.cuda.get_device_properties(0).multi_processor_count)
    print(card_line(torch.device("cuda", 0)))


if __name__ == "__main__":
    main()
