"""Build and load the port's CUDA kernels.

Each kernel is one source under ``csrc/`` with a plain C interface.  It is
compiled by ``nvcc`` for ``sm_90a`` into a shared library of its own and
loaded with ``ctypes`` at first use; nothing is compiled at import time.
Libraries go into ``csrc/build/`` under a name that carries a digest of the
sources and flags, so an edited source is rebuilt and a stale library is
never loaded.  ``build()`` starts one ``nvcc`` per missing kernel, all at
once, and is what a caller uses to build everything up front.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = CSRC / "build"
KERNELS = ("lstm", "dilated_conv1d", "banded_conv1d", "conv1d_bf16",
           "quantized_matmul", "depth_draft", "probe_depth", "probe_vpu", "probe_auto")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# depth_draft must round every product and sum as its plain version does:
# no contracted multiply-adds
EXTRA_FLAGS = {"depth_draft": ("--fmad=false",)}
NVCC_TIMEOUT_S = 600

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are compiled at first use "
        "and need the CUDA toolkit (put nvcc on PATH or set CUDA_HOME)"
    )


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + EXTRA_FLAGS.get(name, ())).encode())
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest(name)}.so"


def build(names=KERNELS) -> dict[str, str]:
    """Compile every named kernel whose library is missing, one ``nvcc``
    process each, started together.  Returns name -> compiler output
    (``-Xptxas -v``: registers, shared memory and spills per kernel)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, *EXTRA_FLAGS.get(name, ()),
               "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, out)
    failed = []
    for name, (proc, tmp, out) in running.items():
        try:
            log, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
            log += f"\nnvcc timed out after {NVCC_TIMEOUT_S} s"
        out.with_suffix(".log").write_text(log)
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(f"{name}:\n{log}")
    if failed:
        raise RuntimeError("kernel build failed\n" + "\n".join(failed))
    return {name: library_path(name).with_suffix(".log").read_text()
            for name in names}


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if it is missing."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib
