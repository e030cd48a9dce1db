"""Codec checkpoint loading from a local directory (counterpart of the
local-path branch of ``mlx_audio_tpu/codec/loading.py``).

A checkpoint directory holds ``config.json`` and one or more
``*.safetensors`` files; ``load_weights_files`` is the port's copy of the
shard-collecting helper of ``mlx_audio_tpu/utils/loader.py``.  Nothing is
fetched: a path that does not exist raises.  ``safetensors`` is imported
only when weights are read.
"""

from __future__ import annotations

import glob
import json
from pathlib import Path


def checkpoint_dir(path: str) -> Path:
    """The local checkpoint directory ``path``; raises if it is missing."""
    p = Path(path)
    if not p.exists():
        raise FileNotFoundError(
            f"{path}: no such checkpoint directory (the port loads local "
            "checkpoints only)")
    return p


def load_config(path: Path) -> dict:
    with open(Path(path) / "config.json") as f:
        return json.load(f)


def load_weights_files(path: Path) -> dict:
    """numpy weights of every ``*.safetensors`` in ``path`` (HF shard
    layouts), else in ``path/LLM``."""
    from safetensors.numpy import load_file

    files = glob.glob(str(path / "*.safetensors"))
    if not files:
        files = glob.glob(str(path / "LLM" / "*.safetensors"))
    if not files:
        raise FileNotFoundError(f"No safetensors found in {path}")
    weights = {}
    for f in files:
        weights.update(load_file(f))
    return weights
