"""Codec checkpoint loading from a local directory (counterpart of the
local-path branch of ``mlx_audio_tpu/codec/loading.py``).

A checkpoint directory holds ``config.json`` and one or more
``*.safetensors`` files, which ``load_safetensors`` reads through
``utils.loader.load_weights_files``.  Nothing is fetched: a path that does
not exist raises.  ``safetensors`` is imported only when weights are
read.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

from mlx_audio_tpu_torch.utils.loader import load_weights_files


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


def load_safetensors(path: Path, filename: Optional[str] = None) -> dict:
    """numpy weights of ``path/filename``, or of every ``*.safetensors`` in
    the directory ``path`` (HF shard layouts)."""
    if filename is not None:
        from safetensors.numpy import load_file

        return load_file(str(Path(path) / filename))
    return load_weights_files(Path(path))
