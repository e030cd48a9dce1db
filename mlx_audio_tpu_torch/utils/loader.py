"""Model registry and loader: a local checkpoint directory -> a model of the
port with its weights (counterpart of ``mlx_audio_tpu/utils/loader.py``).

A family is found by scanning ``models/{domain}`` with a remapping table,
as in the JAX package.  Two checkpoint formats load:

* native: written by :func:`save_checkpoint` of either package, safetensors
  keyed by the JAX package's pytree paths in its channels-last layouts, and
  ``"native_format": true`` in ``config.json``;
* foreign (torch, HF or MLX layouts): each family's ``sanitize`` maps it to
  the JAX layout first.

Both end in ``convert.params_from_jax`` and ``load_state_dict``.  Nothing
is fetched: a path that does not exist raises ``FileNotFoundError`` naming
it, and a config without ``config.json`` is read by ``AutoConfig`` from
local files only.
"""

from __future__ import annotations

import importlib
import json
import logging
from pathlib import Path
from typing import List, Optional, Union

import torch

from mlx_audio_tpu_torch.codec.loading import load_weights_files

MODEL_REMAPPING = {"outetts": "outetts", "spark": "spark", "csm": "sesame",
                   "styletts2": "kokoro", "wav2vec2": "wav2vec",
                   "parakeet_ctc": "parakeet"}

DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16,
          "float32": torch.float32}


def get_model_path(path_or_hf_repo: Union[str, Path]) -> Path:
    """The local checkpoint directory ``path_or_hf_repo``.  A hub repo id
    is not downloaded: a path that does not exist raises."""
    model_path = Path(path_or_hf_repo)
    if not model_path.exists():
        raise FileNotFoundError(
            f"{path_or_hf_repo}: no such checkpoint directory (the port loads "
            "local checkpoints only; nothing is downloaded)")
    return model_path


def get_available_models(domain: str = "tts") -> List[str]:
    models_dir = Path(__file__).parent.parent / "models" / domain
    out = []
    if models_dir.is_dir():
        for item in models_dir.iterdir():
            if item.is_dir() and not item.name.startswith("__"):
                out.append(item.name)
    return out


def get_model_and_args(model_type: str, model_name: Optional[List[str]],
                       domain: str = "tts"):
    """The family module of ``model_type`` and the repo name's segments."""
    model_type = MODEL_REMAPPING.get(model_type, model_type)
    models = get_available_models(domain)
    if model_name is not None:
        for part in model_name:
            if part in models:
                model_type = part
            if part in MODEL_REMAPPING:
                model_type = MODEL_REMAPPING[part]
                break
    try:
        arch = importlib.import_module(
            f"mlx_audio_tpu_torch.models.{domain}.{model_type}")
    except ImportError as e:
        raise ValueError(f"Model type {model_type} not supported ({e})")
    return arch, model_type


def load_config(model_path: Union[str, Path], **kwargs) -> dict:
    model_path = get_model_path(model_path)
    cfg = model_path / "config.json"
    if cfg.exists():
        with open(cfg, encoding="utf-8") as f:
            return json.load(f)
    try:
        from transformers import AutoConfig

        return AutoConfig.from_pretrained(
            model_path, local_files_only=True, **kwargs).to_dict()
    except Exception as exc:
        raise FileNotFoundError(f"Config not found at {model_path}") from exc


def _model_name(path_or_repo: Union[str, Path]) -> List[str]:
    """The repo name's dash-separated segments, lower case (a hub cache
    path names its repo after ``hub``)."""
    if isinstance(path_or_repo, str):
        return path_or_repo.lower().split("/")[-1].split("-")
    parts = Path(path_or_repo).parts
    if "hub" in parts and parts.index("hub") + 1 < len(parts):
        return parts[parts.index("hub") + 1].lower().split("--")[-1].split("-")
    return Path(path_or_repo).name.lower().split("-")


def load_model(path_or_repo: Union[str, Path], domain: str = "tts",
               strict: bool = False, dtype=None, device: str = "cuda",
               **kwargs):
    """Build the family's ``Model`` on ``device`` and load a local
    checkpoint into it.

    A quantized native checkpoint gets its quantized modules first
    (``quantize_model`` with its recorded group size and bits, and the
    mixed recipe the port's converter records).  A native checkpoint keeps
    the dtype its ``config.json`` names (``"dtype"``, which the converter
    writes) where the port's kernels take it, bf16 or float32; a float16
    one loads in float32, as the JAX package loads every checkpoint into
    its float32 arrays.  ``dtype`` overrides it.  With ``strict``, every
    checkpoint path must name an array of the model, as in the JAX
    package."""
    from mlx_audio_tpu_torch.convert import params_from_jax

    model_name = _model_name(path_or_repo)
    model_path = get_model_path(path_or_repo)
    config = load_config(model_path, **kwargs)
    config.setdefault("tokenizer_name", str(model_path))
    model_type = config.get("model_type") or (model_name[0] if model_name else None)
    arch, model_type = get_model_and_args(model_type, model_name, domain)

    model_config = arch.ModelConfig.from_dict(config)
    model = arch.Model(model_config, device=device)

    native = bool(config.get("native_format"))
    if native and config.get("quantization"):
        from mlx_audio_tpu_torch.nn.quantize import (
            mixed_quant_predicate_builder,
            quantize_model,
        )

        qcfg = config["quantization"]
        recipe = qcfg.get("recipe")
        model = quantize_model(
            model, group_size=qcfg.get("group_size", 64), bits=qcfg.get("bits", 4),
            quant_predicate=(mixed_quant_predicate_builder(recipe, model)
                             if recipe else None))

    weights = load_weights_files(model_path)
    if not native and hasattr(model, "sanitize"):
        weights = model.sanitize(weights)
    if dtype is None and native and config.get("dtype") in ("bfloat16", "float32"):
        dtype = config["dtype"]
    if isinstance(dtype, str):
        dtype = DTYPES[dtype]
    if dtype is not None:
        model = model.to(dtype)
    _, unexpected = model.load_state_dict(params_from_jax(weights, model), strict=False)
    if strict and unexpected:
        raise KeyError(f"unknown parameter paths: {sorted(unexpected)[:10]}")
    model._asset_dir = str(model_path)
    logging.info(f"Loaded {model_type} from {model_path}")
    return model


def save_checkpoint(model: torch.nn.Module, out_dir: Union[str, Path],
                    config: dict) -> Path:
    """Write ``model`` in the native format: safetensors keyed by the JAX
    package's pytree paths and layouts (``convert.params_to_jax``), and
    ``config`` with ``"native_format": true`` and, where every floating
    tensor of the state has one dtype, that ``"dtype"``, so ``load_model``
    gives the model back in it.  The JAX package's ``load_model`` reads it
    as its own."""
    from safetensors.numpy import save_file

    from mlx_audio_tpu_torch.convert import params_to_jax

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    state = model.state_dict()
    save_file(params_to_jax(state, model), str(out_dir / "weights.safetensors"))
    config = {**config, "native_format": True}
    floating = {t.dtype for t in state.values() if t.is_floating_point()}
    if len(floating) == 1:
        config["dtype"] = str(floating.pop()).removeprefix("torch.")
    with open(out_dir / "config.json", "w") as f:
        json.dump(config, f, indent=2, default=str)
    return out_dir
