"""Checkpoint converter CLI (counterpart of ``mlx_audio_tpu/tts/convert.py``).

Loads a local checkpoint through the registry, then casts its dtype,
quantizes it (uniform, or a mixed recipe of ``nn.quantize.QUANT_RECIPES``)
or dequantizes it, and writes a native checkpoint (JAX-layout safetensors
and ``config.json``) that either package's ``load_model`` reads back
without ``sanitize``.  A mixed recipe is recorded in the config's
``quantization`` as ``recipe``, so the port's loader rebuilds the same
modules.  The model is loaded, and quantized or cast, on ``--device``
(``cuda`` unless ``cpu`` is asked for).

``--upload-repo`` raises the JAX package's error naming the written folder:
the port does not push to the hub.
"""

from __future__ import annotations

import argparse
import json

from mlx_audio_tpu_torch.nn.quantize import (
    QUANT_RECIPES,
    dequantize_model,
    mixed_quant_predicate_builder,
    quantize_model,
)
from mlx_audio_tpu_torch.utils.loader import (
    DTYPES,
    load_config,
    load_model,
    save_checkpoint,
)


def convert(hf_path: str, out_path: str = "torch_model", quantize: bool = False,
            q_group_size: int = 64, q_bits: int = 4, dtype: str = "bfloat16",
            quant_predicate=None, dequantize: bool = False,
            domain: str = "tts", upload_repo=None, device: str = "cuda"):
    model = load_model(hf_path, domain=domain, device=device)
    config = dict(load_config(hf_path))

    if dequantize:
        model = dequantize_model(model)
        config.pop("quantization", None)
    elif quantize:
        recipe = quant_predicate if isinstance(quant_predicate, str) else None
        if recipe is not None:
            quant_predicate = mixed_quant_predicate_builder(recipe, model)
        model = quantize_model(model, group_size=q_group_size, bits=q_bits,
                               quant_predicate=quant_predicate)
        config["quantization"] = {"group_size": q_group_size, "bits": q_bits,
                                  **({"recipe": recipe} if recipe else {})}
    else:
        model = model.to(DTYPES[dtype])
        config["dtype"] = dtype

    out = save_checkpoint(model, out_path, config)
    if upload_repo:
        upload_to_hub(str(out), upload_repo, hf_path)
    return out


def upload_to_hub(path: str, upload_repo: str, hf_path: str) -> None:
    """The port does not push to the hub: raise the JAX package's error
    naming the folder to push by hand."""
    raise RuntimeError(
        f"upload to {upload_repo} needs network access; push the written "
        f"folder manually: {path}")


def configure_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Convert a local checkpoint to the native format")
    parser.add_argument("--hf-path", type=str, required=True,
                        help="local checkpoint directory")
    parser.add_argument("--out-path", "--mlx-path", dest="out_path",
                        type=str, default="torch_model")
    parser.add_argument("-q", "--quantize", action="store_true")
    parser.add_argument("--q-group-size", type=int, default=64)
    parser.add_argument("--q-bits", type=int, default=4)
    parser.add_argument("--quant-predicate", choices=QUANT_RECIPES,
                        type=str, required=False)
    parser.add_argument("--dtype", type=str, default="bfloat16",
                        choices=list(DTYPES))
    parser.add_argument("-d", "--dequantize", action="store_true")
    parser.add_argument("--domain", type=str, default="tts",
                        choices=["tts", "stt"])
    parser.add_argument("--upload-repo", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on (cuda, or cpu)")
    return parser


def main(argv=None):
    args = configure_parser().parse_args(argv)
    out = convert(
        args.hf_path, args.out_path, quantize=args.quantize,
        q_group_size=args.q_group_size, q_bits=args.q_bits,
        dtype=args.dtype, quant_predicate=args.quant_predicate,
        dequantize=args.dequantize, domain=args.domain,
        upload_repo=args.upload_repo, device=args.device,
    )
    print(json.dumps({"written": str(out)}))


if __name__ == "__main__":
    main()
