"""Llama-3 text tokenizer for CSM (counterpart of
``mlx_audio_tpu/models/tts/sesame/tokenizer.py``): an HF tokenizer read from a
local directory, whose every encode is wrapped in <bos> ... <eos>.

``transformers`` and ``tokenizers`` are imported when a tokenizer is loaded,
so the package imports without them.  Nothing is fetched: a path that is not
a local directory raises ``FileNotFoundError`` naming it.
"""

from __future__ import annotations

from pathlib import Path


def load_llama3_tokenizer(path: str):
    """The tokenizer in the local directory ``path`` with the
    ``<bos> $A <eos>`` post-processor."""
    if not Path(path).is_dir():
        raise FileNotFoundError(
            f"{path}: no such tokenizer directory (the port reads local files "
            "only; pass text_tokenizer= or a directory holding a Llama-3 "
            "tokenizer)")
    from tokenizers.processors import TemplateProcessing
    from transformers import AutoTokenizer

    tokenizer = AutoTokenizer.from_pretrained(path, local_files_only=True)
    bos, eos = tokenizer.bos_token, tokenizer.eos_token
    tokenizer._tokenizer.post_processor = TemplateProcessing(
        single=f"{bos}:0 $A:0 {eos}:0",
        pair=f"{bos}:0 $A:0 {eos}:0 {bos}:1 $B:1 {eos}:1",
        special_tokens=[(f"{bos}", tokenizer.bos_token_id),
                        (f"{eos}", tokenizer.eos_token_id)],
    )
    return tokenizer
