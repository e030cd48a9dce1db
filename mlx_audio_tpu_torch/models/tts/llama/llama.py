"""Orpheus TTS: a Llama-3B generating SNAC tokens in 7-token frames
(counterpart of ``mlx_audio_tpu/models/tts/llama/llama.py``).

The prompt layout (start/end of human and text, a voice prefix, optional
reference-audio cloning), the 7-token SNAC frame interleave and the decode
loop (``models.lm.causal``) are the JAX package's.  After
``quantize_model(model.lm, group_size=64, bits=8)`` every decode-sized
projection and the tied head run through the ``quantized_matmul`` kernel.
The JAX package runs bf16; the port runs float32 (or int8 weights with
float32 activations).  Under a mesh with dp > 1 a multi-segment
``generate`` without a reference decodes its segments as one
``generate_batch`` (the loop's mesh branches are ``models.lm.causal``'s).
Left for later: tokenizer downloads (``tokenizer=`` or a local path).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch
from torch import nn

from mlx_audio_tpu_torch.codec.snac import SNAC, SNACConfig
from mlx_audio_tpu_torch.models.base import (
    BaseModelArgs,
    init_weights,
    make_generation_result,
    model_device,
)
from mlx_audio_tpu_torch.models.lm.causal import (
    LlamaForCausalLM,
    generate_tokens,
    generate_tokens_batch,
)
from mlx_audio_tpu_torch.models.lm.llama import LlamaConfig

# Orpheus special tokens
SOH = 128259           # start of human
EOT = 128009           # end of text
EOH = 128260           # end of human
PAD = 128263
AUDIO_START = (128261, 128257)
AUDIO_END = (128258, 128262)
AUDIO_MARK = 128257    # last marker before audio tokens
STOP_AUDIO = 128258
CODE_OFFSET = 128266


@dataclass
class ModelConfig(BaseModelArgs):
    """Defaults: the published widths of ``canopylabs/orpheus-3b-0.1-ft``."""

    model_type: str = "llama"
    hidden_size: int = 3072
    num_hidden_layers: int = 28
    intermediate_size: int = 8192
    num_attention_heads: int = 24
    num_key_value_heads: Optional[int] = 8
    head_dim: Optional[int] = None
    rms_norm_eps: float = 1e-5
    vocab_size: int = 156940
    max_position_embeddings: int = 131072
    rope_theta: float = 500000.0
    rope_scaling: Optional[dict] = None
    tie_word_embeddings: bool = True
    tokenizer_name: str = "mlx-community/orpheus-3b-0.1-ft-bf16"
    sample_rate: int = 24000

    def to_llama(self) -> LlamaConfig:
        return LlamaConfig(
            num_hidden_layers=self.num_hidden_layers,
            num_attention_heads=self.num_attention_heads,
            num_key_value_heads=self.num_key_value_heads or self.num_attention_heads,
            head_dim=self.head_dim or self.hidden_size // self.num_attention_heads,
            hidden_size=self.hidden_size,
            intermediate_size=self.intermediate_size,
            rms_norm_eps=self.rms_norm_eps,
            vocab_size=self.vocab_size,
            max_position_embeddings=min(self.max_position_embeddings, 8192),
            rope_theta=self.rope_theta,
            rope_scaling=self.rope_scaling,
            tie_word_embeddings=self.tie_word_embeddings,
        )


def snac_24khz_config() -> SNACConfig:
    """The published ``hubertsiuzdak/snac_24khz``."""
    return SNACConfig(
        sampling_rate=24000, encoder_dim=64, encoder_rates=[2, 4, 8, 8],
        decoder_dim=1024, decoder_rates=[8, 8, 4, 2], attn_window_size=None,
        codebook_size=4096, codebook_dim=8, vq_strides=[4, 2, 1],
        noise=True, depthwise=True,
    )


def decode_audio_from_codes(code_list: List[int], snac: SNAC) -> np.ndarray:
    """De-interleave the 7-token frames into SNAC's 3 scales and decode;
    returns [B, T] audio."""
    layer_1, layer_2, layer_3 = [], [], []
    for i in range((len(code_list) + 1) // 7):
        layer_1.append(code_list[7 * i])
        layer_2.append(code_list[7 * i + 1] - 4096)
        layer_3.append(code_list[7 * i + 2] - 2 * 4096)
        layer_3.append(code_list[7 * i + 3] - 3 * 4096)
        layer_2.append(code_list[7 * i + 4] - 4 * 4096)
        layer_3.append(code_list[7 * i + 5] - 5 * 4096)
        layer_3.append(code_list[7 * i + 6] - 6 * 4096)
    codes = [torch.as_tensor(np.clip(layer, 0, 4095), dtype=torch.long,
                             device=snac.device)[None, :]
             for layer in (layer_1, layer_2, layer_3)]
    # a bf16 SNAC's audio leaves as float32 (numpy holds no bf16)
    return snac.decode(codes)[:, 0].float().cpu().numpy()


def encode_audio_to_codes(audio: np.ndarray, snac: SNAC) -> np.ndarray:
    """Audio -> the interleaved 7-token frame list [1, 7 T]."""
    audio = torch.as_tensor(np.asarray(audio, dtype=np.float32),
                            device=snac.device)[None, None, :]
    l1, l2, l3 = (c[0].cpu().numpy() for c in snac.encode(audio))
    out = []
    for i in range(len(l1)):
        out += [int(l1[i]), int(l2[2 * i]) + 4096,
                int(l3[4 * i]) + 2 * 4096, int(l3[4 * i + 1]) + 3 * 4096,
                int(l2[2 * i + 1]) + 4 * 4096, int(l3[4 * i + 2]) + 5 * 4096,
                int(l3[4 * i + 3]) + 6 * 4096]
    return np.asarray(out, dtype=np.int64)[None, :]


class Model(nn.Module):
    """User-facing Orpheus model.  Runs on ``device``, "cuda" unless the
    caller asks for "cpu"; the LM's weights (and a SNAC-24kHz's, when no
    ``snac`` is given) are drawn from ``seed`` on the device.  The tokenizer
    is passed in, or loaded from ``config.tokenizer_name`` as a local
    directory: an object whose ``tokenizer(text).input_ids`` are ids."""

    def __init__(self, config, snac: Optional[SNAC] = None, tokenizer=None,
                 device: str = "cuda", seed: int = 0):
        super().__init__()
        if isinstance(config, dict):
            config = ModelConfig.from_dict(config)
        device = model_device(device, "Model")
        self.config = config
        with torch.device(device):
            self.lm = LlamaForCausalLM(config.to_llama())
        init_weights(self.lm, torch.Generator(device).manual_seed(seed))
        self._snac = (snac if snac is not None
                      else SNAC(snac_24khz_config(), device=device, seed=seed))
        self._tokenizer = tokenizer
        self.device = device

    @property
    def sample_rate(self):
        return self.config.sample_rate

    def _get_tokenizer(self):
        if self._tokenizer is None:
            from mlx_audio_tpu_torch.codec.loading import checkpoint_dir

            path = checkpoint_dir(self.config.tokenizer_name)
            from transformers import AutoTokenizer

            self._tokenizer = AutoTokenizer.from_pretrained(str(path))
        return self._tokenizer

    def parse_output(self, token_ids: np.ndarray) -> List[List[int]]:
        """Crop after the last audio marker, drop stop tokens, trim to whole
        frames, remove the code offset."""
        code_lists = []
        for row in np.asarray(token_ids):
            marks = np.nonzero(row == AUDIO_MARK)[0]
            if len(marks) > 0:
                row = row[marks[-1] + 1:]
            row = row[row != STOP_AUDIO]
            row = row[: (len(row) // 7) * 7]
            code_lists.append([int(t) - CODE_OFFSET for t in row])
        return code_lists

    def prepare_input_ids(self, prompts: List[str], voice: Optional[str] = None,
                          ref_audio=None, ref_text: Optional[str] = None):
        tokenizer = self._get_tokenizer()
        audio_ids = None
        if ref_audio is not None and ref_text is not None:
            audio_ids = encode_audio_to_codes(np.asarray(ref_audio),
                                              self._snac) + CODE_OFFSET
            transcript_ids = np.asarray(tokenizer(ref_text).input_ids)
        elif voice is not None:
            prompts = [f"{voice}: " + p for p in prompts]
        rows = []
        for prompt in prompts:
            ids = np.asarray(tokenizer(prompt).input_ids)
            parts = []
            if audio_ids is not None:
                parts += [[SOH], transcript_ids.tolist(), [EOT, EOH],
                          list(AUDIO_START), audio_ids[0].tolist(),
                          list(AUDIO_END)]
            parts += [[SOH], ids.tolist(), [EOT, EOH]]
            rows.append(np.concatenate([np.asarray(p, dtype=np.int64)
                                        for p in parts]))
        return rows

    def generate(self, text: str, voice: Optional[str] = None,
                 temperature: float = 0.6, top_p: float = 0.8,
                 split_pattern: str = "\n", max_tokens: int = 1200,
                 ref_audio=None, ref_text: Optional[str] = None,
                 repetition_penalty: float = 1.3,
                 repetition_context_size: int = 20, seed: int = 0, **kwargs):
        """One GenerationResult per segment of ``text`` (split on
        ``split_pattern``), batch 1; under a mesh with dp > 1 the segments
        of a call without ``ref_audio`` decode as one ``generate_batch``."""
        from mlx_audio_tpu_torch.parallel.context import data_parallel

        prompt = text.replace("\\n", "\n").replace("\\t", "\t")
        prompts = prompt.split(split_pattern)
        if data_parallel(len(prompts)) is not None and ref_audio is None:
            yield from self.generate_batch(
                prompts, voice=voice, temperature=temperature, top_p=top_p,
                max_tokens=max_tokens, repetition_penalty=repetition_penalty,
                repetition_context_size=repetition_context_size, seed=seed)
            return
        rows = self.prepare_input_ids(prompts, voice, ref_audio, ref_text)
        for seg_idx, input_ids in enumerate(rows):
            start = time.perf_counter()
            tokens = list(input_ids)
            for chunk in generate_tokens(
                    self.lm, input_ids, max_tokens=max_tokens,
                    temperature=temperature, top_p=top_p,
                    repetition_penalty=repetition_penalty,
                    repetition_context_size=repetition_context_size,
                    stop_tokens=(STOP_AUDIO,), seed=seed + seg_idx):
                tokens.extend(int(t) for t in chunk)
            for code_list in self.parse_output(np.asarray(tokens)[None, :]):
                if not code_list:
                    continue
                audio = decode_audio_from_codes(code_list, self._snac)[0]
                yield make_generation_result(
                    audio, self.config.sample_rate, seg_idx, len(tokens),
                    time.perf_counter() - start, self.device)

    def generate_batch(self, texts: List[str], voice: Optional[str] = None,
                       temperature: float = 0.6, top_p: float = 0.8,
                       max_tokens: int = 1200,
                       repetition_penalty: float = 1.3,
                       repetition_context_size: int = 20, seed: int = 0,
                       **kwargs):
        """All texts in one batched decode (the rows share every weight
        read), then a SNAC decode each.  One GenerationResult per text, an
        empty one for a row that produced no audio codes."""
        start = time.perf_counter()
        rows = self.prepare_input_ids(list(texts), voice)
        outs = generate_tokens_batch(
            self.lm, rows, max_tokens=max_tokens, temperature=temperature,
            top_p=top_p, repetition_penalty=repetition_penalty,
            repetition_context_size=repetition_context_size,
            stop_tokens=(STOP_AUDIO,), seed=seed)
        elapsed = time.perf_counter() - start
        results = []
        for i, (prompt_ids, gen) in enumerate(zip(rows, outs)):
            tokens = np.concatenate([np.asarray(prompt_ids), gen])
            code_list = self.parse_output(tokens[None, :])[0]
            audio = (decode_audio_from_codes(code_list, self._snac)[0]
                     if code_list else np.zeros((0,), dtype=np.float32))
            results.append(make_generation_result(
                audio, self.config.sample_rate, i, len(tokens),
                elapsed / len(texts), self.device))
        return results

    def sanitize(self, weights: dict) -> dict:
        """HF Llama checkpoints map one to one under the ``lm.`` prefix."""
        out = {}
        for k, v in weights.items():
            if k.startswith(("model.", "lm_head")):
                k = "lm." + k
            elif not k.startswith("lm."):
                k = "lm.model." + k
            out[k] = np.asarray(v)
        return out
