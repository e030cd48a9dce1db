"""IndexTTS: a GPT-2 mel-code LM with conformer-perceiver voice conditioning
and a speaker-conditioned BigVGAN that vocodes the LM's latents
(counterpart of ``mlx_audio_tpu/models/tts/indextts/indextts.py``).

The prompt of a text is [conditioning latents | start_text, tokens,
stop_text, start_mel] with learned text positions; a batch's ragged
prompts are left-padded to a multiple of 64 and decoded in lockstep, one
GPT step a Python iteration, the host looking for stop codes every
``_CHECK_EVERY`` steps.  The mel positions are offset by each row's whole
prompt length and clipped to the table (the reference's quirk).  A row's
latent stream is the prefill's latent and that of every step up to and
including the one that sampled the stop code, cut to ``max_tokens + 1``;
rows of equal latent count go to the vocoder as one call, in sub-batches
of at most ``VOCODER_SUB_BATCH``.

Sampling is ``models.sampling.sample_top_k_rows``: each step takes a seed
from a host generator seeded ``seed``, and row i draws with its own
generator of that seed (the JAX package folds ``jax.random`` keys per
row); temperature 0 is greedy.  A vocoder call encodes the speaker of
the one reference mel once for all its rows (the JAX package encodes it
for each row).  Under an active mesh with dp > 1 ``generate_batch`` pads its
texts to a dp multiple, builds every prompt on the model's device, and each
data row decodes its slice on its replica at the whole batch's prompt
bucket under ``row_offset``; the vocoder runs on the model's device.  A
tokenizer is passed in (any object with
``encode(text) -> ids``), else a SentencePiece ``tokenizer.model`` is read
from ``tokenizer_name``; ``from_pretrained`` loads a local directory only.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from mlx_audio_tpu_torch.models.base import (
    init_weights,
    make_generation_result,
    model_device,
)
from mlx_audio_tpu_torch.models.sampling import call_seed, sample_top_k_rows
from mlx_audio_tpu_torch.models.tts.indextts import normalize
from mlx_audio_tpu_torch.models.tts.indextts.attention import LearnedPositionEncoding
from mlx_audio_tpu_torch.models.tts.indextts.conformer import Conformer, ConformerArgs
from mlx_audio_tpu_torch.models.tts.indextts.gpt import GPT2Args, GPT2Model
from mlx_audio_tpu_torch.models.tts.indextts.perceiver import PerceiverResampler
from mlx_audio_tpu_torch.models.tts.indextts.vocoder import (
    BigVGANConditioning,
    BigVGANConditioningConfig,
    log_mel_spectrogram,
)
from mlx_audio_tpu_torch.nn.layers import Embedding, LayerNorm, Linear

# most rows a vocoder call takes (generate_batch): the 1024x-upsampled
# activations grow with the rows
VOCODER_SUB_BATCH = 16
_CHECK_EVERY = 8  # decode steps between the host's looks for stop codes


@dataclass
class GPTConfig:
    model_dim: int
    heads: int
    layers: int
    max_mel_tokens: int
    max_text_tokens: int
    number_text_tokens: int
    number_mel_codes: int
    start_mel_token: int
    stop_mel_token: int
    start_text_token: int
    stop_text_token: int
    use_mel_codes_as_input: bool = True
    mel_length_compression: int = 1024
    condition_type: str = "conformer_perceiver"
    condition_module: ConformerArgs = field(default_factory=ConformerArgs)
    max_conditioning_inputs: int = 1
    condition_num_latent: int = 32


@dataclass
class ModelConfig:
    bigvgan: BigVGANConditioningConfig
    gpt: GPTConfig
    tokenizer_name: Any = ""
    sample_rate: int = 24000

    @classmethod
    def from_dict(cls, params: Dict[str, Any]) -> "ModelConfig":
        p = dict(params)
        gpt = dict(p["gpt"])
        cond = gpt.get("condition_module", {})
        if isinstance(cond, dict):
            gpt["condition_module"] = ConformerArgs(**{
                k: v for k, v in cond.items() if k in ConformerArgs.__dataclass_fields__})
        gpt = {k: v for k, v in gpt.items() if k in GPTConfig.__dataclass_fields__}
        bigvgan = p["bigvgan"]
        if isinstance(bigvgan, dict):
            bigvgan = BigVGANConditioningConfig.from_dict(bigvgan)
        return cls(bigvgan=bigvgan, gpt=GPTConfig(**gpt),
                   tokenizer_name=p.get("tokenizer_name", ""),
                   sample_rate=p.get("sample_rate", 24000))


def _bucket(n: int, step: int = 64) -> int:
    return max(step, -(-n // step) * step)


class Model(nn.Module):
    def __init__(self, config, tokenizer=None, device: str = "cuda", seed: int = 0):
        super().__init__()
        if isinstance(config, dict):
            config = ModelConfig.from_dict(config)
        if not config.gpt.use_mel_codes_as_input:
            raise NotImplementedError("use_mel_codes_as_input=false")
        if config.gpt.condition_type != "conformer_perceiver":
            raise NotImplementedError(f"condition_type={config.gpt.condition_type}")
        self.args = config
        self.sample_rate = config.sample_rate
        self._tokenizer = tokenizer
        self.device = model_device(device, "IndexTTS")
        g = config.gpt
        self.bigvgan = BigVGANConditioning(config.bigvgan, device=self.device, seed=seed)
        with torch.device(self.device):
            self.text_embedding = Embedding(g.number_text_tokens + 1, g.model_dim)
            self.mel_embedding = Embedding(g.number_mel_codes, g.model_dim)
            self.mel_pos_embedding = LearnedPositionEncoding(
                g.max_mel_tokens + 2 + g.max_conditioning_inputs, g.model_dim)
            self.text_pos_embedding = LearnedPositionEncoding(g.max_text_tokens + 2,
                                                              g.model_dim)
            self.text_head = Linear(g.model_dim, g.number_text_tokens + 1)
            self.mel_head = Linear(g.model_dim, g.number_mel_codes)
            self.conditioning_encoder = Conformer(g.condition_module)
            self.perceiver_encoder = PerceiverResampler(
                g.model_dim, n_dim_context=g.condition_module.output_size,
                n_ff_mult=g.condition_module.perceiver_mult,
                n_heads=g.condition_module.attention_heads,
                n_latents=g.condition_num_latent)
            self.gpt = GPT2Model(GPT2Args(g.model_dim, g.heads, g.layers))
            self.final_norm = LayerNorm(g.model_dim)
        gen = torch.Generator(self.device).manual_seed(seed + 1)
        for name, child in self.named_children():
            if name != "bigvgan":  # drawn from ``seed`` when it was built
                init_weights(child, gen)

    @property
    def model_type(self) -> str:
        return "indextts"

    @property
    def tokenizer(self):
        if self._tokenizer is None:
            try:
                import sentencepiece as spm
            except ImportError as e:
                raise RuntimeError(
                    "IndexTTS needs sentencepiece (tokenizer.model); install "
                    "it or pass tokenizer= to Model()") from e
            self._tokenizer = spm.SentencePieceProcessor(
                model_file=str(Path(self.args.tokenizer_name) / "tokenizer.model"))
        return self._tokenizer

    # -- conditioning ----------------------------------------------------------

    @torch.no_grad()
    def get_conditioning(self, mel: torch.Tensor) -> torch.Tensor:
        """reference log-mel [B, T, num_mels] -> conditioning latents [B,
        condition_num_latent, model_dim]."""
        return self.perceiver_encoder(self.conditioning_encoder(mel))

    @torch.no_grad()
    def prepare_input_embedding(self, prompts: List[str], ref_mel: torch.Tensor):
        """Each prompt's [1, L_i, model_dim] embedding (one tensor for one
        prompt, else a list)."""
        conditioning = self.get_conditioning(ref_mel).repeat_interleave(len(prompts), 0)
        g = self.args.gpt
        rows = []
        for idx, prompt in enumerate(prompts):
            tokens = list(self.tokenizer.encode(
                normalize.tokenize_by_CJK_char(normalize.normalize(prompt))))
            tokens = [g.start_text_token] + tokens + [g.stop_text_token, g.start_mel_token]
            tok = torch.tensor(tokens, dtype=torch.long, device=self.device)[None]
            text_emb = self.text_embedding(tok) + self.text_pos_embedding(tok)
            rows.append(torch.cat([conditioning[idx:idx + 1], text_emb], dim=1))
        return rows[0] if len(rows) == 1 else rows

    def _reference_mel(self, ref_audio, ref_mel) -> torch.Tensor:
        if ref_audio is not None:
            return log_mel_spectrogram(torch.as_tensor(ref_audio, dtype=torch.float32,
                                                       device=self.device))
        if ref_mel is None:
            raise ValueError("Must provide one of ref_audio or ref_mel")
        return torch.as_tensor(ref_mel, dtype=torch.float32, device=self.device)

    # -- generation ------------------------------------------------------------

    def generate(self, text: str, ref_audio=None, ref_mel=None, verbose: bool = False,
                 max_tokens: int = 5000, temperature: float = 0.8, top_k: int = 30,
                 seed: int = 0, chunk: int = 64, **kwargs):
        yield self.generate_batch([text], ref_audio=ref_audio, ref_mel=ref_mel,
                                  max_tokens=max_tokens, temperature=temperature,
                                  top_k=top_k, seed=seed, chunk=chunk)[0]

    @torch.no_grad()
    def _start(self, texts: List[str], ref_mel: torch.Tensor, max_tokens: int,
               rows: Optional[list] = None, bucket: Optional[int] = None):
        """The texts' prompts (``rows``, their embeddings, when given),
        left-padded to a shared bucket (the least that fits unless given),
        through the prefill: (caches, pad_len [B], prompt_len [B], latent0
        [B, D])."""
        if rows is None:
            rows = self.prepare_input_embedding(texts, ref_mel)
            rows = [rows] if len(texts) == 1 else rows
        b, d = len(rows), rows[0].shape[-1]
        lens = [int(r.shape[1]) for r in rows]
        bucket = bucket or _bucket(max(lens))
        padded = torch.zeros(b, bucket, d, device=self.device)
        for i, r in enumerate(rows):
            padded[i, bucket - lens[i]:] = r[0].to(self.device)
        pad_len = torch.tensor([bucket - n for n in lens], device=self.device)
        caches = self.gpt.init_cache(b, bucket + max_tokens,
                                     dtype=self.mel_embedding.weight.dtype)
        hidden, caches = self.gpt.prefill_left(caches, padded, pad_len)
        return caches, pad_len, torch.tensor(lens, device=self.device), self.final_norm(hidden)

    @torch.no_grad()
    def _step(self, caches, last: torch.Tensor, mel_pos: int, pad_len: torch.Tensor,
              prompt_len: torch.Tensor) -> torch.Tensor:
        """Decode step ``mel_pos`` (from 0): the codes ``last`` [B] in at
        their learned positions, the latent [B, D] out."""
        table = self.mel_pos_embedding.emb.weight.shape[0]
        pos = torch.clamp(prompt_len + mel_pos, max=table - 1)
        emb = self.mel_embedding(last[:, None]) + self.mel_pos_embedding.emb(pos)[:, None]
        hidden, _ = self.gpt.step(caches, emb, pad_len)
        return self.final_norm(hidden)

    @torch.no_grad()
    def generate_latents(self, texts: List[str], ref_mel: torch.Tensor,
                         max_tokens: int = 5000, temperature: float = 0.8,
                         top_k: int = 30, seed: int = 0, rows: Optional[list] = None,
                         bucket: Optional[int] = None):
        """The texts' prompts, their left-padded prefill and the lockstep
        decode loop -> (latent streams, codes): row i's stream [n_i,
        model_dim] (n_i <= max_tokens + 1) and its n_i mel codes, code k
        sampled from latent k (the last one the stop code, where the row
        stopped).  ``rows`` and ``bucket`` go to ``_start``."""
        stop = self.args.gpt.stop_mel_token
        caches, pad_len, prompt_len, latent0 = self._start(texts, ref_mel, max_tokens,
                                                           rows, bucket)
        gen = torch.Generator().manual_seed(seed)
        first = last = sample_top_k_rows(self.mel_head(latent0), temperature, top_k,
                                         seed=call_seed(gen))
        done = (last == stop).cpu().numpy()
        stopped_at_first = done.copy()
        latents, tokens = [], []
        while not done.all() and len(tokens) < max_tokens:
            latent = self._step(caches, last, len(tokens), pad_len, prompt_len)
            last = sample_top_k_rows(self.mel_head(latent), temperature, top_k,
                                     seed=call_seed(gen))
            latents.append(latent)
            tokens.append(last)
            if len(tokens) % _CHECK_EVERY == 0:
                recent = torch.stack(tokens[-_CHECK_EVERY:], dim=1)
                done |= (recent == stop).any(1).cpu().numpy()
        streams = torch.stack([latent0] + latents, dim=1)  # [B, 1 + steps, D]
        codes = torch.stack([first] + tokens, dim=1).cpu().numpy()
        out, out_codes = [], []
        for i in range(len(texts)):
            n = 0
            if not stopped_at_first[i]:
                hits = np.nonzero(codes[i, 1:] == stop)[0]
                # the latent of the step that sampled the stop code is kept
                n = int(hits[0]) + 1 if len(hits) else len(tokens)
            out.append(streams[i, :1 + n])
            out_codes.append(codes[i, :1 + n].tolist())
        return out, out_codes

    def generate_batch(self, texts: List[str], ref_audio=None, ref_mel=None,
                       max_tokens: int = 5000, temperature: float = 0.8, top_k: int = 30,
                       seed: int = 0, chunk: int = 64, **kwargs) -> list:
        """Batched synthesis: the texts share one conditioning pass and one
        decode loop (left-padded ragged prompts, per-row stops); rows of
        equal latent count share a vocoder call.  ``chunk`` is accepted for
        the JAX package's signature (its decode scans that many steps a
        call); here the loop steps once a Python iteration."""
        from mlx_audio_tpu_torch.parallel.context import data_parallel

        ref_mel = self._reference_mel(ref_audio, ref_mel)
        t0 = time.perf_counter()
        dp = data_parallel(len(texts))
        if dp is None:
            streams, _ = self.generate_latents(texts, ref_mel, max_tokens, temperature,
                                               top_k, seed)
        else:
            run = list(texts) + [texts[-1]] * (dp.pad_rows(len(texts)) - len(texts))
            with torch.no_grad():
                rows = self.prepare_input_embedding(run, ref_mel)
            bucket = _bucket(max(int(r.shape[1]) for r in rows))
            parts = dp.map_rows(dp.place_replicated(self), len(run), lambda m, lo, hi: (
                m.generate_latents(run[lo:hi], None, max_tokens, temperature, top_k,
                                   seed, rows[lo:hi], bucket)[0]))
            streams = [st.to(self.device) for part in parts for st in part][:len(texts)]
        elapsed = time.perf_counter() - t0  # the JAX package's clock stops here
        lengths = [int(s.shape[0]) for s in streams]
        length_groups: Dict[int, list] = {}
        for i, n in enumerate(lengths):
            length_groups.setdefault(n, []).append(i)
        cap = VOCODER_SUB_BATCH
        audios: Dict[int, np.ndarray] = {}
        for idxs in length_groups.values():
            for j in range(0, len(idxs), cap):
                part = idxs[j:j + cap]
                # float32, as the JAX package stacks them: a bf16 model's
                # vocoder runs in float32 over its bf16 weights
                stack = torch.stack([streams[i] for i in part]).float()  # [G, n, D]
                # one reference: its speaker embedding broadcasts over the rows
                wavs = self.bigvgan(stack, ref_mel).cpu().numpy()
                for row, i in enumerate(part):
                    audios[i] = wavs[row].reshape(-1)
        return [make_generation_result(audios[i], self.sample_rate, i, lengths[i],
                                       elapsed / len(texts), self.device)
                for i in range(len(texts))]

    # -- weights ---------------------------------------------------------------

    def sanitize(self, weights: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """A torch IndexTTS checkpoint -> the JAX package's layouts (which
        ``convert.params_from_jax`` takes on to the port's)."""
        gpt_w, bigvgan_w = {}, {}
        bigvgan_prefixes = ("ups.", "speaker_encoder.", "resblocks.", "conv_pre.",
                            "conv_post.", "conds.", "cond_layer.", "activation_post.")
        for k, v in weights.items():
            (bigvgan_w if k.startswith(bigvgan_prefixes) else gpt_w)[k] = v

        out: Dict[str, np.ndarray] = {}
        for k, v in gpt_w.items():
            v = np.asarray(v)
            if "pos_enc" in k or "num_batches_tracked" in k:
                continue  # computed tables, torch counters
            if k.endswith(".attn.bias") and ".c_" not in k:
                continue  # HF's causal-mask buffer
            # speechbrain wrapper flattening
            k = (k.replace("norm.norm", "norm").replace("conv.conv", "conv")
                 .replace("fc.conv", "fc").replace("asp_bn.norm", "asp_bn"))
            if "conv" in k and v.ndim == 3:
                v = v.transpose(2, 1, 0)  # torch [O, I, K] -> [K, I, O]
            elif "conv" in k and v.ndim == 4:
                v = v.transpose(2, 3, 1, 0)  # [O, I, kh, kw] -> HWIO
            if ("gpt.h." in k and v.ndim == 2 and k.endswith(".weight")
                    and (".c_attn." in k or ".c_proj." in k or ".c_fc." in k)):
                v = v.T  # HF GPT2's Conv1D stores [in, out]
            # perceiver naming: to_q / to_kv / to_out -> linear_{q,k,v,out}
            if "perceiver_encoder.layers." in k:
                if ".0.to_q." in k:
                    k = k.replace(".0.to_q.", ".0.linear_q.")
                elif ".0.to_out." in k:
                    k = k.replace(".0.to_out.", ".0.linear_out.")
                elif ".0.to_kv." in k:
                    kk, vv = np.split(v, 2, axis=0)
                    out[k.replace(".0.to_kv.", ".0.linear_k.")] = kk
                    out[k.replace(".0.to_kv.", ".0.linear_v.")] = vv
                    continue
                elif ".1.0." in k:
                    k = k.replace(".1.0.", ".1.w_1.")
                elif ".1.2." in k:
                    k = k.replace(".1.2.", ".1.w_2.")
            if k == "perceiver_encoder.norm.gamma":
                k = "perceiver_encoder.norm.weight"
            out[k] = v

        for k, v in bigvgan_w.items():
            v = np.asarray(v)
            if "num_batches_tracked" in k or ".filter" in k:
                continue  # torch counters, computed sinc filters
            k = (k.replace("norm.norm", "norm").replace("conv.conv", "conv")
                 .replace("conv1.conv", "conv1").replace("conv2.conv", "conv2")
                 .replace("fc.conv", "fc").replace("asp_bn.norm", "asp_bn"))
            if v.ndim == 3:
                if k.startswith("ups."):
                    v = v.transpose(2, 0, 1)  # convT [I, O, K] -> [K, I, O]
                else:
                    v = v.transpose(2, 1, 0)  # conv [O, I, K] -> [K, I, O]
            if (".alpha" in k or ".beta" in k) and v.ndim > 1:
                v = v.reshape(-1)
            out["bigvgan." + k] = v
        return out

    @classmethod
    def from_pretrained(cls, path: str, tokenizer=None, device: str = "cuda") -> "Model":
        """A local directory holding ``config.json`` (``ModelConfig``'s fields)
        and ``*.safetensors`` in a torch IndexTTS checkpoint's layout (through
        ``sanitize``), or in the JAX package's when the config says
        ``native_format``.  The computed anti-aliasing filters keep their
        values."""
        from mlx_audio_tpu_torch.codec.loading import (
            checkpoint_dir,
            load_config,
            load_weights_files,
        )
        from mlx_audio_tpu_torch.convert import params_from_jax

        model_path = checkpoint_dir(path)
        config = load_config(model_path)
        model = cls(ModelConfig.from_dict(config), tokenizer=tokenizer, device=device)
        weights = load_weights_files(model_path)
        if not config.get("native_format"):
            weights = model.sanitize(weights)
        missing, unexpected = model.load_state_dict(params_from_jax(weights, model),
                                                    strict=False)
        missing = [k for k in missing if not k.endswith(".filter")]
        if missing or unexpected:
            raise ValueError(f"{path}: missing {missing[:10]}, unexpected {unexpected[:10]}")
        return model
