"""Sesame CSM-1B: conversational text to speech (counterpart of
``mlx_audio_tpu/models/tts/sesame/model.py``).

A Llama-1B backbone predicts Mimi codebook 0 of each 80 ms frame; a
Llama-100M depth decoder predicts codebooks 1..31 within the frame; Mimi
decodes the frames to 24 kHz audio.

* The prompt is left-padded to a length bucket and prefilled once; frames
  are generated in chunks of Python steps, and the host looks for the
  all-zero end-of-speech frame between chunks.
* After ``quantize_model(model.model, ...)`` every Linear runs through the
  ``quantized_matmul`` kernel at decode sizes.
* ``SesameModel.enable_spec_decode()`` switches a batch-1 frame to the
  draft-and-verify depth decode: the ``depth_draft`` kernel drafts c2..c31
  from an int8 pack, one teacher-forced pass verifies them, and the rejected
  tail is finished step by step, so the emitted frames are the plain
  decode's (bit-equal under greedy decoding up to float ties).
* Sampling draws come from the model's host-side ``torch.Generator``,
  seeded per ``generate`` call: each sampling call takes a seed from it in
  frame order, and each batch row samples with its own generator of that
  seed (``models.sampling.sample_top_k_rows``), so a row's draw does not
  depend on its batch.  The JAX package's PRNG cannot be reproduced, so
  only greedy decodes are compared with it.
* ``generate(stream=True)`` yields the first 3 frames' audio, then 4, then
  chunks of ``streaming_interval * 12.5`` frames, each decoded through
  Mimi's carried streaming state; a chunk schedule changes when audio
  leaves, not which frames are sampled.
* Left for later slices: the silentcipher watermark, the tokenizer loader
  (pass ``text_tokenizer``), the mesh and data-parallel branches, and
  bf16.
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mlx_audio_tpu_torch.codec.mimi import Mimi, mimi_202407, mimi_from_hf_config
from mlx_audio_tpu_torch.models.base import (
    GenerationResult,
    init_weights,
    make_generation_result,
    model_device,
)
from mlx_audio_tpu_torch.models.lm.llama import (
    LLAMA_FLAVORS,
    LlamaConfig,
    LlamaModel,
    lm_dtype,
)
from mlx_audio_tpu_torch.models.sampling import (
    call_seed,
    gumbel,
    row_generator,
    sample_top_k_rows,
)
from mlx_audio_tpu_torch.nn import kernels
from mlx_audio_tpu_torch.nn.layers import Embedding, Linear, _uniform_
from mlx_audio_tpu_torch.nn.pallas_depth import _dense, gumbel_argmax, pack_depth
from mlx_audio_tpu_torch.models.tts.sesame.watermarking import (
    CSM_1B_GH_WATERMARK,
    load_watermarker,
    watermark,
)

DRAFT_CACHE = 40  # depth-decoder cache slots of the draft path (nc + 1, padded)
FRAME_CHUNK = 32  # frames between the host's end-of-speech checks


@dataclass
class Segment:
    speaker: int
    text: str
    audio: np.ndarray  # (num_samples,) at 24 kHz


def _llama_cfg_from_dict(d: dict, vocab_override: Optional[int] = None) -> LlamaConfig:
    return LlamaConfig(
        num_hidden_layers=d["num_hidden_layers"],
        num_attention_heads=d["num_attention_heads"],
        num_key_value_heads=d["num_key_value_heads"],
        head_dim=d["head_dim"], hidden_size=d["hidden_size"],
        intermediate_size=d["intermediate_size"],
        rms_norm_eps=d["rms_norm_eps"],
        vocab_size=vocab_override if vocab_override is not None else d["vocab_size"],
        max_position_embeddings=d.get("max_position_embeddings", 2048),
        attention_bias=d.get("attention_bias", False),
        mlp_bias=d.get("mlp_bias", False),
        rope_theta=d.get("rope_theta", 500000),
        rope_scaling=d.get("rope_scaling"))


def check_spec_decode(decoder_cfg: LlamaConfig, num_codebooks: int,
                      vocab: int, device) -> None:
    """Raise ValueError, naming the shape, when the ``depth_draft`` kernel
    does not take this depth decoder on ``device``; on the CPU the plain
    draft takes every shape."""
    if torch.device(device).type != "cuda":
        return
    c = decoder_cfg
    shape = dict(n_layers=c.num_hidden_layers, dm=c.hidden_size,
                 f_inter=c.intermediate_size, hq=c.num_attention_heads,
                 hkv=c.num_key_value_heads, dh=c.head_dim,
                 n_steps=num_codebooks - 2, vpad=-(-vocab // 128) * 128)
    if not kernels.depth_draft_supported(**shape):
        raise ValueError(f"spec decode: the depth_draft kernel does not take "
                         f"this depth decoder: {shape}")


class SesameModel(nn.Module):
    """Backbone, depth decoder, embeddings and heads."""

    def __init__(self, config: dict):
        super().__init__()
        self.audio_num_codebooks = config.get("audio_num_codebooks",
                                              config.get("num_codebooks"))
        self.audio_vocab_size = config.get("audio_vocab_size",
                                           config.get("vocab_size"))
        if "num_hidden_layers" in config:
            backbone_cfg = _llama_cfg_from_dict(
                config, vocab_override=int(config["text_vocab_size"]))
            decoder_cfg = _llama_cfg_from_dict(config["depth_decoder_config"])
        else:
            backbone_cfg = LLAMA_FLAVORS[config["backbone_flavor"]]
            decoder_cfg = LLAMA_FLAVORS[config["decoder_flavor"]]
        self.backbone_cfg, self.decoder_cfg = backbone_cfg, decoder_cfg
        self.backbone = LlamaModel(backbone_cfg, use_embed_tokens=False)
        self.decoder = LlamaModel(decoder_cfg, use_embed_tokens=False)
        db, dm = backbone_cfg.hidden_size, decoder_cfg.hidden_size
        nc, v = self.audio_num_codebooks, self.audio_vocab_size
        self.text_embeddings = Embedding(config["text_vocab_size"], db)
        self.audio_embeddings = Embedding(v * nc, db)
        self.projection = Linear(db, dm, bias=False)
        self.codebook0_head = Linear(db, v, bias=False)
        self.audio_head = nn.Parameter(torch.zeros(nc - 1, dm, v),
                                       requires_grad=False)
        self.spec_decode = False
        self._spec_packed = None
        self.spec_stats = [0, 0]  # draft tokens accepted, drafted

    def init_weights(self, generator: torch.Generator) -> None:
        # the JAX package starts audio_head at zero for loading; random
        # weights need a non-degenerate head
        _uniform_(self.audio_head, self.decoder_cfg.hidden_size ** -0.5, generator)

    # -- embeddings --------------------------------------------------------

    def embed_tokens(self, tokens: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """tokens [B, T, nc + 1] (audio codebooks, then text) -> [B, T, D]."""
        nc, v = self.audio_num_codebooks, self.audio_vocab_size
        text = self.text_embeddings(tokens[..., -1])[:, :, None]
        offsets = torch.arange(nc, device=tokens.device) * v
        audio = self.audio_embeddings(tokens[..., :-1] + offsets)
        embeds = torch.cat([audio, text], dim=-2)
        return (embeds * mask[..., None]).sum(2)

    def embed_audio(self, codebook: int, tokens: torch.Tensor) -> torch.Tensor:
        return self.audio_embeddings(tokens + codebook * self.audio_vocab_size)

    def lm_dtype(self) -> torch.dtype:
        return lm_dtype(self.backbone)

    # -- one frame ---------------------------------------------------------

    def _use_spec(self, batch: int) -> bool:
        return self.spec_decode and batch == 1 and self._spec_packed is not None

    def first_frame(self, last_h, temp, top_k, generator):
        """The frame after hidden state last_h [B, D]: codebook 0 from the
        backbone's head, then the depth decode.  ``generator`` (CPU) gives
        each sampling call's seed."""
        c0 = sample_top_k_rows(self.codebook0_head(last_h), temp, top_k,
                               call_seed(generator))[:, None].long()
        if self._use_spec(last_h.shape[0]):
            return self._depth_decode_spec(last_h, c0, temp, top_k, generator)
        return self._depth_decode(last_h, c0, temp, top_k, generator)

    def generate_frame_step(self, caches: list, pad_len: torch.Tensor,
                            embeds: torch.Tensor, temp: float, top_k: int,
                            generator: Optional[torch.Generator] = None):
        """embeds [B, S, D] -> (frame codes [B, nc], caches)."""
        h, caches = self.backbone.step(caches, embeds, pad_len)
        return self.first_frame(h[:, -1], temp, top_k, generator), caches

    def _depth_decode(self, last_h, c0, temp, top_k, generator):
        """The nc - 1 sequential depth-decoder steps of a frame."""
        b = last_h.shape[0]
        nc = self.audio_num_codebooks
        caches = self.decoder.init_cache(b, max_len=nc + 1, dtype=last_h.dtype)
        pad0 = torch.zeros(b, dtype=torch.long, device=last_h.device)
        first = torch.cat([last_h[:, None], self.embed_audio(0, c0)], dim=1)
        h, _ = self.decoder.step(caches, self.projection(first), pad0)
        codes = [c0]
        for i in range(nc - 1):
            if i:
                embed = self.embed_audio(i, codes[-1])
                h, _ = self.decoder.step(caches, self.projection(embed), pad0)
            logits = h[:, -1] @ self.audio_head[i]
            codes.append(sample_top_k_rows(logits, temp, top_k,
                                           call_seed(generator))[:, None].long())
        return torch.cat(codes, dim=1)

    # -- speculative depth decode (batch 1) --------------------------------

    @torch.no_grad()
    def enable_spec_decode(self) -> None:
        """Pack the depth decoder for the ``depth_draft`` kernel and switch
        batch-1 frames to draft-and-verify decoding.  A quantized model packs
        its dequantized weights.  Raises ValueError on a card whose kernel
        does not take the depth decoder's shape."""
        check_spec_decode(self.decoder_cfg, self.audio_num_codebooks,
                          self.audio_vocab_size, self.decoder.rope_cos.device)
        self._spec_packed = pack_depth(
            self.decoder, _dense(self.projection).t(), self.audio_head,
            _dense(self.audio_embeddings), self.audio_vocab_size)
        self.spec_decode = True

    def _depth_decode_spec(self, last_h, c0, temp, top_k, generator):
        """Draft c2..c31 with the int8 kernel, verify them with one
        teacher-forced pass, finish the rejected tail step by step."""
        nc, v = self.audio_num_codebooks, self.audio_vocab_size
        packed = self._spec_packed
        vpad = packed.heads.shape[1]
        dev = last_h.device
        pad0 = torch.zeros(1, dtype=torch.long, device=dev)
        # one row: its noise block comes from the row-0 generator of a seed
        noise = (gumbel((nc - 1, vpad), row_generator(call_seed(generator), 0, dev),
                        dev) if temp > 0 else torch.zeros(nc - 1, vpad, device=dev))

        def padded(logits):
            return F.pad(logits, (0, vpad - v), value=float("-inf"))

        caches = self.decoder.init_cache(1, max_len=DRAFT_CACHE, dtype=last_h.dtype)
        first = torch.cat([last_h[:, None], self.embed_audio(0, c0)], dim=1)
        h, _ = self.decoder.step(caches, self.projection(first), pad0)
        c1 = gumbel_argmax(padded(h[:, -1] @ self.audio_head[0]),
                           noise[0:1], v, temp, top_k)[0]

        kc = torch.stack([c.k[0] for c in caches]).float()
        vc = torch.stack([c.v[0] for c in caches]).float()
        draft = kernels.depth_draft(packed, kc, vc, c1, noise[1:], v, temp, top_k)
        draft_full = torch.cat([c1[None], draft.long()])   # c1..c31

        offs = torch.arange(1, nc - 1, device=dev) * v
        emb = self.audio_embeddings(draft_full[:-1] + offs)[None]
        ver_in = self.projection(torch.cat([first, emb], dim=1))
        ver_caches = self.decoder.init_cache(1, max_len=DRAFT_CACHE, dtype=last_h.dtype)
        vh, _ = self.decoder.prefill(ver_caches, ver_in, pad0)
        logits = torch.einsum("td,tdv->tv", vh[0, 1:], self.audio_head)
        targets = gumbel_argmax(padded(logits), noise, v, temp, top_k)

        mismatch = torch.nonzero(targets != draft_full).flatten().tolist()
        m = mismatch[0] if mismatch else nc - 1
        self.spec_stats[0] += max(m - 1, 0)
        self.spec_stats[1] += nc - 2
        tokens = torch.where(torch.arange(nc - 1, device=dev) < m, draft_full, targets)
        # tokens c1..c_{m+1} are right; slots 0..m+1 of the verify cache were
        # built from right inputs, so finish c_{m+2}.. on it
        for c in ver_caches:
            c.idx = m + 2
        for j in range(m + 1, nc - 1):
            embed = self.audio_embeddings(tokens[j - 1].reshape(1, 1) + j * v)
            hh, _ = self.decoder.step(ver_caches, self.projection(embed), pad0)
            tokens[j] = gumbel_argmax(padded(hh[:, -1] @ self.audio_head[j]),
                                      noise[j:j + 1], v, temp, top_k)[0]
        return torch.cat([c0, tokens[None]], dim=1)


class Model(nn.Module):
    """User-facing CSM model.

    Runs on ``device``, "cuda" unless the caller asks for "cpu"; weights
    are drawn from ``seed`` (load real ones with ``load_state_dict``).  The
    text tokenizer is passed in: an object whose ``encode(text)`` returns
    token ids (Llama-3's for a published checkpoint).
    """

    def __init__(self, config: dict, mimi: Optional[Mimi] = None,
                 text_tokenizer=None, device: str = "cuda", seed: int = 0):
        super().__init__()
        device = model_device(device, "Model")
        self.config = config
        gen = torch.Generator(device).manual_seed(seed)
        with torch.device(device):
            self.model = SesameModel(config)
            own = [self.model]
            if mimi is None:
                codec = config.get("codec_config")
                mimi = Mimi(mimi_from_hf_config(codec) if isinstance(codec, dict)
                            else mimi_202407(self.model.audio_num_codebooks))
                own.append(mimi)
        for root in own:
            init_weights(root, gen)
        self._mimi = mimi.to(device)
        self.audio_num_codebooks = self.model.audio_num_codebooks
        self._text_tokenizer = text_tokenizer
        self._sample_rate = int(mimi.sample_rate)
        self.device = device
        self.generator = torch.Generator()  # host side: the sampling calls' seeds
        # imperceptible AI-audio watermark on every output; disable only with
        # apply_watermark=False
        self.apply_watermark = config.get("apply_watermark", True)

    @property
    def sample_rate(self) -> int:
        return self._sample_rate

    @property
    def mimi(self) -> Mimi:
        return self._mimi

    def cast_lm(self, dtype) -> "Model":
        """Cast the backbone and depth decoder; float32 only in this port so
        far.  bf16 runs through the conv and LSTM kernels (Kokoro, the conv
        codecs and vocoders); CSM's bf16 LM, with quantized_matmul's bf16
        activations and the depth draft's inputs, is ROADMAP queue 1 item
        7b."""
        if dtype != torch.float32:
            raise NotImplementedError(
                "cast_lm: CSM's LM runs float32 only so far (bf16 is ROADMAP "
                "queue 1 item 7b)")
        return self

    def _watermark(self, audio: np.ndarray) -> np.ndarray:
        if not self.apply_watermark:
            return audio
        return watermark(load_watermarker(), audio, self._sample_rate,
                         CSM_1B_GH_WATERMARK)

    def _get_tokenizer(self):
        if self._text_tokenizer is None:
            raise ValueError("CSM needs text_tokenizer= (an object with "
                             "encode(text) -> ids); the port loads none")
        return self._text_tokenizer

    # -- tokenization ------------------------------------------------------

    def _tokenize_text_segment(self, text: str, speaker: int):
        nc1 = self.audio_num_codebooks + 1
        ids = np.asarray(self._get_tokenizer().encode(f"[{speaker}]{text}"))
        frame = np.zeros((len(ids), nc1), dtype=np.int64)
        mask = np.zeros((len(ids), nc1), dtype=bool)
        frame[:, -1] = ids
        mask[:, -1] = True
        return frame, mask

    def _tokenize_audio(self, audio: np.ndarray, add_eos: bool = True):
        nc1 = self.audio_num_codebooks + 1
        spf = self._mimi.samples_per_frame
        pcm = np.asarray(audio, dtype=np.float32)
        pcm = np.pad(pcm, (0, (-len(pcm)) % spf))
        codes = self._mimi.encode(torch.as_tensor(pcm, device=self.device)
                                  [None, None]).cpu().numpy()[0]  # [nc, T]
        if add_eos:
            codes = np.concatenate([codes, np.zeros((codes.shape[0], 1), codes.dtype)], 1)
        frame = np.zeros((codes.shape[1], nc1), dtype=np.int64)
        mask = np.zeros((codes.shape[1], nc1), dtype=bool)
        frame[:, :-1] = codes.T
        mask[:, :-1] = True
        return frame, mask

    def _tokenize_segment(self, segment: Segment, add_eos: bool = True):
        tf, tm = self._tokenize_text_segment(segment.text, segment.speaker)
        af, am = self._tokenize_audio(segment.audio, add_eos=add_eos)
        return np.concatenate([tf, af]), np.concatenate([tm, am])

    def _prompt(self, prompt: str, context: List[Segment], speaker: int,
                voice_match: bool):
        if voice_match:
            gen_text = (context[0].text + " " + prompt).strip()
            toks = [self._tokenize_segment(
                Segment(speaker=speaker, text=gen_text, audio=context[0].audio),
                add_eos=False)]
        else:
            toks = [self._tokenize_segment(s) for s in context]
            toks.append(self._tokenize_text_segment(prompt, speaker))
        return (np.concatenate([t for t, _ in toks]),
                np.concatenate([m for _, m in toks]))

    @staticmethod
    def _context(context, speaker, ref_audio, ref_text):
        context = list(context or [])
        if not context and ref_audio is not None and ref_text is not None:
            context = [Segment(speaker=speaker, text=ref_text, audio=ref_audio)]
        if not context:
            raise ValueError("CSM requires a reference: pass ref_audio+ref_text "
                             "or context segments")
        return context

    # -- decoding ----------------------------------------------------------

    def _prefill(self, prompts: list, max_frames: int):
        """Left-pad the prompts to one bucket, prefill the backbone, and
        return (caches, pad_len, first frame [B, nc])."""
        longest = max(p.shape[0] for p, _ in prompts)
        max_seq_len = self.model.backbone_cfg.max_position_embeddings - max_frames
        if longest >= max_seq_len:
            raise ValueError(f"Inputs too long, must be below {max_seq_len}")
        bucket = _prompt_bucket(longest)
        b, nc1 = len(prompts), self.audio_num_codebooks + 1
        tokens = np.zeros((b, bucket, nc1), dtype=np.int64)
        mask = np.zeros((b, bucket, nc1), dtype=bool)
        pad = np.zeros((b,), dtype=np.int64)
        for i, (p, m) in enumerate(prompts):
            pad[i] = bucket - p.shape[0]
            tokens[i, pad[i]:] = p
            mask[i, pad[i]:] = m
        dev = self.device
        pad_len = torch.as_tensor(pad, device=dev)
        caches = self.model.backbone.init_cache(b, max_len=bucket + max_frames,
                                                dtype=self.model.lm_dtype())
        embeds = self.model.embed_tokens(torch.as_tensor(tokens, device=dev),
                                         torch.as_tensor(mask, device=dev))
        h, caches = self.model.backbone.prefill(caches, embeds, pad_len)
        return caches, pad_len, h[:, -1]

    def _frame_chunk(self, caches, pad_len, last_frame, n, temp, top_k):
        """n frames from the decode state; last_frame [B, nc] is the first
        input.  Returns frames [n, B, nc]."""
        frames = []
        for _ in range(n):
            b = last_frame.shape[0]
            tokens = F.pad(last_frame, (0, 1))[:, None]
            mask = torch.ones_like(tokens, dtype=torch.bool)
            mask[..., -1] = False
            embeds = self.model.embed_tokens(tokens, mask)
            last_frame, caches = self.model.generate_frame_step(
                caches, pad_len, embeds, temp, top_k, self.generator)
            frames.append(last_frame)
        return torch.stack(frames)

    @torch.no_grad()
    def _generate_frames(self, prompt, max_frames, chunk, temp, top_k) -> list:
        """Batch-1 frames until the end-of-speech frame or ``max_frames``."""
        caches, pad_len, last_h = self._prefill([prompt], max_frames)
        frame = self.model.first_frame(last_h, temp, top_k, self.generator)
        frames = []
        last = frame
        out = frame[None]
        while True:
            done = False
            for f in out[:, 0].cpu().numpy():
                if (f == 0).all():
                    done = True
                    break
                frames.append(f)
                if len(frames) >= max_frames:
                    done = True
                    break
            if done:
                return frames
            n = min(chunk, max_frames - len(frames))
            out = self._frame_chunk(caches, pad_len, last, n, temp, top_k)
            last = out[-1]

    def generate(self, text, voice: Optional[str] = None, speaker: int = 0,
                 context: Optional[List[Segment]] = None,
                 split_pattern: Optional[str] = r"\n+",
                 max_audio_length_ms: float = 90_000,
                 ref_audio: Optional[np.ndarray] = None,
                 ref_text: Optional[str] = None, stream: bool = False,
                 streaming_interval: float = 0.5, voice_match: bool = True,
                 temperature: float = 0.9, top_k: int = 50, seed: int = 0,
                 **kwargs):
        """Text -> one GenerationResult per text segment (batch 1), or with
        ``stream=True`` one per chunk of frames as they are decoded: the
        first ``min(3, max frames)``, then 4, then
        ``max(1, int(streaming_interval * 12.5))`` at a time."""
        context = self._context(context, speaker, ref_audio, ref_text)
        max_frames = int(max_audio_length_ms / 80)
        if isinstance(text, str):
            text = re.split(split_pattern, text.strip()) if split_pattern else [text]
        self.generator.manual_seed(seed)
        for seg_idx, prompt in enumerate(text):
            start = time.perf_counter()
            tokens = self._prompt(prompt, context, speaker, voice_match)
            if stream:
                yield from self._generate_stream(
                    tokens, max_frames, max(1, int(streaming_interval * 12.5)),
                    temperature, top_k, seg_idx, start)
                continue
            frames = self._generate_frames(tokens, max_frames, FRAME_CHUNK,
                                           temperature, top_k)
            if not frames:
                continue
            codes = torch.as_tensor(np.stack(frames, axis=-1), device=self.device)[None]
            audio = self._watermark(self._mimi.decode(codes)[0, 0].cpu().numpy())
            yield make_generation_result(audio, self._sample_rate, seg_idx,
                                         len(frames), time.perf_counter() - start,
                                         self.device)

    @torch.no_grad()
    def _generate_stream(self, prompt, max_frames, chunk, temp, top_k,
                         seg_idx, start):
        """Streaming decode of one segment: GenerationResults of the first
        ``min(3, max_frames)`` frames (cut at an end-of-speech frame), then
        of a ramp chunk of 4, then of ``chunk`` frames each, every chunk's
        audio decoded through the carried Mimi state.  Frames are sampled
        in the order the non-streaming decode samples them."""
        spf = self._mimi.samples_per_frame
        state = self._mimi.init_state(1)

        def emit(codes, n):
            nonlocal state, start
            audio, state = self._mimi.decode_frames_stateful(codes, state)
            audio = self._watermark(audio[0, 0, :n * spf].cpu().numpy())
            result = make_generation_result(audio, self._sample_rate, seg_idx, n,
                                            time.perf_counter() - start, self.device)
            start = time.perf_counter()
            return result

        caches, pad_len, last_h = self._prefill([prompt], max_frames)
        last = self.model.first_frame(last_h, temp, top_k, self.generator)
        n_first = min(3, max_frames)
        out = last[None]
        if n_first > 1:
            out = torch.cat([out, self._frame_chunk(caches, pad_len, last,
                                                    n_first - 1, temp, top_k)])
        eos = np.nonzero((out[:, 0].cpu().numpy() == 0).all(axis=1))[0]
        n_valid = int(eos[0]) if len(eos) else n_first
        if n_valid:
            yield emit(out.permute(1, 2, 0), n_valid)
        if len(eos) or n_valid >= max_frames:
            return
        produced, last, ramp = n_first, out[-1], [4]
        while produced < max_frames:
            n = min(ramp.pop(0) if ramp else chunk, max_frames - produced)
            out = self._frame_chunk(caches, pad_len, last, n, temp, top_k)
            frames = []
            for f in out[:, 0].cpu().numpy():
                if (f == 0).all():
                    break
                frames.append(f)
            produced += len(frames)
            if frames:
                codes = torch.as_tensor(np.stack(frames, axis=-1), device=self.device)
                yield emit(codes[None], len(frames))
            if len(frames) < n:
                return
            last = out[-1]

    @torch.no_grad()
    def generate_batch(self, texts: List[str], speaker: int = 0,
                       context: Optional[List[Segment]] = None,
                       max_audio_length_ms: float = 90_000,
                       ref_audio: Optional[np.ndarray] = None,
                       ref_text: Optional[str] = None, voice_match: bool = True,
                       temperature: float = 0.9, top_k: int = 50,
                       seed: int = 0, chunk: int = FRAME_CHUNK) -> List[GenerationResult]:
        """All ``texts`` in one batched decode: the rows share every weight
        read.  Finished rows keep stepping (their frames are dropped) until
        all are done."""
        context = self._context(context, speaker, ref_audio, ref_text)
        max_frames = int(max_audio_length_ms / 80)
        start = time.perf_counter()
        self.generator.manual_seed(seed)
        prompts = [self._prompt(t, context, speaker, voice_match) for t in texts]
        b = len(prompts)
        caches, pad_len, last_h = self._prefill(prompts, max_frames)
        last = self.model.first_frame(last_h, temperature, top_k, self.generator)
        first = last.cpu().numpy()
        all_frames = [first]
        done = (first == 0).all(axis=1)
        n_frames = np.where(done, 0, 1)
        while len(all_frames) < max_frames and not done.all():
            n = min(chunk, max_frames - len(all_frames))
            out = self._frame_chunk(caches, pad_len, last, n, temperature, top_k)
            for f in out.cpu().numpy():
                done = done | (f == 0).all(axis=1)
                n_frames = np.where(done, n_frames, n_frames + 1)
                all_frames.append(f)
            last = out[-1]
        codes = torch.as_tensor(np.stack(all_frames, axis=-1), device=self.device)
        audio = self._mimi.decode(codes)[:, 0].cpu().numpy()
        spf = self._mimi.samples_per_frame
        elapsed = time.perf_counter() - start
        results = []
        for i in range(b):
            a = audio[i, :int(n_frames[i]) * spf]
            a = self._watermark(a) if a.size else a
            results.append(make_generation_result(a, self._sample_rate, i,
                                                  int(n_frames[i]), elapsed / b,
                                                  self.device))
        return results

    # -- weights -----------------------------------------------------------

    def sanitize(self, weights: dict) -> dict:
        return sanitize(weights)


def _prompt_bucket(n: int) -> int:
    """Prompt-length buckets: powers of two to 256, then steps of 128."""
    for b in (64, 128, 256):
        if n <= b:
            return b
    return -(-n // 128) * 128


def sanitize(weights: dict) -> dict:
    """Map torchtune / MLX CSM checkpoint keys to this model's state_dict
    keys (the JAX package's ``sanitize``).  HF-transformers checkpoints
    (``backbone_model.*``) need the Mimi sanitizers, a later slice."""
    if any(k.startswith("backbone_model.") for k in weights):
        raise NotImplementedError("HF-transformers CSM checkpoints are not "
                                  "ported yet")
    out = {}
    for k, v in weights.items():
        if not k.startswith("model."):
            k = "model." + k
        if "attn" in k and "self_attn" not in k:
            k = k.replace("attn", "self_attn").replace("output_proj", "o_proj")
        if "mlp" in k:
            k = (k.replace("w1", "gate_proj").replace("w2", "down_proj")
                 .replace("w3", "up_proj"))
        if "sa_norm" in k or "mlp_norm" in k:
            k = (k.replace("sa_norm", "input_layernorm")
                 .replace("mlp_norm", "post_attention_layernorm")
                 .replace("scale", "weight"))
        if "decoder.norm" in k or "backbone.norm" in k:
            k = k.replace("scale", "weight")
        out[k] = np.asarray(v)
    return out
