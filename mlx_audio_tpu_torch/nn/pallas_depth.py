"""The CSM depth decoder's int8 draft: pack and plain version (counterpart
of ``mlx_audio_tpu/nn/pallas_depth.py``, whose path this module keeps).

``pack_depth`` quantizes the depth decoder to int8 with symmetric
per-128-row-group scales and lays it out for the ``depth_draft`` kernel
(``csrc/depth_draft.cu``, wrapper ``nn.kernels.depth_draft``), which runs
the 30 sequential steps c2..c31 of one frame in one launch.
``depth_draft_plain`` computes the same function with PyTorch operations
and is the kernel's plain version.  ``gumbel_argmax`` is the token
decision that it and the model's verification pass share.
``draft_inputs`` makes a full llama-100M pack from seeded random weights,
the shape at which ``chip_smoke.py`` and ``scripts/tune_depth.py`` run the
kernel.

Layout: the JAX package stores each int8 matrix as x @ W, [In, Out]; here it
is stored transposed, [Out, In] (scales [Out, In / 128]), so that one output
column's 128-row group is 128 contiguous bytes for the kernel's s8 x s8 dot
products.  ``heads`` is [S, Vp, Dm].  The values are the JAX package's.

Two things are exact here by construction and decide the draft's tokens:
the s8 x s8 products of a group sum to an integer below 2**24, so any
float32 sum of them is exact; and each output column adds its group
partials in ascending group order as ``acc + part * (scale * sx)``.  The
other reductions that feed a token (the RMS mean, the attention scores,
the softmax sum and the attention output) are taken in float64 and rounded
once to float32, so their order does not matter and the kernel, which does
the same, gives the same tokens.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

GROUP = 128  # quant group along the contraction dim


def _gsz(n: int) -> int:
    """Group size for a contraction dim: 128, or the whole dim where 128
    does not divide it (tiny test configs)."""
    return GROUP if n % GROUP == 0 else n


def _tensor(value: float, like: torch.Tensor) -> torch.Tensor:
    # PyTorch's CUDA division by a Python scalar multiplies by its
    # reciprocal; a tensor divisor keeps IEEE division, as the kernel has it
    return torch.full((), value, dtype=like.dtype, device=like.device)


def quantize_int8(w: torch.Tensor):
    """W [In, Out] -> (codes int8 [In, Out], scales f32 [In/g, Out]),
    symmetric per-group max-abs (g = _gsz(In)), as the JAX package's."""
    ing, out = w.shape
    gs = _gsz(ing)
    wg = w.float().reshape(ing // gs, gs, out)
    scale = wg.abs().amax(1) / _tensor(127.0, wg) + 1e-12
    codes = torch.clamp(torch.round(wg / scale[:, None, :]), -127, 127)
    return codes.reshape(ing, out).to(torch.int8), scale


class PackedDepth(NamedTuple):
    """Device pack of the depth decoder (see pack_depth).  Matrices are
    [Out, In] int8 with scales [Out, In / g] float32."""

    wqkv: torch.Tensor        # [L, Cqkv, Dm]
    sqkv: torch.Tensor
    wo: torch.Tensor          # [L, Dm, Hq*Dh]
    so: torch.Tensor
    wgu: torch.Tensor         # [L, 2F, Dm]: gate rows, then up rows
    sgu: torch.Tensor
    wdown: torch.Tensor       # [L, Dm, F]
    sdown: torch.Tensor
    norms: torch.Tensor       # [L, 2, Dm] input / post-attention RMS weights
    final_norm: torch.Tensor  # [Dm]
    heads: torch.Tensor       # [S, Vp, Dm]: audio_head[1..30], vocab padded
    sheads: torch.Tensor      # [S, Vp, Dm/g]
    emb_proj: torch.Tensor    # [S, Vp, Dm] bf16: codebooks 1..30's embedding
    #                           tables times the backbone->decoder projection;
    #                           row `tok` of slab s is the input of token c_{s+1}
    rope_cos: torch.Tensor    # [P, Dh/2] rows for positions 0..P-1
    rope_sin: torch.Tensor


def _dense(mod) -> torch.Tensor:
    """A Linear's or Embedding's weight; a quantized module's dequantized
    weight.  (The JAX package reads ``.weight`` whatever the module is, so
    after ``quantize_model`` it packs the uint8 codes as if they were
    weights: its draft is then noise, though verification keeps the frames
    exact.  This port packs the dequantized weight.)"""
    if hasattr(mod, "to_linear"):
        return mod.to_linear().weight.to(mod.scales.device)
    if hasattr(mod, "to_embedding"):
        return mod.to_embedding().weight.to(mod.scales.device)
    return mod.weight.detach()


def _pack(w_in_out: torch.Tensor):
    codes, scales = quantize_int8(w_in_out)
    return codes.t().contiguous(), scales.t().contiguous()


@torch.no_grad()
def pack_depth(decoder, projection_w: torch.Tensor, audio_head: torch.Tensor,
               embed_table: torch.Tensor, vocab: int) -> PackedDepth:
    """Quantize and lay out the depth decoder for the draft.

    decoder: models.lm.llama.LlamaModel (the CSM depth LM); projection_w
    [Db, Dm]; audio_head [nc-1, Dm, V]; embed_table [nc*V, Db]."""
    packs = {k: [] for k in ("qkv", "o", "gu", "down")}
    norms = []
    for lyr in decoder.layers:
        a, m = lyr.self_attn, lyr.mlp
        packs["qkv"].append(_pack(torch.cat(
            [_dense(a.q_proj).t(), _dense(a.k_proj).t(), _dense(a.v_proj).t()], 1)))
        packs["o"].append(_pack(_dense(a.o_proj).t()))
        packs["gu"].append(_pack(torch.cat(
            [_dense(m.gate_proj).t(), _dense(m.up_proj).t()], 1)))
        packs["down"].append(_pack(_dense(m.down_proj).t()))
        norms.append(torch.stack([lyr.input_layernorm.weight.float(),
                                  lyr.post_attention_layernorm.weight.float()]))

    def stack(name):
        codes, scales = zip(*packs[name])
        return torch.stack(codes), torch.stack(scales)

    audio_head = audio_head.float()
    v = audio_head.shape[-1]
    vpad = -(-v // 128) * 128
    heads = [_pack(F.pad(h, (0, vpad - v))) for h in audio_head[1:]]
    nc = audio_head.shape[0] + 1
    emb = embed_table.float().reshape(nc, vocab, -1)[1:nc - 1]
    ep = F.pad(emb @ projection_w.float(), (0, 0, 0, vpad - vocab))
    return PackedDepth(
        *stack("qkv"), *stack("o"), *stack("gu"), *stack("down"),
        norms=torch.stack(norms), final_norm=decoder.norm.weight.float().clone(),
        heads=torch.stack([c for c, _ in heads]),
        sheads=torch.stack([s for _, s in heads]),
        emb_proj=ep.to(torch.bfloat16),
        rope_cos=decoder.rope_cos[:64].clone(),
        rope_sin=decoder.rope_sin[:64].clone())


def draft_inputs(gen: torch.Generator, vocab: int = 2051, n_codebooks: int = 32):
    """A full llama-100M depth pack from seeded random weights, as CSM-1B's
    depth decoder has it (4 layers, Dm 1024, F 8192, 8 query and 2
    key/value heads of 128, n_codebooks - 1 heads of ``vocab`` codes), and
    its caches with positions 0 and 1 filled, on ``gen``'s device:
    (packed, kc, vc, c1, vocab)."""
    from mlx_audio_tpu_torch.models.lm.llama import LLAMA_FLAVORS, LlamaModel

    cfg = LLAMA_FLAVORS["llama-100M"]
    dev = gen.device
    db = 2048
    with torch.device(dev):
        dec = LlamaModel(cfg, use_embed_tokens=False)
    for m in dec.modules():
        if hasattr(m, "init_weights"):
            m.init_weights(gen)
    dm = cfg.hidden_size
    nc = n_codebooks
    packed = pack_depth(
        dec, torch.randn(db, dm, generator=gen, device=dev) * db ** -0.5,
        torch.randn(nc - 1, dm, vocab, generator=gen, device=dev) * dm ** -0.5,
        torch.rand(nc * vocab, db, generator=gen, device=dev) * 2 - 1, vocab)
    del dec
    shape = (cfg.num_hidden_layers, cfg.num_key_value_heads, 40, cfg.head_dim)
    kc, vc = torch.zeros(shape, device=dev), torch.zeros(shape, device=dev)
    kc[:, :, :2] = torch.randn(*shape[:2], 2, shape[3], generator=gen, device=dev)
    vc[:, :, :2] = torch.randn(*shape[:2], 2, shape[3], generator=gen, device=dev)
    return packed, kc, vc, torch.tensor(17, device=dev), vocab


def draft_exchanges(packed: PackedDepth) -> int:
    """Exchanges of one draft launch, each a synchronisation of every CTA:
    4 a layer and 1 after the head, every step."""
    return packed.heads.shape[0] * (4 * packed.wqkv.shape[0] + 1)


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    n = x.shape[-1]
    ms = ((x.double() * x.double()).sum(-1, keepdim=True)
          / _tensor(float(n), x.double())).float()
    return x * torch.rsqrt(ms + eps) * w


def _quant_row(x: torch.Tensor):
    """f32 [In] -> (s8 values as f32 [In], f32 scale): symmetric max-abs,
    rounded half to even, clipped to +-127."""
    amax = x.abs().amax().clamp(min=1e-30)
    inv = _tensor(127.0, x) / amax
    xq = torch.clamp(torch.round(x * inv), -127.0, 127.0)
    return xq, amax * (1.0 / 127.0)


def _matvec(x: torch.Tensor, w: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """x [In] against int8 w [Out, In], scales s [Out, G]: per-group s8 dots
    (exact), scaled and added in ascending group order."""
    xq, sx = _quant_row(x)
    out, ing = w.shape
    g = s.shape[1]
    parts = torch.einsum("ogk,gk->og", w.float().reshape(out, g, ing // g),
                         xq.reshape(g, ing // g))
    scaled = parts * (s * sx)
    acc = scaled[:, 0]
    for j in range(1, g):
        acc = acc + scaled[:, j]
    return acc


def _topk_bisect_mask(z: torch.Tensor, valid: torch.Tensor,
                      top_k: int) -> torch.Tensor:
    """Keep the values at or above the k-th largest, found by 24 halvings
    of [min valid, max]: the JAX package's draft and verify share it."""
    lo = torch.where(valid, z, float("inf")).amin(-1, keepdim=True)
    hi = z.amax(-1, keepdim=True)
    for _ in range(24):
        mid = 0.5 * (lo + hi)
        keep = (z >= mid).sum(-1, keepdim=True) >= top_k
        lo, hi = torch.where(keep, mid, lo), torch.where(keep, hi, mid)
    return torch.where(z >= lo, z, float("-inf"))


def gumbel_argmax(logits: torch.Tensor, noise: torch.Tensor, vocab: int,
                  temp: float, top_k: int) -> torch.Tensor:
    """The token decision of the draft and of its verification, on logits
    [..., Vp] padded past ``vocab``: pad lanes at -inf, IEEE division by
    ``temp``, bisection top-k, the Gumbel ``noise`` added, argmax (the
    lowest index on ties).  Greedy when ``temp`` is 0."""
    valid = torch.arange(logits.shape[-1], device=logits.device) < vocab
    z = torch.where(valid, logits.float(), float("-inf"))
    if temp > 0:
        z = z / _tensor(temp, z)
        if 0 < top_k < vocab:
            z = _topk_bisect_mask(z, valid, top_k)
        z = z + noise
    return torch.argmax(z, dim=-1)


@torch.no_grad()
def depth_draft_plain(packed: PackedDepth, cache_k0: torch.Tensor,
                      cache_v0: torch.Tensor, c1: torch.Tensor,
                      noise: torch.Tensor, vocab: int, temp: float = 0.0,
                      top_k: int = 0) -> torch.Tensor:
    """Plain version of the depth_draft kernel (port of
    ``depth_draft_xla``): the same int8 pack, bisection top-k and
    Gumbel-argmax.  Returns int32 tokens [S]."""
    n_layers, hkv, cap, dh = cache_k0.shape
    f_inter = packed.wdown.shape[2]
    cqkv = packed.wqkv.shape[1]
    hq = cqkv // dh - 2 * hkv
    half = dh // 2
    kc, vc = cache_k0.clone(), cache_v0.clone()
    slot = torch.arange(cap, device=kc.device)
    scale = 1.0 / dh ** 0.5
    tok = c1.reshape(()).long()
    toks = []
    for s in range(noise.shape[0]):
        pos = s + 2
        x = packed.emb_proj[s, tok].float()
        c = packed.rope_cos[pos]
        si = packed.rope_sin[pos]

        def rope(t):
            t1, t2 = t[:, :half], t[:, half:]
            return torch.cat([t1 * c - t2 * si, t2 * c + t1 * si], dim=1)

        for l in range(n_layers):
            qkv = _matvec(_rms(x, packed.norms[l, 0]), packed.wqkv[l],
                          packed.sqkv[l])
            q = rope(qkv[:hq * dh].reshape(hq, dh))
            k = rope(qkv[hq * dh:(hq + hkv) * dh].reshape(hkv, dh))
            kc[l, :, pos] = k
            vc[l, :, pos] = qkv[(hq + hkv) * dh:].reshape(hkv, dh)
            qg = q.reshape(hkv, hq // hkv, dh).double()
            scores = (qg @ kc[l].double().transpose(1, 2)).float() * scale
            scores = torch.where(slot <= pos, scores, -1e9)
            e = torch.exp(scores - scores.amax(-1, keepdim=True))
            probs = e / e.double().sum(-1, keepdim=True).float()
            attn = (probs.double() @ vc[l].double()).float()
            x = x + _matvec(attn.reshape(hq * dh), packed.wo[l], packed.so[l])
            gu = _matvec(_rms(x, packed.norms[l, 1]), packed.wgu[l],
                         packed.sgu[l])
            h = F.silu(gu[:f_inter]) * gu[f_inter:]
            x = x + _matvec(h, packed.wdown[l], packed.sdown[l])

        logits = _matvec(_rms(x, packed.final_norm), packed.heads[s],
                         packed.sheads[s])
        tok = gumbel_argmax(logits, noise[s], vocab, temp, top_k)
        toks.append(tok)
    return torch.stack(toks).to(torch.int32)
