"""The CSM depth-decoder draft in the port against the JAX package.

The pack holds the JAX package's int8 codes and scales (stored transposed,
[Out, In]) and its pre-projected embedding slab to within one bf16 step;
the plain draft (``nn.kernels.depth_draft`` on CPU tensors) gives the same
tokens as ``depth_draft_xla`` and as ``depth_draft_pallas(interpret=True)``,
greedy and sampled on the same noise, as tests/test_pallas_depth.py holds
the two JAX versions to each other.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_audio_tpu.models.lm.llama import LlamaConfig as JaxConfig
from mlx_audio_tpu.models.lm.llama import LlamaModel as JaxLlama
from mlx_audio_tpu.nn import pallas_depth as jpd
from mlx_audio_tpu.nn.module import named_arrays
from mlx_audio_tpu_torch.convert import params_from_jax
from mlx_audio_tpu_torch.models.lm.llama import LlamaConfig, LlamaModel
from mlx_audio_tpu_torch.nn import kernels
from mlx_audio_tpu_torch.nn import pallas_depth as tpd
from mlx_audio_tpu_torch.nn.quantize import quantize_model

VOCAB, NC, DB, DM, DH = 64, 8, 256, 128, 128


def _cfg(cls):
    return cls(num_hidden_layers=2, num_attention_heads=1, num_key_value_heads=1,
               head_dim=DH, hidden_size=DM, intermediate_size=256,
               rms_norm_eps=1e-5, vocab_size=VOCAB, max_position_embeddings=64,
               rope_theta=500_000)


@pytest.fixture(scope="module")
def packs():
    import mlx_audio_tpu.nn.layers as jax_layers

    # set up before conftest's per-test reseed: seed the JAX init here
    jax_layers._INIT_RNG = np.random.default_rng(0)
    rng = np.random.default_rng(0)
    jdec = JaxLlama(_cfg(JaxConfig), use_embed_tokens=False)
    tdec = LlamaModel(_cfg(LlamaConfig), use_embed_tokens=False)
    tdec.load_state_dict(params_from_jax(
        {k: np.asarray(v) for k, v in named_arrays(jdec)}, tdec), strict=True)
    proj = rng.standard_normal((DB, DM)).astype(np.float32) * 0.05
    head = rng.standard_normal((NC - 1, DM, VOCAB)).astype(np.float32) * 0.1
    emb = rng.standard_normal((NC * VOCAB, DB)).astype(np.float32) * 0.1
    jp = jpd.pack_depth(jdec, proj, head, emb, VOCAB)
    tp = tpd.pack_depth(tdec, *map(torch.as_tensor, (proj, head, emb)), VOCAB)
    return jp, tp, tdec, (proj, head, emb)


def test_quantize_int8_matches_jax():
    w = np.random.default_rng(1).standard_normal((256, 64)).astype(np.float32)
    cj, sj = jpd.quantize_int8(w)
    ct, st = tpd.quantize_int8(torch.as_tensor(w))
    np.testing.assert_array_equal(ct.numpy(), cj)
    np.testing.assert_array_equal(st.numpy(), sj)


def test_pack_matches_jax(packs):
    jp, tp = packs[:2]
    for name in ("wqkv", "sqkv", "wo", "so", "wgu", "sgu", "wdown", "sdown",
                 "heads", "sheads"):
        np.testing.assert_array_equal(
            getattr(tp, name).transpose(-1, -2).numpy(),
            np.asarray(getattr(jp, name)), err_msg=name)
    for name in ("norms", "final_norm", "rope_cos", "rope_sin"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name)), err_msg=name)
    # the slab is a float32 matmul rounded to bf16: the two frameworks may
    # round a product to neighbouring bf16 values, one step apart (at most
    # 2**-7 of the value)
    np.testing.assert_allclose(tp.emb_proj.float().numpy(),
                               np.asarray(jp.emb_proj, np.float32),
                               rtol=2 ** -7, atol=0)


def _cache0(rng):
    kc = np.zeros((2, 1, 40, DH), np.float32)
    vc = np.zeros((2, 1, 40, DH), np.float32)
    kc[:, :, :2] = rng.standard_normal((2, 1, 2, DH)) * 0.3
    vc[:, :, :2] = rng.standard_normal((2, 1, 2, DH)) * 0.3
    return kc, vc


@pytest.mark.parametrize("temp,top_k", [(0.0, 0), (0.9, 8), (1.0, 0)])
def test_plain_draft_tokens_match_jax(packs, temp, top_k):
    jp, tp = packs[:2]
    rng = np.random.default_rng(2)
    kc, vc = _cache0(rng)
    n_steps, vpad = NC - 2, tp.heads.shape[1]
    noise = (np.array(jax.random.gumbel(jax.random.PRNGKey(0), (n_steps, vpad),
                                        jnp.float32))
             if temp > 0 else np.zeros((n_steps, vpad), np.float32))
    c1 = 3
    args = (jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(c1, jnp.int32),
            jnp.asarray(noise), VOCAB, temp, top_k)
    xla = np.asarray(jpd.depth_draft_xla(jp, *args))
    pallas = np.asarray(jpd.depth_draft_pallas(jp, *args, interpret=True))
    got = kernels.depth_draft(tp, torch.as_tensor(kc), torch.as_tensor(vc),
                              torch.tensor(c1), torch.as_tensor(noise), VOCAB,
                              temp, top_k)
    assert got.dtype == torch.int32 and got.shape == (n_steps,)
    np.testing.assert_array_equal(got.numpy(), xla)
    np.testing.assert_array_equal(got.numpy(), pallas)


def test_quantized_decoder_packs_its_dequantized_weights(packs):
    """After quantize_model the pack is made from the dequantized weights
    (the JAX package would pack the uint8 codes themselves)."""
    from mlx_audio_tpu_torch.nn.quantize import dequantize_model

    tdec, (proj, head, emb) = packs[2], packs[3]
    inputs = list(map(torch.as_tensor, (proj, head, emb)))
    qdec = LlamaModel(_cfg(LlamaConfig), use_embed_tokens=False)
    qdec.load_state_dict(tdec.state_dict())
    quantize_model(qdec, group_size=32, bits=8)
    from_quantized = tpd.pack_depth(qdec, *inputs, VOCAB)
    from_dense = tpd.pack_depth(dequantize_model(qdec), *inputs, VOCAB)
    for a, b in zip(from_quantized, from_dense):
        assert torch.equal(a, b)


# (L, Dm, F, Hq, Hkv, Dh, S, Vp) and whether csrc/depth_draft.cu takes them
_DRAFT_GATE = {
    "llama-100m": ((4, 1024, 8192, 8, 2, 128, 30, 2176), True),
    "tests' pack": ((2, DM, 256, 1, 1, DH, NC - 2, 128), True),
    # 31 steps: 32 slots of 512 bytes fill a 16 KB stage; 32 do not fit
    "31-steps": ((4, 1024, 8192, 8, 2, 128, 31, 2176), True),
    "32-steps": ((4, 1024, 8192, 8, 2, 128, 32, 2176), False),
    # Dm 8192: a gate/up pair (2 Dm bytes) fills a stage
    "dm-8192": ((1, 8192, 8192, 8, 2, 128, 4, 2176), True),
    "dm-8320": ((1, 8320, 8192, 8, 2, 128, 4, 2176), False),
    "f-past-registers": ((4, 1024, 8192 + 128, 8, 2, 128, 30, 2176), False),
    "vpad-past-registers": ((4, 1024, 8192, 8, 2, 128, 30, 4096 + 128), False),
    "nine-layers": ((9, 1024, 8192, 8, 2, 128, 30, 2176), False),
    "twelve-query-heads-a-kv-head": ((4, 1536, 8192, 12, 1, 128, 30, 2176), False),
    "dh-not-a-multiple-of-8": ((4, 1024, 8192, 32, 4, 100, 30, 2176), False),
}


@pytest.mark.parametrize("case", list(_DRAFT_GATE))
def test_draft_shape_gate(case):
    shape, supported = _DRAFT_GATE[case]
    assert kernels.depth_draft_supported(*shape) is supported


@pytest.fixture
def exchanges(monkeypatch):
    monkeypatch.setattr(kernels, "_DRAFT_EXCHANGES", {})
    return kernels._DRAFT_EXCHANGES


def test_draft_exchange_is_kept_across_launches(exchanges):
    """Launches on one stream share one exchange, not zeroed between them:
    each launch's tags start above the last launch's."""
    cpu = torch.device("cpu")
    xch, base = kernels.draft_exchange(cpu, 7, 100, 30)
    assert base == 0 and xch.dtype == torch.int64 and xch.numel() == 100
    assert not xch.any()
    xch.fill_(-1)
    again, base = kernels.draft_exchange(cpu, 7, 100, 30)
    assert again is xch and base == 30 and (again == -1).all()
    assert kernels.draft_exchange(cpu, 7, 80, 4)[1] == 60
    other, base = kernels.draft_exchange(cpu, 8, 100, 30)
    assert other is not xch and base == 0


def test_draft_exchange_grows_zeroed(exchanges):
    cpu = torch.device("cpu")
    xch, _ = kernels.draft_exchange(cpu, 0, 100, 30)
    xch.fill_(-1)
    grown, base = kernels.draft_exchange(cpu, 0, 300, 30)
    assert grown.numel() == 300 and not grown.any() and base == 30


def test_draft_exchange_is_zeroed_before_its_tags_wrap(exchanges):
    cpu = torch.device("cpu")
    bases = []
    for _ in range(4):
        xch, base = kernels.draft_exchange(cpu, 0, 100, 30, limit=100)
        bases.append(base)
        # kept as the last launch left it, or zeroed when it starts over
        assert (xch == -1).all() if base else not xch.any()
        xch.fill_(-1)
    # 90 + 30 would pass the limit: the fourth launch starts again from 0
    assert bases == [0, 30, 60, 0]
    assert kernels.draft_exchange(cpu, 0, 100, 30, limit=100)[1] == 30


def test_spec_decode_gate_names_a_depth_decoder_the_kernel_refuses():
    """enable_spec_decode's check: on a card a depth decoder that
    depth_draft_supported refuses (here Dh % 8 != 0) raises ValueError with
    its shape; llama-100M passes; on the CPU the plain draft takes every
    shape."""
    import dataclasses

    from mlx_audio_tpu_torch.models.lm.llama import LLAMA_FLAVORS
    from mlx_audio_tpu_torch.models.tts.sesame.model import check_spec_decode

    ok = LLAMA_FLAVORS["llama-100M"]
    check_spec_decode(ok, 32, 2051, "cuda")
    bad = dataclasses.replace(ok, head_dim=100)
    with pytest.raises(ValueError, match="'dh': 100"):
        check_spec_decode(bad, 32, 2051, "cuda")
    check_spec_decode(bad, 32, 2051, "cpu")
