"""HF-transformers and Kyutai checkpoints through the port, and the Llama-3
tokenizer loader: twins of tests/test_golden_hf.py's CSM and Mimi tests and
of its raw Parakeet and Wav2Vec2 directories, and of tests/test_mimi.py's
``sanitize_mimi`` test.

Tiny HF torch models (``_csm_pair``, ``build_mimi_pair``) are built by the
JAX tests' own helpers; the port reads their state dicts and
``save_pretrained`` directories through its sanitizers and
``convert.params_from_jax``.  Float32 on the CPU; against HF within 1e-4
(as the JAX tests), codes and greedy frames equal; against the JAX package
bit for bit where both load the same file.  ``chip_smoke.py``'s checkpoint
writers (the inverses of the sanitizers, which its phase 16 uses on the
card) are held to HF's own layout here.
"""

import json
import os

import numpy as np
import pytest
import torch

# transformers imports in a third of the time without its TF and Flax probes
os.environ.setdefault("USE_TF", "0")
os.environ.setdefault("USE_FLAX", "0")
transformers = pytest.importorskip("transformers")

import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
import mlx_audio_tpu.nn.layers as jax_layers  # noqa: E402
from mlx_audio_tpu.nn.module import named_arrays  # noqa: E402
from mlx_audio_tpu_torch.codec.mimi import Mimi, mimi_202407, mimi_from_hf_config  # noqa: E402
from mlx_audio_tpu_torch.codec.mimi.mimi import sanitize_hf_mimi, sanitize_mimi  # noqa: E402
from mlx_audio_tpu_torch.convert import params_from_jax, params_to_jax  # noqa: E402
from mlx_audio_tpu_torch.models.lm.llama import LLAMA_FLAVORS  # noqa: E402
from mlx_audio_tpu_torch.models.tts.sesame import Model  # noqa: E402
from mlx_audio_tpu_torch.models.tts.sesame.model import (  # noqa: E402
    _llama_cfg_from_dict,
    sanitize,
    sanitize_hf_csm,
)
from mlx_audio_tpu_torch.utils.loader import load_model  # noqa: E402
from test_golden_hf import RATIOS, _csm_pair, build_mimi_pair  # noqa: E402
from test_torch_mimi import port_config  # noqa: E402

ATOL = 1e-4

# tests/test_golden_hf.py::_csm_pair's JAX config, with its tiny Mimi
_ROPE = {"rope_type": "llama3", "factor": 32.0, "low_freq_factor": 1.0,
         "high_freq_factor": 4.0, "original_max_position_embeddings": 16}
CSM_PAIR_CONFIG = {
    "text_vocab_size": 128, "audio_vocab_size": 66, "audio_num_codebooks": 4,
    "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
    "head_dim": 16, "hidden_size": 64, "intermediate_size": 128,
    "rms_norm_eps": 1e-5, "vocab_size": 128, "max_position_embeddings": 64,
    "rope_theta": 500000.0, "rope_scaling": _ROPE,
    "depth_decoder_config": {
        "num_hidden_layers": 2, "num_attention_heads": 2, "num_key_value_heads": 1,
        "head_dim": 16, "hidden_size": 32, "intermediate_size": 64,
        "rms_norm_eps": 1e-5, "vocab_size": 66, "max_position_embeddings": 33,
        "rope_theta": 500000.0, "rope_scaling": _ROPE},
}


def _hf_state(hf) -> dict:
    return {k: v.detach().numpy() for k, v in hf.state_dict().items()}


@pytest.fixture(scope="module")
def mimi_pair():
    """(HF MimiModel, JAX Mimi loaded from it, port Mimi loaded from it)."""
    jax_layers._INIT_RNG = np.random.default_rng(0)
    hf, jm = build_mimi_pair()
    pm = Mimi.build(port_config(jm.cfg), device="cpu")
    pm.load_weights(pm.sanitize(_hf_state(hf)))
    return hf, jm, pm


@pytest.fixture(scope="module")
def csm_pair():
    """(HF CsmForConditionalGeneration, port Model whose SesameModel holds
    the HF weights, codebooks, vocabulary)."""
    jax_layers._INIT_RNG = np.random.default_rng(0)
    hf, _, nc, v = _csm_pair()
    model = Model(CSM_PAIR_CONFIG, mimi=Mimi.build(port_config(
        build_mimi_pair()[1].cfg), device="cpu"), device="cpu")
    sd = sanitize_hf_csm(_hf_state(hf))
    inner = {k[len("model."):]: w for k, w in sd.items() if k.startswith("model.")}
    missing, unexpected = model.model.load_state_dict(
        params_from_jax(inner, model.model), strict=False)
    assert not unexpected and all("rope_" in k for k in missing), (missing, unexpected)
    return hf, model, nc, v


def test_mimi_matches_hf_transformers(mimi_pair):
    """Twin of test_golden_hf.py:77: the SEANet encoder, the encoder
    transformer (RoPE un-permuted), codes equal, decoded audio within 1e-4."""
    hf, _, pm = mimi_pair
    audio = (np.random.default_rng(0).standard_normal((1, 1, 1920 * 12)) * 0.1
             ).astype(np.float32)
    x = torch.from_numpy(audio)
    with torch.no_grad():
        h_hf = hf.encoder(x)
        t_hf = hf.encoder_transformer(h_hf.transpose(1, 2))[0]
        codes_hf = hf.encode(x).audio_codes
        wav_hf = hf.decode(codes_hf).audio_values
        h = pm.encoder(x.transpose(1, 2))
        t = pm.encoder_transformer(h)[0]
    np.testing.assert_allclose(h.numpy(), h_hf.transpose(1, 2).numpy(), atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(t.numpy(), t_hf.numpy(), atol=ATOL, rtol=ATOL)
    codes = pm.encode(x)
    assert torch.equal(codes, codes_hf)
    wav = pm.decode(codes_hf)
    np.testing.assert_allclose(wav[..., :wav_hf.shape[-1]].numpy(), wav_hf.numpy(),
                               atol=ATOL, rtol=ATOL)


def test_mimi_hf_rope_convention_is_discriminated(mimi_pair):
    """Twin of test_golden_hf.py:679: without the q/k un-permutation the
    encoder transformer leaves HF's by more than 1e-4."""
    hf, jm, pm = mimi_pair
    x = (np.random.default_rng(1).standard_normal((1, 24, 32)) * 4.0).astype(np.float32)
    with torch.no_grad():
        t_hf = hf.encoder_transformer(torch.from_numpy(x))[0].numpy()
        assert np.abs(pm.encoder_transformer(torch.from_numpy(x))[0].numpy() - t_hf).max() < 1e-5
    sd = _hf_state(hf)
    naive = sanitize_hf_mimi(sd, n_heads=2, n_ratios=len(RATIOS))
    for k in list(naive):
        if k.endswith("self_attn.in_proj.weight"):
            pre = k[: -len("in_proj.weight")]
            naive[k] = np.concatenate([sd[pre + p] for p in (
                "q_proj.weight", "k_proj.weight", "v_proj.weight")], axis=0)
    wrong = Mimi.build(port_config(jm.cfg), device="cpu").load_weights(naive)
    with torch.no_grad():
        t_wrong = wrong.encoder_transformer(torch.from_numpy(x))[0].numpy()
    assert np.abs(t_hf - t_wrong).max() > 1e-4


def test_mimi_sanitizers_match_jax(mimi_pair):
    """The port's HF and Kyutai sanitizers give the JAX package's paths and
    arrays exactly, and chip_smoke.py's writers are their inverses (the HF
    one gives HF's own state dict back)."""
    from mlx_audio_tpu.codec.mimi.mimi import sanitize_hf_mimi as jax_hf
    from mlx_audio_tpu.codec.mimi.mimi import sanitize_mimi as jax_kyutai

    hf, jm, _ = mimi_pair
    sd = _hf_state(hf)
    ours, theirs = sanitize_hf_mimi(sd, 2, len(RATIOS)), jax_hf(sd, 2, len(RATIOS))
    assert ours.keys() == theirs.keys()
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k])
    named = {k: np.asarray(v) for k, v in named_arrays(jm)}
    hf_back = chip_smoke.hf_mimi_weights(named, n_heads=2, n_ratios=len(RATIOS))
    assert hf_back.keys() == sd.keys()
    for k in sd:
        np.testing.assert_array_equal(hf_back[k], sd[k].astype(hf_back[k].dtype), err_msg=k)
    kyutai = chip_smoke.kyutai_mimi_weights(named)
    ours, theirs = sanitize_mimi(kyutai), jax_kyutai(kyutai)
    assert ours.keys() == theirs.keys() == named.keys()
    for k in named:
        np.testing.assert_array_equal(ours[k], named[k])
        np.testing.assert_array_equal(theirs[k], named[k])


def test_sanitize_mimi_key_mapping():
    """Twin of tests/test_mimi.py:126."""
    w = {
        "encoder.model.0.conv.conv.weight": np.zeros((8, 1, 7)),
        "decoder.model.2.convtr.convtr.weight": np.zeros((128, 64, 16)),
        "encoder.model.1.block.1.conv.conv.weight": np.zeros((4, 8, 3)),
        "downsample.conv.conv.weight": np.zeros((64, 64, 4)),
        "upsample.convtr.convtr.weight": np.zeros((64, 1, 4)),
        "quantizer.rvq_first.input_proj.weight": np.zeros((32, 64, 1)),
        "encoder_transformer.layers.0.self_attn.in_proj_weight": np.zeros((192, 64)),
    }
    out = sanitize_mimi(w)
    assert out["encoder.init_conv1d.weight"].shape == (7, 1, 8)
    assert out["decoder.layers.0.upsample.weight"].shape == (16, 128, 64)
    assert out["encoder.layers.0.residuals.0.block.0.weight"].shape == (3, 8, 4)
    assert out["downsample.weight"].shape == (4, 64, 64)
    assert out["upsample.weight"].shape == (4, 64, 1)
    assert out["quantizer.rvq_first.input_proj.weight"].shape == (32, 64)
    assert "encoder_transformer.layers.0.self_attn.in_proj.weight" in out


def test_mimi_from_pretrained_hf_directory_and_kyutai_file(mimi_pair, tmp_path, monkeypatch):
    """Twin of the Mimi part of test_golden_hf.py:1478: ``from_pretrained``
    of an HF directory gives HF's codes (which that test holds the JAX
    package's to); of a Kyutai-layout file, written from the same weights,
    it reads every tensor bit for bit and gives the JAX package's
    ``load_pytorch_weights`` codes.  The file path builds
    ``mimi_202407(32)``, here patched to the tiny config."""
    from safetensors.numpy import save_file

    from mlx_audio_tpu_torch.codec.mimi import mimi as port_mimi

    hf, jm, pm = mimi_pair
    hf.save_pretrained(str(tmp_path / "mimi"), safe_serialization=True)
    m = Mimi.from_pretrained(str(tmp_path / "mimi"), device="cpu")
    audio = (np.random.default_rng(0).standard_normal((1, 1, 1920 * 4)) * 0.1
             ).astype(np.float32)
    with torch.no_grad():
        codes_hf = hf.encode(torch.from_numpy(audio)).audio_codes
    assert torch.equal(m.encode(torch.from_numpy(audio)), codes_hf)

    named = {k: np.asarray(v) for k, v in named_arrays(jm)}
    path = tmp_path / "mimi.safetensors"
    save_file(chip_smoke.kyutai_mimi_weights(named), str(path))
    monkeypatch.setattr(port_mimi, "mimi_202407", lambda n: port_config(jm.cfg))
    got = Mimi.from_pretrained(str(path), device="cpu")
    for k, t in pm.state_dict().items():
        assert torch.equal(got.state_dict()[k], t), k
    jax_m = jm.load_pytorch_weights(str(path))
    assert (got.encode(torch.from_numpy(audio)).numpy()
            == np.asarray(jax_m.encode(jnp.asarray(audio)))).all()


def _tokens(ids, nc):
    b, t = ids.shape
    tokens = np.zeros((b, t, nc + 1), dtype=np.int64)
    mask = np.zeros((b, t, nc + 1), dtype=bool)
    tokens[:, :, -1] = ids
    mask[:, :, -1] = True
    return torch.from_numpy(tokens), torch.from_numpy(mask)


def test_csm_matches_hf_transformers(csm_pair):
    """Twin of test_golden_hf.py:501: the fused frame embeddings, backbone
    hidden states, codebook-0 logits and the depth decoder's logits at every
    codebook position within 1e-4 of HF's."""
    hf, model, nc, v = csm_pair
    sm = model.model
    rng = np.random.default_rng(9)
    b, t = 2, 6
    audio_ids = rng.integers(0, v, size=(b, t, nc))
    with torch.no_grad():
        e_hf = hf.backbone_model.embed_tokens(torch.from_numpy(audio_ids))
        h_hf = hf.backbone_model(inputs_embeds=e_hf).last_hidden_state
        c0_hf = hf.lm_head(h_hf[:, -1])
        tokens = torch.from_numpy(np.concatenate(
            [audio_ids, np.zeros((b, t, 1), dtype=audio_ids.dtype)], axis=-1))
        mask = torch.ones(b, t, nc + 1, dtype=torch.bool)
        mask[..., -1] = False
        e = sm.embed_tokens(tokens, mask)
        np.testing.assert_allclose(e.numpy(), e_hf.numpy(), atol=ATOL, rtol=ATOL)
        h = sm.backbone(e)
        np.testing.assert_allclose(h.numpy(), h_hf.numpy(), atol=ATOL, rtol=ATOL)
        np.testing.assert_allclose(sm.codebook0_head(h[:, -1]).numpy(), c0_hf.numpy(),
                                   atol=ATOL, rtol=ATOL)
        last_h = h_hf[:, -1]
        codes = torch.from_numpy(rng.integers(0, v, size=(b, nc - 1)))
        for s in range(1, nc):
            ids = torch.cat([torch.zeros(b, 1, dtype=codes.dtype), codes[:, :s]], dim=1)
            want = hf.depth_decoder(input_ids=ids, backbone_last_hidden_state=last_h
                                    ).logits[:, -1]
            caches = sm.decoder.init_cache(b, max_len=nc + 1)
            embeds = [last_h[:, None], sm.embed_audio(0, codes[:, :1])]
            if s > 1:
                embeds.append(sm.audio_embeddings(codes[:, 1:s] + torch.arange(1, s) * v))
            hd, _ = sm.decoder.step(caches, sm.projection(torch.cat(embeds, dim=1)),
                                    torch.zeros(b, dtype=torch.long))
            np.testing.assert_allclose(sm.head_logits(hd[:, -1], s - 1).numpy(),
                                       want.numpy(), atol=ATOL, rtol=ATOL)


def _greedy_frames(model, ids: np.ndarray, n_frames: int) -> np.ndarray:
    """Greedy frames of the port's frame loop from an unpadded prompt of
    text ids [1, T]: the backbone prefill, the first frame, then
    ``Model._frame_chunk`` (the depth decode plain or spec, as enabled)."""
    sm = model.model
    tokens, mask = _tokens(ids, sm.audio_num_codebooks)
    pad = torch.zeros(1, dtype=torch.long)
    with torch.no_grad():
        caches = sm.backbone.init_cache(1, max_len=ids.shape[1] + n_frames + 4)
        h, caches = sm.backbone.prefill(caches, sm.embed_tokens(tokens, mask), pad)
        first = sm.first_frame(h[:, -1], 0.0, 50, model.generator)
        rest = model._frame_chunk(caches, pad, first, n_frames - 1, 0.0, 50)
    return torch.cat([first[None], rest]).permute(1, 0, 2).numpy()


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
def test_csm_greedy_frames_match_hf_generate(csm_pair, spec):
    """Twin of test_golden_hf.py:1134: the port's frame loop equals HF's
    ``generate`` frame for frame on two prompts, with the plain depth decode
    and with spec decode (the draft's plain version on the CPU)."""
    from transformers.generation import GenerationConfig

    hf, model, nc, _ = csm_pair
    sm = model.model
    sm.spec_decode, sm._spec_packed = False, None
    if spec:
        sm.enable_spec_decode()
    try:
        for prompt in ([1, 5, 9, 12, 3], [1, 40, 100, 3]):
            ids = np.asarray(prompt, dtype=np.int64)[None]
            gc = GenerationConfig(do_sample=False, max_new_tokens=4, min_new_tokens=4,
                                  pad_token_id=2, bos_token_id=1)
            with torch.no_grad():
                want = hf.generate(input_ids=torch.from_numpy(ids), generation_config=gc,
                                   output_audio=False).numpy()
            assert (_greedy_frames(model, ids, 4) == want).all()
    finally:
        sm.spec_decode, sm._spec_packed = False, None


def test_csm_directory_through_load_model(tmp_path):
    """Twin of test_golden_hf.py:1421: a ``save_pretrained`` CSM directory
    (CsmConfig field names, the tied audio table kept as the depth decoder's
    copy, the Mimi embedded as ``codec_model.*``) through the port's
    ``load_model``: greedy frames equal HF ``generate``'s, the embedded Mimi
    decodes within 1e-4 of HF's codec, and the loaded state equals the JAX
    ``load_model``'s bit for bit."""
    from transformers.generation import GenerationConfig

    from mlx_audio_tpu.utils.loader import load_model as jax_load_model

    jax_layers._INIT_RNG = np.random.default_rng(0)
    hf, _, nc, _ = _csm_pair()
    ckpt = tmp_path / "csm-hf"
    hf.save_pretrained(str(ckpt), safe_serialization=True)
    m = load_model(str(ckpt), domain="tts", device="cpu", strict=True)
    ids = np.array([[1, 5, 9, 12, 3]], dtype=np.int64)
    gc = GenerationConfig(do_sample=False, max_new_tokens=3, min_new_tokens=3,
                          pad_token_id=2, bos_token_id=1)
    with torch.no_grad():
        want = hf.generate(input_ids=torch.from_numpy(ids), generation_config=gc,
                           output_audio=False).numpy()
    assert (_greedy_frames(m, ids, 3) == want).all()

    codes = np.random.default_rng(0).integers(0, 16, size=(1, nc, 13))
    with torch.no_grad():
        wav_hf = hf.codec_model.decode(torch.from_numpy(codes)).audio_values.numpy()
    wav = m.mimi.decode(torch.from_numpy(codes)).numpy()
    n = min(wav.shape[-1], wav_hf.shape[-1])
    np.testing.assert_allclose(wav.reshape(-1)[:n], wav_hf.reshape(-1)[:n], atol=ATOL)

    jm = jax_load_model(str(ckpt), domain="tts")
    jax_state = params_from_jax({k: np.asarray(v) for k, v in named_arrays(jm)}, m)
    state = m.state_dict()
    assert jax_state.keys() == state.keys()
    for k, t in state.items():
        assert torch.equal(jax_state[k].to(t.dtype), t), k


@pytest.mark.parametrize("kept", ["backbone", "depth", "both"])
def test_sanitize_hf_csm_takes_either_tied_copy(kept):
    """The tied audio table under either key, or both (the backbone's wins),
    gives the JAX package's sanitized dict; ``sanitize`` dispatches to it
    on ``backbone_model.*`` keys."""
    from mlx_audio_tpu.models.tts.sesame.model import sanitize_hf_csm as jax_sanitize

    rng = np.random.default_rng(kept == "depth")
    backbone, depth = rng.standard_normal((2, 12, 4)).astype(np.float32)
    w = {"backbone_model.norm.weight": np.ones(4, np.float32),
         "lm_head.weight": rng.standard_normal((3, 4)).astype(np.float32),
         "depth_decoder.model.layers.0.mlp.up_proj.weight": np.eye(4, dtype=np.float32)}
    if kept in ("backbone", "both"):
        w["backbone_model.embed_tokens.embed_audio_tokens.weight"] = backbone
    if kept in ("depth", "both"):
        w["depth_decoder.model.embed_tokens.weight"] = depth
    ours, theirs = sanitize(w), jax_sanitize(w)
    assert ours.keys() == theirs.keys()
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k])
    np.testing.assert_array_equal(ours["model.audio_embeddings.weight"],
                                  depth if kept == "depth" else backbone)


def test_chip_smoke_csm_hf_writer_round_trips():
    """chip_smoke.py's HF CSM writer is the inverse of ``sanitize_hf_csm``
    on a port model (no RoPE tables, the depth decoder's copy of the tied
    table only), so its phase 16 reads every tensor back.  Like the JAX
    package's, ``sanitize_hf_csm`` un-permutes the embedded Mimi's q and k
    with kyutai/mimi's 8 heads, so the writer permutes with 8 here too."""
    model = Model(CSM_PAIR_CONFIG, mimi=Mimi.build(port_config(
        build_mimi_pair()[1].cfg), device="cpu"), device="cpu", seed=5)
    named = params_to_jax(model.state_dict(), model)
    written = chip_smoke.hf_csm_weights(named, n_mimi_heads=8, n_ratios=len(RATIOS))
    assert "backbone_model.embed_tokens.embed_audio_tokens.weight" not in written
    back = sanitize(written)
    assert back.keys() == {k for k in named if "rope_" not in k}
    for k, v in back.items():
        np.testing.assert_array_equal(v, named[k], err_msg=k)


def test_chip_smoke_csm_hf_config_is_the_published_one():
    """chip_smoke.CSM_HF_CONFIG builds CSM_CONFIG's flavors and
    mimi_202407(32), and agrees with transformers' CsmConfig() defaults on
    every field the port reads.  Where they part, as named here: the
    published checkpoint sets llama3 RoPE scaling (the class defaults to
    none); the depth decoder's vocabulary (its LM has no token embedding)
    and 33 positions (its RoPE table's rows, the same values as 2048's
    first 33) are HF's, not the flavor's; HF's MimiConfig has no
    ``normalize``, which no Mimi of either package reads."""
    import dataclasses

    from transformers import CsmConfig

    cfg = chip_smoke.CSM_HF_CONFIG
    assert _llama_cfg_from_dict(cfg, vocab_override=cfg["text_vocab_size"]) == \
        LLAMA_FLAVORS["llama-1B"]
    assert _llama_cfg_from_dict(cfg["depth_decoder_config"]) == dataclasses.replace(
        LLAMA_FLAVORS["llama-100M"], vocab_size=2051, max_position_embeddings=33)
    assert mimi_from_hf_config(cfg["codec_config"]) == dataclasses.replace(
        mimi_202407(32), renormalize=False)
    assert cfg["num_codebooks"] == chip_smoke.CSM_CONFIG["audio_num_codebooks"]
    assert cfg["vocab_size"] == chip_smoke.CSM_CONFIG["audio_vocab_size"]
    assert cfg["text_vocab_size"] == chip_smoke.CSM_CONFIG["text_vocab_size"]

    hf = CsmConfig().to_dict()
    read = ("num_codebooks", "vocab_size", "text_vocab_size", "num_hidden_layers",
            "num_attention_heads", "num_key_value_heads", "head_dim", "hidden_size",
            "intermediate_size", "rms_norm_eps", "max_position_embeddings",
            "attention_bias", "mlp_bias", "rope_theta")
    for k in read:
        assert cfg[k] == hf[k], k
        assert cfg["depth_decoder_config"][k if k != "text_vocab_size" else "vocab_size"] \
            == hf["depth_decoder_config"][k if k != "text_vocab_size" else "vocab_size"], k
    assert hf["rope_scaling"] is None and hf["depth_decoder_config"]["rope_scaling"] is None
    codec_read = ("hidden_size", "audio_channels", "use_causal_conv", "num_filters",
                  "num_residual_layers", "upsampling_ratios", "kernel_size",
                  "residual_kernel_size", "last_kernel_size", "dilation_growth_rate",
                  "compress", "num_attention_heads", "num_hidden_layers",
                  "layer_scale_initial_scale", "sliding_window", "rope_theta",
                  "intermediate_size", "sampling_rate", "num_quantizers", "codebook_size",
                  "vector_quantization_hidden_dimension")
    for k in codec_read:
        assert cfg["codec_config"][k] == hf["codec_config"][k], k
    assert "normalize" not in hf["codec_config"] and "frame_rate" not in cfg["codec_config"]
    CsmConfig(**cfg)  # HF takes the dict as its own


# -- the Llama-3 tokenizer loader -------------------------------------------


def _tiny_tokenizer_dir(path):
    """A tiny offline Llama-3-style fast tokenizer (word level, <bos> and
    <eos> specials) saved with ``save_pretrained``."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    words = ["[0]hello", "world", "[1]the", "port", "speaks", "<unk>"]
    vocab = {w: i + 10 for i, w in enumerate(words)}
    vocab.update({"<|begin_of_text|>": 1, "<|end_of_text|>": 2})
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    fast = PreTrainedTokenizerFast(tokenizer_object=tok, bos_token="<|begin_of_text|>",
                                   eos_token="<|end_of_text|>", unk_token="<unk>")
    fast.save_pretrained(str(path))
    return path


def test_llama3_tokenizer_loader_matches_jax(tmp_path):
    """``load_llama3_tokenizer`` on a local directory: every encode wrapped
    in <bos> ... <eos>, ids equal to the JAX package's loader's; a CSM whose
    config names that directory tokenizes through it."""
    from mlx_audio_tpu.models.tts.sesame.tokenizer import (
        load_llama3_tokenizer as jax_load,
    )
    from mlx_audio_tpu_torch.models.tts.sesame.tokenizer import load_llama3_tokenizer

    path = _tiny_tokenizer_dir(tmp_path / "llama3")
    ours, theirs = load_llama3_tokenizer(str(path)), jax_load(str(path))
    for text in ("[0]hello world", "[1]the port speaks", "[0]hello unknown"):
        assert ours.encode(text) == theirs.encode(text)
        assert ours.encode(text)[0] == 1 and ours.encode(text)[-1] == 2
    model = Model({**CSM_PAIR_CONFIG, "text_tokenizer": str(path)},
                  mimi=Mimi.build(port_config(build_mimi_pair()[1].cfg), device="cpu"),
                  device="cpu")
    frame, mask = model._tokenize_text_segment("hello world", 0)
    assert frame[:, -1].tolist() == ours.encode("[0]hello world") and mask[:, -1].all()


def _no_fetch(monkeypatch):
    """Every hub download and every socket connection raises."""
    import socket

    def refuse(*a, **k):
        raise AssertionError("a network fetch was attempted")

    for target in ("huggingface_hub.hf_hub_download", "huggingface_hub.snapshot_download",
                   "huggingface_hub.file_download.hf_hub_download",
                   "huggingface_hub._snapshot_download.snapshot_download",
                   "transformers.AutoTokenizer.from_pretrained"):
        monkeypatch.setattr(target, refuse)
    monkeypatch.setattr(socket.socket, "connect", refuse)


@pytest.mark.parametrize("entry", ["load_model", "mimi", "tokenizer", "csm_tokenizer",
                                   "silentcipher", "s3"])
def test_a_hub_id_raises_without_a_fetch(monkeypatch, entry):
    """A path that is not a local directory raises FileNotFoundError naming
    it, with every hub download and socket connection made to raise."""
    from mlx_audio_tpu_torch.codec.s3 import S3TokenizerV2
    from mlx_audio_tpu_torch.models.tts.sesame.silentcipher import load_silentcipher
    from mlx_audio_tpu_torch.models.tts.sesame.tokenizer import load_llama3_tokenizer

    _no_fetch(monkeypatch)
    calls = {
        "load_model": ("sesame/csm-1b", lambda p: load_model(p, domain="tts", device="cpu")),
        "mimi": ("kyutai/mimi", lambda p: Mimi.from_pretrained(p, device="cpu")),
        "tokenizer": ("unsloth/Llama-3.2-1B", load_llama3_tokenizer),
        "csm_tokenizer": ("unsloth/Llama-3.2-1B", lambda p: Model(
            CSM_PAIR_CONFIG, mimi=Mimi.build(port_config(build_mimi_pair()[1].cfg),
                                             device="cpu"), device="cpu")._get_tokenizer()),
        "silentcipher": ("sesame/silentcipher", lambda p: load_silentcipher(p, device="cpu")),
        "s3": ("mlx-community/CosyVoice2-0.5B-S3Tokenizer",
               lambda p: S3TokenizerV2.from_pretrained(repo_id=p, device="cpu")),
    }
    path, call = calls[entry]
    with pytest.raises(FileNotFoundError, match=path.replace("/", ".")) as e:
        call(path)
    if entry.endswith("tokenizer"):
        assert "text_tokenizer=" in str(e.value)


# -- the raw STT directories through the generic loader -----------------------


def test_stt_families_load_hf_checkpoint_directories(tmp_path):
    """Twin of test_golden_hf.py:1538: raw HF-transformers Parakeet-CTC and
    Wav2Vec2 directories through the port's ``load_model`` reproduce HF's
    log-probs and last hidden state within 1e-4, and Parakeet's vocabulary
    comes from the directory's tokenizer.json."""
    from transformers import Wav2Vec2Config, Wav2Vec2Model
    from transformers.models.parakeet import ParakeetCTCConfig, ParakeetEncoderConfig
    from transformers.models.parakeet.modeling_parakeet import ParakeetForCTC

    rng = np.random.default_rng(40)
    enc = ParakeetEncoderConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=64, conv_kernel_size=9, num_mel_bins=16,
        subsampling_factor=8, subsampling_conv_channels=8, dropout=0.0,
        attention_dropout=0.0, dropout_positions=0.0, scale_input=False)
    torch.manual_seed(0)
    phf = ParakeetForCTC(ParakeetCTCConfig(encoder_config=enc.to_dict(), vocab_size=33)).eval()
    phf.save_pretrained(str(tmp_path / "parakeet"), safe_serialization=True)
    vocab33 = [["▁tok%d" % i, -float(i)] for i in range(33)]
    with open(tmp_path / "parakeet" / "tokenizer.json", "w") as f:
        json.dump({"model": {"type": "Unigram", "vocab": vocab33}}, f)
    pk = load_model(str(tmp_path / "parakeet"), domain="stt", device="cpu")
    assert pk.vocabulary[:2] == ["▁tok0", "▁tok1"] and len(pk.vocabulary) == 32
    mel = rng.standard_normal((1, 64, 16)).astype(np.float32)
    with torch.no_grad():
        want = torch.log_softmax(phf(input_features=torch.from_numpy(mel)).logits, -1)
        feats, _ = pk.encoder(torch.from_numpy(mel))
        logp = pk.decoder(feats)
    np.testing.assert_allclose(logp.numpy(), want.numpy(), atol=ATOL, rtol=ATOL)

    torch.manual_seed(0)
    whf = Wav2Vec2Model(Wav2Vec2Config(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=64, conv_dim=[16, 16], conv_stride=[5, 2],
        conv_kernel=[10, 3], num_feat_extract_layers=2,
        num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=2)).eval()
    whf.save_pretrained(str(tmp_path / "w2v"), safe_serialization=True)
    w2v = load_model(str(tmp_path / "w2v"), domain="stt", device="cpu")
    wav = torch.from_numpy((rng.standard_normal((1, 800)) * 0.1).astype(np.float32))
    with torch.no_grad():
        want = whf(wav).last_hidden_state
        got = w2v(wav)[0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=ATOL)
