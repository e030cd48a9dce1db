"""IndexTTS in the port against the JAX package, float32 on the CPU: a twin
of each test of tests/test_indextts.py at its ``tiny_model_config`` (the
normalisation, the conformer, perceiver, ECAPA and GPT-2, the log-mel,
greedy generation end to end, the vocoder's sub-batch exactness, sanitize,
the growing position table), of test_golden_hf.py's GPT-2 golden, and the
port's own contracts: a ragged batch with one row that stops early, a
first code that is already the stop code, the sampled path, the default
device, the strict crossing of every array, the local loader and the
vocoder's conv routes at IndexTTS-1.5's widths.

Each model is built once, in JAX with a seeded init, and its arrays cross
with ``convert.params_from_jax`` and ``load_state_dict(strict=True)``.  The
JAX init leaves ``weight_g`` at the norm of ``weight_v``, the snake
parameters, ``pos_bias_u``/``pos_bias_v`` and the perceiver's latents at 0
and every norm at the identity, which would hide a wrong axis: all are
redrawn before crossing.  The JAX side runs its matmuls at "highest" (its
CPU default rounds past 1e-5).  Modules are held to 1e-5, audio to 1e-4,
greedy codes equal.
"""

import dataclasses
import json
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mlx_audio_tpu.models.tts.indextts.indextts as jit_mod
import mlx_audio_tpu.models.tts.indextts.vocoder as jvoc
import mlx_audio_tpu.nn.layers as jax_layers
from mlx_audio_tpu.models.tts.indextts import normalize as jnorm
from mlx_audio_tpu.models.tts.indextts.conformer import Conformer as JaxConformer
from mlx_audio_tpu.models.tts.indextts.ecapa import ECPATDNN as JaxECPATDNN
from mlx_audio_tpu.models.tts.indextts.ecapa import ECPATDNNArgs as JaxECPATDNNArgs
from mlx_audio_tpu.models.tts.indextts.gpt import GPT2Args as JaxGPT2Args
from mlx_audio_tpu.models.tts.indextts.gpt import GPT2Model as JaxGPT2Model
from mlx_audio_tpu.models.tts.indextts.indextts import Model as JaxModel
from mlx_audio_tpu.models.tts.indextts.perceiver import PerceiverResampler as JaxPerceiver
from mlx_audio_tpu.nn.module import named_arrays, update_arrays
from mlx_audio_tpu_torch.codec.bigvgan import bigvgan as tbv
from mlx_audio_tpu_torch.convert import params_from_jax
from mlx_audio_tpu_torch.models.tts.indextts import Model, ModelConfig
from mlx_audio_tpu_torch.models.tts.indextts import indextts as it
from mlx_audio_tpu_torch.models.tts.indextts import normalize
from mlx_audio_tpu_torch.models.tts.indextts.conformer import Conformer, ConformerArgs
from mlx_audio_tpu_torch.models.tts.indextts.ecapa import ECPATDNN, ECPATDNNArgs
from mlx_audio_tpu_torch.models.tts.indextts.gpt import GPT2Args, GPT2Model
from mlx_audio_tpu_torch.models.tts.indextts.perceiver import PerceiverResampler
from mlx_audio_tpu_torch.models.tts.indextts.vocoder import (
    BigVGANConditioningConfig,
    log_mel_spectrogram,
)
from mlx_audio_tpu_torch.nn import layers
from test_indextts import TINY_CONFORMER, _FakeSpm, tiny_model_config

MOD = dict(atol=1e-5, rtol=1e-5)
AUDIO = dict(atol=1e-4, rtol=1e-4)
TEXT = "hello world"
# the ragged batch: the first row is made to stop early (test_ragged_batch)
RAGGED = ("hello world", "a second text, longer than the first one")


def _seeded(build):
    saved = jax_layers._INIT_RNG
    jax_layers._INIT_RNG = np.random.default_rng(0)
    try:
        return build()
    finally:
        jax_layers._INIT_RNG = saved


_NORM = re.compile(r"(^|\.)(\w*norm\w*|ln_\w+|asp_bn)\.(weight|bias)$")


def randomized(jm, seed=1):
    """Every array the JAX init sets to a constant, drawn: weight-norm g,
    snake alpha and beta, batch-norm statistics, norm affines, the
    relative-position biases and the perceiver's latents."""
    rng = np.random.default_rng(seed)
    new = {}
    for k, v in named_arrays(jm):
        v = np.asarray(v)
        if k.endswith("weight_g"):
            w = v * rng.uniform(0.5, 1.5, v.shape)
        elif k.endswith((".alpha", ".beta")):
            w = rng.standard_normal(v.shape) * 0.3
        elif k.endswith("running_var"):
            w = rng.uniform(0.5, 1.5, v.shape)
        elif k.endswith(("running_mean", "pos_bias_u", "pos_bias_v")):
            w = rng.standard_normal(v.shape) * 0.1
        elif k.endswith(".latents"):
            w = rng.standard_normal(v.shape) * 0.5
        elif _NORM.search(k):
            w = rng.standard_normal(v.shape) * 0.1 + k.endswith("weight")
        else:
            continue
        new[k] = w.astype(np.float32)
    return update_arrays(jm, new)


def carry(jm, tm):
    named = {k: np.asarray(v) for k, v in named_arrays(jm)}
    tm.load_state_dict(params_from_jax(named, tm), strict=True)
    return tm


def port_config(jax_config) -> ModelConfig:
    return ModelConfig.from_dict(dataclasses.asdict(jax_config))


@pytest.fixture(scope="module")
def pair():
    jm = randomized(_seeded(lambda: JaxModel(tiny_model_config(), tokenizer=_FakeSpm())))
    tm = Model(port_config(tiny_model_config()), tokenizer=_FakeSpm(), device="cpu")
    return jm, carry(jm, tm)


@pytest.fixture(scope="module")
def ref_mel():
    return np.random.default_rng(5).standard_normal((1, 21, 16)).astype(np.float32)


def jax_run(jm, texts, ref_mel, **kw):
    """The JAX package's generate_batch, recording each row's codes and the
    latent stream it handed the vocoder: (results, codes, latents)."""
    rec = {"first": None, "chunks": [], "latents": {}}
    first_fn, chunk_fn, voc_fn = (jit_mod.sample_top_k_rows, jit_mod._decode_chunk,
                                  jvoc._vocoder_forward_jit)

    def first(*a, **k):
        out = first_fn(*a, **k)
        if rec["first"] is None:
            rec["first"] = np.asarray(out)
        return out

    def chunk(*a, **k):
        out = chunk_fn(*a, **k)
        rec["chunks"].append(np.asarray(out[-1]))  # tokens [chunk, B]
        return out

    def vocoder(model, latents, mel):
        for row in np.asarray(latents):
            rec["latents"].setdefault(len(row), []).append(row)
        return voc_fn(model, latents, mel)

    jit_mod.sample_top_k_rows, jit_mod._decode_chunk = first, chunk
    jvoc._vocoder_forward_jit = vocoder
    try:
        with jax.default_matmul_precision("highest"):
            results = jm.generate_batch(list(texts), ref_mel=jnp.asarray(ref_mel), **kw)
    finally:
        jit_mod.sample_top_k_rows, jit_mod._decode_chunk = first_fn, chunk_fn
        jvoc._vocoder_forward_jit = voc_fn
    stop = jm.args.gpt.stop_mel_token
    steps = (np.concatenate(rec["chunks"]) if rec["chunks"]
             else np.zeros((0, len(texts)), np.int32))
    codes = []
    for i, r in enumerate(results):
        row = [int(rec["first"][i])]
        if row[0] != stop:
            hits = np.nonzero(steps[:, i] == stop)[0]
            row += steps[:hits[0] + 1 if len(hits) else len(steps), i].tolist()
        codes.append(row[:r.token_count])
    return results, codes, rec["latents"]


def port_run(tm, texts, ref_mel, **kw):
    """The port's generate_latents and generate_batch: (results, codes,
    latent streams)."""
    mel = torch.as_tensor(ref_mel)
    streams, codes = tm.generate_latents(list(texts), mel, **kw)
    return tm.generate_batch(list(texts), ref_mel=ref_mel, **kw), codes, streams


def assert_rows_match(got, want):
    """Port rows against JAX rows: codes equal, latents 1e-5, audio 1e-4."""
    (t_res, t_codes, t_lat), (j_res, j_codes, j_lat) = got, want
    assert t_codes == j_codes
    for i, (r, s) in enumerate(zip(t_res, j_res)):
        assert r.token_count == s.token_count == len(t_codes[i])
        assert r.audio.shape == s.audio.shape
        np.testing.assert_allclose(r.audio, s.audio, **AUDIO)
    for i, lat in enumerate(t_lat):
        rows = j_lat[lat.shape[0]]
        assert any(np.allclose(lat.numpy(), row, **MOD) for row in rows), i


# ---------------------------------------------------------------------------
# the twins of tests/test_indextts.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("text", [
    "I owe $23 and that's 1,234 reasons!", "It's 5 6 7, isn't it?",
    "Pay $1 now. 1000000 people", "你好，世界！“引号”", "ni3 hao3 lü4 qu2",
    "张三-李四说：好", "mail@example.com", "a (b) [c] ~d~ e...f"])
def test_normalize_english(text):
    out = normalize.normalize(text)
    assert out == jnorm.normalize(text)
    assert normalize.tokenize_by_CJK_char(out) == jnorm.tokenize_by_CJK_char(out)
    if text.startswith("I owe"):
        assert "twenty three dollars" in out
        assert "one thousand two hundred thirty four" in out
        assert "that is" in out and out.endswith("!")


def test_normalize_routing_and_cjk():
    for text in ("你好", "ni3 hao3", "hello world", "x@y.z"):
        assert normalize.use_chinese(text) == jnorm.use_chinese(text)
    assert normalize.use_chinese("你好") and normalize.use_chinese("ni3 hao3")
    assert not normalize.use_chinese("hello world")
    assert normalize.tokenize_by_CJK_char("你好 hello 世界") == "你 好 HELLO 世 界"
    assert normalize.correct_pinyin("qu2") == "QV2" == jnorm.correct_pinyin("qu2")
    assert normalize.correct_pinyin("ma3") == "ma3"
    assert normalize.number_to_words(10 ** 12 + 7) == jnorm.number_to_words(10 ** 12 + 7)


def _module_pair(build_jax, build_port):
    jm = randomized(_seeded(build_jax))
    with torch.device("cpu"):
        return jm, carry(jm, build_port())


def _hold(tm, jm, x):
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jm(jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, **MOD)
    return got


@pytest.fixture(scope="module")
def conformer_pair():
    return _module_pair(lambda: JaxConformer(TINY_CONFORMER),
                        lambda: Conformer(ConformerArgs(**vars(TINY_CONFORMER))))


def test_conformer_shapes(conformer_pair):
    """conv2d2: T' = (21 - 3 + 2) // 2 = 10; equal to the JAX conformer."""
    jm, tm = conformer_pair
    x = np.random.default_rng(0).standard_normal((2, 21, 16)).astype(np.float32)
    assert _hold(tm, jm, x).shape == (2, 10, 32)


def test_perceiver_latents():
    jm, tm = _module_pair(
        lambda: JaxPerceiver(32, n_dim_context=48, n_latents=8, n_heads=4, n_ff_mult=2),
        lambda: PerceiverResampler(32, n_dim_context=48, n_latents=8, n_heads=4,
                                   n_ff_mult=2))
    ctx = np.random.default_rng(1).standard_normal((2, 12, 48)).astype(np.float32)
    assert _hold(tm, jm, ctx).shape == (2, 8, 32)


def test_ecapa_embedding_shape():
    kw = dict(input_size=16, lin_neurons=24, channels=[32, 32, 32, 32, 64],
              res2net_scale=4, se_channels=16, attention_channels=16)
    jm, tm = _module_pair(lambda: JaxECPATDNN(JaxECPATDNNArgs(**kw)),
                          lambda: ECPATDNN(ECPATDNNArgs(**kw)))
    mel = np.random.default_rng(2).standard_normal((2, 30, 16)).astype(np.float32)
    assert _hold(tm, jm, mel).shape == (2, 1, 24)


def test_gpt_prefill_step_consistency():
    """step(t + 1 | prefill(t)) equals prefill(t + 1)'s last hidden, and
    both equal the JAX stack's; a left-padded prefill and its steps equal
    the unpadded row's."""
    jm = randomized(_seeded(lambda: JaxGPT2Model(JaxGPT2Args(n_embd=32, n_head=4,
                                                             n_layer=2))))
    tm = carry(jm, GPT2Model(GPT2Args(n_embd=32, n_head=4, n_layer=2)))
    rng = np.random.default_rng(3)
    embeds = (rng.standard_normal((1, 6, 32)) * 0.1).astype(np.float32)
    pad = np.zeros((1, 2, 32), np.float32)
    full = np.concatenate([embeds, pad], axis=1)
    with jax.default_matmul_precision("highest"):
        j_full, _ = jm.prefill(jm.init_cache(1, 16), jnp.asarray(full), jnp.asarray(6))
        _, jc = jm.prefill(jm.init_cache(1, 16), jnp.asarray(embeds[:, :5]), jnp.asarray(5))
        j_step, _ = jm.step(jc, jnp.asarray(embeds[:, 5:6]))
    with torch.no_grad():
        t_full, _ = tm.prefill(tm.init_cache(1, 16), torch.as_tensor(full), 6)
        _, tc = tm.prefill(tm.init_cache(1, 16), torch.as_tensor(embeds[:, :5]), 5)
        t_step, _ = tm.step(tc, torch.as_tensor(embeds[:, 5:6]))
        np.testing.assert_allclose(t_step.numpy(), t_full.numpy(), **MOD)
        np.testing.assert_allclose(t_full.numpy(), np.asarray(j_full), **MOD)
        np.testing.assert_allclose(t_step.numpy(), np.asarray(j_step), **MOD)
        # left padding: 3 pad slots in front of the first 5 embeddings
        left = np.concatenate([np.ones((1, 3, 32), np.float32), embeds[:, :5]], axis=1)
        pad_len = torch.tensor([3])
        _, lc = tm.prefill_left(tm.init_cache(1, 16), torch.as_tensor(left), pad_len)
        h_step, _ = tm.step(lc, torch.as_tensor(embeds[:, 5:6]), pad_len)
        np.testing.assert_allclose(h_step.numpy(), t_step.numpy(), **MOD)


def test_log_mel_shape():
    audio = np.random.default_rng(4).standard_normal(2400).astype(np.float32)
    got = log_mel_spectrogram(torch.as_tensor(audio), n_mels=16, n_fft=64, hop_length=16)
    want = np.asarray(jvoc.log_mel_spectrogram(jnp.asarray(audio), n_mels=16, n_fft=64,
                                               hop_length=16))
    assert got.shape[0] == 1 and got.shape[2] == 16 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **MOD)
    # the defaults: 24 kHz, 100 HTK mels, n_fft 1024, hop 256
    audio = np.random.default_rng(6).standard_normal((2, 6000)).astype(np.float32) * 0.1
    got = log_mel_spectrogram(torch.as_tensor(audio)).numpy()
    np.testing.assert_allclose(got, np.asarray(jvoc.log_mel_spectrogram(
        jnp.asarray(audio))), **MOD)


def test_indextts_generate_e2e(pair, ref_mel):
    """Greedy generate: codes equal to the JAX package's, latents 1e-5,
    audio 1e-4; four samples a latent (2 x 2 upsampling)."""
    jm, tm = pair
    got = port_run(tm, [TEXT], ref_mel, max_tokens=12, temperature=0)
    assert_rows_match(got, jax_run(jm, [TEXT], ref_mel, max_tokens=12, chunk=4,
                                   temperature=0))
    r = list(tm.generate(TEXT, ref_mel=ref_mel, max_tokens=12, temperature=0))[0]
    assert r.sample_rate == 24000 and r.audio.ndim == 1
    assert r.audio.size == r.token_count * 4 and r.token_count == 13
    np.testing.assert_array_equal(r.audio, got[0][0].audio)


def test_vocoder_sub_batch_cap_is_exact(pair, ref_mel, monkeypatch):
    """Sub-batched vocoder calls give audio identical to one whole-group
    call: splitting a group changes the number of calls only (the speaker
    is encoded once a call, from the one reference mel).  oneDNN's CPU
    convolutions pick their blocking by batch size (a row moves by up to
    9e-8 between batch 4 and 3 + 1), so the exact comparison runs with
    oneDNN off, where torch's CPU convs compute each row alone; with it on
    the split stays within 1e-6."""
    _, tm = pair
    texts = [TEXT] * 6
    kw = dict(ref_mel=ref_mel, max_tokens=8, temperature=0.8, seed=0)
    calls = []
    hook = tm.bigvgan.register_forward_pre_hook(lambda m, a: calls.append(a[0].shape[0]))
    try:
        with torch.backends.mkldnn.flags(enabled=False):
            monkeypatch.setattr(it, "VOCODER_SUB_BATCH", 100)  # one whole group
            whole = tm.generate_batch(texts, **kw)
            whole_calls, calls[:] = list(calls), []
            monkeypatch.setattr(it, "VOCODER_SUB_BATCH", 3)  # splits the group of 4
            split = tm.generate_batch(texts, **kw)
    finally:
        hook.remove()
    assert max(whole_calls) > 3 and len(calls) > len(whole_calls) and max(calls) <= 3
    for w, s in zip(whole, split):
        np.testing.assert_array_equal(w.audio, s.audio)
    streams, _ = tm.generate_latents(texts, torch.as_tensor(ref_mel), 8, 0.8, 30, 0)
    group = torch.stack([x for x in streams if len(x) == len(streams[0])][:4])
    mel = torch.as_tensor(ref_mel)
    one = tm.bigvgan(group, mel)
    parts = torch.cat([tm.bigvgan(group[:3], mel), tm.bigvgan(group[3:], mel)])
    np.testing.assert_allclose(parts.numpy(), one.numpy(), atol=1e-6, rtol=0)


def test_indextts_sanitize():
    weights = {
        "gpt.h.0.attn.c_attn.weight": np.arange(32 * 96, dtype=np.float32).reshape(32, 96),
        "gpt.h.0.attn.bias": np.zeros((1, 1, 8, 8)),
        "perceiver_encoder.norm.gamma": np.ones((32,)),
        "perceiver_encoder.layers.0.0.to_kv.weight": np.arange(64 * 32.).reshape(64, 32),
        "perceiver_encoder.layers.0.1.0.weight": np.ones((84, 32)),
        "perceiver_encoder.layers.0.1.2.bias": np.ones((32,)),
        "conditioning_encoder.encoders.0.conv_module.depthwise_conv.weight":
            np.arange(32 * 7.).reshape(32, 1, 7),
        "conditioning_encoder.embed.conv.0.weight": np.arange(32 * 9.).reshape(32, 1, 3, 3),
        "conditioning_encoder.pos_enc.pe": np.zeros((1, 64, 32)),
        "ups.0.0.weight_v": np.arange(32 * 16 * 4.).reshape(32, 16, 4),
        "speaker_encoder.blocks.0.conv.conv.weight": np.arange(32 * 16 * 5.).reshape(32, 16, 5),
        "speaker_encoder.asp_bn.norm.running_mean": np.ones((8,)),
        "speaker_encoder.blocks.0.norm.norm.num_batches_tracked": np.zeros(()),
        "resblocks.0.activations.0.act.alpha": np.ones((1, 16, 1)),
        "resblocks.0.activations.0.upsample.filter": np.ones((1, 1, 12)),
    }
    got = Model.sanitize(None, weights)
    want = JaxModel.sanitize(None, weights)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert got["gpt.h.0.attn.c_attn.weight"].shape == (96, 32)
    assert "gpt.h.0.attn.bias" not in got and "perceiver_encoder.norm.weight" in got
    assert got["perceiver_encoder.layers.0.0.linear_k.weight"].shape == (32, 32)
    assert got["conditioning_encoder.encoders.0.conv_module.depthwise_conv.weight"
               ].shape == (7, 1, 32)
    assert got["bigvgan.ups.0.0.weight_v"].shape == (4, 32, 16)
    assert got["bigvgan.speaker_encoder.blocks.0.conv.weight"].shape == (5, 16, 32)


def test_rel_pos_table_grows(conformer_pair):
    """A reference mel longer than pos_emb_max_len (64) regrows the table:
    T' = (151 - 3 + 2) // 2 = 75; equal to the JAX conformer."""
    jm, tm = conformer_pair
    mel = np.random.default_rng(6).standard_normal((1, 151, 16)).astype(np.float32)
    assert _hold(tm, jm, mel).shape == (1, 75, 32)
    assert tm.pos_enc.pe.shape == (1, 75, 32)


# ---------------------------------------------------------------------------
# the twin of tests/test_golden_hf.py::test_indextts_gpt2_matches_hf_transformers
# ---------------------------------------------------------------------------


def test_indextts_gpt2_matches_hf_transformers():
    """The GPT-2 stack vs HF transformers' GPT2Model position by position
    through prefill and cached steps (atol 1e-4, as the golden test), with
    the weights through ``sanitize``'s HF-GPT2 rules; and equal to the JAX
    stack loaded the same way."""
    from transformers import GPT2Config
    from transformers import GPT2Model as HFGPT2Model

    from mlx_audio_tpu.nn import Module

    d, h, n_layer, t = 32, 2, 2, 12
    torch.manual_seed(0)
    hf = HFGPT2Model(GPT2Config(vocab_size=64, n_positions=64, n_embd=d, n_layer=n_layer,
                                n_head=h, resid_pdrop=0.0, embd_pdrop=0.0,
                                attn_pdrop=0.0)).eval()
    with torch.no_grad():
        hf.wpe.weight.zero_()  # embedding-level: the caller adds positions
    sd = {f"gpt.{k}": v.detach().numpy() for k, v in hf.state_dict().items()
          if not k.startswith(("wte.", "wpe."))}
    weights = Model.sanitize(None, sd)

    class Holder(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.gpt = GPT2Model(GPT2Args(n_embd=d, n_head=h, n_layer=n_layer))

    class JaxHolder(Module):
        def __init__(self, gpt):
            self.gpt = gpt

    holder = Holder()
    holder.load_state_dict(params_from_jax(weights, holder), strict=True)
    jh = update_arrays(JaxHolder(JaxGPT2Model(JaxGPT2Args(d, h, n_layer))), weights)
    gpt, jgpt = holder.gpt, jh.gpt
    x = np.random.default_rng(0).standard_normal((1, t, d)).astype(np.float32)
    with torch.no_grad():
        h_hf = hf(inputs_embeds=torch.from_numpy(x)).last_hidden_state.numpy()
        caches = gpt.init_cache(1, 32)
        hp, caches = gpt.prefill(caches, torch.as_tensor(x[:, :4]), 4)
        got = [hp.numpy()[0]]
        for i in range(4, t):
            hs, caches = gpt.step(caches, torch.as_tensor(x[:, i:i + 1]))
            got.append(hs.numpy()[0])
    with jax.default_matmul_precision("highest"):
        jc = jgpt.init_cache(1, 32)
        hp, jc = jgpt.prefill(jc, jnp.asarray(x[:, :4]), jnp.array(4))
        want = [np.asarray(hp)[0]]
        for i in range(4, t):
            hs, jc = jgpt.step(jc, jnp.asarray(x[:, i:i + 1]))
            want.append(np.asarray(hs)[0])
    np.testing.assert_allclose(np.stack(got), h_hf[0, 3:], atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(np.stack(got), np.stack(want), **MOD)


# ---------------------------------------------------------------------------
# the port's own contracts
# ---------------------------------------------------------------------------


def _with_rows_swapped(jm, tm, a: int, b: int):
    """Copies of both models whose mel_head rows a and b (weight and bias)
    are swapped: where the model chose a it now chooses b."""
    import copy

    named = dict(named_arrays(jm))
    new = {}
    for key in ("mel_head.weight", "mel_head.bias"):
        w = np.array(named[key])
        w[[a, b]] = w[[b, a]]
        new[key] = w
    tm2 = copy.deepcopy(tm)
    with torch.no_grad():
        for key, w in new.items():
            tm2.get_parameter(key).copy_(torch.as_tensor(w))
    return update_arrays(jm, new), tm2


def test_ragged_batch_rows_equal_single_runs(pair, ref_mel):
    """Two prompts of different lengths in one left-padded batch, greedy:
    the first row stops early (its code at step k, seen in neither row
    before, swapped with the stop code), the second runs its budget.  Each
    row equals its single run (codes equal, audio 1e-4) and the JAX
    package's batch row (codes equal, latents 1e-5, audio 1e-4)."""
    jm, tm = pair
    stop = tm.args.gpt.stop_mel_token
    kw = dict(max_tokens=12, temperature=0)
    _, (codes_a, codes_b) = tm.generate_latents(list(RAGGED), torch.as_tensor(ref_mel), **kw)
    k = next(k for k in range(1, len(codes_a))
             if codes_a[k] not in codes_a[:k] and codes_a[k] not in codes_b)
    jm2, tm2 = _with_rows_swapped(jm, tm, codes_a[k], stop)
    got = port_run(tm2, RAGGED, ref_mel, **kw)
    assert got[1][0][-1] == stop and len(got[1][0]) == k + 1
    assert len(got[1][1]) == 13 and stop not in got[1][1]
    assert_rows_match(got, jax_run(jm2, RAGGED, ref_mel, chunk=4, **kw))
    for i, text in enumerate(RAGGED):
        single = port_run(tm2, [text], ref_mel, **kw)
        assert single[1][0] == got[1][i]
        np.testing.assert_allclose(single[0][0].audio, got[0][i].audio, **AUDIO)


def test_first_code_already_stop(pair, ref_mel):
    """A first code that is the stop code ends the row with the prefill's
    latent alone: one latent, four samples, equal to the JAX package's."""
    jm, tm = pair
    stop = tm.args.gpt.stop_mel_token
    first = tm.generate_latents([TEXT], torch.as_tensor(ref_mel), max_tokens=4,
                                temperature=0)[1][0][0]
    jm2, tm2 = _with_rows_swapped(jm, tm, first, stop)
    got = port_run(tm2, [TEXT], ref_mel, max_tokens=4, temperature=0)
    assert got[1] == [[stop]] and got[0][0].token_count == 1 and got[0][0].audio.size == 4
    assert_rows_match(got, jax_run(jm2, [TEXT], ref_mel, max_tokens=4, chunk=4,
                                   temperature=0))


def test_sampled_path_contract(pair, ref_mel):
    """Sampling: a batch of one equals the single run, a seed repeats, and
    another seed draws other codes."""
    _, tm = pair
    kw = dict(max_tokens=10, temperature=0.8, top_k=5)
    mel = torch.as_tensor(ref_mel)
    one = list(tm.generate(TEXT, ref_mel=ref_mel, seed=3, **kw))[0]
    batch = tm.generate_batch([TEXT], ref_mel=ref_mel, seed=3, **kw)[0]
    np.testing.assert_array_equal(one.audio, batch.audio)
    assert tm.generate_latents([TEXT], mel, seed=3, **kw)[1] == \
        tm.generate_latents([TEXT], mel, seed=3, **kw)[1]
    assert tm.generate_latents([TEXT], mel, seed=3, **kw)[1] != \
        tm.generate_latents([TEXT], mel, seed=4, **kw)[1]


def test_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(port_config(tiny_model_config()))
    with pytest.raises(ValueError, match="ref_audio or ref_mel"):
        Model(port_config(tiny_model_config()), tokenizer=_FakeSpm(),
              device="cpu").generate_batch([TEXT])
    # no SentencePiece here: the tokenizer property raises as the JAX one does
    with pytest.raises(RuntimeError, match="sentencepiece"):
        Model(port_config(tiny_model_config()), device="cpu").tokenizer


def test_params_from_jax_loads_strict(pair):
    """Every array of the JAX model crosses by name and shape; the computed
    position table is dropped; the ECAPA's and the conditioning convs move
    [K, Cin, Cout] -> [Cout, Cin, K], the subsampling conv HWIO -> OIHW, and
    the 2-d latents and position biases keep their layout."""
    jm, tm = pair
    named = {k: np.asarray(v) for k, v in named_arrays(jm)}
    state = params_from_jax(named, tm)
    assert set(state) == set(tm.state_dict()) == set(named) - {
        "conditioning_encoder.pos_enc.pe"}
    for key, t in tm.state_dict().items():
        assert t.shape == state[key].shape, key
        np.testing.assert_array_equal(t.numpy(), state[key].numpy())
    for key in ("bigvgan.speaker_encoder.blocks.0.conv.weight", "bigvgan.cond_layer.weight",
                "bigvgan.conds.0.weight", "bigvgan.speaker_encoder.fc.weight"):
        np.testing.assert_array_equal(state[key].numpy(), named[key].transpose(2, 1, 0))
    np.testing.assert_array_equal(state["conditioning_encoder.embed.conv.0.weight"].numpy(),
                                  named["conditioning_encoder.embed.conv.0.weight"]
                                  .transpose(3, 2, 0, 1))
    for key in ("perceiver_encoder.latents",
                "conditioning_encoder.encoders.0.self_attn.pos_bias_u"):
        np.testing.assert_array_equal(state[key].numpy(), named[key])


def test_from_pretrained_loads_a_local_directory(pair, ref_mel, tmp_path):
    """A local directory of config.json and safetensors in the JAX layout
    (``native_format``) loads into the same model; a missing one raises."""
    from safetensors.numpy import save_file

    jm, tm = pair
    save_file({k: np.ascontiguousarray(v) for k, v in named_arrays(jm)},
              str(tmp_path / "model.safetensors"))
    config = dataclasses.asdict(tiny_model_config())
    (tmp_path / "config.json").write_text(json.dumps({**config, "native_format": True}))
    loaded = Model.from_pretrained(str(tmp_path), tokenizer=_FakeSpm(), device="cpu")
    for key, t in tm.state_dict().items():
        np.testing.assert_array_equal(loaded.state_dict()[key].numpy(), t.numpy())
    a = loaded.generate_batch([TEXT], ref_mel=ref_mel, max_tokens=4, temperature=0)[0]
    b = tm.generate_batch([TEXT], ref_mel=ref_mel, max_tokens=4, temperature=0)[0]
    np.testing.assert_array_equal(a.audio, b.audio)
    with pytest.raises(FileNotFoundError):
        Model.from_pretrained(str(tmp_path / "missing"), device="cpu")


# IndexTTS-1.5's vocoder (scripts/bench_indextts.py's widths)
INDEXTTS_BIGVGAN = BigVGANConditioningConfig(
    num_mels=100, upsample_rates=[8, 8, 4, 2, 2], upsample_kernel_sizes=[16, 16, 8, 4, 4],
    upsample_initial_channel=1536, resblock="1", resblock_kernel_sizes=[3, 7, 11],
    resblock_dilation_sizes=[[1, 3, 5]] * 3, activation="snakebeta", snake_logscale=True,
    use_tanh_at_final=False, gpt_dim=1280, speaker_embedding_dim=512)


@pytest.mark.parametrize("latents,want", [
    (193, {(0, "library"): 18, (1, "shifted"): 8, (1, "banded"): 10}),
    (257, {(0, "shifted"): 18, (1, "shifted"): 8, (1, "banded"): 10}),
    (301, {(0, "shifted"): 18, (1, "shifted"): 8, (1, "banded"): 10}),
    (385, {(0, "shifted"): 18, (1, "shifted"): 6, (1, "banded"): 12}),
])
def test_vocoder_resblocks_route_to_both_conv_kernels(latents, want):
    """The conditioned BigVGAN's resblocks at IndexTTS-1.5's widths: at 301
    latents (300 mel tokens) the 768-channel stage [B, 2408, 768] takes
    dilated_conv1d (18 convs) and the 384-channel stage [B, 19264, 384]
    dilated_conv1d 8 times and banded_conv1d 10 times: 26 and 10.  Below
    256 latents the 768-channel stage has fewer than 2048 rows and takes
    the library.  The stages at 192 channels and below take the library.
    The blocks are built on the meta device (shapes only)."""
    cfg = INDEXTTS_BIGVGAN
    with torch.device("meta"):
        blocks = [(i, tbv.AMPBlock1(cfg.upsample_initial_channel // 2 ** (i + 1), True,
                                    "snakebeta", k, d))
                  for i in range(len(cfg.upsample_rates))
                  for k, d in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes)]
    counts = {}
    for i, block in blocks:
        rows = latents * int(np.prod(cfg.upsample_rates[:i + 1]))
        for conv in (*block.convs1, *block.convs2):
            c_out, c, k = conv.weight_v.shape
            route = layers.conv1d_route(k, c, c_out, rows, conv.dilation, conv.stride,
                                        conv.groups, conv.padding)
            counts[(i, route)] = counts.get((i, route), 0) + 1
    assert counts == {**want, (2, "library"): 18, (3, "library"): 18, (4, "library"): 18}
