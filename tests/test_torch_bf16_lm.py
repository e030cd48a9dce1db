"""The int8 LMs in bf16 in the port against the JAX package's bf16, on the
CPU at tiny widths: ``quantized_matmul``'s bf16 plain version against the
Pallas kernel, the weight bridge of a quantized bf16 model, CSM after
``cast_lm`` (greedy frames, spec decode, ``generate_batch``), the causal-LM
loop (the twin of tests/test_orpheus.py's bf16 test), and Orpheus, OuteTTS,
Spark and Voxtral end to end.

A quantized bf16 model is the float32 model quantized by each package's own
``quantize_model`` (equal codes), then cast: ``.astype(jnp.bfloat16)`` and
``.to(torch.bfloat16)``, or ``cast_lm`` for CSM.  On the CPU both packages
dequantize in bf16 and multiply in bf16 (the JAX package's dense route), each
rounding at its own places, so greedy runs are held teacher-forced: both
LMs' logits on JAX's greedy tokens within ``REL_RMS``; JAX's tokens its
argmax wherever its winner beats its runner-up by more than one bf16 step of
its logit, and the port's own greedy tokens equal JAX's up to the first
position where it does not (a near-tie).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mlx_audio_tpu.models.lm.causal as jax_causal
from mlx_audio_tpu.models.lm.causal import LlamaForCausalLM as JaxLM
from mlx_audio_tpu.models.lm.llama import LlamaConfig as JaxLlamaConfig
from mlx_audio_tpu.models.tts.sesame.model import Segment as JaxSegment
from mlx_audio_tpu.nn.layers import Linear as JaxLinear
from mlx_audio_tpu.nn.module import named_arrays
from mlx_audio_tpu.nn.pallas_ops import quantized_matmul as pallas_quantized_matmul
from mlx_audio_tpu.nn.quantize import QuantizedLinear as JaxQuantizedLinear
from mlx_audio_tpu.nn.quantize import _affine_dequantize, _unpack4
from mlx_audio_tpu.nn.quantize import quantize_model as jax_quantize_model
from mlx_audio_tpu_torch.convert import params_from_jax
from mlx_audio_tpu_torch.models.lm import causal
from mlx_audio_tpu_torch.models.lm.causal import LlamaForCausalLM, generate_tokens_batch
from mlx_audio_tpu_torch.models.lm.llama import LlamaConfig
from mlx_audio_tpu_torch.nn import kernels
from mlx_audio_tpu_torch.nn.quantize import quantize_model
from test_torch_orpheus import LM, _carry, _seeded
from test_torch_bf16 import rel_rms

BF16 = torch.bfloat16
# teacher-forced logits of the bf16 LMs against JAX's (5.1e-3 and 6.2e-3 at
# the LM and Spark runs here)
REL_RMS = 3e-2


def bf16_step(v: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values at |v|: 2^(e - 7) for 2^e <= |v| < 2^(e + 1)."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(v), 1e-30))) - 7)


def _penalized(logits: np.ndarray, tokens, penalty: float, context: int) -> np.ndarray:
    """The decode loop's repetition penalty on the logits [T, V] of generated
    position t: the tokens generated in the last ``context`` steps before it
    (none before the first, which comes from the prefill)."""
    out = logits.copy()
    if penalty == 1.0:
        return out
    for t in range(1, len(out)):
        for v in set(tokens[max(0, t - context):t]):
            out[t, v] = out[t, v] / penalty if out[t, v] > 0 else out[t, v] * penalty
    return out


def teacher_forced(jax_logits, port_logits, jax_tokens, port_tokens,
                   penalty: float = 1.0, context: int = 20) -> dict:
    """Holds the port's greedy run to JAX's: ``*_logits`` [T, V] are both LMs'
    logits at JAX's T generated positions, fed JAX's tokens (the penalty
    applied as the loop applies it).  The logits within REL_RMS; JAX's
    tokens its argmax wherever its winner beats its runner-up by more than
    one bf16 step of its logit; the port's greedy tokens equal JAX's up to
    the first position where it does not (a near-tie).  Returns the
    relative RMS and the count of near-ties."""
    jl = np.asarray(jax_logits, np.float64)
    err = rel_rms(torch.as_tensor(np.asarray(port_logits, np.float64)), torch.as_tensor(jl))
    assert err <= REL_RMS, err
    jax_tokens, port_tokens = list(jax_tokens), list(port_tokens)
    jp = _penalized(jl, jax_tokens, penalty, context)
    top = np.sort(jp, axis=-1)[:, -2:]
    tie = top[:, 1] - top[:, 0] <= bf16_step(top[:, 1])
    assert (jp.argmax(-1) == np.asarray(jax_tokens))[~tie].all()
    first = int(np.argmax(tie)) if tie.any() else len(jax_tokens)
    assert port_tokens[:first] == jax_tokens[:first]
    if not tie.any():
        assert port_tokens == jax_tokens
    return {"rel_rms": err, "near_ties": int(tie.sum())}


def _lm_logits(jlm, tlm, prompt, tokens):
    """Both causal LMs' float32 logits at the positions that predict
    ``tokens`` after ``prompt``, in one full forward of each."""
    ids = np.concatenate([np.asarray(prompt), np.asarray(tokens[:-1], np.int64)])[None]
    n = len(prompt) - 1
    jl = np.asarray(_jax_forward(jlm, jnp.asarray(ids, jnp.int32)))[0, n:]
    with torch.no_grad():
        tl = tlm(torch.as_tensor(ids)).float().numpy()[0, n:]
    return jl, tl


def _record_tokens(monkeypatch, pairs):
    """(module, key) pairs whose ``generate_tokens`` is recorded: each call's
    (prompt ids, generated tokens) under its key."""
    seen = {key: [] for _, key in pairs}
    for module, key in pairs:
        fn = module.generate_tokens

        def wrapped(model, input_ids, *a, f=fn, k=key, **kw):
            toks = []
            seen[k].append((np.asarray(input_ids).reshape(-1).tolist(), toks))
            for chunk in f(model, input_ids, *a, **kw):
                toks.extend(int(t) for t in chunk)
                yield chunk
        monkeypatch.setattr(module, "generate_tokens", wrapped)
    return seen


def _check_runs(jlm, tlm, seen, penalty=1.0, context=20) -> list:
    """Every recorded run of both packages, held teacher-forced; their
    prompts equal."""
    assert len(seen["jax"]) == len(seen["port"]) > 0
    out = []
    for (jp, jt), (pp, pt) in zip(seen["jax"], seen["port"]):
        assert pp == jp and len(jt) > 1
        jl, tl = _lm_logits(jlm, tlm, jp, jt)
        out.append(teacher_forced(jl, tl, jt, pt, penalty, context))
    return out


@jax.jit
def _jax_forward(lm, ids):
    return lm(ids).astype(jnp.float32)


@jax.jit
def _bf16_jax(module):
    """``module.astype(jnp.bfloat16)``, in one compiled call."""
    return module.astype(jnp.bfloat16)


# ---------------------------------------------------------------------------
# the kernel's plain version and the weight bridge
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("scale_dtype", ["bf16", "float32"])
def test_quantized_matmul_bf16_matches_the_pallas_kernel(scale_dtype, bits):
    """The twin of tests/test_pallas_ops.py's bf16-activation test: bf16 x,
    bf16 or float32 scales, int8 and packed int4, the Pallas kernel in
    interpret mode against the port's plain version (float32 dequant and
    sums, one rounding), both bf16, within 2e-2 of the float32 product of
    the same scales and of each other; the port within one bf16 step of
    float64."""
    rng = np.random.default_rng(2)
    b, i, o = 2, 256, 128
    lin = JaxLinear(i, o, bias=False)
    lin.weight = jnp.asarray(rng.standard_normal((o, i)) * 0.2, dtype=jnp.float32)
    q = JaxQuantizedLinear.from_linear(lin, group_size=64, bits=bits)
    sdt = jnp.bfloat16 if scale_dtype == "bf16" else jnp.float32
    s, z = q.scales.astype(sdt), q.biases.astype(sdt)
    x = jnp.asarray(rng.standard_normal((b, i)) * 0.5, dtype=jnp.bfloat16)
    out = pallas_quantized_matmul(x, q.weight, s, z, 64, packed=q.packed, interpret=True)
    assert out.dtype == jnp.bfloat16
    codes = _unpack4(q.weight) if q.packed else q.weight
    w = _affine_dequantize(codes, s.astype(jnp.float32), z.astype(jnp.float32), 64)
    ref = np.asarray(x.astype(jnp.float32) @ w.T)

    def t(a):
        return torch.as_tensor(np.array(a.astype(jnp.float32))).to(
            BF16 if a.dtype == jnp.bfloat16 else torch.float32)

    args = (t(x), torch.as_tensor(np.array(q.weight)), t(s), t(z), 64, q.packed)
    got = kernels.quantized_matmul(*args)
    assert got.dtype == BF16
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(out, np.float32),
                               rtol=2e-2, atol=2e-2)
    exact = kernels.quantized_matmul_plain(args[0].double(), *args[1:])
    assert kernels.bf16_steps(got, exact) <= 1.0


@pytest.mark.parametrize("order", ["quantize_then_cast", "cast_then_quantize"])
def test_params_from_jax_carries_a_quantized_bf16_model(order):
    """uint8 codes, and bf16 (quantized, then cast) or float32 (cast, then
    quantized) scales and biases, bit for bit: each package's own quantize
    and cast give the same arrays, and they cross unchanged."""
    cfg = dict(LM, qkv_bias=True)
    jm = _seeded(lambda: JaxLM(JaxLlamaConfig(**cfg)))
    tm = _carry(jm, LlamaForCausalLM(LlamaConfig(**cfg)))
    if order == "quantize_then_cast":
        jax_quantize_model(jm, group_size=16, bits=8)
        quantize_model(tm, group_size=16, bits=8)
        jm, tm = _bf16_jax(jm), tm.to(BF16)
    else:
        jm, tm = _bf16_jax(jm), tm.to(BF16)
        jax_quantize_model(jm, group_size=16, bits=8)
        quantize_model(tm, group_size=16, bits=8)
    named = {k: np.asarray(v) for k, v in named_arrays(jm)}
    state = tm.state_dict()
    crossed = params_from_jax(named, tm)
    scales = named["model.layers.0.self_attn.q_proj.scales"]
    assert scales.dtype == (jnp.bfloat16 if order == "quantize_then_cast" else np.float32)
    assert named["model.layers.0.self_attn.q_proj.bias"].dtype == jnp.bfloat16
    for k, v in named.items():
        for got in (state[k], crossed[k]):
            assert str(got.dtype).removeprefix("torch.") == str(v.dtype), k
            if v.dtype == jnp.bfloat16:
                np.testing.assert_array_equal(got.view(torch.uint16).numpy(),
                                              v.view(np.uint16), err_msg=k)
            else:
                np.testing.assert_array_equal(got.numpy(), v, err_msg=k)


# ---------------------------------------------------------------------------
# CSM
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def csm():
    from test_torch_sesame import _jax_model, _port_model

    jm = _jax_model(True)
    port = _port_model(jm, True)
    jm.cast_lm(jnp.bfloat16)
    port.cast_lm(BF16)
    return jm, port


def test_csm_cast_lm_casts_the_lm_but_rope_mimi_and_codes(csm):
    jm, port = csm
    named = {k: np.asarray(v) for k, v in named_arrays(jm)}
    for k, t in port.state_dict().items():
        assert str(t.dtype).removeprefix("torch.") == str(named[k].dtype), k
        if k.startswith("model.") and t.is_floating_point():
            assert t.dtype == (torch.float32 if "rope_" in k else BF16), k
        elif t.is_floating_point():
            assert t.dtype == torch.float32, k   # Mimi
    assert port.model.lm_dtype() == BF16


def test_csm_bf16_greedy_frames_match_jax_and_spec_decode(csm):
    """Greedy frames after cast_lm(bf16) equal the JAX package's; spec decode
    (the draft packed from float32 upcasts, fed float32 caches; verify and
    finishing steps in bf16) gives the plain frames; the audio decodes
    through float32 Mimi."""
    from test_torch_sesame import MAX_MS, _port_frames, _ref_audio

    jm, port = csm
    ref_audio = _ref_audio()
    toks, mask = jm._tokenize_segment(
        JaxSegment(0, "reference text hello", ref_audio), add_eos=False)
    ref = np.stack([f for part in jm._generate_frame_chunks(
        toks.astype(np.int32), mask, MAX_MS // 80, 32, 0.0, 0,
        jax.random.PRNGKey(0)) for f in part])
    frames = _port_frames(port, "hello", ref_audio)
    np.testing.assert_array_equal(frames, ref)
    port.model.enable_spec_decode()
    port.model.spec_stats[:] = [0, 0]
    try:
        assert port.model._spec_packed.wqkv.dtype == torch.int8
        spec = _port_frames(port, "hello", ref_audio)
        assert port.model.spec_stats[1] > 0
    finally:
        port.model.spec_decode = False
    np.testing.assert_array_equal(spec, frames)
    (result,) = list(port.generate("hello", ref_audio=ref_audio, ref_text="reference text",
                                   max_audio_length_ms=MAX_MS, temperature=0.0))
    assert result.audio.dtype == np.float32 and np.isfinite(result.audio).all()
    assert result.token_count == len(frames)


def test_csm_bf16_generate_batch(csm):
    """The twin of tests/test_sesame.py's bf16 generate_batch test."""
    _, port = csm
    results = port.generate_batch(["x"], ref_audio=np.zeros(1920, dtype=np.float32),
                                  ref_text="r", max_audio_length_ms=400, seed=5)
    assert len(results) == 1 and np.isfinite(results[0].audio).all()
    assert results[0].samples == 1920 * results[0].token_count


# ---------------------------------------------------------------------------
# the causal-LM loop and Orpheus
# ---------------------------------------------------------------------------


def test_generate_tokens_batch_bf16_and_stops():
    """The twin of tests/test_orpheus.py's bf16 test: a bf16 LM, sampled,
    every row within the budget and without its stop token."""
    cfg = dict(num_hidden_layers=1, num_attention_heads=2, num_key_value_heads=2,
               head_dim=8, hidden_size=16, intermediate_size=32, rms_norm_eps=1e-5,
               vocab_size=32, max_position_embeddings=256, tie_word_embeddings=True)
    jm = _seeded(lambda: JaxLM(JaxLlamaConfig(**cfg)))
    lm = _carry(jm, LlamaForCausalLM(LlamaConfig(**cfg))).to(BF16)
    assert lm.model.rope_cos.dtype == BF16   # .to casts the tables, as astype does
    outs = generate_tokens_batch(lm, [np.arange(4), np.arange(6)], max_tokens=20,
                                 temperature=0.9, top_k=8, stop_tokens=(7,), chunk=8,
                                 seed=2)
    assert len(outs) == 2
    for o in outs:
        assert len(o) <= 20 and 7 not in o.tolist()


def test_quantized_bf16_lm_greedy_matches_jax(monkeypatch):
    """Orpheus's LM, int8 in bf16 (the causal-LM loop every family but CSM
    and Voxtral decodes with), at penalty 1.3: greedy tokens held
    teacher-forced to JAX's.  On the CPU no call reaches the kernel wrapper
    (JAX's CPU route: bf16 dequantize and matmul)."""
    from test_torch_orpheus import EMBED_SCALE, PROMPTS

    jm = _seeded(lambda: JaxLM(JaxLlamaConfig(**LM)))
    jm.model.embed_tokens.weight = jm.model.embed_tokens.weight * EMBED_SCALE
    tm = _carry(jm, LlamaForCausalLM(LlamaConfig(**LM)))
    jax_quantize_model(jm, group_size=16, bits=8)
    quantize_model(tm, group_size=16, bits=8)
    jm, tm = _bf16_jax(jm), tm.to(BF16)
    seen = _record_tokens(monkeypatch, [(jax_causal, "jax"), (causal, "port")])
    monkeypatch.setattr(kernels, "quantized_matmul", None)
    kw = dict(max_tokens=32, temperature=0.0, repetition_penalty=1.3,
              repetition_context_size=8, chunk=16)
    for mod, lm in ((jax_causal, jm), (causal, tm)):
        list(mod.generate_tokens(lm, PROMPTS[1], **kw))
    _check_runs(jm, tm, seen, penalty=1.3, context=8)


# ---------------------------------------------------------------------------
# OuteTTS, Spark and Voxtral
# ---------------------------------------------------------------------------


def test_outetts_bf16_generate_matches_jax(monkeypatch):
    """OuteTTS int8 in bf16, the 24 kHz DAC too: greedy tokens (penalty 1.3,
    64 tokens of context) held teacher-forced to JAX's; the port's audio
    float32 and finite.  (JAX's bf16 DAC decode is not run: its codes are
    the tokens held here.)"""
    import mlx_audio_tpu.models.tts.outetts.outetts as jax_outetts
    from mlx_audio_tpu_torch.models.tts import outetts
    from test_torch_outetts import _pair

    jm, tm = _pair(bits=8)
    jm, tm = _bf16_jax(jm), tm.to(BF16)
    assert next(tm.audio_processor.audio_codec.model.parameters()).dtype == BF16
    monkeypatch.setattr(jm.audio_processor.audio_codec, "decode",
                        lambda codes: np.zeros((1, 1, 8), np.float32))
    seen = _record_tokens(monkeypatch, [(jax_outetts, "jax"), (outetts.outetts, "port")])
    kw = dict(max_tokens=40, temperature=0.0, repetition_penalty=1.3,
              repetition_context_size=64)
    list(jm.generate("hi there", **kw))
    got = list(tm.generate("hi there", **kw))
    _check_runs(jm.lm, tm.lm, seen, penalty=1.3, context=64)
    assert got and all(g.audio.dtype == np.float32 and np.isfinite(g.audio).all()
                       and g.audio.size for g in got)


def test_spark_bf16_generate_matches_jax(monkeypatch):
    """Spark int8 in bf16, BiCodec and wav2vec2 too: greedy tokens held
    teacher-forced to JAX's in control mode, and in clone mode, where the
    JAX package's feature mix raises and the port's three-layer mix stands
    in for it, as tests/test_torch_spark.py does; the audio float32 and
    finite."""
    import mlx_audio_tpu.models.tts.spark.audio_tokenizer as jax_tokenizer
    import mlx_audio_tpu.models.tts.spark.spark as jax_spark
    import test_torch_spark as ts
    from mlx_audio_tpu_torch.models.tts.spark import spark as port_spark

    @jax.jit
    def mix(model, wavs):
        _, _, hidden = model(wavs, output_hidden_states=True)
        return (hidden[11] + hidden[14] + hidden[16]) / 3

    monkeypatch.setattr(jax_tokenizer, "_w2v_features_jit", mix)
    jm, pm = ts.models.__wrapped__()
    jax_quantize_model(jm.lm, group_size=16, bits=8)
    quantize_model(pm.lm, group_size=16, bits=8)
    jm, pm = _bf16_jax(jm), pm.to(BF16)
    seen = _record_tokens(monkeypatch, [(jax_spark, "jax"), (port_spark, "port")])
    control = dict(gender="female", pitch=1.5, speed=0.5)
    clone = dict(ref_audio=ts._ref_audio(), ref_text="a reference")
    for mode in (control, clone):
        kw = dict(temperature=0.0, max_tokens=8, **mode)
        list(jm.generate("hello world", **kw))
        got = list(pm.generate("hello world", **kw))
        assert len(got) == 1 and got[0].audio.dtype == np.float32
        assert np.isfinite(got[0].audio).all()
    assert len(_check_runs(jm.lm, pm.lm, seen, penalty=1.3)) == 2


def test_voxtral_bf16_transcribe_matches_jax():
    """Voxtral in bf16, its LM and untied head int8 (under which the greedy
    tokens vary): the float32 log-mel promotes through the bf16 audio tower
    and the prompt's float32 audio embeddings through the prefill, as
    jnp.where and the JAX package's einsums promote them; the decode steps
    run bf16 over a bf16 cache.  Greedy tokens held teacher-forced to JAX's
    (the full forward of the prompt and JAX's tokens, float32 as JAX's
    prefill is)."""
    from test_torch_voxtral import TEXT, _audio, pair_of

    jm, pm = pair_of(text=dict(TEXT, tie_word_embeddings=False))
    lm_only = dict(group_size=16, bits=8, quant_predicate=lambda p, m, c: p.startswith(
        ("language_model", "lm_head")))
    jax_quantize_model(jm, **lm_only)
    quantize_model(pm, **lm_only)
    jm, pm = _bf16_jax(jm), pm.to(BF16)
    audio = _audio(1, 1.0)
    kw = dict(temperature=0.0, eos_token_ids=(2,), max_tokens=12)
    jt = list(jm.generate(audio, **kw).segments[0]["tokens"])
    pt = list(pm.generate(audio, **kw).segments[0]["tokens"])
    mel, ids = pm._prepare_inputs(audio)
    full = np.concatenate([np.asarray(ids), np.asarray(jt[:-1], np.int64)])[None]
    n = len(ids) - 1

    @jax.jit
    def jax_logits(m, ids, mel):
        return m.lm_logits(m.language_model(m.merge_input_embeddings(ids, mel))).astype(
            jnp.float32)

    jl = np.asarray(jax_logits(jm, jnp.asarray(full, jnp.int32),
                               jnp.asarray(np.asarray(mel), jnp.float32)[None]))[0, n:]
    with torch.no_grad():
        h = pm.language_model(pm.merge_input_embeddings(torch.as_tensor(full), mel[None]))
        tl = pm.lm_logits(h).float().numpy()[0, n:]
    teacher_forced(jl, tl, jt, pt)
