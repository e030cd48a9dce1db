"""CSM (Sesame) in the port against the JAX package, at the tiny config of
tests/test_sesame.py, float32 on the CPU.

Weights cross with ``convert.params_from_jax``.  Greedy frames are held
equal to the JAX package's, dense and after ``quantize_model(bits=8,
group_size=16)``; the watermarked audio to atol 1e-4 (Mimi's float32 sums
in another order, observed below 1e-5).  The speculative depth decode is
held to the plain decode's greedy frames, and a batch row to a batch-1
decode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_audio_tpu.models.tts.sesame.model import Model as JaxModel
from mlx_audio_tpu.models.tts.sesame.model import Segment as JaxSegment
from mlx_audio_tpu.nn.module import named_arrays
from mlx_audio_tpu.nn.quantize import quantize_model as jax_quantize_model
from mlx_audio_tpu_torch.codec.mimi import Mimi
from mlx_audio_tpu_torch.convert import params_from_jax
from mlx_audio_tpu_torch.models.tts.sesame import Model, Segment, sanitize
from mlx_audio_tpu_torch.models.tts.sesame.model import _prompt_bucket
from mlx_audio_tpu_torch.nn.quantize import QuantizedLinear, quantize_model
from test_mimi import tiny_mimi
from test_sesame import FakeTokenizer, tiny_config
from test_torch_mimi import port_config

AUDIO_ATOL = 1e-4
MAX_MS = 640  # 8 frames


def _jax_model(quant: bool):
    m = JaxModel(tiny_config(), mimi=tiny_mimi(nq=4), text_tokenizer=FakeTokenizer())
    m = m.tree_replace(model=m.model.tree_replace(audio_head=jnp.asarray(
        np.random.default_rng(0).standard_normal(m.model.audio_head.shape) * 0.1,
        dtype=jnp.float32)))
    if quant:
        jax_quantize_model(m.model, group_size=16, bits=8)
    return m


def _port_model(jm, quant: bool):
    port = Model(tiny_config(), mimi=Mimi(port_config(jm.mimi.cfg)),
                 text_tokenizer=FakeTokenizer(), device="cpu")
    if quant:
        quantize_model(port.model, group_size=16, bits=8)
    port.load_state_dict(params_from_jax(
        {k: np.asarray(v) for k, v in named_arrays(jm)}, port), strict=True)
    return port


@pytest.fixture(scope="module", params=["dense", "int8_g16"])
def pair(request):
    quant = request.param == "int8_g16"
    jm = _jax_model(quant)
    return jm, _port_model(jm, quant)


def _ref_audio(seed=0, frames=3):
    return (np.random.default_rng(seed).standard_normal(1920 * frames) * 0.1
            ).astype(np.float32)


def _port_frames(port, text, ref, temp=0.0, top_k=0):
    prompt = port._prompt(text, [Segment(0, "reference text", ref)], 0, True)
    port.generator.manual_seed(0)
    return np.stack(port._generate_frames(prompt, MAX_MS // 80, 32, temp, top_k))


def test_bridge_round_trip(pair):
    """Every array of the JAX model, uint8 codes included, loads strictly
    and comes back unchanged in layout and dtype."""
    jm, port = pair
    state = port.state_dict()
    for k, v in named_arrays(jm):
        got = state[k].numpy()
        ref = np.asarray(v)
        if k.endswith(".weight") and got.ndim == 3:   # Mimi convs: torch layout
            continue
        assert got.dtype == ref.dtype, k
        np.testing.assert_array_equal(got, ref, err_msg=k)
    assert len(state) == len(list(named_arrays(jm)))


def test_greedy_frames_and_audio_match_jax(pair):
    jm, port = pair
    ref_audio = _ref_audio()
    toks, mask = jm._tokenize_segment(
        JaxSegment(0, "reference text hello", ref_audio), add_eos=False)
    ref_frames = np.stack([f for part in jm._generate_frame_chunks(
        toks.astype(np.int32), mask, MAX_MS // 80, 32, 0.0, 0,
        jax.random.PRNGKey(0)) for f in part])
    frames = _port_frames(port, "hello", ref_audio)
    np.testing.assert_array_equal(frames, ref_frames)

    kw = dict(ref_audio=ref_audio, ref_text="reference text",
              max_audio_length_ms=MAX_MS, temperature=0.0)
    (ref,) = list(jm.generate("hello", **kw))
    (got,) = list(port.generate("hello", **kw))
    assert got.token_count == ref.token_count == len(frames)
    assert got.samples == ref.samples == 1920 * len(frames)
    np.testing.assert_allclose(got.audio, np.asarray(ref.audio), atol=AUDIO_ATOL,
                               rtol=0)


def test_spec_decode_greedy_frames_equal_plain(pair):
    port = pair[1]
    ref = _ref_audio(1)
    plain = _port_frames(port, "hello world", ref)
    port.model.enable_spec_decode()
    try:
        spec = _port_frames(port, "hello world", ref)
        assert port.model.spec_stats[1] > 0
    finally:
        port.model.spec_decode = False
    np.testing.assert_array_equal(spec, plain)


def test_spec_decode_sampled_runs(pair):
    port = pair[1]
    port.model.enable_spec_decode()
    try:
        out = list(port.generate("hey", ref_audio=_ref_audio(2, 1), ref_text="yo",
                                 max_audio_length_ms=480, temperature=0.9,
                                 top_k=10, seed=2))
    finally:
        port.model.spec_decode = False
    assert out and all(np.isfinite(r.audio).all() for r in out)
    assert all(r.samples == 1920 * r.token_count for r in out)


def test_generate_batch_row_equals_generate():
    jm = _jax_model(False)
    port = _port_model(jm, False)
    kw = dict(ref_audio=_ref_audio(3, 2), ref_text="ref",
              max_audio_length_ms=MAX_MS, temperature=0.0)
    batch = port.generate_batch(["hello", "a longer second prompt"], **kw)
    (single,) = list(port.generate("hello", **kw))
    assert len(batch) == 2
    assert batch[0].token_count == single.token_count
    np.testing.assert_allclose(batch[0].audio, single.audio, atol=AUDIO_ATOL, rtol=0)
    for r in batch:
        assert r.samples == 1920 * r.token_count and np.isfinite(r.audio).all()


def test_watermark_round_trip_and_match():
    from mlx_audio_tpu.models.tts.sesame import watermarking as jwm
    from mlx_audio_tpu_torch.models.tts.sesame import watermarking as twm

    clean = (np.random.default_rng(0).standard_normal(24000 * 3) * 0.1
             ).astype(np.float32)
    wm = twm.load_watermarker()
    marked = twm.watermark(wm, clean, 24000, twm.CSM_1B_GH_WATERMARK)
    np.testing.assert_allclose(
        marked, jwm.watermark(jwm.Watermarker(), clean, 24000,
                              jwm.CSM_1B_GH_WATERMARK), atol=1e-6, rtol=0)
    assert twm.verify(wm, marked, 24000, twm.CSM_1B_GH_WATERMARK)
    assert not twm.verify(wm, clean, 24000, twm.CSM_1B_GH_WATERMARK)
    assert not twm.verify(wm, marked, 24000, [1, 2, 3, 4, 5])


def test_prompt_bucket_and_sanitize():
    assert [_prompt_bucket(n) for n in (10, 65, 256, 300)] == [64, 128, 256, 384]
    out = sanitize({
        "backbone.layers.0.attn.q_proj.weight": np.zeros((4, 4)),
        "backbone.layers.0.attn.output_proj.weight": np.zeros((4, 4)),
        "backbone.layers.0.mlp.w1.weight": np.zeros((4, 4)),
        "backbone.layers.0.sa_norm.scale": np.zeros((4,)),
        "backbone.norm.scale": np.zeros((4,)),
    })
    assert sorted(out) == sorted([
        "model.backbone.layers.0.self_attn.q_proj.weight",
        "model.backbone.layers.0.self_attn.o_proj.weight",
        "model.backbone.layers.0.mlp.gate_proj.weight",
        "model.backbone.layers.0.input_layernorm.weight",
        "model.backbone.norm.weight"])


def test_quantized_model_reaches_the_kernel_wrapper(monkeypatch):
    from mlx_audio_tpu_torch.nn import kernels

    port = _port_model(_jax_model(False), False)
    quantize_model(port.model, group_size=16, bits=8)
    assert isinstance(port.model.backbone.layers[0].mlp.down_proj, QuantizedLinear)
    calls = []
    real = kernels.quantized_matmul
    monkeypatch.setattr(kernels, "quantized_matmul",
                        lambda *a: calls.append(1) or real(*a))
    _port_frames(port, "hi", _ref_audio(4, 1))
    assert calls


def test_model_runs_on_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(tiny_config(), text_tokenizer=FakeTokenizer())


def _recorded_stream(port, **kw):
    """Streamed results, and the frames each chunk handed to Mimi."""
    seen = []
    decode = port.mimi.decode_frames_stateful

    def recording(codes, state):
        seen.append(codes[0].T.numpy().copy())
        return decode(codes, state)

    port.mimi.decode_frames_stateful = recording
    try:
        results = list(port.generate("hello", stream=True, **kw))
    finally:
        port.mimi.decode_frames_stateful = decode
    frames = np.concatenate([f[:r.token_count] for f, r in zip(seen, results)])
    return results, frames


def test_streamed_greedy_frames_and_chunks_match_jax():
    """Greedy streaming: the port's chunk sizes equal the JAX package's
    generate(stream=True), its frames the JAX frames, and its audio the JAX
    streamed audio."""
    jm = _jax_model(False)
    port = _port_model(jm, False)
    ref_audio = _ref_audio(5)
    kw = dict(ref_audio=ref_audio, ref_text="reference text",
              max_audio_length_ms=1200, temperature=0.0)
    ref = list(jm.generate("hello", stream=True, **kw))
    got, frames = _recorded_stream(port, **kw)
    assert [r.token_count for r in got] == [r.token_count for r in ref]
    assert got[0].token_count == 3 and len(got) > 2 and got[1].token_count == 4
    toks, mask = jm._tokenize_segment(
        JaxSegment(0, "reference text hello", ref_audio), add_eos=False)
    ref_frames = np.stack([f for part in jm._generate_frame_chunks(
        toks.astype(np.int32), mask, 1200 // 80, 32, 0.0, 0,
        jax.random.PRNGKey(0)) for f in part])
    np.testing.assert_array_equal(frames, ref_frames)
    np.testing.assert_allclose(np.concatenate([r.audio for r in got]),
                               np.concatenate([np.asarray(r.audio) for r in ref]),
                               atol=1e-3, rtol=0)


def test_streamed_sampled_audio_equals_non_streamed(pair):
    """At temperature 0.9 the streamed chunks concatenate to the
    non-streaming audio: the same frames in the same draw order, decoded
    through the carried Mimi state."""
    port = pair[1]
    kw = dict(ref_audio=_ref_audio(6), ref_text="ref", max_audio_length_ms=1200,
              temperature=0.9, top_k=10, seed=4)
    streamed = list(port.generate("hi there", stream=True, streaming_interval=0.24, **kw))
    (whole,) = list(port.generate("hi there", **kw))
    assert sum(r.token_count for r in streamed) == whole.token_count
    assert all(r.samples == 1920 * r.token_count for r in streamed)
    np.testing.assert_allclose(np.concatenate([r.audio for r in streamed]), whole.audio,
                               atol=1e-3, rtol=0)


def test_spec_decode_streams_the_plain_greedy_frames(pair):
    port = pair[1]
    kw = dict(ref_audio=_ref_audio(7), ref_text="ref", max_audio_length_ms=800,
              temperature=0.0)
    _, plain = _recorded_stream(port, **kw)
    port.model.enable_spec_decode()
    try:
        _, spec = _recorded_stream(port, **kw)
    finally:
        port.model.spec_decode = False
    np.testing.assert_array_equal(spec, plain)
