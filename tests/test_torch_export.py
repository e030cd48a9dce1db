"""Exported programs of the port (mlx_audio_tpu_torch/export.py) against
the JAX package's live programs: the port twin of tests/test_export.py, at
its tiny configs, float32 on the CPU.

Each program is exported with ``torch.export``, saved, loaded back with
``load_program`` and held to the JAX package's live jitted closure on the
same weights (``convert.params_from_jax``) and inputs: Kokoro with the JAX
source draws, past ``HEAD`` within ``AUDIO_ATOL`` and durations equal;
CSM, causal-LM and Whisper greedy tokens and frames equal; Mimi within
1e-5 and its stream within 1e-4 of the batch decode.  Beyond the twins:
the graphs hold the kernels' custom-op nodes, one a kernel call of the
live run (the wrappers counted), the loaded programs equal the live port
bit for bit, the sampled session replays the same noise and not fresh
noise, and a subprocess loads an artifact with no JAX, no JAX package and
no port model module imported.  The custom ops themselves are checked
with ``torch.library.opcheck`` against their plain versions.
"""

import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mlx_audio_tpu.export as jexport
import mlx_audio_tpu.nn.layers as jax_layers
from mlx_audio_tpu.models.lm.causal import LlamaForCausalLM as JaxLM
from mlx_audio_tpu.models.lm.causal import generate_tokens_batch as jax_generate_tokens_batch
from mlx_audio_tpu.models.lm.llama import LlamaConfig as JaxLlamaConfig
from mlx_audio_tpu.models.tts.kokoro.model import Model as JaxKokoro
from mlx_audio_tpu.nn.module import named_arrays
from mlx_audio_tpu_torch import export, ops
from mlx_audio_tpu_torch.codec.mimi import Mimi
from mlx_audio_tpu_torch.convert import params_from_jax
from mlx_audio_tpu_torch.models.lm.causal import LlamaForCausalLM, generate_tokens_batch
from mlx_audio_tpu_torch.models.lm.llama import LlamaConfig
from mlx_audio_tpu_torch.models.sampling import gumbel
from mlx_audio_tpu_torch.models.tts.kokoro import Model as Kokoro
from mlx_audio_tpu_torch.nn import kernels
from mlx_audio_tpu_torch.nn import pallas_depth as tpd
from test_kokoro import tiny_config as kokoro_tiny_config
from test_mimi import tiny_mimi
from test_torch_kokoro import AUDIO_ATOL, HEAD, _port_config, _source_draws
from test_torch_mimi import port_config

ROOT = Path(__file__).resolve().parents[1]
LM = dict(num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=2,
          head_dim=8, hidden_size=16, intermediate_size=32, rms_norm_eps=1e-5,
          vocab_size=64, max_position_embeddings=256, tie_word_embeddings=True)
EMBED_SCALE = 0.05  # at the JAX init a tied tiny LM repeats one token


def _seeded(build):
    """Build a JAX model from the init RNG seeded 0: module fixtures run
    before conftest's per-test reseed."""
    saved = jax_layers._INIT_RNG
    jax_layers._INIT_RNG = np.random.default_rng(0)
    try:
        return build()
    finally:
        jax_layers._INIT_RNG = saved


def _carry(jax_module, port_module):
    named = {k: np.asarray(v) for k, v in named_arrays(jax_module)}
    port_module.load_state_dict(params_from_jax(named, port_module), strict=True)
    return port_module


@pytest.fixture
def calls(monkeypatch):
    """``calls()`` starts counting the kernel wrappers' calls (the plain
    versions run on the CPU) and returns the counts: a loaded program's op
    nodes call the wrappers too.  Started after the exports, whose traces
    call the ops."""
    counts = dict.fromkeys(ops.OPS, 0)

    def start():
        for name in ops.OPS:
            fn = getattr(kernels, name)

            def counted(*a, _name=name, _fn=fn, **kw):
                counts[_name] += 1
                return _fn(*a, **kw)

            monkeypatch.setattr(kernels, name, counted)
        return counts

    return start


def _load_graph(path):
    with open(path, "rb") as f:
        return torch.export.load(f)


def _used(counts):
    return {k: v for k, v in counts.items() if v}


# ---------------------------------------------------------------------------
# Kokoro
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def kokoros():
    jm = _seeded(lambda: JaxKokoro(kokoro_tiny_config()))
    return jm, _carry(jm, Kokoro(_port_config(), device="cpu"))


def _kokoro_args(b, p_bucket, f_bucket, key):
    ids = np.zeros((b, p_bucket), np.int64)
    ids[0, :5] = [0, 4, 9, 2, 0]
    if b > 1:
        ids[1, :8] = [0, 7, 7, 3, 5, 1, 2, 0]
    lengths = np.array([5, 8][:b])
    ref = (np.random.default_rng(0).standard_normal((b, 256)) * 0.1).astype(np.float32)
    rand_ini, noise = _source_draws(key, b, f_bucket)
    port = (torch.as_tensor(ids), torch.as_tensor(lengths), torch.as_tensor(ref),
            torch.ones(b), rand_ini, noise)
    jax_args = (jnp.asarray(ids, jnp.int32), jnp.asarray(lengths, jnp.int32),
                jnp.asarray(ref), jnp.ones((b,), jnp.float32), key)
    return port, jax_args


P_BUCKET, F_BUCKET = 64, 100


@pytest.fixture(scope="module")
def kokoro_artifact(kokoros, tmp_path_factory):
    """The port's Kokoro written as a native checkpoint and exported from
    it by the CLI (``python -m mlx_audio_tpu_torch.export``) on the CPU."""
    from mlx_audio_tpu_torch.utils.loader import save_checkpoint
    from test_torch_loader_cli import kokoro_config_dict

    root = tmp_path_factory.mktemp("kokoro")
    save_checkpoint(kokoros[1], root / "Kokoro-82M", kokoro_config_dict(kokoro_tiny_config()))
    path = root / "kokoro.pt2"
    export.main(["--model", str(root / "Kokoro-82M"), "--out", str(path), "--kind", "kokoro",
                 "--batch", "2", "--phoneme-bucket", str(P_BUCKET), "--frame-bucket",
                 str(F_BUCKET), "--device", "cpu"])
    assert path.stat().st_size > 1000
    return path


def test_kokoro_export_roundtrip(kokoros, kokoro_artifact, calls):
    """The exported synthesis against the JAX package's live jitted
    closure (durations equal, audio past HEAD within AUDIO_ATOL), and
    against the live port bit for bit, its graph holding one op node a
    kernel call of the live run, and calling them as often."""
    jm, pm = kokoros
    args, jax_args = _kokoro_args(2, P_BUCKET, F_BUCKET, jax.random.PRNGKey(3))
    live_audio, live_dur = jax.jit(jexport.kokoro_synthesis_fn(jm, F_BUCKET))(*jax_args)
    program = export.load_program(kokoro_artifact)
    calls = calls()
    port_audio, port_dur = export.kokoro_synthesis_fn(pm, F_BUCKET)(*args)
    live_calls = _used(calls)
    calls.update(dict.fromkeys(calls, 0))
    got_audio, got_dur = program(*args)

    np.testing.assert_array_equal(got_dur.numpy(), np.asarray(live_dur))
    np.testing.assert_allclose(got_audio.numpy()[:, HEAD:],
                               np.asarray(live_audio)[:, HEAD:], atol=AUDIO_ATOL, rtol=0)
    assert torch.equal(got_audio, port_audio) and torch.equal(got_dur, port_dur)
    assert live_calls["lstm"] > 0 and _used(calls) == live_calls
    assert _used(ops.graph_ops(program)) == live_calls


def _kokoro_loader_script(path, b, p_bucket, f_bucket):
    return f"""
import sys
import torch
from mlx_audio_tpu_torch.export import load_program
synth = load_program(r"{path}")
out = synth(torch.zeros(({b}, {p_bucket}), dtype=torch.int64),
            torch.ones(({b},), dtype=torch.int64), torch.zeros(({b}, 256)),
            torch.ones(({b},)), torch.zeros(({b}, 9)),
            torch.zeros(({b}, {600 * f_bucket}, 9)))
assert out[0].shape == ({b}, {600 * f_bucket}) and torch.isfinite(out[0]).all()
banned = [m for m in sys.modules if m.split(".")[0] in ("jax", "mlx_audio_tpu")
          or m.startswith(("mlx_audio_tpu_torch.models", "mlx_audio_tpu_torch.codec",
                           "mlx_audio_tpu_torch.tts", "mlx_audio_tpu_torch.stt",
                           "mlx_audio_tpu_torch.sts", "mlx_audio_tpu_torch.parallel"))]
assert not banned, banned
print("ok", tuple(out[0].shape))
"""


def test_export_artifact_needs_no_model_code(kokoro_artifact, tmp_path):
    """Loading and calling an artifact imports no JAX, nothing of the JAX
    package and no port model module (checked in a clean subprocess that
    imports the export module's loader, which imports only the ops)."""
    env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"), "PYTHONPATH": str(ROOT),
           "OMP_NUM_THREADS": "2", "HOME": str(tmp_path)}
    script = _kokoro_loader_script(kokoro_artifact, 2, P_BUCKET, F_BUCKET)
    r = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                       timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "ok" in r.stdout


# ---------------------------------------------------------------------------
# Mimi
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mimis():
    jm = _seeded(lambda: tiny_mimi(nq=4))
    return jm, _carry(jm, Mimi(port_config(jm.cfg)))


def test_mimi_export_roundtrip(mimis, tmp_path):
    jm, pm = mimis
    path = tmp_path / "mimi.pt2"
    export.export_mimi_decode(pm, path, batch=1, frames=7, device="cpu")
    codes = np.random.default_rng(1).integers(0, 17, size=(1, 4, 7))
    live = np.asarray(jm.decode(jnp.asarray(codes, jnp.int32)))
    got = export.load_program(path)(torch.as_tensor(codes))
    np.testing.assert_allclose(got.numpy(), live, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, pm.decode(torch.as_tensor(codes)))


def _init_state_from_meta(meta):
    out = []
    for s, d, v in zip(meta["state_shapes"], meta["state_dtypes"], meta["state_init"]):
        dtype = getattr(torch, d)
        out.append(torch.zeros(s, dtype=dtype) if v == "zeros"
                   else torch.full(s, v, dtype=dtype))
    return out


def test_mimi_stream_export_seamless(mimis, tmp_path):
    """Chunked decode through the exported STATEFUL program equals the
    JAX batch decode of the same codes (the MimiStreamingDecoder
    guarantee), and the port's own frame-by-frame decode bit for bit; the
    state crosses as the meta describes it (offsets 0, flags True)."""
    jm, pm = mimis
    path = tmp_path / "mimi_stream.pt2"
    info = export.export_mimi_stream_decode(pm, path, batch=1, chunk_frames=3,
                                            device="cpu")
    assert info["bytes"] > 1000
    meta = json.load(open(f"{path}.meta.json"))
    assert meta["device"] == "cpu"
    assert True in meta["state_init"] and 0 in meta["state_init"]

    codes = np.random.default_rng(2).integers(0, 17, size=(1, 4, 9))
    batch_audio = np.asarray(jm.decode(jnp.asarray(codes, jnp.int32)))
    step = export.load_program(path)
    state = _init_state_from_meta(meta)
    chunks = []
    for i in range(3):
        out = step(torch.as_tensor(codes[:, :, 3 * i:3 * i + 3]), *state)
        chunks.append(out[0])
        state = list(out[1:])
    stream = torch.cat(chunks, dim=-1)
    assert stream.shape == batch_audio.shape
    np.testing.assert_allclose(stream.numpy(), batch_audio, atol=1e-4)
    assert torch.equal(stream, pm.decode_frames(torch.as_tensor(codes)))


# ---------------------------------------------------------------------------
# CSM session
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def csms():
    from test_torch_sesame import _jax_model, _port_model

    jm = _seeded(lambda: _jax_model(quant=True))
    return jm, _port_model(jm, quant=True)


PAD = 10  # the prompt's 6 text tokens, left-padded to the 16 bucket


def _csm_prompt(nc, bucket=16):
    rng = np.random.default_rng(0)
    tokens = np.zeros((1, bucket, nc + 1), np.int64)
    mask = np.zeros((1, bucket, nc + 1), bool)
    tokens[0, PAD:, -1] = rng.integers(3, 100, size=bucket - PAD)
    mask[0, PAD:, -1] = True
    return tokens, mask


def _session_state(meta):
    return [torch.zeros(s, dtype=getattr(torch, d))
            for s, d in zip(meta["cache_shapes"], meta["cache_dtypes"])]


def _run_csm(artifact, tokens, mask):
    _, meta, (prefill, chunk) = artifact
    nc, n = meta["audio_num_codebooks"], meta["chunk_frames"]
    pad_len = torch.tensor([PAD])
    pre = prefill(torch.as_tensor(tokens), torch.as_tensor(mask), pad_len,
                  torch.zeros(meta["noise_shapes"]["prefill"]), *_session_state(meta))
    ch = chunk(
        pre[0], pad_len,
        torch.zeros(meta["noise_shapes"]["chunk"]), *pre[1:])
    assert ch[0].shape == (n, 1, nc)
    return pre[0], ch[0]


@pytest.fixture(scope="module")
def csm_artifact(csms, tmp_path_factory):
    """The int8 CSM session with spec decode on (batch 1, greedy), as on
    CSM-1B's main path: (prefix, meta, the loaded prefill and chunk)."""
    lm = csms[1].model
    lm.enable_spec_decode()
    prefix = str(tmp_path_factory.mktemp("csm") / "csm")
    export.export_csm_session(lm, prefix, prompt_bucket=16, max_frames=8,
                              chunk_frames=3, temp=0.0, device="cpu")
    programs = [export.load_program(f"{prefix}.{kind}") for kind in ("prefill", "chunk")]
    return prefix, json.load(open(f"{prefix}.meta.json")), programs


def test_csm_session_export_roundtrip(csms, csm_artifact):
    """Exported int8 prefill and chunk programs emit the exact frames of
    the JAX package's live jitted session (greedy; the spec decode's
    frames are the plain decode's), caches crossing as flat tensors."""
    jm, _ = csms
    _, meta, _ = csm_artifact
    assert meta["cache_shapes"] and meta["audio_num_codebooks"] == 4
    assert meta["spec_decode"] and "FRESH" in meta["rng"]
    tokens, mask = _csm_prompt(4)

    prefill, chunk = jexport.csm_session_fns(jm.model, temp=0.0, top_k=50)
    jcaches = jm.model.backbone.init_cache(1, max_len=24, dtype=jm.model.lm_dtype())
    key = jax.random.PRNGKey(9)
    pad_len = jnp.asarray([PAD], jnp.int32)
    ref_pre = jax.jit(prefill)(jnp.asarray(tokens, jnp.int32), jnp.asarray(mask),
                               pad_len, key, *jexport._flat_caches(jcaches))
    ref_ch = jax.jit(functools.partial(chunk, n=3))(ref_pre[0], pad_len, key,
                                                    *ref_pre[1:])
    first, frames = _run_csm(csm_artifact, tokens, mask)
    np.testing.assert_array_equal(first.numpy(), np.asarray(ref_pre[0]))
    np.testing.assert_array_equal(frames.numpy(), np.asarray(ref_ch[0]))


def test_csm_spec_session_export_matches_live(csms, csm_artifact, calls):
    """The spec chunk program holds one depth_draft node (a while_loop
    finishes the rejected tail) and the projections' quantized_matmul
    nodes; its frames equal the live port's spec decode bit for bit, with
    as many kernel calls."""
    _, pm = csms
    lm = pm.model
    tokens, mask = _csm_prompt(4)
    graph = ops.graph_ops(csm_artifact[2][1])
    assert graph["depth_draft"] == 1 and graph["quantized_matmul"] > 0

    calls = calls()
    first, frames = _run_csm(csm_artifact, tokens, mask)
    exported = dict(calls)
    calls.update(dict.fromkeys(calls, 0))
    caches, pad_len, last_h = pm._prefill([(tokens[0, PAD:], mask[0, PAD:])], 8,
                                          bucket=16)
    live_first = lm.first_frame(last_h, 0.0, 50, pm.generator)
    live = pm._frame_chunk(caches, pad_len, live_first, 3, 0.0, 50)
    assert torch.equal(first, live_first) and torch.equal(frames, live)
    assert exported == calls and calls["depth_draft"] == 4


# ---------------------------------------------------------------------------
# Causal-LM session, Orpheus
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lms():
    jm = _seeded(lambda: JaxLM(JaxLlamaConfig(**LM)))
    jm.model.embed_tokens.weight = jm.model.embed_tokens.weight * EMBED_SCALE
    return jm, _carry(jm, LlamaForCausalLM(LlamaConfig(**LM)))


def _lm_prompt():
    prompt = np.zeros((1, 16), np.int64)
    prompt[0, 11:] = np.arange(5)
    return torch.as_tensor(prompt), torch.tensor([11])


def test_causal_session_export_roundtrip(lms, tmp_path):
    """Exported causal-LM prefill and chunk programs reproduce the JAX
    package's live greedy loop and the port's."""
    jm, pm = lms
    prefix = str(tmp_path / "lm")
    export.export_causal_session(pm, prefix, prompt_bucket=16, max_tokens=8,
                                 chunk_tokens=4, temp=0.0, device="cpu")
    meta = json.load(open(f"{prefix}.meta.json"))
    assert meta["chunk_tokens"] == 4

    live = jax_generate_tokens_batch(jm, [np.arange(5)], max_tokens=9,
                                     temperature=0.0, chunk=4)[0]
    port_live = generate_tokens_batch(pm, [np.arange(5)], max_tokens=9,
                                      temperature=0.0, chunk=4)[0]
    prompt, pad_len = _lm_prompt()
    pre = export.load_program(f"{prefix}.prefill")(
        prompt, pad_len, torch.zeros(meta["noise_shapes"]["prefill"]),
        *_session_state(meta))
    toks = [int(pre[0][0])]
    last, flat = pre[0], list(pre[1:])
    chunk = export.load_program(f"{prefix}.chunk")
    for _ in range(2):
        out = chunk(last, pad_len, torch.zeros(meta["noise_shapes"]["chunk"]), *flat)
        toks.extend(int(t) for t in out[0][:, 0])
        last, flat = out[0][-1], list(out[1:])
    assert toks[:len(live)] == live.tolist() == port_live.tolist()
    assert len(set(live.tolist())) > 1


def test_causal_session_sampled_noise_contract(lms, tmp_path):
    """temp > 0 sessions: the meta records the fresh-noise-per-call
    contract, and two chunk calls from the same state replay one noise
    identically and draw differently with fresh noise; the draw is the
    port's ``sample_top_k_rows`` from the same rows."""
    from mlx_audio_tpu_torch.models.sampling import _row_noise, sample_top_k_rows

    _, pm = lms
    prefix = str(tmp_path / "lm")
    export.export_causal_session(pm, prefix, prompt_bucket=16, max_tokens=32,
                                 chunk_tokens=16, temp=4.0, device="cpu")
    meta = json.load(open(f"{prefix}.meta.json"))
    assert "FRESH" in meta["rng"]
    gen = torch.Generator().manual_seed(7)
    prompt, pad_len = _lm_prompt()
    noise0 = gumbel(meta["noise_shapes"]["prefill"], gen)
    pre = export.load_program(f"{prefix}.prefill")(prompt, pad_len, noise0,
                                                   *_session_state(meta))
    last, flat = pre[0], list(pre[1:])
    chunk = export.load_program(f"{prefix}.chunk")
    n1 = gumbel(meta["noise_shapes"]["chunk"], gen)
    n2 = gumbel(meta["noise_shapes"]["chunk"], gen)
    out_same = chunk(last, pad_len, n1, *flat)[0]
    out_same2 = chunk(last, pad_len, n1, *flat)[0]
    out_fresh = chunk(last, pad_len, n2, *flat)[0]
    assert torch.equal(out_same, out_same2)
    assert (out_same != out_fresh).any()

    from mlx_audio_tpu_torch.models.lm.causal import _prefill, _start

    caches, pad, prompt_t, _, _ = _start(pm, [np.arange(5)], 32, None, 1.0, 20, 16)
    logits = _prefill(pm, caches, pad, prompt_t)
    row = _row_noise(logits, logits.shape[-1], 123)
    got = export.load_program(f"{prefix}.prefill")(prompt, pad_len, row,
                                                   *_session_state(meta))[0]
    assert torch.equal(got, sample_top_k_rows(logits, 4.0, 0, 123))


def test_orpheus_export_set(tmp_path):
    """export_orpheus writes the LM session, the SNAC program and the frame
    constants the host parser needs; the SNAC program equals the port's
    SNAC decode."""
    from mlx_audio_tpu_torch.codec.snac import SNAC, SNACConfig
    from mlx_audio_tpu_torch.models.tts.llama import Model, ModelConfig
    from test_orpheus import FakeTokenizer, tiny_model

    jm = _seeded(tiny_model)
    snac = _carry(jm._snac, SNAC(SNACConfig(**vars(jm._snac.config)), device="cpu"))
    pm = Model(ModelConfig(**vars(jm.config)), snac=snac, tokenizer=FakeTokenizer(),
               device="cpu")
    _carry(jm.lm, pm.lm)
    info = export.export_orpheus(pm, str(tmp_path / "orp"), prompt_bucket=16,
                                 max_tokens=8, chunk_tokens=4, snac_frames=8,
                                 device="cpu")
    meta = json.load(open(tmp_path / "orp.meta.json"))
    assert meta["codes_per_frame"] == 7 and meta["stop_token"] > 0
    assert meta["snac_noise_shapes"] == export.snac_noise_shapes(snac, 8)
    assert info["snac_bytes"] > 1000

    codes = [torch.as_tensor(np.random.default_rng(i).integers(0, 64, (1, n)))
             for i, n in enumerate((2, 4, 8))]
    noise = [torch.randn(s) for s in meta["snac_noise_shapes"]]
    audio = export.load_program(tmp_path / "orp.snac")(*codes, *noise)
    assert audio.ndim == 3
    assert torch.equal(audio, snac.decode(codes, noise=noise or None))


# ---------------------------------------------------------------------------
# Whisper
# ---------------------------------------------------------------------------


def test_whisper_greedy_export_roundtrip(tmp_path):
    """The exported greedy window program reproduces api.decode's greedy
    tokens for the same mel, in the JAX package and in the port, with
    conv1 a dilated_conv1d node where it is on the kernel's route."""
    from mlx_audio_tpu.models.stt.whisper import api as japi
    from mlx_audio_tpu.models.stt.whisper.decoding import DecodingOptions as JOptions
    from mlx_audio_tpu_torch.models.stt.whisper import api
    from mlx_audio_tpu_torch.models.stt.whisper.decoding import DecodingOptions
    from test_torch_whisper import _hi, models as whisper_models, toks as whisper_toks

    jt, pt = whisper_toks.__wrapped__()
    jm, pm = whisper_models.__wrapped__((jt, pt))
    pm._tokenizer = lambda language=None, task=None: pt
    path = tmp_path / "whisper.pt2"
    export.export_whisper_greedy(pm, path, batch=2, sample_len=8, device="cpu")
    meta = json.load(open(f"{path}.meta.json"))
    sb, eot = meta["finalize"]["sample_begin"], meta["finalize"]["eot"]

    mel = (np.random.default_rng(3).standard_normal((2, 200, 80)) * 0.1).astype(np.float32)
    live = _hi(japi.decode, jm, jnp.asarray(mel), JOptions(language="en", sample_len=8,
                                                         temperature=0.0), tokenizer=jt)
    port_live = api.decode(pm, mel, DecodingOptions(language="en", sample_len=8,
                                                    temperature=0.0), tokenizer=pt)
    toks, t_end, _, ns = export.load_program(path)(torch.as_tensor(mel))
    for i, (r, rp) in enumerate(zip(live, port_live)):
        seq = toks[i, sb:int(t_end)].tolist()
        if eot in seq:
            seq = seq[:seq.index(eot)]
        assert seq == r.tokens == rp.tokens
        np.testing.assert_allclose(float(ns[i]), rp.no_speech_prob, rtol=1e-6)


# ---------------------------------------------------------------------------
# The custom ops
# ---------------------------------------------------------------------------


def _op_cases(dtype):
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(*shape, generator=g).to(dtype)

    codes = torch.randint(0, 256, (16, 64), generator=g, dtype=torch.uint8)
    return {
        "lstm": (r(2, 5, 32), r(8, 32), r(2, 8), r(2, 8)),
        "dilated_conv1d": (r(2, 20, 16), r(3, 16, 8), 2),
        "banded_conv1d": (r(2, 20, 16), r(7, 16, 8)),
        "quantized_matmul": (r(3, 64), codes, r(16, 2).abs(), r(16, 2), 32, False),
    }


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["lstm", "dilated_conv1d", "banded_conv1d",
                                  "quantized_matmul"])
def test_custom_op_matches_plain_version(name, dtype):
    """Each op passes ``opcheck`` (its fake shapes, dtypes and strides
    are the plain results'), and on the CPU returns the wrapper's plain
    result bit for bit."""
    args = _op_cases(dtype)[name]
    op = getattr(ops, name)
    torch.library.opcheck(op, args)
    got = op(*args)
    want = getattr(kernels, name)(*args)
    if name == "lstm":
        want = (*want[:2], *want[2])
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert a.dtype == dtype and torch.equal(a, b)


def test_depth_draft_op_matches_plain_version():
    from test_torch_depth import DM, NC, VOCAB, packs as depth_packs

    _, tp, tdec, _ = depth_packs.__wrapped__()
    g = torch.Generator().manual_seed(1)
    cap = 16
    shape = (len(tdec.layers), tdec.cfg.num_key_value_heads, cap, tdec.cfg.head_dim)
    kc, vc = torch.randn(shape, generator=g) * 0.1, torch.randn(shape, generator=g) * 0.1
    noise = gumbel((NC - 2, tp.heads.shape[1]), g)
    args = (list(tp), kc, vc, torch.tensor(3), noise, VOCAB, 0.9, 8)
    torch.library.opcheck(ops.depth_draft, args)
    got = ops.depth_draft(*args)
    assert got.dtype == torch.int32 and got.shape == (NC - 2,)
    assert torch.equal(got, kernels.depth_draft(tp, kc, vc, torch.tensor(3), noise,
                                                VOCAB, 0.9, 8))
    del DM


def test_wrappers_skip_the_dispatcher_outside_export(monkeypatch):
    """Outside an export the wrappers never reach the custom ops."""
    def refuse(name):
        raise AssertionError(f"{name} went through the dispatcher")

    monkeypatch.setattr(kernels, "_op", refuse)
    for name, args in _op_cases(torch.float32).items():
        getattr(kernels, name)(*args)


# ---------------------------------------------------------------------------
# Tensor write positions (the state an exported program carries)
# ---------------------------------------------------------------------------


def _tensor_idx(caches):
    for c in caches:
        c.idx = torch.tensor(c.idx)
    return caches


def test_llama_decode_with_tensor_positions_equals_int(lms):
    """Prefill and decode steps over caches whose write index is a 0-d
    tensor (written with index_copy, RoPE rows gathered) give the logits of
    the int-index caches bit for bit (the Orpheus / OuteTTS / CSM LM)."""
    _, pm = lms
    prompt, pad_len = _lm_prompt()
    out = []
    for tensor in (False, True):
        caches = pm.model.init_cache(1, max_len=24)
        if tensor:
            _tensor_idx(caches)
        h, caches = pm.model.prefill(caches, prompt, pad_len)
        logits = [pm.logits(h[:, -1])]
        tok = logits[-1].argmax(-1)
        for _ in range(6):
            h, caches = pm.model.step(caches, tok[:, None], pad_len)
            logits.append(pm.logits(h[:, -1]))
            tok = logits[-1].argmax(-1)
        assert isinstance(caches[0].idx, torch.Tensor) == tensor
        assert int(caches[0].idx) == 22
        out.append(torch.stack(logits))
    assert torch.equal(out[0], out[1])


def test_whisper_decode_with_tensor_positions_equals_int():
    """Whisper's decoder steps at a tensor write index (the positional row
    gathered, clamped as the slice is) equal the int-index steps, and the
    filters at a tensor step equal them at the int step."""
    from mlx_audio_tpu_torch.models.stt.whisper import decoding
    from test_torch_whisper import models as whisper_models, toks as whisper_toks

    jt, pt = whisper_toks.__wrapped__()
    _, pm = whisper_models.__wrapped__((jt, pt))
    features = torch.randn(1, pm.dims.n_audio_ctx, pm.dims.n_audio_state,
                           generator=torch.Generator().manual_seed(0)) * 0.1
    cross = pm.decoder.compute_cross_kv(features)
    tokens = torch.tensor([list(pt.sot_sequence) + [pt.eot] * 8])
    n_init = len(pt.sot_sequence)
    cfg = decoding.FilterConfig(eot=pt.eot, timestamp_begin=pt.timestamp_begin,
                                no_timestamps=pt.no_timestamps,
                                max_initial_timestamp_index=50, apply_timestamp_rules=True)
    sup = torch.zeros(pm.dims.n_vocab)
    blank = torch.zeros(pm.dims.n_vocab)
    blank[pt.eot] = float("-inf")
    runs = []
    for tensor in (False, True):
        caches = pm.decoder.init_cache(1, tokens.shape[1])
        if tensor:
            _tensor_idx(caches)
        _, caches = pm.decoder.prefill(caches, tokens[:, :n_init], n_init, cross)
        for c in caches:
            c.idx = torch.tensor(n_init - 1) if tensor else n_init - 1
        toks, steps = tokens.clone(), []
        for t in range(n_init, n_init + 6):
            logits, caches = pm.decoder.step(caches, toks[:, t - 1:t], cross)
            tt = torch.tensor(t) if tensor else t
            logits = decoding.apply_filters(logits.float(), toks, tt, n_init, cfg, sup, blank)
            toks[:, t] = logits.argmax(-1)
            steps.append(logits)
        runs.append(torch.stack(steps))
    assert torch.equal(runs[0], runs[1])


def test_mimi_stream_with_tensor_state_equals_int(mimis):
    """Mimi's streaming decode from a state whose ring offsets are 0-d
    int64 tensors and conv flags 0-d bool tensors equals the decode from
    the int / bool state, and carries tensors on."""
    from torch.utils import _pytree as pytree

    _, pm = mimis
    codes = torch.as_tensor(np.random.default_rng(4).integers(0, 17, size=(1, 4, 4)))
    state = pm.init_state(1)
    tensor_state = pytree.tree_map(
        lambda x: x if isinstance(x, torch.Tensor) else torch.tensor(x), state)
    a, s1 = pm.decode_frames_stateful(codes, state)
    b, s2 = pm.decode_frames_stateful(codes, tensor_state)
    assert torch.equal(a, b)
    # 4 frames, upsampled twice for the transformer
    assert s1.decoder_tf[0].offset == int(s2.decoder_tf[0].offset) == 8
    flags = [x for x in pytree.tree_leaves(s2.decoder) if x.dtype == torch.bool]
    assert flags and not any(bool(f) for f in flags)


def test_csm_frame_from_noise_greedy_equals_first_frame(csms):
    """An exported program's frame (Gumbel rows given, here greedy) is the
    live frame, over backbone caches at a tensor write index."""
    _, pm = csms
    lm = pm.model
    tokens, mask = _csm_prompt(4)
    frames = []
    for tensor in (False, True):
        caches = lm.backbone.init_cache(1, max_len=24)
        if tensor:
            _tensor_idx(caches)
        h, caches = lm.backbone.prefill(caches, lm.embed_tokens(
            torch.as_tensor(tokens), torch.as_tensor(mask)), torch.tensor([PAD]))
        noise = torch.zeros(1, 4, export.noise_width(lm.audio_vocab_size))
        frames.append(lm.frame_from_noise(h[:, -1], noise, 0.0, 50) if tensor
                      else lm.first_frame(h[:, -1], 0.0, 50, pm.generator))
    assert torch.equal(frames[0], frames[1])
