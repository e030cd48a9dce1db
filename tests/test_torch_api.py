"""The port's public surface against the JAX package's.

``test_port_names_cover_reference`` parses both packages (``ast``, no
import) and fails on a public name of the JAX package with no port name at
the same path, unless NO_COUNTERPART states why it has none.  The other
tests hold each helper the port took over from the JAX package to it, on
seeded inputs: integer outputs exactly, float32 ones within 1e-6 (the
modules' own twins keep their files' tolerances), weights carried with
``convert.params_from_jax`` and ``load_state_dict(strict=True)``.
"""

import ast
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mlx_audio_tpu.nn as jnn
import mlx_audio_tpu.nn.layers as jax_layers
import mlx_audio_tpu_torch.nn as tnn
from mlx_audio_tpu.nn.module import named_arrays
from mlx_audio_tpu_torch.convert import params_from_jax

ROOT = Path(__file__).resolve().parent.parent
ATOL = 1e-6

# Public names of the JAX package that have no port name at the same path,
# each with the reason.  A file path stands for every name in it.
NO_COUNTERPART = {
    "nn/module.py": "torch.nn.Module, state_dict and convert.params_from_jax do "
                    "Module's, named_arrays', update_arrays' and map_arrays' jobs",
    "nn/pallas_ops.py": "the TPU kernels: nn/kernels.py wraps their CUDA ports",
    "nn/layers.py::use_decomp_conv": "a TPU conv gate",
    "nn/layers.py::promote_conv_operands": "the TPU conv gate's promotion; the "
                                           "port's is nn.layers.promote_operands",
    "parallel/context.py::MeshContext.data_sharding": "a JAX sharding",
    "parallel/context.py::MeshContext.replicated_sharding": "a JAX sharding",
    "parallel/context.py::MeshContext.shard_batch_tree": "JAX shardings of a pytree",
    "codec/loading.py::fetch_from_hub": "a hub download: the port loads local files only",
    "models/stt/parakeet/conformer.py::Conv2dLayer": "nn.layers.Conv2d takes its place",
    "nn/pallas_depth.py::depth_draft_pallas": "the Pallas kernel: the port's is "
                                              "nn.kernels.depth_draft",
    "nn/pallas_depth.py::depth_draft_xla": "the XLA reference: the port's is "
                                           "nn.kernels.depth_draft_plain",
    "nn/pallas_depth.py::dequant_ref": "the port dequantizes in nn/pallas_depth.py's "
                                       "own packing",
    "nn/pallas_depth.py::CHUNK_COLS": "the Pallas kernel's VMEM streaming width; the "
                                      "CUDA kernel sizes its own ring",
}


def _public(name: str) -> bool:
    return not name.startswith("_")


def _assigned(node) -> list:
    targets = node.targets if isinstance(node, ast.Assign) else [node.target]
    return [t.id for t in targets if isinstance(t, ast.Name)]


def _reference_names(tree) -> set:
    """Top-level public functions, classes and assigned names, and each
    top-level class's public methods and nested classes as Class.name."""
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            if _public(node.name):
                names.add(node.name)
            if isinstance(node, ast.ClassDef):
                names |= {f"{node.name}.{m.name}" for m in node.body
                          if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef,
                                            ast.ClassDef)) and _public(m.name)}
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            names |= {n for n in _assigned(node) if _public(n)}
    return names


def _port_names(tree) -> set:
    """Every name the module binds at top level (defined, assigned or
    imported), and each class's members with those its bases in the same
    module give it."""
    names, classes = set(), {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
            if isinstance(node, ast.ClassDef):
                classes[node.name] = node
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            names |= set(_assigned(node))
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}

    def members(cls, seen=()):
        own = {m.name for m in cls.body
               if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))}
        for base in cls.bases:
            if isinstance(base, ast.Name) and base.id in classes and base.id not in seen:
                own |= members(classes[base.id], (*seen, cls.name))
        return own

    for name, cls in classes.items():
        names |= {f"{name}.{m}" for m in members(cls)}
    return names


def _parse(package: str) -> dict:
    root = ROOT / package
    return {p.relative_to(root).as_posix(): ast.parse(p.read_text(), str(p))
            for p in sorted(root.rglob("*.py"))}


def test_port_names_cover_reference():
    ref, port = _parse("mlx_audio_tpu"), _parse("mlx_audio_tpu_torch")
    missing, stale = [], []
    for path, tree in ref.items():
        if path in NO_COUNTERPART:
            if path in port:
                stale.append(path)
            continue
        have = _port_names(port[path]) if path in port else set()
        for name in sorted(_reference_names(tree)):
            listed = f"{path}::{name}" in NO_COUNTERPART
            if name not in have and not listed:
                missing.append(f"{path}::{name}")
            elif name in have and listed:
                stale.append(f"{path}::{name}")
    assert not missing, f"public JAX names with no port name at the same path: {missing}"
    assert not stale, f"NO_COUNTERPART lists names the port now has: {stale}"
    assert all(k.split("::")[0] in ref for k in NO_COUNTERPART)


def test_package_exports_match_jax():
    import mlx_audio_tpu
    import mlx_audio_tpu.utils as jutils
    import mlx_audio_tpu_torch
    import mlx_audio_tpu_torch.utils as tutils

    assert mlx_audio_tpu_torch.__all__ == mlx_audio_tpu.__all__
    assert mlx_audio_tpu_torch.__version__ == mlx_audio_tpu.__version__ == "0.1.0"
    assert mlx_audio_tpu_torch.stft is mlx_audio_tpu_torch.dsp.stft
    assert tutils.__all__ == jutils.__all__
    assert tutils.load_audio.__module__ == "mlx_audio_tpu_torch.utils.audio_io"
    module_jobs = {"Module", "named_arrays", "update_arrays", "map_arrays"}  # torch.nn.Module's
    assert set(jnn.__all__) - module_jobs <= set(tnn.__all__)
    assert all(hasattr(tnn, n) for n in tnn.__all__)


def _carry(jax_module, port_module):
    named = {k: np.asarray(v) for k, v in named_arrays(jax_module)}
    port_module.load_state_dict(params_from_jax(named, port_module), strict=True)
    return port_module


def _x(shape, seed=0, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _seeded(build):
    saved = jax_layers._INIT_RNG
    jax_layers._INIT_RNG = np.random.default_rng(0)
    try:
        return build()
    finally:
        jax_layers._INIT_RNG = saved


@pytest.mark.parametrize("case", ["self_causal", "gqa_bias_out_dim", "rope", "rope_positions",
                                  "rope_batched_positions", "cross", "cache"])
def test_multi_head_attention_matches_jax(case):
    """``MultiHeadAttention``: GQA, biases, an output width of its own,
    RoPE at the start or at given positions, cross-attention over ``xk``,
    and two cached decode steps with a padding mask."""
    kw = dict(dim=32, num_heads=4)
    if case in ("gqa_bias_out_dim", "rope_batched_positions", "cache"):
        kw.update(num_kv_heads=2, bias=True, out_dim=24)
    j = _seeded(lambda: jnn.MultiHeadAttention(**kw))
    t = _carry(j, tnn.MultiHeadAttention(**kw))
    x = _x((2, 6, 32))
    args_j, args_t = {}, {}
    if case == "self_causal":
        args_j["mask"], args_t["mask"] = jnn.causal_mask(6), tnn.causal_mask(6)
    if case.startswith("rope"):
        args_j["rope"], args_t["rope"] = jnn.rope_table(8, 64), tnn.rope_table(8, 64)
        pos = {"rope": None, "rope_positions": np.arange(6) + 9,
               "rope_batched_positions": np.array([np.arange(6) + 3, np.arange(6) + 40])}[case]
        if pos is not None:
            args_j["positions"], args_t["positions"] = jnp.asarray(pos), torch.as_tensor(pos)
    if case == "cross":
        xk = _x((2, 9, 32), 1)
        args_j["xk"], args_t["xk"] = jnp.asarray(xk), torch.as_tensor(xk)
    if case == "cache":
        jc = jnn.KVCache.create(2, 2, 8, 8)
        tc = tnn.KVCache.create(2, 2, 8, 8)
        pad = np.zeros((2, 1, 1, 8), np.float32)
        pad[1, ..., 0] = -1e9  # row 1's first slot is padding
        outs_j, outs_t = [], []
        for step in (x[:, :3], x[:, 3:4]):
            oj, jc = j(jnp.asarray(step), mask=jnp.asarray(pad), cache=jc)
            ot, tc = t(torch.as_tensor(step), mask=torch.as_tensor(pad), cache=tc)
            outs_j.append(np.asarray(oj))
            outs_t.append(ot.numpy())
        assert tc.idx == int(jc.idx) == 4
        np.testing.assert_allclose(np.concatenate(outs_t, 1), np.concatenate(outs_j, 1),
                                   atol=ATOL, rtol=0)
        return
    ref = np.asarray(j(jnp.asarray(x), **args_j))
    got = t(torch.as_tensor(x), **args_t).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_zero_pad_time_matches_jax():
    x = _x((2, 5, 3))
    for pad in ((0, 4), (3, 0), (2, 7)):
        ref = np.asarray(jnn.layers.zero_pad_time(jnp.asarray(x), pad))
        got = tnn.layers.zero_pad_time(torch.as_tensor(x), pad).numpy()
        np.testing.assert_array_equal(got, ref)


def test_adjust_speed_matches_jax():
    from mlx_audio_tpu.models.base import adjust_speed as jax_adjust_speed
    from mlx_audio_tpu_torch.models.base import adjust_speed

    for shape in ((2401,), (1000, 2)):
        audio = _x(shape)
        for speed in (1.5, 0.8, 1.0, 3.0):
            ref = np.asarray(jax_adjust_speed(jnp.asarray(audio), speed))
            got = adjust_speed(torch.as_tensor(audio), speed).numpy()
            assert got.shape == ref.shape == (int(shape[0] / speed), *shape[1:])
            np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_kokoro_load_config_from_dict_and_path(tmp_path):
    import dataclasses

    from mlx_audio_tpu.models.tts.kokoro.model import load_config as jax_load_config
    from mlx_audio_tpu_torch.models.tts.kokoro.model import ModelConfig, load_config
    from test_kokoro import tiny_config

    d = {**dataclasses.asdict(tiny_config()), "model_type": "kokoro"}
    path = tmp_path / "config.json"
    path.write_text(json.dumps(d))
    for src in (d, path, str(path)):
        got = load_config(src)
        assert isinstance(got, ModelConfig)
        assert dataclasses.asdict(got) == dataclasses.asdict(jax_load_config(src))


def test_dac_decode_latents_matches_jax():
    from mlx_audio_tpu.codec.dac.dac import VectorQuantize as JaxVQ
    from mlx_audio_tpu_torch.codec.dac.dac import VectorQuantize

    j = _seeded(lambda: JaxVQ(16, 32, 8))
    t = _carry(j, VectorQuantize(16, 32, 8))
    z_e = _x((2, 11, 8), 3)
    zq_j, idx_j = j.decode_latents(jnp.asarray(z_e))
    zq_t, idx_t = t.decode_latents(torch.as_tensor(z_e))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(zq_t.numpy(), np.asarray(zq_j), atol=ATOL, rtol=0)
    z = _x((2, 11, 16), 4)
    out, idx, _ = t(torch.as_tensor(z))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j(jnp.asarray(z))[1]))


def test_mimi_warmup_encodes_and_decodes_four_frames_of_silence(monkeypatch):
    from mlx_audio_tpu_torch.codec.mimi import Mimi
    from test_mimi import tiny_mimi
    from test_torch_mimi import port_config

    jm = tiny_mimi()
    model = Mimi.build(port_config(jm.cfg), device="cpu")
    seen = []
    enc, dec = model.encode, model.decode
    monkeypatch.setattr(model, "encode", lambda pcm: (seen.append(pcm), enc(pcm))[1])
    monkeypatch.setattr(model, "decode", lambda c: (seen.append(c), dec(c))[1])
    assert model.warmup() is None
    pcm, codes = seen
    assert tuple(pcm.shape) == (1, 1, jm.samples_per_frame * 4) and not pcm.any()
    assert tuple(codes.shape) == (1, jm.cfg.quantizer_nq, 4)


def test_seanet_elu_matches_jax_and_the_blocks_use_it(monkeypatch):
    """``seanet.elu`` is the JAX package's, and SEANet's blocks call it as
    often as the JAX package's call theirs."""
    import mlx_audio_tpu.codec.mimi.seanet as jseanet
    from mlx_audio_tpu_torch.codec.mimi import seanet

    x = _x((3, 40), 5, 2.0)
    np.testing.assert_allclose(seanet.elu(torch.as_tensor(x)).numpy(),
                               np.asarray(jseanet.elu(jnp.asarray(x))), atol=ATOL, rtol=0)
    calls = {"jax": 0, "port": 0}

    def counting(name, fn):
        def elu(v):
            calls[name] += 1
            return fn(v)
        return elu

    monkeypatch.setattr(jseanet, "elu", counting("jax", jseanet.elu))
    monkeypatch.setattr(seanet, "elu", counting("port", seanet.elu))
    kw = dict(dimension=16, channels=1, causal=True, nfilters=4, nresidual_layers=1,
              ratios=[2], ksize=3, residual_ksize=3, last_ksize=3, dilation_base=2,
              pad_mode="constant", true_skip=True, compress=2)
    jenc = _seeded(lambda: jseanet.SeanetEncoder(jseanet.SeanetConfig(**kw)))
    enc = _carry(jenc, seanet.SeanetEncoder(seanet.SeanetConfig(**kw)))
    pcm = _x((1, 8, 1), 6)
    np.testing.assert_allclose(enc(torch.as_tensor(pcm)).numpy(),
                               np.asarray(jenc(jnp.asarray(pcm))), atol=1e-5, rtol=0)
    assert calls["port"] == calls["jax"] > 0


def test_load_safetensors_and_load_weights_files_match_jax(tmp_path):
    from safetensors.numpy import save_file

    from mlx_audio_tpu.codec.loading import load_safetensors as jax_load_safetensors
    from mlx_audio_tpu.utils.loader import load_weights_files as jax_load_weights_files
    from mlx_audio_tpu_torch.codec import loading
    from mlx_audio_tpu_torch.utils.loader import load_weights_files

    assert loading.load_weights_files is load_weights_files
    one, shards, llm = tmp_path / "one", tmp_path / "shards", tmp_path / "spark"
    for d in (one, shards, llm / "LLM"):
        d.mkdir(parents=True)
    save_file({"a": _x((3, 4)), "b": np.arange(5, dtype=np.int32)}, str(one / "model.safetensors"))
    save_file({"c": _x((2,), 1)}, str(shards / "model-00001-of-00002.safetensors"))
    save_file({"d": _x((4, 1), 2)}, str(shards / "model-00002-of-00002.safetensors"))
    save_file({"e": _x((6,), 3)}, str(llm / "LLM" / "model.safetensors"))
    for path, filename in ((one, None), (one, "model.safetensors"), (shards, None), (llm, None)):
        got = loading.load_safetensors(path, filename)
        ref = jax_load_safetensors(path, filename)
        assert got.keys() == ref.keys()
        assert all(np.array_equal(got[k], ref[k]) for k in ref)
    for path in (one, shards, llm):
        got, ref = load_weights_files(path), jax_load_weights_files(path)
        assert got.keys() == ref.keys() and all(np.array_equal(got[k], ref[k]) for k in ref)
    with pytest.raises(FileNotFoundError, match="No safetensors"):
        load_weights_files(tmp_path / "one" / "..")


def test_lm_dtype_at_the_causal_path():
    from mlx_audio_tpu_torch.models.lm import causal, llama
    from mlx_audio_tpu_torch.models.lm.llama import LlamaConfig
    from mlx_audio_tpu_torch.nn.quantize import quantize_model

    assert causal.lm_dtype is llama.lm_dtype
    cfg = LlamaConfig(num_hidden_layers=1, num_attention_heads=2, num_key_value_heads=1,
                      head_dim=8, hidden_size=16, intermediate_size=32, rms_norm_eps=1e-5,
                      vocab_size=64)
    model = causal.LlamaForCausalLM(cfg)
    assert causal.lm_dtype(model) == torch.float32
    quantize_model(model, group_size=16, bits=8)
    assert causal.lm_dtype(model) == torch.float32  # uint8 codes are not its dtype
    assert causal.lm_dtype(llama.cast_lm(model, torch.bfloat16)) == torch.bfloat16


def test_spark_repeat_upsampler_matches_jax_and_forward_calls_it(monkeypatch):
    from mlx_audio_tpu.models.tts.spark.modules import SamplingBlock as JaxBlock
    from mlx_audio_tpu_torch.models.tts.spark.modules import SamplingBlock

    x = _x((2, 5, 4))
    for scale in (1, 2, 3):
        np.testing.assert_array_equal(
            SamplingBlock.repeat_upsampler(torch.as_tensor(x), scale).numpy(),
            np.asarray(JaxBlock.repeat_upsampler(jnp.asarray(x), scale)))
    j = _seeded(lambda: JaxBlock(dim=4, groups=4, upsample_scale=2))
    t = _carry(j, SamplingBlock(dim=4, groups=4, upsample_scale=2))
    np.testing.assert_allclose(t(torch.as_tensor(x)).numpy(), np.asarray(j(jnp.asarray(x))),
                               atol=ATOL, rtol=0)
    calls = []
    repeat = SamplingBlock.repeat_upsampler
    monkeypatch.setattr(SamplingBlock, "repeat_upsampler",
                        staticmethod(lambda x, s: (calls.append(s), repeat(x, s))[1]))
    t(torch.as_tensor(x))
    assert calls == [2]
