"""The port's distribution layer (``mlx_audio_tpu_torch.parallel``): the twin
of tests/test_parallel.py, and its contract against the JAX package's.

The twins run on CPU meshes (``[torch.device("cpu")] * 8``, a device
repeated, as the JAX tests run on 8 virtual CPU devices).  Against the JAX
package directly: ``parse_mesh_spec`` and ``activate_mesh``'s tiling and
errors over the JAX tests' spec strings; every parameter's split by
``tp_rules_llama`` and ``tp_rules_dia`` on the tiny Llama and Dia (the
port's names and layouts from ``convert.params_from_jax``), before and
after the divisibility fallback; and a tiny int8 causal LM under
dp=2,tp=2, greedy, whose tokens equal JAX's ``generate_tokens_batch``
under the same mesh over 4 of its 8 devices.  Sampled rows are held to
the port's unsharded run (the JAX PRNG cannot be reproduced).
"""

from pathlib import Path
import sys

import jax
import numpy as np
import pytest
import torch

import mlx_audio_tpu.nn.layers as jax_layers
import mlx_audio_tpu.parallel.context as jax_context
import mlx_audio_tpu.parallel.mesh as jax_mesh
from mlx_audio_tpu.nn.module import named_arrays
from mlx_audio_tpu_torch.convert import params_from_jax
from mlx_audio_tpu_torch.models.base import init_weights
from mlx_audio_tpu_torch.nn.layers import Linear
from mlx_audio_tpu_torch.nn.quantize import QuantizedLinear, quantize_model
from mlx_audio_tpu_torch.parallel import context, mesh as port_mesh
from mlx_audio_tpu_torch.parallel.mesh import (
    ColumnParallel,
    RowParallel,
    VocabParallelEmbedding,
    get_mesh,
    pmap_batches,
    replicate,
    shard_batch,
    shard_module,
    tp_plan,
    tp_rules_dia,
    tp_rules_llama,
)

sys.path.insert(0, str(Path(__file__).parent))

CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(autouse=True)
def _clean_mesh():
    context.deactivate_mesh()
    jax_context.deactivate_mesh()
    yield
    context.deactivate_mesh()
    jax_context.deactivate_mesh()


def _seeded(build):
    saved = jax_layers._INIT_RNG
    jax_layers._INIT_RNG = np.random.default_rng(0)
    try:
        return build()
    finally:
        jax_layers._INIT_RNG = saved


LLAMA = dict(num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
             head_dim=8, hidden_size=32, intermediate_size=64, rms_norm_eps=1e-5,
             vocab_size=64, max_position_embeddings=64)


# ---------------------------------------------------------------------------
# twins of tests/test_parallel.py
# ---------------------------------------------------------------------------


def test_mesh_shapes():
    m = get_mesh(model_parallel=2, devices=CPU8)
    assert m.shape == {"data": 4, "model": 2}
    assert m.row(1) == [torch.device("cpu")] * 2


def test_pmap_batches_data_parallel():
    """pmap_batches hands each data row its slice of the batch and equals
    the single-device result."""
    lin = Linear(16, 8)
    init_weights(lin, torch.Generator().manual_seed(0))
    x = torch.as_tensor(np.random.default_rng(0).standard_normal((8, 16)), dtype=torch.float32)
    ref = lin(x)
    out = pmap_batches(get_mesh(devices=CPU8), lambda m, a: m(a), lin, x)
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(), atol=1e-5)


def test_pmap_batches_rejects_indivisible():
    lin = Linear(4, 4)
    with pytest.raises(ValueError):
        pmap_batches(get_mesh(devices=CPU8), lambda m, a: m(a), lin, torch.zeros(6, 4))
    with pytest.raises(ValueError):
        shard_batch(get_mesh(devices=CPU8), torch.zeros(6, 4))


def test_shard_module_tp_matches_replicated():
    """Tensor-parallel placement does not change the results: the
    column-parallel outputs concatenate, the row-parallel partials add."""
    from mlx_audio_tpu_torch.models.lm.llama import LlamaConfig, LlamaModel

    model = LlamaModel(LlamaConfig(**LLAMA))
    init_weights(model, torch.Generator().manual_seed(0))
    ids = torch.as_tensor(np.random.default_rng(1).integers(0, 64, (2, 10)))
    ref = model(ids)
    m = get_mesh(model_parallel=2, devices=CPU8)
    sharded = shard_module(m, model, tp_rules_llama)
    (ids_r, *_) = replicate(m, ids)
    np.testing.assert_allclose(sharded(ids_r).detach().numpy(), ref.detach().numpy(),
                               atol=1e-4)
    # the module is not changed, and the copy holds the wrappers
    assert isinstance(model.layers[0].self_attn.q_proj, Linear)
    assert isinstance(sharded.layers[0].self_attn.q_proj, ColumnParallel)
    assert isinstance(sharded.layers[0].mlp.down_proj, RowParallel)
    assert isinstance(sharded.embed_tokens, VocabParallelEmbedding)


def test_csm_tp_decode_matches_replicated():
    """CSM's first frame after a prefill under tensor-parallel backbone and
    depth decoder equals the replicated model's codes (greedy), dense and
    int8."""
    from mlx_audio_tpu_torch.models.tts.sesame.model import SesameModel
    from test_sesame import tiny_config

    sm = SesameModel(tiny_config())
    init_weights(sm, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(5)
    tokens = torch.as_tensor(rng.integers(0, 60, (1, 16, 5)))
    mask = torch.ones((1, 16, 5), dtype=torch.bool)

    def frame(lm):
        caches = lm.backbone.init_cache(1, max_len=32)
        h, _ = lm.backbone.prefill(caches, lm.embed_tokens(tokens, mask), torch.tensor([2]))
        return lm.first_frame(h[:, -1], 0.0, 1, torch.Generator().manual_seed(0))

    m = get_mesh(model_parallel=2, devices=CPU8)
    with torch.no_grad():
        for _ in ("dense", "int8"):
            ref = frame(sm)
            np.testing.assert_array_equal(frame(shard_module(m, sm, tp_rules_llama)).numpy(),
                                          ref.numpy())
            quantize_model(sm, group_size=16, bits=8)


# ---------------------------------------------------------------------------
# the mesh's contract against the JAX package's
# ---------------------------------------------------------------------------

SPECS = ["dp=4", "dp=4,tp=2", "tp=2", "8", "", " DP=2 , TP=2 ", "dp=0,tp=4", "pp=2",
         "dp", "dp=x"]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_mesh_spec_matches_jax(spec):
    try:
        want = jax_context.parse_mesh_spec(spec)
    except ValueError:
        with pytest.raises(ValueError):
            context.parse_mesh_spec(spec)
        return
    assert context.parse_mesh_spec(spec) == want


@pytest.mark.parametrize("spec", ["dp=4", "dp=4,tp=2", "tp=2", "dp=2,tp=2", "8", "",
                                  "tp=4", "dp=16", "tp=3", "dp=-1", "tp=0", "dp=3,tp=3"])
def test_activate_mesh_tiling_matches_jax(spec):
    """The same dp, tp and grid as JAX's on 8 devices, or the same
    ValueError."""
    try:
        want = jax_context.activate_mesh(spec)
    except ValueError:
        with pytest.raises(ValueError):
            context.activate_mesh(spec, devices=CPU8)
        return
    got = context.activate_mesh(spec, devices=CPU8)
    assert (got.dp, got.tp) == (want.dp, want.tp)
    assert got.mesh.shape == dict(want.mesh.shape)
    assert context.active_mesh() is got


def test_activate_mesh_takes_cards_only():
    """Without devices= the mesh is every visible CUDA card: here, none, so
    it raises (no CPU fallback); a CLI's --device cpu asks for the CPU,
    where dp=0 resolves to 1."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(ValueError, match="no CUDA device"):
        context.activate_mesh("dp=1")
    assert context.active_mesh() is None
    ctx = context.activate_cli_mesh("dp=0", "cpu")
    assert (ctx.dp, ctx.tp) == (1, 1)
    ctx = context.activate_cli_mesh("dp=2,tp=2", "cpu")
    assert ctx.mesh.shape == {"data": 2, "model": 2}


def _jax_shard_specs(jmod, rules, tp):
    devs = jax.devices()[:2 * tp]
    m = jax_mesh.get_mesh(model_parallel=tp, devices=devs)
    sharded = jax_mesh.shard_module(m, jmod, rules)
    return {k: tuple(v.sharding.spec) for k, v in named_arrays(sharded)}


def _assert_rules_match(jmod, pmod, jax_rules, port_rules, tp):
    named = {k: np.asarray(v) for k, v in named_arrays(jmod)}
    port = params_from_jax(named, pmod)
    split = 0
    for path, leaf in named.items():
        want = tuple(jax_rules(path, leaf))
        assert tuple(port_rules(path, port[path])) == want, path
        split += "model" in want
    assert split
    # after the divisibility fallback: JAX's placed shardings
    plan = tp_plan(pmod, port_rules, tp)
    placed = _jax_shard_specs(jmod, jax_rules, tp)
    for path, spec in placed.items():
        assert plan.get(path, ()) == (spec if "model" in spec else ()), path


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_rules_llama_match_jax(tp):
    from mlx_audio_tpu.models.lm.causal import LlamaForCausalLM as JaxLM
    from mlx_audio_tpu.models.lm.llama import LlamaConfig as JaxConfig
    from mlx_audio_tpu_torch.models.lm.causal import LlamaForCausalLM
    from mlx_audio_tpu_torch.models.lm.llama import LlamaConfig

    # vocab 66: the embedding's vocabulary axis splits at tp=2, not at 4
    cfg = dict(LLAMA, vocab_size=66)
    jm = _seeded(lambda: JaxLM(JaxConfig(**cfg)))
    pm = LlamaForCausalLM(LlamaConfig(**cfg))
    _assert_rules_match(jm, pm, jax_mesh.tp_rules_llama, tp_rules_llama, tp)


def test_tp_rules_dia_match_jax():
    """Dia's DenseGeneral layouts are the JAX package's, so each rule
    splits the same logical axis: q/k/v heads, o's head input axis, the
    fused MLP's hidden dim, wo's input, the logits head's vocabulary."""
    from mlx_audio_tpu_torch.models.tts.dia.model import DiaModel
    from test_dia import tiny_dia
    from test_torch_dia import port_config

    jd = _seeded(tiny_dia)
    pm = DiaModel(port_config(jd.config))
    _assert_rules_match(jd.model, pm, jax_mesh.tp_rules_dia, tp_rules_dia, 2)
    sharded = shard_module(get_mesh(2, CPU8), pm, tp_rules_dia)
    attn = sharded.decoder.layers[0].self_attention
    assert isinstance(attn.q_proj, ColumnParallel) and attn.q_proj.dim == -2
    assert isinstance(attn.o_proj, RowParallel) and attn.o_proj.dim == -2


def test_quantized_splits_keep_codes_and_replicate_where_jax_cannot_cut():
    """int8 column shards are views of the codes, row shards one contiguous
    copy each; an int4 input split (the concat-half packing) and a split
    that would cut a group replicate."""
    lin8 = QuantizedLinear.from_linear(_lin(64, 32), group_size=16, bits=8)
    lin4 = QuantizedLinear.from_linear(_lin(64, 32), group_size=16, bits=4)
    lin_g = QuantizedLinear.from_linear(_lin(64, 32), group_size=64, bits=8)
    x = torch.as_tensor(np.random.default_rng(0).standard_normal((3, 64)), dtype=torch.float32)
    for spec, mod, kind in ((("model", None), lin8, ColumnParallel),
                            ((None, "model"), lin8, RowParallel),
                            ((None, "model"), lin4, None),
                            ((None, "model"), lin_g, None),
                            (("model", None), lin4, ColumnParallel)):
        holder = torch.nn.Sequential(mod)
        sharded = port_mesh.shard_devices(holder, lambda p, w: spec, CPU8[:2])[0]
        if kind is None:
            assert sharded is not mod and isinstance(sharded, QuantizedLinear)
            assert sharded.weight is mod.weight
            continue
        assert isinstance(sharded, kind)
        np.testing.assert_allclose(sharded(x).numpy(), mod(x).numpy(), atol=1e-5)
        for s in sharded.shards:
            assert s.weight.dtype == torch.uint8
        if kind is ColumnParallel:
            base = mod.weight.untyped_storage().data_ptr()
            assert all(s.weight.untyped_storage().data_ptr() == base for s in sharded.shards)


def _lin(i, o):
    lin = Linear(i, o)
    init_weights(lin, torch.Generator().manual_seed(i + o))
    return lin


def test_int8_causal_lm_dp2_tp2_matches_jax():
    """A tiny int8 causal LM under dp=2,tp=2: greedy tokens equal JAX's
    generate_tokens_batch under the same mesh over 4 of its 8 devices (and
    its unsharded run); sampled rows at temp 0.9 equal the port's
    unsharded run."""
    from mlx_audio_tpu.models.lm.causal import LlamaForCausalLM as JaxLM
    from mlx_audio_tpu.models.lm.causal import generate_tokens_batch as jax_batch
    from mlx_audio_tpu.models.lm.llama import LlamaConfig as JaxConfig
    from mlx_audio_tpu.nn.quantize import quantize_model as jax_quantize_model
    from mlx_audio_tpu_torch.models.lm.causal import LlamaForCausalLM, generate_tokens_batch
    from mlx_audio_tpu_torch.models.lm.llama import LlamaConfig

    kw = dict(num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=2, head_dim=8,
              hidden_size=16, intermediate_size=32, rms_norm_eps=1e-5, vocab_size=64,
              max_position_embeddings=256, tie_word_embeddings=True)
    jm = _seeded(lambda: JaxLM(JaxConfig(**kw)))
    jm.model.embed_tokens.weight = jm.model.embed_tokens.weight * 0.05
    jax_quantize_model(jm, group_size=8, bits=8)
    pm = quantize_model(LlamaForCausalLM(LlamaConfig(**kw)), group_size=8, bits=8)
    pm.load_state_dict(params_from_jax({k: np.asarray(v) for k, v in named_arrays(jm)}, pm),
                       strict=True)
    prompts = [np.arange(5), np.arange(3, 12), np.arange(7), np.arange(2, 6)]
    greedy = dict(max_tokens=12, temperature=0.0, chunk=8, seed=11)

    want_unsharded = [r.tolist() for r in jax_batch(jm, prompts, **greedy)]
    jax_context.activate_mesh("dp=2,tp=2", devices=jax.devices()[:4])
    want = [r.tolist() for r in jax_batch(jm, prompts, **greedy)]
    assert want == want_unsharded and len({tuple(r) for r in want}) > 1

    sampled = dict(greedy, temperature=0.9, top_k=8)
    base = [r.tolist() for r in generate_tokens_batch(pm, prompts, **sampled)]
    ctx = context.activate_mesh("dp=2,tp=2", devices=CPU8[:4])
    assert [r.tolist() for r in generate_tokens_batch(pm, prompts, **greedy)] == want
    assert [r.tolist() for r in generate_tokens_batch(pm, prompts, **sampled)] == base
    # the replicas run the int8 shards: the o and down projections split I
    (rep, _) = ctx.place_tp(pm, tp_rules_llama)
    down = rep.model.layers[0].mlp.down_proj
    assert isinstance(down, RowParallel)
    assert [tuple(s.weight.shape) for s in down.shards] == [(16, 16), (16, 16)]
