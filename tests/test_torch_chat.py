"""The port's chat LM (``models/lm/chat.py``) against the JAX package's, on
the CPU: a tiny Qwen2-style LM (``qkv_bias``, tied embeddings) carried
across with ``convert.params_from_jax``, its embedding scaled by 0.05 as the
other LM twins scale it and its projections by 3 (at the JAX init a tied
tiny LM repeats one or two tokens under greedy decoding, and a chat LM has
no repetition penalty); greedy replies and every streamed snapshot equal,
token for token; the prompt's eviction and truncation, the HF config
mapping and the checkpoint sanitizer equal; ``from_pretrained`` from a
local HF-layout directory in both packages.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mlx_audio_tpu.models.lm.chat as jax_chat
import mlx_audio_tpu.nn.layers as jax_layers
from mlx_audio_tpu.models.lm.causal import LlamaForCausalLM as JaxLM
from mlx_audio_tpu.models.lm.llama import LlamaConfig as JaxLlamaConfig
from mlx_audio_tpu_torch.models.lm import chat
from mlx_audio_tpu_torch.models.lm.causal import LlamaForCausalLM
from mlx_audio_tpu_torch.models.lm.llama import LlamaConfig
from test_server_sts import FakeChatTokenizer
from test_torch_orpheus import EMBED_SCALE, _carry

QWEN = dict(num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            head_dim=8, hidden_size=32, intermediate_size=64, rms_norm_eps=1e-6,
            vocab_size=64, max_position_embeddings=160, rope_theta=1_000_000.0,
            tie_word_embeddings=True, qkv_bias=True)
HF_CONFIGS = {
    "llama": {"model_type": "llama", "hidden_size": 48, "num_attention_heads": 6,
              "num_key_value_heads": 2, "num_hidden_layers": 3, "intermediate_size": 96,
              "vocab_size": 200, "rms_norm_eps": 1e-5, "rope_theta": 500000.0,
              "rope_scaling": {"factor": 32.0, "low_freq_factor": 1.0,
                               "high_freq_factor": 4.0,
                               "original_max_position_embeddings": 8192,
                               "rope_type": "llama3"},
              "max_position_embeddings": 131072, "mlp_bias": False},
    "qwen2": {"model_type": "qwen2", "hidden_size": 32, "num_attention_heads": 4,
              "num_hidden_layers": 2, "intermediate_size": 64, "vocab_size": 128,
              "tie_word_embeddings": True},
    "qwen3": {"model_type": "qwen3", "hidden_size": 64, "num_attention_heads": 4,
              "num_key_value_heads": 2, "head_dim": 32, "num_hidden_layers": 2,
              "intermediate_size": 64, "vocab_size": 128, "attention_bias": True,
              "max_position_embeddings": 4096},
}
PROJ_SCALE = 3.0
TEXTS = ["hello assistant", "what is the weather like today", "one more question"]


def _jax_lm():
    from mlx_audio_tpu.nn.module import map_arrays

    saved = jax_layers._INIT_RNG
    jax_layers._INIT_RNG = np.random.default_rng(0)
    try:
        jm = JaxLM(JaxLlamaConfig(**QWEN))
    finally:
        jax_layers._INIT_RNG = saved
    jm = map_arrays(jm, lambda p, x: x * PROJ_SCALE if p.endswith("proj.weight") else x)
    jm.model.embed_tokens.weight = jm.model.embed_tokens.weight * EMBED_SCALE
    return jm


@pytest.fixture(scope="module")
def lms():
    jm = _jax_lm()
    return jm, _carry(jm, LlamaForCausalLM(LlamaConfig(**QWEN)))


def _pair(lms, tokenizer=None, **kw):
    jm, tm = lms
    kw = {"max_tokens": 24, "temperature": 0.0, **kw}
    return (jax_chat.ChatLM(jm, tokenizer or FakeChatTokenizer(), **kw),
            chat.ChatLM(tm, tokenizer or FakeChatTokenizer(), **kw))


def test_greedy_respond_and_stream_match_jax(lms):
    """Greedy replies and every streamed snapshot equal the JAX package's,
    string for string, with and without history."""
    jc, tc = _pair(lms)
    history = [{"role": "user", "content": "earlier"},
               {"role": "assistant", "content": "an earlier reply"}]
    for text in TEXTS:
        for hist in (None, history):
            want = jc.respond(text, history=hist)
            assert want and tc.respond(text, history=hist) == want
            snaps = list(jc.respond_stream(text, history=hist))
            assert list(tc.respond_stream(text, history=hist)) == snaps
            assert snaps[-1] == want
    # the replies are not one token repeated
    assert len(set(want.split())) > 3


class _PlainTokenizer:
    """A tokenizer without a chat template: both packages fall back to the
    same transcript format and take <|im_end|> as a stop."""

    eos_token_id = [2, 5]
    unk_token_id = 0

    def encode(self, text):
        return [3 + (ord(c) % 60) for c in text][-40:]

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(f"w{i}" for i in ids)

    def convert_tokens_to_ids(self, tok):
        return {"<|im_end|>": 7, "<|eot_id|>": 0}[tok]


def test_plain_tokenizer_transcript_and_stops_match_jax(lms):
    jc, tc = _pair(lms, tokenizer=_PlainTokenizer())
    assert tc._stop_tokens() == jc._stop_tokens() and set(tc._stop_tokens()) == {2, 5, 7}
    msgs = [{"role": "system", "content": "s"}, {"role": "user", "content": "u"}]
    assert tc._tokenize_messages(msgs) == jc._tokenize_messages(msgs)
    assert tc.respond("hello") == jc.respond("hello")


class _LongTokenizer(FakeChatTokenizer):
    """No truncation: a long history overflows the context."""

    def apply_chat_template(self, messages, tokenize=True, add_generation_prompt=True):
        return [3 + (ord(c) % 60) for c in " ".join(m["content"] for m in messages)]


@pytest.mark.parametrize("turns,text", [(0, "short"), (30, "the current question"),
                                        (4, "x" * 400)])
def test_prompt_eviction_and_truncation_match_jax(lms, turns, text, caplog):
    """Drop-oldest eviction, then the tail when the system prompt and the
    user's text alone overflow: the prompt ids equal the JAX package's."""
    jc, tc = _pair(lms, tokenizer=_LongTokenizer())
    history = [{"role": "user" if i % 2 == 0 else "assistant",
                "content": f"turn {i} " + "x" * 40} for i in range(turns)]
    want = jc._build_prompt_ids(text, history)
    got = tc._build_prompt_ids(text, history)
    assert got == want
    assert len(got) <= QWEN["max_position_embeddings"] - tc.max_tokens
    if len(text) > 300:
        assert "truncating to the tail" in caplog.text


@pytest.mark.parametrize("model_type", sorted(HF_CONFIGS))
def test_llama_config_from_hf_matches_jax(model_type):
    cfg = HF_CONFIGS[model_type]
    want = vars(jax_chat.llama_config_from_hf(cfg))
    got = vars(chat.llama_config_from_hf(cfg))
    assert got == want
    assert got["qkv_bias"] == (model_type == "qwen2")
    assert got["use_qk_norm"] == (model_type == "qwen3")


def _hf_weights(jm) -> dict:
    """The JAX model's arrays under HF keys, with the buffers some
    conversions ship, one key without its ``model.`` prefix."""
    from mlx_audio_tpu.nn.module import named_arrays

    out = {k: np.asarray(v) for k, v in named_arrays(jm) if "rope_" not in k}
    out["model.layers.0.self_attn.rotary_emb.inv_freq"] = np.ones(4, np.float32)
    out["model.layers.1.attn.bias"] = np.ones(4, np.float32)
    out["norm.weight"] = out.pop("model.norm.weight")
    return out


def test_sanitize_hf_causal_lm_matches_jax(lms):
    weights = _hf_weights(lms[0])
    want = jax_chat.sanitize_hf_causal_lm(weights)
    got = chat.sanitize_hf_causal_lm(weights)
    assert sorted(got) == sorted(want) and "model.norm.weight" in got
    assert not any("inv_freq" in k or k.endswith(".attn.bias") for k in got)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def _write_hf_dir(path, jm, config):
    from safetensors.numpy import save_file

    path.mkdir(parents=True)
    save_file(_hf_weights(jm), str(path / "model.safetensors"))
    (path / "config.json").write_text(json.dumps(config))
    return path


def test_from_pretrained_local_directory_matches_jax(lms, tmp_path):
    """An HF-layout directory loads in both packages to the same replies;
    with a dtype, every floating tensor but the RoPE tables takes it."""
    config = {"model_type": "qwen2", "hidden_size": 32, "num_attention_heads": 4,
              "num_key_value_heads": 2, "num_hidden_layers": 2, "intermediate_size": 64,
              "vocab_size": 64, "rms_norm_eps": 1e-6, "rope_theta": 1_000_000.0,
              "max_position_embeddings": 160, "tie_word_embeddings": True}
    root = _write_hf_dir(tmp_path / "Qwen2.5-tiny", lms[0], config)
    kw = dict(max_tokens=24, temperature=0.0)
    jc = jax_chat.ChatLM.from_pretrained(str(root), tokenizer=FakeChatTokenizer(), **kw)
    tc = chat.ChatLM.from_pretrained(str(root), tokenizer=FakeChatTokenizer(),
                                     device="cpu", **kw)
    for text in TEXTS:
        assert tc.respond(text) == jc.respond(text)
    b = chat.ChatLM.from_pretrained(str(root), tokenizer=FakeChatTokenizer(),
                                    dtype="bfloat16", device="cpu")
    dtypes = {k: t.dtype for k, t in b.model.state_dict().items()}
    assert dtypes.pop("model.rope_cos") == dtypes.pop("model.rope_sin") == torch.float32
    assert set(dtypes.values()) == {torch.bfloat16}
    jb = jax_chat.ChatLM.from_pretrained(str(root), tokenizer=FakeChatTokenizer(),
                                         dtype=jnp.bfloat16)
    assert jb.model.model.rope_cos.dtype == jnp.float32


def test_from_pretrained_fetches_nothing(tmp_path, monkeypatch, lms):
    """A chat path that is not a local directory raises
    FileNotFoundError naming it and fetches nothing (the JAX package
    downloads the repo); a directory without a tokenizer raises
    RuntimeError naming ``tokenizer=``."""
    import huggingface_hub

    fetched = []
    monkeypatch.setattr(huggingface_hub, "snapshot_download",
                        lambda *a, **k: fetched.append(a))
    with pytest.raises(FileNotFoundError, match="Qwen/Qwen2.5-0.5B-Instruct"):
        chat.ChatLM.from_pretrained("Qwen/Qwen2.5-0.5B-Instruct", device="cpu")
    root = _write_hf_dir(tmp_path / "no-tokenizer", lms[0],
                         {**HF_CONFIGS["qwen2"], "vocab_size": 64,
                          "num_key_value_heads": 2, "max_position_embeddings": 160})
    with pytest.raises(RuntimeError, match="tokenizer="):
        chat.ChatLM.from_pretrained(str(root), device="cpu")
    assert not fetched


def test_prewarm_runs_one_turn_where_jax_warms_a_turn_a_bucket(lms, monkeypatch):
    """Eager PyTorch compiles nothing a prompt length: the port's prewarm
    runs one streamed turn and returns 1, where the JAX package's runs one
    full-budget turn a reachable 64-token bucket (here 64 and 128 of a
    160-token context less 24 generated: 2).  The port's default buckets
    cannot miss a prompt length, so the JAX package's ``max_prompt=512``
    limit has no counterpart."""
    jc, tc = _pair(lms)
    calls = []
    real = chat.generate_tokens
    monkeypatch.setattr(chat, "generate_tokens",
                        lambda *a, **k: calls.append(len(a[1])) or real(*a, **k))
    assert tc.prewarm() == 1 and len(calls) == 1
    assert jc.prewarm() == 2
    assert tc.respond("hello assistant") == jc.respond("hello assistant")
