"""Whisper, Bark, Dia, IndexTTS and Parakeet in bf16 in the port against the
JAX package's bf16, on the CPU at the tiny configs of their float32 twins
(the twins of tests/test_bf16_families.py's Dia, IndexTTS and Parakeet CTC
tests, and of the JAX package's bf16 paths of Whisper and Bark, which it
tests nowhere).

A model in bf16 is the float32 pair of the family's twin file cast with
``.to(torch.bfloat16)`` and ``.astype(jnp.bfloat16)``; both carry the same
bf16 weights.  Each family computes where the JAX package computes:
Whisper's encoder, caches and decoder in bf16 with float32 scores, masks and
logits; Bark's three GPTs in bf16 with float32 scores and logits; Dia's
encoder and decoder in bf16 with float32 scores and logits (its head
promotes); Parakeet's encoder and joint in float32 over bf16 weights (the
float32 log-mel promotes its first conv); IndexTTS's conditioning, prompt
and vocoder in float32, its decode steps over bf16 caches.

Both frameworks round to bf16 at their own places, so logits are held to
``REL_RMS`` and greedy codes to JAX's wherever JAX's winner beats its
runner-up by more than one bf16 step of its logit (``bf16_step``); a row is
not compared past its first differing code, which must be such a near-tie:
there the histories part.  The JAX
PRNG cannot be reproduced, so sampled paths run greedy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_bf16 import rel_rms

BF16 = torch.bfloat16
# teacher-forced logits and features of the bf16 models against JAX's
# (1.9e-3 to 8.2e-3 at the runs here)
REL_RMS = 3e-2


@jax.jit
def _bf16_jax(module):
    """``module.astype(jnp.bfloat16)``, in one compiled call."""
    return module.astype(jnp.bfloat16)


def bf16_step(v) -> np.ndarray:
    """The spacing of bf16 values at |v|: 2^(e - 7) for 2^e <= |v| < 2^(e + 1)."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(np.asarray(v, np.float64)), 1e-30)))
                   - 7)


def near_ties(logits) -> np.ndarray:
    """Where a row of float logits [..., V] is a near-tie: its winner leads
    its runner-up by one bf16 step of the winner's logit or less."""
    top = np.sort(np.asarray(logits, np.float64), axis=-1)[..., -2:]
    return top[..., 1] - top[..., 0] <= bf16_step(top[..., 1])


# ---------------------------------------------------------------------------
# Dia
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dia_bf16():
    from test_dia import tiny_dia
    from test_torch_dia import _seeded, port_pair

    jm = _seeded(tiny_dia)
    return _bf16_jax(jm), port_pair(jm).to(BF16)


# greedy decode steps of the Dia runs
DIA_STEPS = 20


def _dia_cfg(logits, scale: float = 3.0) -> np.ndarray:
    """Step logits [2, 1, C, V] of one (uncond, cond) pair -> the greedy
    pick's CFG logits [C, V] over the valid classes, as both packages form
    them (the top-k threshold does not move the argmax)."""
    lg = np.asarray(logits, np.float64)[:, 0]
    cfg = lg[1] + scale * (lg[1] - lg[0])
    cfg[:, 1025:] = -np.inf
    return cfg


def test_dia_bf16_greedy_codes_and_logits_match_jax(dia_bf16, monkeypatch):
    """The twin of tests/test_bf16_families.py's Dia test, greedy.  JAX's
    greedy decode steps its decoder (one compiled step) from its own start
    state, taking the CFG argmax with the delay's BOS forcing as
    ``_dia_chunk`` does; its codes are fed teacher-forced through the
    port's decoder from the port's ``_start``: the float32 logits within
    REL_RMS, the port's argmax equal to JAX's codes wherever JAX's winner
    leads by more than one bf16 step.  The port's ``_generate`` gives JAX's
    codes up to a step where JAX's winner leads by one bf16 step or less.
    The caches are bf16, the logits float32; the DAC given at construction
    is cast and decodes to finite float32 audio."""
    import mlx_audio_tpu.models.tts.dia.model as jax_dia
    from mlx_audio_tpu_torch.models.tts import dia
    from test_torch_dia import TEXT

    jm, tm = dia_bf16
    data = jm.config.data
    assert next(tm._dac.parameters()).dtype == BF16
    seen = []
    fn = dia.model.codebook_to_audio
    monkeypatch.setattr(dia.model, "codebook_to_audio", lambda codes, *a, **kw: (
        seen.append(np.asarray(codes)), fn(codes, *a, **kw))[1])
    audio, n = tm._generate(TEXT, max_tokens=DIA_STEPS, temperature=0.0)
    assert audio.dtype == np.float32 and audio.size and np.isfinite(audio).all()
    pcodes = seen[0].T                                           # [T, C], BOS first

    src, pos, pad, mask = jm._prepare_text_input(TEXT)
    src2 = jnp.concatenate([jnp.zeros_like(src), src])
    pos2, pad2, mask2 = (jnp.concatenate([a, a]) for a in (pos, pad, mask))
    _, jkv = jax_dia._encode_text_jit(jm.model, src2, pos2, mask2)
    jkv, jca = jax_dia._trim_cross(jkv, pad2)
    jcache = jm.model.decoder.init_cache(2, 64, dtype=jnp.bfloat16)
    tcache, tkv, tca, _ = tm._start([TEXT], 64)
    assert tcache[0].k.dtype == BF16 and tkv[0][0].dtype == BF16
    jstep = jax.jit(type(jm.model.decoder).step)
    delay = np.asarray(data.delay_pattern)
    jcodes = [np.full(data.channels, data.audio_bos_value)]
    jl, tl = [], []
    for t in range(DIA_STEPS):
        frame = np.stack([jcodes[t], jcodes[t]])[:, None]
        ref, jcache = jstep(jm.model.decoder, jnp.asarray(frame), jnp.asarray([[t]]), jcache,
                            jkv, None, jca)
        with torch.no_grad():
            got, _ = tm.model.decoder.step(torch.as_tensor(frame), torch.tensor([[t]]), tcache,
                                           tkv, None, tca)
        assert ref.dtype == jnp.float32 and got.dtype == torch.float32
        jl.append(_dia_cfg(ref))
        tl.append(_dia_cfg(got))
        jcodes.append(np.where(t >= delay, jl[-1].argmax(-1), data.audio_bos_value))
    jl, tl, jcodes = np.stack(jl), np.stack(tl), np.stack(jcodes)   # [T, C, V], [T + 1, C]
    fin = np.isfinite(jl)
    assert rel_rms(tl[fin], jl[fin]) <= REL_RMS
    # channel c is forced to BOS until step t reaches its delay
    free = np.arange(DIA_STEPS)[:, None] >= delay[None, :]
    tie = near_ties(jl)
    assert (tl.argmax(-1) == jcodes[1:])[free & ~tie].all()
    # the port's own greedy run parts from JAX's only at a near-tie: its
    # first differing frame comes from a step where JAX's winner led by one
    # bf16 step or less in a channel past its delay
    assert n == len(pcodes) == DIA_STEPS + 1
    differ = (pcodes != jcodes).any(-1)
    if differ.any():
        assert (free & tie)[int(np.argmax(differ)) - 1].any()


# ---------------------------------------------------------------------------
# Bark
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bark_bf16():
    from test_torch_bark import pair

    jm, tm = pair.__wrapped__()
    return _bf16_jax(jm), tm.to(BF16)


def _record_draws(monkeypatch):
    """Every call of both packages' ``_cat_rows`` (the semantic, coarse and
    fine draws, in order): the float logits [B, ..., V] it drew from and the
    tokens it drew."""
    import mlx_audio_tpu.models.tts.bark.bark as jax_bark
    from mlx_audio_tpu_torch.models.tts.bark import bark as port_bark

    seen = {"jax": [], "port": []}
    jfn, pfn = jax_bark._cat_rows, port_bark._cat_rows

    def jax_draw(key, logits, temperature):
        out = jfn(key, logits, temperature)
        jax.debug.callback(lambda lg, tok: seen["jax"].append((np.asarray(lg, np.float64),
                                                               np.asarray(tok))),
                           logits, out, ordered=True)
        return out

    def port_draw(logits, temperature, seed=None, noise=None):
        out = pfn(logits, temperature, seed, noise)
        seen["port"].append((logits.double().numpy(), out.numpy()))
        return out

    monkeypatch.setattr(jax_bark, "_cat_rows", jax_draw)
    monkeypatch.setattr(port_bark, "_cat_rows", port_draw)
    return seen


def test_bark_bf16_generate_batch_codes_match_jax(bark_bf16, monkeypatch):
    """``generate_batch`` of two texts at the greedy temperature (the EnCodec
    given is cast too): every draw of the three stages in order, each row
    held up to its first token that differs from JAX's; until then both
    packages draw from logits of the same history, as teacher forcing on
    JAX's tokens would.  The logits within REL_RMS, the tokens equal
    wherever JAX's winner leads by more than one bf16 step, so the first
    differing token is a near-tie.  The audio is float32 in the port (an
    exact upcast of the bf16 EnCodec's) and finite."""
    from test_torch_bark import GREEDY

    jm, tm = bark_bf16
    assert next(tm._codec.parameters()).dtype == BF16
    seen = _record_draws(monkeypatch)
    want = jm.generate_batch(["hi there", "another text"], temperature=GREEDY, max_steps=12)
    got = tm.generate_batch(["hi there", "another text"], temperature=GREEDY, max_steps=12)
    assert len(seen["port"]) == len(seen["jax"]) > 12
    live = np.ones(2, bool)
    held = {"semantic": 0, "coarse": 0, "fine": 0}
    for (jl, jt), (pl, pt) in zip(seen["jax"], seen["port"]):
        assert jl.shape == pl.shape
        rows = np.nonzero(live)[0]
        if not len(rows):
            break
        fin = np.isfinite(jl[rows])
        assert rel_rms(pl[rows][fin], jl[rows][fin]) <= REL_RMS
        tie = near_ties(jl).reshape(len(jl), -1)
        same = (pt == jt).reshape(len(jt), -1)
        stage = ("fine" if jl.ndim == 3 else "semantic" if jl.shape[-1] == 10001
                 else "coarse")
        for b in rows:
            assert same[b][~tie[b]].all()
            held[stage] += int(same[b].size)
            live[b] = same[b].all()
    assert min(held.values()) > 0, held
    for g, w in zip(got, want):
        assert g.samples == w.samples > 0
        assert g.audio.dtype == np.float32 and np.isfinite(g.audio).all()


# ---------------------------------------------------------------------------
# Whisper
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def whisper_bf16():
    from mlx_audio_tpu.models.stt.whisper import transcribe as jtr
    from mlx_audio_tpu.models.stt.whisper.tokenizer import Tokenizer as JaxTokenizer
    from mlx_audio_tpu_torch.models.stt.whisper import transcribe
    from mlx_audio_tpu_torch.models.stt.whisper.tokenizer import Tokenizer
    from test_torch_whisper import pair_of
    from test_whisper import tiny_dims, tiny_encoding

    enc = tiny_encoding()
    kw = dict(num_languages=4, language="en", task="transcribe")
    toks = JaxTokenizer(encoding=enc, **kw), Tokenizer(encoding=enc, **kw)
    jm, pm = pair_of(tiny_dims(toks[0]), jtr.Model, transcribe.Model)
    return (_bf16_jax(jm), pm.to(BF16)), toks


@pytest.mark.parametrize("beam_size", [None, 2], ids=["greedy", "beam2"])
def test_whisper_bf16_decode_matches_jax(whisper_bf16, beam_size):
    """``decode`` of a float32 log-mel: both cast it to conv1's dtype, so
    the encoder, the cross keys and the caches run in bf16.  The features
    within REL_RMS, the tokens and text equal, the log-probability within
    REL_RMS."""
    from mlx_audio_tpu.models.stt.whisper import api as japi
    from mlx_audio_tpu.models.stt.whisper import decoding as jdec
    from mlx_audio_tpu_torch.models.stt.whisper import api, decoding

    (jm, pm), (jt, pt) = whisper_bf16
    mel = (np.random.default_rng(3).standard_normal((200, 80)) * 0.1).astype(np.float32)
    opts = dict(temperature=0.0, beam_size=beam_size)
    rj = japi.decode(jm, jnp.asarray(mel), jdec.DecodingOptions(**opts), tokenizer=jt)
    rp = api.decode(pm, mel, decoding.DecodingOptions(**opts), tokenizer=pt)
    assert rp.audio_features.dtype == BF16
    assert rel_rms(rp.audio_features, rj.audio_features) <= REL_RMS
    assert len(rp.tokens) > 2 and rp.tokens == rj.tokens and rp.text == rj.text
    assert abs(rp.avg_logprob - rj.avg_logprob) <= REL_RMS * abs(rj.avg_logprob)


def test_whisper_bf16_generate_word_timestamps_matches_jax(whisper_bf16, monkeypatch):
    """``generate`` with word timestamps on 2 s of noise: the text, each
    segment's tokens and bounds, and each word and its start and end equal
    JAX's (the alignment heads' DTW over the bf16 attention)."""
    from mlx_audio_tpu.models.stt.whisper import transcribe as jtr
    from mlx_audio_tpu_torch.models.stt.whisper import transcribe

    (jm, pm), toks = whisper_bf16
    monkeypatch.setattr(jtr.Model, "_tokenizer", lambda self, language=None, task=None: toks[0])
    monkeypatch.setattr(transcribe.Model, "_tokenizer",
                        lambda self, language=None, task=None: toks[1])
    audio = (np.random.default_rng(5).standard_normal(2 * 16000) * 0.05).astype(np.float32)
    kw = dict(temperature=0.0, language="en", no_speech_threshold=None,
              logprob_threshold=None, compression_ratio_threshold=None, word_timestamps=True)
    oj, op = jm.generate(audio, **kw), pm.generate(audio, **kw)
    assert op.text == oj.text and len(op.segments) == len(oj.segments)
    words = 0
    for a, b in zip(oj.segments, op.segments):
        assert (b["tokens"], b["start"], b["end"]) == (a["tokens"], a["start"], a["end"])
        assert [(w["word"], w["start"], w["end"]) for w in b["words"]] == [
            (w["word"], w["start"], w["end"]) for w in a["words"]]
        words += len(b["words"])
    assert words > 1


# ---------------------------------------------------------------------------
# Parakeet
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("head", ["tdt", "rnnt", "ctc"])
def test_parakeet_bf16_decode_matches_jax(head):
    """The twin of tests/test_bf16_families.py's Parakeet CTC test, and the
    TDT and RNN-T heads: ``generate`` of 0.5 s, the text and every token's
    id, text, start and duration equal JAX's.  The float32 log-mel promotes
    the first conv, so the encoder (and the joint, and the prediction net's
    float32 state) run in float32 over the bf16 weights in both packages:
    the encoder's output is float32 and within the float32 twins'
    tolerance of JAX's."""
    from test_parakeet import ctc_config, tdt_config
    from test_torch_parakeet import TOL, _audio, _tokens, pair_of, rnnt_config

    cfg = {"tdt": tdt_config, "rnnt": rnnt_config, "ctc": ctc_config}[head]()
    jm, tm = pair_of(cfg)
    jm, tm = _bf16_jax(jm), tm.to(BF16)
    assert tm.encoder.pre_encode.conv[0].weight.dtype == BF16
    audio = _audio(4, 8000)
    rj, rt = jm.generate(audio), tm.generate(audio)
    assert rt.text == rj.text and _tokens(rt) == _tokens(rj) and _tokens(rt)
    mel = np.random.default_rng(5).standard_normal((2, 97, 80)).astype(np.float32)
    jf, jlen = jm.encoder(jnp.asarray(mel))
    with torch.no_grad():
        tf, tlen = tm.encoder(torch.as_tensor(mel))
    assert jf.dtype == jnp.float32 and tf.dtype == torch.float32
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), **TOL)


# ---------------------------------------------------------------------------
# IndexTTS
# ---------------------------------------------------------------------------


def test_indextts_bf16_generate_matches_jax(monkeypatch):
    """The twin of tests/test_bf16_families.py's IndexTTS test, greedy: the
    float32 reference mel takes the conformer, the perceiver and the
    prompt to float32 (the prefill's latent is float32); the decode steps
    run over bf16 caches (their latents bf16); the vocoder's latents are
    stacked float32, so BigVGAN runs in float32 over bf16 weights.  The
    codes equal JAX's (no near-tie is crossed at this seed), the latent
    stream within REL_RMS, the audio float32 and finite."""
    from mlx_audio_tpu_torch.models.tts.indextts.vocoder import BigVGANConditioning
    from test_torch_indextts import TEXT, jax_run, pair

    jm, tm = pair.__wrapped__()
    jm, tm = _bf16_jax(jm), tm.to(BF16)
    ref_mel = np.random.default_rng(5).standard_normal((1, 21, 16)).astype(np.float32)
    _, jcodes, jlat = jax_run(jm, [TEXT], ref_mel, max_tokens=12, chunk=4, temperature=0)
    caches, steps, voc_in = [], [], []
    start, step, forward = tm._start, tm._step, BigVGANConditioning.forward
    monkeypatch.setattr(tm, "_start", lambda *a, **k: (lambda out: (
        caches.append(out[0]), out)[1])(start(*a, **k)))
    monkeypatch.setattr(tm, "_step", lambda *a, **k: (lambda out: (
        steps.append(out.dtype), out)[1])(step(*a, **k)))
    monkeypatch.setattr(BigVGANConditioning, "forward", lambda self, x, *a, **k: (
        voc_in.append(x.dtype), forward(self, x, *a, **k))[1])
    streams, codes = tm.generate_latents([TEXT], torch.as_tensor(ref_mel), max_tokens=12,
                                         temperature=0)
    (result,) = tm.generate_batch([TEXT], ref_mel=ref_mel, max_tokens=12, temperature=0)
    assert codes == jcodes and len(codes[0]) > 2
    assert caches[0][0].k.dtype == BF16 and set(steps) == {BF16}
    assert streams[0].dtype == torch.float32
    (want,) = jlat[streams[0].shape[0]]
    assert rel_rms(streams[0], want) <= REL_RMS
    assert voc_in and set(voc_in) == {torch.float32}
    assert result.audio.dtype == np.float32 and np.isfinite(result.audio).all()
    assert result.audio.size == 4 * len(codes[0])
