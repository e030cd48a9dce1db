"""Where the Kokoro twin's port and JAX part, over JAX init seeds.

``tests/test_torch_kokoro.py::test_slice_matches_jax`` holds the port's
audio to the JAX package's within ``AUDIO_ATOL`` past ``HEAD``.  This
script builds that test's models at each seed of the JAX init RNG, runs the
test's comparison, and records three stages on both sides as they run:
SineGen's sine waves (``_f02sine_hl``, after its float32 phase cumsum) and
the decoder's magnitude and phase at the ISTFT.  It prints, a seed a line,
the audio's largest difference past ``HEAD`` and each stage's past the same
point; then the float32 cumsum's spread alone: the same phase increments
summed by torch and by JAX on the CPU, each against float64.

    JAX_PLATFORMS=cpu python tests/kokoro_seed_spread.py [seed ...]

(seeds 0-15 by default, about 20 s a seed on 8 CPU cores).
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import mlx_audio_tpu.nn.layers as jax_layers  # noqa: E402
import test_torch_kokoro as twin  # noqa: E402
from mlx_audio_tpu.models.tts.kokoro import istftnet as jax_istft  # noqa: E402
from mlx_audio_tpu.models.tts.kokoro.model import _duration_stage, _synthesis_stage  # noqa: E402
from mlx_audio_tpu_torch.models.tts.kokoro import duration_stage, istftnet  # noqa: E402
from mlx_audio_tpu_torch.models.tts.kokoro import synthesis_stage  # noqa: E402

STAGES = ("sine", "magnitude", "phase")


def recorders():
    """Both packages' SineGen and ISTFT wrapped to keep their last stage
    values (JAX's through ``jax.debug.callback``, under jit); returns the
    record and a function that puts the originals back."""
    rec = {"jax": {}, "port": {}}
    saved = [(jax_istft.TorchSTFT, "inverse"), (jax_istft.SineGen, "_f02sine_hl"),
             (istftnet.TorchSTFT, "inverse"), (istftnet.SineGen, "_f02sine_hl")]
    saved = [(cls, name, getattr(cls, name)) for cls, name in saved]
    j_inv, j_sine, t_inv, t_sine = (f for _, _, f in saved)

    def keep(side, name):
        return lambda x: rec[side].__setitem__(name, np.asarray(x, dtype=np.float64))

    def jax_inverse(self, magnitude, phase):
        jax.debug.callback(keep("jax", "magnitude"), magnitude)
        jax.debug.callback(keep("jax", "phase"), phase)
        return j_inv(self, magnitude, phase)

    def jax_sine(self, fn, key):
        out = j_sine(self, fn, key)
        jax.debug.callback(keep("jax", "sine"), out)
        return out

    def port_inverse(self, magnitude, phase):
        keep("port", "magnitude")(magnitude.detach().double().numpy())
        keep("port", "phase")(phase.detach().double().numpy())
        return t_inv(self, magnitude, phase)

    def port_sine(self, fn, rand_ini):
        out = t_sine(self, fn, rand_ini)
        keep("port", "sine")(out.detach().double().numpy())
        return out

    jax_istft.TorchSTFT.inverse, jax_istft.SineGen._f02sine_hl = jax_inverse, jax_sine
    istftnet.TorchSTFT.inverse, istftnet.SineGen._f02sine_hl = port_inverse, port_sine

    def restore():
        for cls, name, fn in saved:
            setattr(cls, name, fn)

    return rec, restore


def compare(seed: int, rec: dict) -> dict:
    """test_slice_matches_jax's comparison with the models built at
    ``seed``: the audio's largest difference past HEAD and where it is,
    and each stage's largest past the same point."""
    jax_layers._INIT_RNG = np.random.default_rng(seed)
    jax_model = twin.JaxModel(twin.tiny_config())
    port = twin.Model(twin._port_config(), device="cpu")
    port.load_state_dict(twin.params_from_jax(
        {k: np.asarray(v) for k, v in twin.named_arrays(jax_model)}, port))
    ids, lengths, ref, speed = twin._inputs()
    d_j, dur_j = _duration_stage(jax_model, jnp.asarray(ids, jnp.int32),
                                 jnp.asarray(lengths, jnp.int32),
                                 jnp.asarray(ref[:, 128:]), jnp.asarray(speed))
    with torch.no_grad():
        d_t, _ = duration_stage(port, torch.as_tensor(ids), torch.as_tensor(lengths),
                                torch.as_tensor(ref[:, 128:]), torch.as_tensor(speed))
    dur = np.minimum(np.asarray(dur_j), 3)
    frames, key = 100, jax.random.PRNGKey(0)
    audio_j, _ = _synthesis_stage(
        jax_model, jnp.asarray(ids, jnp.int32), jnp.asarray(lengths, jnp.int32), d_j,
        jnp.asarray(dur), jnp.asarray(ref), key, jnp.zeros((frames,), jnp.int32))
    rand_ini, noise = twin._source_draws(key, 2, frames)
    with torch.no_grad():
        audio_t, _ = synthesis_stage(port, torch.as_tensor(ids), torch.as_tensor(lengths),
                                     d_t, torch.as_tensor(dur), torch.as_tensor(ref),
                                     frames, rand_ini, noise)
    jax.effects_barrier()
    diff = np.abs(np.asarray(audio_j) - audio_t.numpy())[:, twin.HEAD:]
    row, sample = np.unravel_index(diff.argmax(), diff.shape)
    out = {"audio": float(diff.max()), "row": int(row), "sample": int(sample) + twin.HEAD}
    samples = audio_t.shape[-1]
    for stage in STAGES:
        a, b = rec["jax"][stage], rec["port"][stage]
        d = np.abs(np.angle(np.exp(1j * (a - b)))) if stage == "phase" else np.abs(a - b)
        # past HEAD: samples of the sine waves [B, H, L], frames at the ISTFT [B, F, bins]
        d = d[..., twin.HEAD:] if stage == "sine" else d[:, twin.HEAD * a.shape[1] // samples:]
        out[stage] = float(d.max())
    # the decoder's phase is a sine: the ISTFT's unwrap has no 2 pi jump to remove
    out["max |phase|"] = float(np.abs(rec["port"]["phase"]).max())
    return out


def cumsum_order(scale: int = 300) -> dict:
    """The same float32 phase increments (U(0, 0.5), 200 frames, 9
    harmonics, 2 rows) summed by torch and by JAX on the CPU and scaled as
    SineGen scales them (2 pi, then the upsampling factor): each against
    float64, and against each other."""
    rad = np.random.default_rng(0).uniform(0, 0.5, (2, 9, 200)).astype(np.float32)
    f64 = np.cumsum(rad.astype(np.float64), -1) * 2 * np.pi * scale
    t = (torch.cumsum(torch.from_numpy(rad), -1) * 2 * np.pi).numpy() * scale
    j = np.asarray(jnp.cumsum(jnp.asarray(rad), -1) * 2 * jnp.pi) * scale
    return {"max phase (rad)": float(f64.max()), "torch from float64": float(np.abs(t - f64).max()),
            "jax from float64": float(np.abs(j - f64).max()),
            "torch from jax": float(np.abs(t - j).max()),
            "sin, torch from jax": float(np.abs(np.sin(t.astype(np.float32))
                                                - np.sin(j.astype(np.float32))).max())}


def main(argv=None) -> None:
    seeds = [int(s) for s in (argv if argv is not None else sys.argv[1:])] or range(16)
    rec, restore = recorders()
    try:
        rows = {seed: compare(seed, rec) for seed in seeds}
    finally:
        restore()
    for seed, row in rows.items():
        print(f"seed {seed}: " + ", ".join(
            f"{k} {v:.3e}" if isinstance(v, float) else f"{k} {v}" for k, v in row.items()),
            flush=True)
    audio = [r["audio"] for r in rows.values()]
    print(f"audio past HEAD over seeds {min(seeds)}-{max(seeds)}: {min(audio):.3e} to "
          f"{max(audio):.3e}, median {float(np.median(audio)):.3e}; over AUDIO_ATOL "
          f"({twin.AUDIO_ATOL}) at seeds {[s for s, r in rows.items() if r['audio'] > twin.AUDIO_ATOL]}")
    print("float32 cumsum order alone: " + ", ".join(
        f"{k} {v:.4g}" for k, v in cumsum_order().items()))


if __name__ == "__main__":
    main()
