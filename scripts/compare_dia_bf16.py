"""Dia in bf16 against float32, in the JAX package and in the port, on the
same weights, on the CPU.

The weights are the port's seeded init at Dia-1.6B's published widths
(``DiaConfig()``; chip_smoke.py's seed 0 and its channel-0 EOS column at 0)
with the depth cut to fit a CPU host, carried into the JAX model through
``convert.params_to_jax``.  The JAX package's float32 greedy CFG codes of
chip_smoke.py's Dia text are fed, teacher-forced, for 5 steps through four
models: JAX float32, JAX after ``astype(jnp.bfloat16)`` (bf16 caches),
the port float32 and the port after ``.to(torch.bfloat16)``.  Prints each
package's relative RMS of the bf16 decoder logits [steps, 2, C, V] from
its float32 ones (the measure chip_smoke.py holds the card's bf16 Dia to)
and the RMS difference of the CFG logits.

    JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/compare_dia_bf16.py \\
        --encoder-layers 12 --decoder-layers 12
"""

import argparse
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

import mlx_audio_tpu.models.tts.dia.model as jax_dia
from mlx_audio_tpu.models.tts.dia import Model as JaxDia
from mlx_audio_tpu.models.tts.dia.config import DiaConfig as JaxDiaConfig
from mlx_audio_tpu.nn.module import update_arrays
from mlx_audio_tpu_torch.convert import params_to_jax
from mlx_audio_tpu_torch.models.tts.dia import DiaConfig, Model

TEXT = "[S1] The port speaks in a voice of its own. [S2] And it answers."
STEPS = 5  # chip_smoke.py's BF16_TF_STEPS + 1
CFG_SCALE = 3.0
VALID = 1025  # the codes and EOS


def jax_logits(model, dtype, codes=None):
    """Decoder logits [steps, 2, C, V] of ``model`` teacher-forced on
    ``codes`` [steps, C]; without codes, the greedy CFG codes it picks
    (with the delay pattern's BOS forcing) are fed and returned."""
    data = model.config.data
    delay = np.asarray(data.delay_pattern)
    src, pos, pad, mask = model._prepare_text_input(TEXT)
    src2 = jnp.concatenate([jnp.zeros_like(src), src])
    pos2, pad2, mask2 = (jnp.concatenate([a, a]) for a in (pos, pad, mask))
    _, kv = jax_dia._encode_text_jit(model.model, src2, pos2, mask2)
    kv, ca = jax_dia._trim_cross(kv, pad2)
    cache = model.model.decoder.init_cache(2, 64, dtype=dtype)
    step = jax.jit(type(model.model.decoder).step)
    out, fed = [], [np.full(data.channels, data.audio_bos_value)]
    for t in range(STEPS):
        cur = fed[t] if codes is None else codes[t]
        frame = np.stack([cur, cur])[:, None]
        lg, cache = step(model.model.decoder, jnp.asarray(frame), jnp.asarray([[t]]), cache,
                         kv, None, ca)
        lg = np.asarray(lg, np.float64)[:, 0]
        out.append(lg)
        fed.append(np.where(t >= delay, cfg(lg)[..., :VALID].argmax(-1), data.audio_bos_value))
    return np.stack(out), np.stack(fed)


def port_logits(model, codes):
    caches, kv, ca, _ = model._start([TEXT], 64)
    out = []
    with torch.no_grad():
        for t in range(STEPS):
            frame = torch.as_tensor(codes[t], dtype=torch.long)
            lg, _ = model.model.decoder.step(frame[None, None].expand(2, 1, -1),
                                             torch.full((1, 1), t), caches, kv, None, ca)
            out.append(lg[:, 0].double().numpy())
    return np.stack(out)


def cfg(lg):
    """(uncond, cond) logits [..., 2, C, V] -> CFG logits [..., C, V]."""
    uncond, cond = np.moveaxis(lg, -3, 0)
    return cond + CFG_SCALE * (cond - uncond)


def rel_rms(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b ** 2)))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--encoder-layers", type=int, default=12)
    parser.add_argument("--decoder-layers", type=int, default=12)
    args = parser.parse_args()
    t0 = time.perf_counter()
    config = DiaConfig()
    config.model.encoder.n_layer = args.encoder_layers
    config.model.decoder.n_layer = args.decoder_layers
    port = Model(config, device="cpu", seed=0)
    with torch.no_grad():
        port.model.decoder.logits_dense.weight[:, 0, 1024] = 0
    jm = JaxDia(JaxDiaConfig.load_dict(dataclasses.asdict(config)))
    jm = jm.tree_replace(model=update_arrays(
        jm.model, params_to_jax(port.model.state_dict(), port.model), strict=True))
    with jax.default_matmul_precision("highest"):
        jax_f32, codes = jax_logits(jm, jnp.float32)
        jax_bf16, _ = jax_logits(jm.astype(jnp.bfloat16), jnp.bfloat16, codes)
    port_f32 = port_logits(port, codes)
    port_bf16 = port_logits(port.to(torch.bfloat16), codes)

    def cfg_diff(a, b):
        d = cfg(a)[..., :VALID] - cfg(b)[..., :VALID]
        return float(np.sqrt(np.mean(d ** 2)))

    print(f"Dia at DiaConfig's widths, {args.encoder_layers} encoder and "
          f"{args.decoder_layers} decoder layers, {STEPS} teacher-forced steps: "
          f"bf16 against float32, relative RMS: JAX {rel_rms(jax_bf16, jax_f32):.4e}, "
          f"port {rel_rms(port_bf16, port_f32):.4e}; CFG logits' RMS difference: JAX "
          f"{cfg_diff(jax_bf16, jax_f32):.4e}, port {cfg_diff(port_bf16, port_f32):.4e}; "
          f"port against JAX: float32 {rel_rms(port_f32, jax_f32):.3e}, bf16 "
          f"{rel_rms(port_bf16, jax_bf16):.4e}; {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
