"""Weight bridge from the JAX package's parameter layout to the port's.

``params_from_jax`` is the one place that knows both layouts.  The JAX
package stores convolutions channels last as ``[K, Cin, Cout]`` and the port
stores them in torch's layouts, so:

* conv weight (and WN ``weight_v``) ``[K, Cin, Cout]`` -> ``[Cout, Cin, K]``;
* transposed conv ``[K, Cin, Cout]`` -> ``[Cin, Cout, K]``, and depthwise
  transposed conv ``[K, C, 1]`` -> ``[C, 1, K]``;
* WN ``weight_g`` ``[1, 1, Cout]`` (conv, output axis) or ``[1, Cin, 1]``
  (transposed conv, input axis) -> ``[C, 1, 1]`` on the same axis; the
  wav2vec2 positional conv's per-tap ``weight_g`` ``[K, 1, 1]`` -> torch's
  ``weight_norm(dim=2)`` layout ``[1, 1, K]``;
* 2-d conv weight HWIO ``[kh, kw, Cin/groups, Cout]`` -> OIHW ``[Cout,
  Cin/groups, kh, kw]`` (Parakeet's ``Conv2dLayer``);
* everything else (linear ``[out, in]``, LSTM, norms, embeddings, snake
  alphas, CSM's ``audio_head`` [nc-1, Dm, V], Dia's ``DenseGeneral``
  weights [in..., out...], RoPE tables, quantized uint8 codes with their
  float32 scales and biases, batch-norm running statistics, FSQ tables)
  keeps its layout, dtype and name (bf16 arrays bit for bit).

The layout of a 3-d ``weight`` or ``weight_v`` follows the type of the
module of the port ``module`` that owns it, not its path or its rank: a
conv (``Conv1d``, grouped ones such as Vocos's depthwise ``dwconv`` too,
``WNConv1d``, ``StreamableConv1d``, EnCodec's ``EncodecConv1d``, and
wav2vec2's ``PositionalConvEmbedding``, whose ``g`` is per tap) or a
transposed conv (``WNConvTranspose1d``, the depthwise one of Spark's
``SamplingBlock`` too, ``StreamableConvTranspose1d``, EnCodec's
``EncodecConvTranspose1d``; DAC's sits at ``decoder.model.N.block.1`` and
SNAC's at ``decoder.blocks.i.pre.1``).
A 4-d ``weight`` moves when its owner is Parakeet's ``Conv2dLayer`` (IndexTTS's
conformer subsampling reuses it).  The sinusoid table ``pe`` that IndexTTS's
``RelPositionalEncoding`` keeps among the JAX model's arrays is computed, not
learned: the port's module computes its own and the array is dropped.  Any
other owner keeps the array as it is (IndexTTS's 2-d perceiver ``latents``
and attention ``pos_bias_u``/``pos_bias_v`` too).  Tests feed it
``dict(named_arrays(jax_model))`` as numpy arrays, and ``from_pretrained``
the output of a JAX-layout ``sanitize``; the port never imports JAX to use
it.

``params_to_jax`` is its exact inverse: a port state_dict back to the JAX
paths and channels-last layouts, as numpy arrays (bf16 as
``ml_dtypes.bfloat16``, uint8 codes and their scales as they are).  It is
the writing side of the native checkpoint format that both packages read
(``utils.loader.save_checkpoint``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def conv_kinds(module: nn.Module) -> dict[str, str]:
    """{path: "conv", "conv_tap", "convt", "conv2d" or "table"} of the
    convs, the per-tap weight-normed positional convs, the transposed convs,
    the 2-d convs and the computed position tables in a port module."""
    from mlx_audio_tpu_torch.codec.encodec.encodec import (
        EncodecConv1d,
        EncodecConvTranspose1d,
    )
    from mlx_audio_tpu_torch.models.stt.parakeet.conformer import Conv2dLayer
    from mlx_audio_tpu_torch.models.stt.wav2vec.wav2vec import PositionalConvEmbedding
    from mlx_audio_tpu_torch.models.tts.indextts.attention import RelPositionalEncoding
    from mlx_audio_tpu_torch.nn.layers import Conv1d, WNConv1d, WNConvTranspose1d
    from mlx_audio_tpu_torch.nn.streaming import (
        StreamableConv1d,
        StreamableConvTranspose1d,
    )

    kinds = {}
    for name, m in module.named_modules():
        if isinstance(m, (Conv1d, WNConv1d, StreamableConv1d, EncodecConv1d)):
            kinds[name] = "conv"
        elif isinstance(m, PositionalConvEmbedding):
            kinds[name] = "conv_tap"
        elif isinstance(m, (WNConvTranspose1d, StreamableConvTranspose1d,
                            EncodecConvTranspose1d)):
            kinds[name] = "convt"
        elif isinstance(m, Conv2dLayer):
            kinds[name] = "conv2d"
        elif isinstance(m, RelPositionalEncoding):
            kinds[name] = "table"
    return kinds


def params_from_jax(named: dict[str, np.ndarray],
                    module: nn.Module) -> dict[str, torch.Tensor]:
    """JAX ``named_arrays`` paths and arrays -> a state_dict for the port's
    ``module`` of the same architecture."""
    kinds = conv_kinds(module)
    out = {}
    for key, w in named.items():
        w = np.asarray(w)
        kind = kinds.get(key.rpartition(".")[0])
        if kind == "table":
            continue
        if w.ndim == 3 and key.endswith("weight_g"):
            w = w.reshape((1, 1, -1) if kind == "conv_tap" else (-1, 1, 1))
        elif w.ndim == 3 and key.endswith(("weight_v", "weight")):
            if kind == "convt":
                w = w.transpose(1, 2, 0)  # [K, Cin, Cout] -> [Cin, Cout, K]
            elif kind in ("conv", "conv_tap"):
                w = w.transpose(2, 1, 0)  # [K, Cin, Cout] -> [Cout, Cin, K]
        elif w.ndim == 4 and key.endswith("weight") and kind == "conv2d":
            w = w.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        out[key] = to_tensor(w)
    return out


def to_tensor(w: np.ndarray) -> torch.Tensor:
    """A copy of ``w`` as a tensor of its dtype.  A bf16 array (numpy's
    ``ml_dtypes.bfloat16``, which torch does not take) crosses bit for bit
    as its uint16 view."""
    if w.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(w).view(np.uint16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.tensor(w)


def params_to_jax(state: dict[str, torch.Tensor],
                  module: nn.Module) -> dict[str, np.ndarray]:
    """A state_dict of the port's ``module`` -> the JAX package's
    ``named_arrays`` paths and layouts, as numpy arrays; the inverse of
    :func:`params_from_jax` (the computed tables it drops stay dropped)."""
    kinds = conv_kinds(module)
    out = {}
    for key, t in state.items():
        w = to_numpy(t)
        kind = kinds.get(key.rpartition(".")[0])
        if kind == "table":
            continue
        if w.ndim == 3 and key.endswith("weight_g"):
            w = w.reshape((-1, 1, 1) if kind == "conv_tap"
                          else (1, -1, 1) if kind == "convt" else (1, 1, -1))
        elif w.ndim == 3 and key.endswith(("weight_v", "weight")):
            if kind == "convt":
                w = w.transpose(2, 0, 1)  # [Cin, Cout, K] -> [K, Cin, Cout]
            elif kind in ("conv", "conv_tap"):
                w = w.transpose(2, 1, 0)  # [Cout, Cin, K] -> [K, Cin, Cout]
        elif w.ndim == 4 and key.endswith("weight") and kind == "conv2d":
            w = w.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        out[key] = np.ascontiguousarray(w)
    return out


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` as a numpy array of its dtype; bf16 as
    ``ml_dtypes.bfloat16`` through its uint16 view, bit for bit."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()
