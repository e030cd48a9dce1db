"""Weight bridge from the JAX package's parameter layout to the port's.

``params_from_jax`` is the one place that knows both layouts.  The JAX
package stores convolutions channels last as ``[K, Cin, Cout]`` and the port
stores them in torch's layouts, so:

* conv weight (and WN ``weight_v``) ``[K, Cin, Cout]`` -> ``[Cout, Cin, K]``;
* transposed conv ``[K, Cin, Cout]`` -> ``[Cin, Cout, K]``, and depthwise
  transposed conv ``[K, C, 1]`` -> ``[C, 1, K]``;
* WN ``weight_g`` ``[1, 1, Cout]`` (conv, output axis) or ``[1, Cin, 1]``
  (transposed conv, input axis) -> ``[C, 1, 1]`` on the same axis;
* everything else (linear ``[out, in]``, LSTM, norms, embeddings, snake
  alphas, CSM's ``audio_head`` [nc-1, Dm, V], RoPE tables, quantized uint8
  codes with their float32 scales and biases) keeps its layout, dtype and
  name.

A key is a transposed conv when the module of the port ``module`` that
owns it is one (``WNConvTranspose1d``, ``StreamableConvTranspose1d``), not
by its path: DAC's sits at ``decoder.model.N.block.1`` and SNAC's at
``decoder.blocks.i.pre.1``.  Tests feed it
``dict(named_arrays(jax_model))`` as numpy arrays, and ``from_pretrained``
the output of a JAX-layout ``sanitize``; the port never imports JAX to use
it.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def transposed_convs(module: nn.Module) -> set[str]:
    """Paths of the transposed convs in a port module."""
    from mlx_audio_tpu_torch.nn.layers import WNConvTranspose1d
    from mlx_audio_tpu_torch.nn.streaming import StreamableConvTranspose1d

    return {name for name, m in module.named_modules()
            if isinstance(m, (WNConvTranspose1d, StreamableConvTranspose1d))}


def params_from_jax(named: dict[str, np.ndarray],
                    module: nn.Module) -> dict[str, torch.Tensor]:
    """JAX ``named_arrays`` paths and arrays -> a state_dict for the port's
    ``module`` of the same architecture."""
    convt = transposed_convs(module)
    out = {}
    for key, w in named.items():
        w = np.asarray(w)
        if w.ndim == 3 and key.endswith("weight_g"):
            w = w.reshape(-1, 1, 1)
        elif w.ndim == 3 and key.endswith(("weight_v", "weight")):
            if key.rpartition(".")[0] in convt:
                w = w.transpose(1, 2, 0)  # [K, Cin, Cout] -> [Cin, Cout, K]
            else:
                w = w.transpose(2, 1, 0)  # [K, Cin, Cout] -> [Cout, Cin, K]
        out[key] = torch.tensor(w)
    return out
