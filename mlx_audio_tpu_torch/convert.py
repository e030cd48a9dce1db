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

The transposed convs are recognised by a path component, as the JAX
package's sanitizers recognise them: in Kokoro the ``ups`` upsamplers and
the ``pool`` depthwise upsamplers; in Mimi ``upsample`` (SEANet's
``DecoderLayer.upsample`` and Mimi's depthwise ``upsample``).  Mimi's
``downsample`` is an ordinary conv.  Tests feed it
``dict(named_arrays(jax_model))`` as numpy arrays; the port never imports
JAX to use it.
"""

from __future__ import annotations

import numpy as np
import torch


def _is_transposed_conv(key: str) -> bool:
    parts = key.split(".")
    return "ups" in parts or "pool" in parts or "upsample" in parts


def params_from_jax(named: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """JAX ``named_arrays`` paths and arrays -> a state_dict for the port's
    module of the same architecture."""
    out = {}
    for key, w in named.items():
        w = np.asarray(w)
        if w.ndim == 3 and key.endswith("weight_g"):
            w = w.reshape(-1, 1, 1)
        elif w.ndim == 3 and key.endswith(("weight_v", "weight")):
            if _is_transposed_conv(key):
                w = w.transpose(1, 2, 0)  # [K, Cin, Cout] -> [Cin, Cout, K]
            else:
                w = w.transpose(2, 1, 0)  # [K, Cin, Cout] -> [Cout, Cin, K]
        out[key] = torch.tensor(w)
    return out
