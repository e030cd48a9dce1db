"""LSTM with the input projection hoisted into one matmul and the recurrence
in one kernel (counterpart of ``mlx_audio_tpu/nn/recurrent.py``).

Gate packing follows torch's LSTM order (i, f, g, o), so checkpoints map
one to one.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from mlx_audio_tpu_torch.nn import kernels
from mlx_audio_tpu_torch.nn.layers import _param, _uniform_


def lstm_scan(x_proj: torch.Tensor, w_h: torch.Tensor, h0: torch.Tensor,
              c0: torch.Tensor, reverse: bool = False,
              return_cells: bool = False):
    """Run the LSTM recurrence.

    x_proj: [B, L, 4H] precomputed input gates (+ biases); w_h: [4H, H].
    Returns (hidden states [B, L, H], final (h, c)); with ``return_cells``,
    (hidden states, cell states [B, L, H], final (h, c)).

    A CUDA tensor runs the LSTM kernel, a CPU tensor its plain version.  The
    reverse direction flips time, runs forward and flips back.
    """
    xp = x_proj.flip(1) if reverse else x_proj
    hs, cs, (h_t, c_t) = kernels.lstm(xp.contiguous(), w_h.t().contiguous(),
                                      h0.contiguous(), c0.contiguous())
    if reverse:
        hs, cs = hs.flip(1), cs.flip(1)
    if return_cells:
        return hs, cs, (h_t, c_t)
    return hs, (h_t, c_t)


def masked_flip(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Reverse each row's valid prefix: out[b, t] = x[b, len_b-1-t] (0 beyond).

    This makes bidirectional RNNs exact under padding to a bucket: the
    backward pass starts at the last valid step, not the padded tail.
    """
    l = x.shape[1]
    idx = lengths[:, None] - 1 - torch.arange(l, device=x.device)[None, :]
    valid = idx >= 0
    idx_c = idx.clamp(0, l - 1).long()
    out = torch.gather(x, 1, idx_c[..., None].expand(-1, -1, x.shape[-1]))
    return torch.where(valid[..., None], out, torch.zeros((), dtype=x.dtype,
                                                          device=x.device))


class LSTM(nn.Module):
    """Single-layer (optionally bidirectional) LSTM over [B, L, D] input.

    ``Wx_forward`` [4H, D], ``Wh_forward`` [4H, H], ``bias_ih_forward``,
    ``bias_hh_forward`` and the ``_backward`` set, as in the JAX package.
    """

    def __init__(self, input_size: int, hidden_size: int, bias: bool = True,
                 bidirectional: bool = True):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.bidirectional = bidirectional
        h4 = 4 * hidden_size
        directions = ("forward", "backward") if bidirectional else ("forward",)
        for d in directions:
            setattr(self, f"Wx_{d}", _param(h4, input_size))
            setattr(self, f"Wh_{d}", _param(h4, hidden_size))
            setattr(self, f"bias_ih_{d}", _param(h4) if bias else None)
            setattr(self, f"bias_hh_{d}", _param(h4) if bias else None)

    def init_weights(self, generator: torch.Generator) -> None:
        scale = 1.0 / math.sqrt(self.hidden_size)
        for p in self.parameters(recurse=False):
            _uniform_(p, scale, generator)

    def _run(self, x, direction, reverse, return_cells=False):
        wx = getattr(self, f"Wx_{direction}")
        b_ih = getattr(self, f"bias_ih_{direction}")
        b_hh = getattr(self, f"bias_hh_{direction}")
        x_proj = x @ wx.t()
        if b_ih is not None:
            x_proj = x_proj + b_ih + b_hh
        h0 = torch.zeros((x.shape[0], self.hidden_size), dtype=x.dtype,
                         device=x.device)
        return lstm_scan(x_proj, getattr(self, f"Wh_{direction}"), h0, h0,
                         reverse=reverse, return_cells=return_cells)

    @staticmethod
    def _final_at(states: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """Each row's state at its last valid step: [B, L, H] -> [B, H]."""
        idx = (lengths - 1).clamp(min=0).long()
        return states[torch.arange(states.shape[0], device=states.device), idx]

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor] = None):
        """x: [B, L, D] (or [L, D]) -> ([B, L, H*dirs], final states).

        With ``lengths`` [B], the backward direction runs over each row's
        flipped valid prefix, and final states come from each row's last
        valid step, so padded buckets give exact results.
        """
        squeeze = x.dim() == 2
        if squeeze:
            x = x[None]
        if lengths is None:
            fwd, (hf, cf) = self._run(x, "forward", reverse=False)
        else:
            fwd, cells_f, _ = self._run(x, "forward", reverse=False,
                                        return_cells=True)
            hf, cf = self._final_at(fwd, lengths), self._final_at(cells_f, lengths)
        if not self.bidirectional:
            out, state = fwd, (hf, cf)
        else:
            if lengths is None:
                bwd, (hb, cb) = self._run(x, "backward", reverse=True)
            else:
                bwd_r, cells_b, _ = self._run(masked_flip(x, lengths),
                                              "backward", reverse=False,
                                              return_cells=True)
                bwd = masked_flip(bwd_r, lengths)
                hb = self._final_at(bwd_r, lengths)
                cb = self._final_at(cells_b, lengths)
            out = torch.cat([fwd, bwd], dim=-1)
            state = ((hf, cf), (hb, cb))
        if squeeze:
            out = out[0]
        return out, state
