"""Parakeet's RNN-T and TDT prediction and joint networks (counterpart of
``mlx_audio_tpu/models/stt/parakeet/rnnt.py``).

The prediction network is an embedding and a stack of unidirectional
LSTMs with torch-layout weights (gate order i, f, g, o), stepped one label
at a time as two matmuls a layer: the greedy loop feeds one token a row a
step, so there is no sequence for ``nn.recurrent.lstm_scan``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional

import torch
from torch import nn

from mlx_audio_tpu_torch.nn.layers import Embedding, Linear, _param, _uniform_, promote_operands


@dataclass
class PredictNetworkArgs:
    pred_hidden: int
    pred_rnn_layers: int
    rnn_hidden_size: Optional[int] = None


@dataclass
class JointNetworkArgs:
    joint_hidden: int
    activation: str
    encoder_hidden: int
    pred_hidden: int


@dataclass
class PredictArgs:
    blank_as_pad: bool
    vocab_size: int
    prednet: PredictNetworkArgs


@dataclass
class JointArgs:
    num_classes: int
    vocabulary: List[str]
    jointnet: JointNetworkArgs
    num_extra_outputs: int = 0


class LSTMLayer(nn.Module):
    """One unidirectional LSTM layer: Wx [4H, D], Wh [4H, H], bias [4H]."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.hidden_size = hidden_size
        self.Wx = _param(4 * hidden_size, input_size)
        self.Wh = _param(4 * hidden_size, hidden_size)
        self.bias = _param(4 * hidden_size)

    def init_weights(self, generator: torch.Generator) -> None:
        scale = 1.0 / math.sqrt(self.hidden_size)
        for t in (self.Wx, self.Wh, self.bias):
            _uniform_(t, scale, generator)

    def step(self, x: torch.Tensor, h: torch.Tensor, c: torch.Tensor):
        """x [B, D], h and c [B, H] -> (h', c')."""
        # mixed operands promote, as the JAX package's matmuls do: a bf16
        # model's float32 state keeps the step in float32
        (x, wx), (h, wh) = promote_operands(x, self.Wx), promote_operands(h, self.Wh)
        i, f, g, o = (x @ wx.t() + h @ wh.t() + self.bias).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c), c


class PredictNetwork(nn.Module):
    """Embedding and stacked LSTM, one step at a time."""

    def __init__(self, args: PredictArgs):
        super().__init__()
        self.pred_hidden = args.prednet.pred_hidden
        self.num_layers = args.prednet.pred_rnn_layers
        hidden = args.prednet.rnn_hidden_size or args.prednet.pred_hidden
        self.hidden_size = hidden
        vocab = args.vocab_size + (1 if args.blank_as_pad else 0)
        self.embed = Embedding(vocab, args.prednet.pred_hidden)
        self.lstm = nn.ModuleList(
            LSTMLayer(args.prednet.pred_hidden if i == 0 else hidden, hidden)
            for i in range(self.num_layers))

    def init_state(self, batch: int = 1, dtype=torch.float32, device=None):
        device = device or self.embed.weight.device
        shape = (self.num_layers, batch, self.hidden_size)
        return (torch.zeros(shape, dtype=dtype, device=device),
                torch.zeros(shape, dtype=dtype, device=device))

    def step(self, token: torch.Tensor, state, use_embedding: torch.Tensor):
        """One prediction step.  token [B] (int), use_embedding [B] bool:
        False feeds the zero vector (the blank start).  Returns (output
        [B, H], (h, c) [layers, B, H])."""
        h, c = state
        # the blank start's token may lie past the table (blank_as_pad off):
        # it is looked up in range and masked out
        token = token.clamp(max=self.embed.weight.shape[0] - 1)
        # a float32 zero row, as in the JAX package: jnp.where promotes a
        # bf16 embedding to float32
        x = torch.where(use_embedding[:, None], self.embed(token),
                        torch.zeros((token.shape[0], self.pred_hidden), device=h.device))
        new_h, new_c = [], []
        for i, layer in enumerate(self.lstm):
            x, ci = layer.step(x, h[i], c[i])
            new_h.append(x)
            new_c.append(ci)
        return x, (torch.stack(new_h), torch.stack(new_c))


class JointNetwork(nn.Module):
    def __init__(self, args: JointArgs):
        super().__init__()
        self.num_classes = args.num_classes + 1 + args.num_extra_outputs
        self.activation = args.jointnet.activation.lower()
        self.pred = Linear(args.jointnet.pred_hidden, args.jointnet.joint_hidden)
        self.enc = Linear(args.jointnet.encoder_hidden, args.jointnet.joint_hidden)
        self.joint = Linear(args.jointnet.joint_hidden, self.num_classes)

    def forward(self, enc: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
        """enc [B, D_enc], pred [B, D_pred] -> logits [B, classes]."""
        x = self.enc(enc) + self.pred(pred)
        if self.activation == "relu":
            x = torch.relu(x)
        elif self.activation == "sigmoid":
            x = torch.sigmoid(x)
        else:
            x = torch.tanh(x)
        return self.joint(x)
