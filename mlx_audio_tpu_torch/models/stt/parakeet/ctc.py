"""Parakeet's CTC head (counterpart of
``mlx_audio_tpu/models/stt/parakeet/ctc.py``): a K = 1 conv to the
vocabulary and the blank, then log-softmax.  The conv takes the library
route of ``nn.layers.conv1d``."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import torch
from torch import nn

from mlx_audio_tpu_torch.nn.layers import Conv1d


@dataclass
class ConvASRDecoderArgs:
    feat_in: int
    num_classes: int
    vocabulary: List[str]


@dataclass
class AuxCTCArgs:
    decoder: ConvASRDecoderArgs


class ConvASRDecoder(nn.Module):
    def __init__(self, args: ConvASRDecoderArgs):
        super().__init__()
        num_classes = (len(args.vocabulary) if args.num_classes <= 0
                       else args.num_classes) + 1
        self.decoder_layers = nn.ModuleList([Conv1d(args.feat_in, num_classes, 1, bias=True)])
        self.temperature = 1.0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.log_softmax(self.decoder_layers[0](x) / self.temperature, dim=-1)
