"""SEANet encoder and decoder, Mimi's convolutional backbone, batch and
stateful paths (counterpart of ``mlx_audio_tpu/codec/mimi/seanet.py``).
NLC layout.  A streaming state is a nested dict of conv carries from
``init_state``, threaded through ``step``; Mimi's chunks are whole frames,
so both branches of every residual always align."""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from mlx_audio_tpu_torch.nn.streaming import (
    StreamableConv1d,
    StreamableConvTranspose1d,
)


@dataclass
class SeanetConfig:
    dimension: int
    channels: int
    causal: bool
    nfilters: int
    nresidual_layers: int
    ratios: list
    ksize: int
    residual_ksize: int
    last_ksize: int
    dilation_base: int
    pad_mode: str
    true_skip: bool
    compress: int


class SeanetResnetBlock(nn.Module):
    def __init__(self, cfg: SeanetConfig, dim: int, ksizes_and_dilations: list):
        super().__init__()
        hidden = dim // cfg.compress
        block = []
        for i, (ksize, dilation) in enumerate(ksizes_and_dilations):
            in_ch = dim if i == 0 else hidden
            out_ch = dim if i == len(ksizes_and_dilations) - 1 else hidden
            block.append(StreamableConv1d(in_ch, out_ch, ksize, dilation=dilation,
                                          causal=cfg.causal, pad_mode=cfg.pad_mode))
        self.block = nn.ModuleList(block)
        self.shortcut = (None if cfg.true_skip else StreamableConv1d(
            dim, dim, 1, causal=cfg.causal, pad_mode=cfg.pad_mode))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x
        for conv in self.block:
            x = conv(F.elu(x))
        return x + (residual if self.shortcut is None else self.shortcut(residual))

    def init_state(self, batch: int, dtype=None) -> dict:
        state = {"block": [c.init_state(batch, dtype) for c in self.block]}
        if self.shortcut is not None:
            state["shortcut"] = self.shortcut.init_state(batch, dtype)
        return state

    def step(self, state: dict, x: torch.Tensor):
        residual = x
        new_block = []
        for conv, s in zip(self.block, state["block"]):
            x, s = conv.step(s, F.elu(x))
            new_block.append(s)
        new_state = {"block": new_block}
        if self.shortcut is None:
            return x + residual, new_state
        sc, new_state["shortcut"] = self.shortcut.step(state["shortcut"], residual)
        return x + sc, new_state


def _residuals(cfg: SeanetConfig, dim: int) -> nn.ModuleList:
    return nn.ModuleList(
        SeanetResnetBlock(cfg, dim, [(cfg.residual_ksize, cfg.dilation_base ** i), (1, 1)])
        for i in range(cfg.nresidual_layers))


class EncoderLayer(nn.Module):
    def __init__(self, cfg: SeanetConfig, ratio: int, mult: int):
        super().__init__()
        self.residuals = _residuals(cfg, mult * cfg.nfilters)
        self.downsample = StreamableConv1d(
            mult * cfg.nfilters, mult * cfg.nfilters * 2, ratio * 2,
            stride=ratio, causal=True, pad_mode=cfg.pad_mode)

    def forward(self, x):
        for r in self.residuals:
            x = r(x)
        return self.downsample(F.elu(x))

    def init_state(self, batch: int, dtype=None) -> dict:
        return {"residuals": [r.init_state(batch, dtype) for r in self.residuals],
                "downsample": self.downsample.init_state(batch, dtype)}

    def step(self, state: dict, x: torch.Tensor):
        rs = []
        for r, s in zip(self.residuals, state["residuals"]):
            x, s = r.step(s, x)
            rs.append(s)
        x, ds = self.downsample.step(state["downsample"], F.elu(x))
        return x, {"residuals": rs, "downsample": ds}


class SeanetEncoder(nn.Module):
    def __init__(self, cfg: SeanetConfig):
        super().__init__()
        self.init_conv1d = StreamableConv1d(cfg.channels, cfg.nfilters, cfg.ksize,
                                            causal=cfg.causal, pad_mode=cfg.pad_mode)
        self.layers = nn.ModuleList(
            EncoderLayer(cfg, ratio, 2 ** i) for i, ratio in enumerate(reversed(cfg.ratios)))
        mult = 2 ** len(cfg.ratios)
        self.final_conv1d = StreamableConv1d(
            mult * cfg.nfilters, cfg.dimension, cfg.last_ksize,
            causal=cfg.causal, pad_mode=cfg.pad_mode)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, T, channels] -> [B, T / prod(ratios), dimension]."""
        x = self.init_conv1d(x)
        for layer in self.layers:
            x = layer(x)
        return self.final_conv1d(F.elu(x))

    def init_state(self, batch: int, dtype=None) -> dict:
        return {"init": self.init_conv1d.init_state(batch, dtype),
                "layers": [layer.init_state(batch, dtype) for layer in self.layers],
                "final": self.final_conv1d.init_state(batch, dtype)}

    def step(self, state: dict, x: torch.Tensor):
        x, si = self.init_conv1d.step(state["init"], x)
        ls = []
        for layer, s in zip(self.layers, state["layers"]):
            x, s = layer.step(s, x)
            ls.append(s)
        x, sf = self.final_conv1d.step(state["final"], F.elu(x))
        return x, {"init": si, "layers": ls, "final": sf}


class DecoderLayer(nn.Module):
    def __init__(self, cfg: SeanetConfig, ratio: int, mult: int):
        super().__init__()
        self.upsample = StreamableConvTranspose1d(
            mult * cfg.nfilters, mult * cfg.nfilters // 2, ratio * 2,
            stride=ratio, causal=cfg.causal)
        self.residuals = _residuals(cfg, mult * cfg.nfilters // 2)

    def forward(self, x):
        x = self.upsample(F.elu(x))
        for r in self.residuals:
            x = r(x)
        return x

    def init_state(self, batch: int, dtype=None) -> dict:
        return {"upsample": self.upsample.init_state(batch, dtype),
                "residuals": [r.init_state(batch, dtype) for r in self.residuals]}

    def step(self, state: dict, x: torch.Tensor):
        x, us = self.upsample.step(state["upsample"], F.elu(x))
        rs = []
        for r, s in zip(self.residuals, state["residuals"]):
            x, s = r.step(s, x)
            rs.append(s)
        return x, {"upsample": us, "residuals": rs}


class SeanetDecoder(nn.Module):
    def __init__(self, cfg: SeanetConfig):
        super().__init__()
        mult = 1 << len(cfg.ratios)
        self.init_conv1d = StreamableConv1d(cfg.dimension, mult * cfg.nfilters,
                                            cfg.ksize, causal=cfg.causal,
                                            pad_mode=cfg.pad_mode)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, ratio, mult >> i) for i, ratio in enumerate(cfg.ratios))
        self.final_conv1d = StreamableConv1d(cfg.nfilters, cfg.channels,
                                             cfg.last_ksize, causal=cfg.causal,
                                             pad_mode=cfg.pad_mode)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.init_conv1d(x)
        for layer in self.layers:
            x = layer(x)
        return self.final_conv1d(F.elu(x))

    def init_state(self, batch: int, dtype=None) -> dict:
        return {"init": self.init_conv1d.init_state(batch, dtype),
                "layers": [layer.init_state(batch, dtype) for layer in self.layers],
                "final": self.final_conv1d.init_state(batch, dtype)}

    def step(self, state: dict, x: torch.Tensor):
        x, si = self.init_conv1d.step(state["init"], x)
        ls = []
        for layer, s in zip(self.layers, state["layers"]):
            x, s = layer.step(s, x)
            ls.append(s)
        x, sf = self.final_conv1d.step(state["final"], F.elu(x))
        return x, {"init": si, "layers": ls, "final": sf}
