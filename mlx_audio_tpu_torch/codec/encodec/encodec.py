"""EnCodec (Meta), the causal streamable SEANet codec with an LSTM bottleneck
(counterpart of ``mlx_audio_tpu/codec/encodec/encodec.py``).

Sequences are channels last, ``[batch, length, channels]``, as in the JAX
package.  Every conv pads itself (causal or asymmetric, reflect by default)
and then runs ``nn.layers.conv1d`` with no padding, which is the library
route; the transposed convs trim their right side.  Each ``UniLSTM``
projects its input in one matmul and runs the recurrence through
``nn.recurrent.lstm_scan``, so ``kernels.lstm`` on a card: at the published
24 kHz config the two encoder and two decoder LSTMs are 512 wide, which
``kernels.lstm_route`` sends to the row route.  Codes are the argmin of
squared distances to each codebook, residual over the quantizers a
bandwidth selects.  A model with ``chunk_length_s`` encodes and decodes
chunk by chunk, each scaled by its RMS when ``normalize`` is set, and joins
the decoded chunks by linear overlap-add.

``Encodec(config, device="cuda", seed=0)`` draws its weights on ``device``
from ``seed``; checkpoints load through ``from_pretrained`` (a local
directory).  Weight norm lives only in the sanitizers: the modules hold
folded weights.
"""

from __future__ import annotations

import functools
import math
import re
from dataclasses import dataclass
from typing import List, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mlx_audio_tpu_torch.models.base import BaseModelArgs, init_weights, model_device
from mlx_audio_tpu_torch.nn.layers import (
    _param,
    _uniform_,
    conv1d,
    conv_transpose1d,
    promote_operands,
)
from mlx_audio_tpu_torch.nn.recurrent import lstm_scan


@dataclass
class EncodecConfig(BaseModelArgs):
    model_type: str = "encodec"
    audio_channels: int = 1
    num_filters: int = 32
    kernel_size: int = 7
    num_residual_layers: int = 1
    dilation_growth_rate: int = 2
    codebook_size: int = 1024
    codebook_dim: int = 128
    hidden_size: int = 128
    num_lstm_layers: int = 2
    residual_kernel_size: int = 3
    use_causal_conv: bool = True
    normalize: bool = False
    pad_mode: str = "reflect"
    norm_type: str = "weight_norm"
    last_kernel_size: int = 7
    trim_right_ratio: float = 1.0
    compress: int = 2
    upsampling_ratios: Optional[List[int]] = None
    target_bandwidths: Optional[List[float]] = None
    sampling_rate: int = 24000
    chunk_length_s: Optional[float] = None
    overlap: Optional[float] = None


def encodec_24khz_config() -> EncodecConfig:
    """The published 24 kHz codec (``facebook/encodec_24khz``'s
    ``config.json``): 32 filters, ratios [8, 5, 4, 2], two 512-wide LSTM
    layers, codebooks of 1024 x 128, 1.5 to 24 kbps."""
    return EncodecConfig(upsampling_ratios=[8, 5, 4, 2],
                         target_bandwidths=[1.5, 3.0, 6.0, 12.0, 24.0])


def preprocess_audio(raw_audio, sampling_rate: int = 24000,
                     chunk_length: Optional[int] = None,
                     chunk_stride: Optional[int] = None):
    """Batch and pad waveforms -> (inputs [B, T, C] float32, masks [B, T]
    bool), on the CPU."""
    if not isinstance(raw_audio, list):
        raw_audio = [raw_audio]
    raw_audio = [np.asarray(x) for x in raw_audio]
    raw_audio = [x[..., None] if x.ndim == 1 else x for x in raw_audio]
    max_length = max(x.shape[0] for x in raw_audio)
    if chunk_length is not None:
        max_length += chunk_length - (max_length % chunk_stride)
    inputs, masks = [], []
    for x in raw_audio:
        mask = np.ones((x.shape[0],), dtype=bool)
        diff = max_length - x.shape[0]
        if diff > 0:
            mask = np.pad(mask, (0, diff))
            x = np.pad(x, ((0, diff), (0, 0)))
        inputs.append(x)
        masks.append(mask)
    return (torch.as_tensor(np.stack(inputs), dtype=torch.float32),
            torch.as_tensor(np.stack(masks)))


def _pad_time(x: torch.Tensor, left: int, right: int, mode: str) -> torch.Tensor:
    """Pad the time axis of NLC ``x``: zeros, or numpy's 'reflect' (the
    edge sample not repeated; pads longer than the signal reflect again)."""
    if mode != "reflect":
        return F.pad(x, (0, 0, left, right))
    length = x.shape[1]
    idx = torch.arange(-left, length + right, device=x.device)
    if length == 1:
        idx = torch.zeros_like(idx)
    else:
        period = 2 * (length - 1)
        idx = idx.remainder(period)
        idx = torch.where(idx >= length, period - idx, idx)
    return x.index_select(1, idx)


class GroupNorm1(nn.Module):
    """GroupNorm(1, C) over NLC input (the 48 kHz model's
    ``time_group_norm``)."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = _param(channels)
        self.bias = _param(channels)

    def init_weights(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        mean = x.mean(dim=(-2, -1), keepdim=True)
        var = x.var(dim=(-2, -1), keepdim=True, correction=0)
        return (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias


class EncodecConv1d(nn.Module):
    """Conv with EnCodec's causal or asymmetric padding; weight [out, in, k]."""

    def __init__(self, config: EncodecConfig, in_channels: int,
                 out_channels: int, kernel_size: int, stride: int = 1,
                 dilation: int = 1):
        super().__init__()
        self.causal = config.use_causal_conv
        self.pad_mode = config.pad_mode
        self.stride = stride
        self.dilation = dilation
        self.ksize_eff = (kernel_size - 1) * dilation + 1
        self.padding_total = kernel_size - stride
        self.fan_in = in_channels * kernel_size
        self.weight = _param(out_channels, in_channels, kernel_size)
        self.bias = _param(out_channels)
        self.norm = (GroupNorm1(out_channels)
                     if config.norm_type == "time_group_norm" else None)

    def init_weights(self, generator: torch.Generator) -> None:
        _uniform_(self.weight, 1.0 / math.sqrt(self.fan_in), generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x):
        length = x.shape[1]
        n_frames = (length - self.ksize_eff + self.padding_total) / self.stride + 1
        ideal = ((math.ceil(n_frames) - 1) * self.stride + self.ksize_eff
                 - self.padding_total)
        extra = ideal - length
        if self.causal:
            left, right = self.padding_total, extra
        else:
            right = self.padding_total // 2
            left, right = self.padding_total - right, right + extra
        x = _pad_time(x, left, right, self.pad_mode)
        y = conv1d(x, self.weight, self.stride, 0, self.dilation) + self.bias
        return self.norm(y) if self.norm is not None else y


class EncodecConvTranspose1d(nn.Module):
    """Transposed conv with EnCodec's right trim; weight [in, out, k]."""

    def __init__(self, config: EncodecConfig, in_channels: int,
                 out_channels: int, kernel_size: int, stride: int = 1):
        super().__init__()
        self.causal = config.use_causal_conv
        self.trim_right_ratio = config.trim_right_ratio
        self.padding_total = kernel_size - stride
        self.stride = stride
        self.fan_in = in_channels * kernel_size
        self.weight = _param(in_channels, out_channels, kernel_size)
        self.bias = _param(out_channels)
        self.norm = (GroupNorm1(out_channels)
                     if config.norm_type == "time_group_norm" else None)

    def init_weights(self, generator: torch.Generator) -> None:
        _uniform_(self.weight, 1.0 / math.sqrt(self.fan_in), generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x):
        y = conv_transpose1d(x, self.weight, self.stride) + self.bias
        if self.norm is not None:
            y = self.norm(y)
        if self.causal:
            right = math.ceil(self.padding_total * self.trim_right_ratio)
        else:
            right = self.padding_total // 2
        left = self.padding_total - right
        return y[:, left:y.shape[1] - right, :]


class UniLSTM(nn.Module):
    """Unidirectional LSTM with EnCodec's one fused bias: ``Wx`` [4H, in],
    ``Wh`` [4H, H], ``bias`` [4H] (torch's bias_ih + bias_hh)."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.hidden_size = hidden_size
        self.Wx = _param(4 * hidden_size, input_size)
        self.Wh = _param(4 * hidden_size, hidden_size)
        self.bias = _param(4 * hidden_size)

    def init_weights(self, generator: torch.Generator) -> None:
        scale = 1.0 / math.sqrt(self.hidden_size)
        for p in (self.Wx, self.Wh, self.bias):
            _uniform_(p, scale, generator)

    def forward(self, x):
        x, wx = promote_operands(x, self.Wx)
        x_proj = x @ wx.t() + self.bias
        h0 = torch.zeros((x.shape[0], self.hidden_size), dtype=x.dtype,
                         device=x.device)
        out, _ = lstm_scan(x_proj, self.Wh, h0, h0)
        return out


class EncodecLSTM(nn.Module):
    def __init__(self, config: EncodecConfig, dimension: int):
        super().__init__()
        self.lstm = nn.ModuleList(UniLSTM(dimension, dimension)
                                  for _ in range(config.num_lstm_layers))

    def forward(self, x):
        h = x
        for lstm in self.lstm:
            h = lstm(h)
        return h + x


class Elu(nn.Module):
    def forward(self, x):
        return F.elu(x, alpha=1.0)


class EncodecResnetBlock(nn.Module):
    def __init__(self, config: EncodecConfig, dim: int, dilations):
        super().__init__()
        kernel_sizes = (config.residual_kernel_size, 1)
        hidden = dim // config.compress
        block = []
        for i, (k, d) in enumerate(zip(kernel_sizes, dilations)):
            in_chs = dim if i == 0 else hidden
            out_chs = dim if i == len(kernel_sizes) - 1 else hidden
            block.append(Elu())
            block.append(EncodecConv1d(config, in_chs, out_chs, k, dilation=d))
        self.block = nn.ModuleList(block)
        self.shortcut = EncodecConv1d(config, dim, dim, kernel_size=1)

    def forward(self, x):
        residual = x
        for layer in self.block:
            x = layer(x)
        return self.shortcut(residual) + x


class EncodecEncoder(nn.Module):
    def __init__(self, config: EncodecConfig):
        super().__init__()
        model = [EncodecConv1d(config, config.audio_channels,
                               config.num_filters, config.kernel_size)]
        scaling = 1
        for ratio in reversed(config.upsampling_ratios):
            cur = scaling * config.num_filters
            for j in range(config.num_residual_layers):
                model.append(EncodecResnetBlock(
                    config, cur, [config.dilation_growth_rate ** j, 1]))
            model.append(Elu())
            model.append(EncodecConv1d(config, cur, cur * 2,
                                       kernel_size=ratio * 2, stride=ratio))
            scaling *= 2
        model.append(EncodecLSTM(config, scaling * config.num_filters))
        model.append(Elu())
        model.append(EncodecConv1d(config, scaling * config.num_filters,
                                   config.hidden_size, config.last_kernel_size))
        self.layers = nn.ModuleList(model)

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


class EncodecDecoder(nn.Module):
    def __init__(self, config: EncodecConfig):
        super().__init__()
        scaling = int(2 ** len(config.upsampling_ratios))
        model = [EncodecConv1d(config, config.hidden_size,
                               scaling * config.num_filters, config.kernel_size)]
        model.append(EncodecLSTM(config, scaling * config.num_filters))
        for ratio in config.upsampling_ratios:
            cur = scaling * config.num_filters
            model.append(Elu())
            model.append(EncodecConvTranspose1d(config, cur, cur // 2,
                                                kernel_size=ratio * 2,
                                                stride=ratio))
            for j in range(config.num_residual_layers):
                model.append(EncodecResnetBlock(
                    config, cur // 2, (config.dilation_growth_rate ** j, 1)))
            scaling //= 2
        model.append(Elu())
        model.append(EncodecConv1d(config, config.num_filters,
                                   config.audio_channels, config.last_kernel_size))
        self.layers = nn.ModuleList(model)

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


class EncodecEuclideanCodebook(nn.Module):
    def __init__(self, config: EncodecConfig):
        super().__init__()
        self.embed = _param(config.codebook_size, config.codebook_dim)

    def init_weights(self, generator: torch.Generator) -> None:
        _uniform_(self.embed, 1.0, generator)

    def encode(self, x):
        """[..., D] -> int32 codes [...], the argmin of squared distances."""
        flat = x.reshape(-1, x.shape[-1])
        emb = self.embed
        # each norm in its own dtype, the product promoted, as in the JAX
        # package
        f, e = promote_operands(flat, emb)
        dist = ((flat * flat).sum(1, keepdim=True) - 2 * f @ e.t()
                + (emb * emb).sum(1)[None, :])
        return torch.argmin(dist, dim=-1).reshape(x.shape[:-1]).to(torch.int32)

    def decode(self, codes):
        return F.embedding(codes.long(), self.embed)


class EncodecVectorQuantization(nn.Module):
    def __init__(self, config: EncodecConfig):
        super().__init__()
        self.codebook = EncodecEuclideanCodebook(config)

    def encode(self, x):
        return self.codebook.encode(x)

    def decode(self, codes):
        return self.codebook.decode(codes)


class EncodecResidualVectorQuantizer(nn.Module):
    def __init__(self, config: EncodecConfig):
        super().__init__()
        self.codebook_size = config.codebook_size
        hop_length = int(np.prod(config.upsampling_ratios))
        self.frame_rate = math.ceil(config.sampling_rate / hop_length)
        self.num_quantizers = int(
            1000 * config.target_bandwidths[-1] // (self.frame_rate * 10))
        self.layers = nn.ModuleList(EncodecVectorQuantization(config)
                                    for _ in range(self.num_quantizers))

    def get_num_quantizers_for_bandwidth(self, bandwidth: Optional[float] = None) -> int:
        bw_per_q = math.log2(self.codebook_size) * self.frame_rate
        n = self.num_quantizers
        if bandwidth is not None and bandwidth > 0.0:
            n = int(max(1, math.floor(bandwidth * 1000 / bw_per_q)))
        return n

    def encode(self, embeddings, bandwidth: Optional[float] = None):
        """[B, T, D] -> codes [B, nq, T]."""
        nq = self.get_num_quantizers_for_bandwidth(bandwidth)
        residual = embeddings
        out = []
        for layer in self.layers[:nq]:
            indices = layer.encode(residual)
            residual = residual - layer.decode(indices)
            out.append(indices)
        return torch.stack(out, dim=1)

    def decode(self, codes):
        """codes [B, nq, T] -> [B, T, D]."""
        out = None
        for i in range(codes.shape[1]):
            q = self.layers[i].decode(codes[:, i])
            out = q if out is None else out + q
        return out


class Encodec(nn.Module):
    def __init__(self, config: Union[EncodecConfig, dict, None] = None,
                 device: str = "cuda", seed: int = 0):
        super().__init__()
        if isinstance(config, dict):
            config = EncodecConfig.from_dict(config)
        config = config or encodec_24khz_config()
        device = model_device(device, "Encodec")
        self.config = config
        with torch.device(device):
            self.encoder = EncodecEncoder(config)
            self.decoder = EncodecDecoder(config)
            self.quantizer = EncodecResidualVectorQuantizer(config)
        init_weights(self, torch.Generator(device).manual_seed(seed))
        self.device = device

    @property
    def chunk_length(self):
        if self.config.chunk_length_s is None:
            return None
        return int(self.config.chunk_length_s * self.config.sampling_rate)

    @property
    def chunk_stride(self):
        if self.config.chunk_length_s is None or self.config.overlap is None:
            return None
        return max(1, int((1.0 - self.config.overlap) * self.chunk_length))

    @torch.no_grad()
    def _encode_frame(self, x, bandwidth, padding_mask):
        scale = None
        if self.config.normalize:
            x = x * padding_mask[..., None]
            mono = x.sum(dim=2, keepdim=True) / x.shape[2]
            scale = torch.sqrt((mono ** 2).mean(dim=1, keepdim=True)) + 1e-8
            x = x / scale
        return self.quantizer.encode(self.encoder(x), bandwidth), scale

    def encode(self, input_values, padding_mask=None,
               bandwidth: Optional[float] = None):
        """[B, T, C] NLC -> (codes [n_chunks, B, nq, T'], scales: one [B, 1,
        1] or None a chunk).  A tensor keeps its dtype (bf16 audio into a bf16
        model encodes in bf16; float32 promotes), an array becomes float32,
        as in the JAX package."""
        if bandwidth is None:
            bandwidth = self.config.target_bandwidths[0]
        if bandwidth not in self.config.target_bandwidths:
            raise ValueError(
                f"This model doesn't support the bandwidth {bandwidth}. "
                f"Select one of {self.config.target_bandwidths}.")
        if not isinstance(input_values, torch.Tensor):
            input_values = torch.as_tensor(np.asarray(input_values, np.float32))
        input_values = input_values.to(self.device)
        _, input_length, channels = input_values.shape
        if channels < 1 or channels > 2:
            raise ValueError(f"Number of audio channels must be 1 or 2, got {channels}")
        chunk_length = self.chunk_length or input_length
        stride = self.chunk_stride or input_length
        if padding_mask is None:
            padding_mask = torch.ones(input_values.shape[:2], dtype=torch.bool)
        padding_mask = torch.as_tensor(padding_mask, device=self.device)
        frames, scales = [], []
        step = chunk_length - stride
        # chunks of the raw waveform, the last one possibly short (HF's
        # EncodecModel.encode), or of stride-padded input with a full tail
        for offset in range(0, max(input_length - step, 1), stride):
            mask = padding_mask[:, offset:offset + chunk_length]
            frame = input_values[:, offset:offset + chunk_length]
            codes, scale = self._encode_frame(frame, bandwidth, mask)
            frames.append(codes)
            scales.append(scale)
        if len(frames) > 1 and frames[-1].shape[-1] < frames[0].shape[-1]:
            # the short tail's codes padded so the chunks stack; decode
            # recomputes the trim from the padding mask
            frames[-1] = F.pad(frames[-1], (0, frames[0].shape[-1] - frames[-1].shape[-1]))
        return torch.stack(frames), scales

    @staticmethod
    def _linear_overlap_add(frames: List[torch.Tensor], stride: int):
        n, frame_length, c = frames[0].shape
        dev, dt = frames[0].device, frames[0].dtype
        total = stride * (len(frames) - 1) + frames[-1].shape[1]
        t = np.linspace(0, 1, frame_length + 2)[1:-1]
        weight = torch.as_tensor(0.5 - np.abs(t - 0.5), dtype=dt, device=dev)[:, None]
        out = torch.zeros((n, total, c), dtype=dt, device=dev)
        sum_w = torch.zeros((total, 1), dtype=dt, device=dev)
        offset = 0
        for frame in frames:
            fl = frame.shape[1]
            out[:, offset:offset + fl] += weight[:fl] * frame
            sum_w[offset:offset + fl] += weight[:fl]
            offset += stride
        return out / sum_w

    @torch.no_grad()
    def _decode_frame(self, codes, scale=None):
        out = self.decoder(self.quantizer.decode(codes))
        return out * scale if scale is not None else out

    def decode(self, audio_codes, audio_scales, padding_mask=None):
        """codes [n_chunks, B, nq, T'] -> audio [B, T, C]."""
        audio_codes = torch.as_tensor(audio_codes, device=self.device)
        if self.chunk_length is None:
            if audio_codes.shape[0] != 1:
                raise ValueError(f"Expected one frame, got {audio_codes.shape[0]}")
            audio_values = self._decode_frame(audio_codes[0], audio_scales[0])
        else:
            frames = list(audio_codes)
            if padding_mask is not None and len(frames) > 1:
                # trim the tail chunk's stacking padding: the input's last
                # chunk may have been shorter than chunk_length
                stride = self.chunk_stride or 1
                hop = int(np.prod(self.config.upsampling_ratios))
                last_samples = padding_mask.shape[1] - (len(frames) - 1) * stride
                real_codes = max(1, math.ceil(last_samples / hop))
                if real_codes < frames[-1].shape[-1]:
                    frames[-1] = frames[-1][..., :real_codes]
            decoded = [self._decode_frame(f, s) for f, s in zip(frames, audio_scales)]
            audio_values = self._linear_overlap_add(decoded, self.chunk_stride or 1)
        if padding_mask is not None and padding_mask.shape[1] < audio_values.shape[1]:
            audio_values = audio_values[:, :padding_mask.shape[1]]
        return audio_values

    def sanitize(self, weights: dict) -> dict:
        """Checkpoint keys and layouts -> the JAX package's: MLX conversions
        (conv [O, K, I] -> [K, I, O], ``.conv.`` nesting collapsed);
        HF-transformers ``EncodecModel`` checkpoints through
        ``sanitize_hf_encodec``.  ``convert.params_from_jax`` takes them on
        to the port's layouts."""
        if any(".parametrizations.weight." in k or "weight_ih_l0" in k
               for k in weights):
            return sanitize_hf_encodec(weights)
        out = {}
        for k, v in weights.items():
            v = np.asarray(v)
            k = k.replace(".conv.weight", ".weight").replace(".conv.bias", ".bias")
            if k.endswith(".weight") and v.ndim == 3:
                v = v.transpose(1, 2, 0)
            out[k] = v
        return out

    @classmethod
    def from_pretrained(cls, path: str, device: str = "cuda"):
        """Model and audio preprocessor from a local checkpoint directory,
        the HF-transformers ``facebook/encodec_*`` layout or an MLX
        conversion.  Returns (model, processor)."""
        from mlx_audio_tpu_torch.codec.loading import (
            checkpoint_dir,
            load_config,
            load_weights_files,
        )
        from mlx_audio_tpu_torch.convert import params_from_jax

        path = checkpoint_dir(path)
        config = EncodecConfig.from_dict(load_config(path))
        model = cls(config, device=device)
        state = params_from_jax(model.sanitize(load_weights_files(path)), model)
        model.load_state_dict(state, strict=False)
        processor = functools.partial(
            preprocess_audio, sampling_rate=config.sampling_rate,
            chunk_length=model.chunk_length, chunk_stride=model.chunk_stride)
        return model, processor


def sanitize_hf_encodec(weights: dict) -> dict:
    """HF-transformers ``EncodecModel`` checkpoints -> the JAX package's
    paths and layouts: weight norm's (g, v) folded (w = g v / ||v||, the
    norm over every axis but 0), each LSTM layer's two biases summed into
    one, convs [O, I, K] -> [K, I, O] and the decoder's transposed convs
    [I, O, K] -> [K, I, O]."""
    raw, gs, vs = {}, {}, {}
    for k, v in weights.items():
        v = np.asarray(v)
        if k.endswith(".parametrizations.weight.original0"):
            gs[k[:-len(".parametrizations.weight.original0")]] = v
        elif k.endswith(".parametrizations.weight.original1"):
            vs[k[:-len(".parametrizations.weight.original1")]] = v
        else:
            raw[k] = v
    for base, vmat in vs.items():
        norm = np.sqrt((vmat ** 2).sum(axis=(1, 2), keepdims=True))
        raw[base + ".weight"] = gs[base] * vmat / np.maximum(norm, 1e-12)

    # the decoder's only bare dense convs are layer 0 and the last layer;
    # every other bare conv of the decoder is a transposed upsampler
    dec_conv = re.compile(r"decoder\.layers\.(\d+)\.(?:conv\.)?weight$")
    dec_idx = [int(m.group(1)) for k in raw if (m := dec_conv.match(k))]
    last_dec = max(dec_idx) if dec_idx else -1
    lstm_re = re.compile(r"(encoder|decoder)\.layers\.(\d+)\.lstm\."
                         r"(weight_ih|weight_hh|bias_ih|bias_hh)_l(\d+)$")
    out = {}
    for k, v in raw.items():
        if k.endswith((".codebook.inited", ".codebook.cluster_size",
                       ".codebook.embed_avg")):
            continue
        m = lstm_re.match(k)
        if m:
            side, idx, kind, layer = m.groups()
            base = f"{side}.layers.{idx}.lstm.{layer}."
            if kind == "weight_ih":
                out[base + "Wx"] = v
            elif kind == "weight_hh":
                out[base + "Wh"] = v
            else:
                out[base + "bias"] = out.get(base + "bias", 0) + v
            continue
        k = k.replace(".conv.weight", ".weight").replace(".conv.bias", ".bias")
        if k.endswith(".weight") and v.ndim == 3:
            cm = re.match(r"decoder\.layers\.(\d+)\.weight$", k)
            if cm and int(cm.group(1)) not in (0, last_dec):
                v = v.transpose(2, 0, 1)  # convT [I, O, K] -> [K, I, O]
            else:
                v = v.transpose(2, 1, 0)  # conv [O, I, K] -> [K, I, O]
        out[k] = v
    return out
