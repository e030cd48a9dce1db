"""Mimi's split residual vector quantizer (counterpart of
``mlx_audio_tpu/codec/mimi/quantization.py``).  The codebook keeps the
checkpoint's ``embedding_sum`` and ``cluster_usage`` and derives its
embedding as ``embedding_sum / max(cluster_usage, eps)``."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mlx_audio_tpu_torch.nn.layers import Linear, _param, _uniform_, promote_operands


class EuclideanCodebook(nn.Module):
    def __init__(self, dim: int, codebook_size: int):
        super().__init__()
        self.epsilon = 1e-5
        self.initialized = _param(1)
        self.embedding_sum = _param(codebook_size, dim)
        self.cluster_usage = _param(codebook_size)

    def init_weights(self, generator: torch.Generator) -> None:
        _uniform_(self.embedding_sum, 1.0, generator)
        with torch.no_grad():
            self.initialized.zero_()
            self.cluster_usage.fill_(1.0)

    @property
    def embedding(self) -> torch.Tensor:
        return self.embedding_sum / torch.clamp(self.cluster_usage, min=self.epsilon)[:, None]

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """[..., D] -> int64 codes [...], the nearest embedding."""
        emb = self.embedding
        c2 = (emb * emb).sum(-1) / 2  # in the embedding's dtype, as in JAX
        x, e = promote_operands(x, emb)
        return torch.argmin(c2 - x @ e.t(), dim=-1)

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """int codes [...] -> [..., D].  A code outside the codebook (CSM's
        audio vocabulary has 2051 entries, Mimi's codebooks 2048) decodes to
        NaN, as the JAX package's ``jnp.take`` fills it."""
        emb = self.embedding
        valid = (codes >= 0) & (codes < emb.shape[0])
        out = emb[codes.clamp(0, emb.shape[0] - 1)]
        return torch.where(valid[..., None], out, float("nan"))


class VectorQuantization(nn.Module):
    def __init__(self, dim: int, codebook_size: int,
                 codebook_dim: Optional[int] = None):
        super().__init__()
        codebook_dim = dim if codebook_dim is None else codebook_dim
        same = dim == codebook_dim
        self.project_in = None if same else Linear(dim, codebook_dim)
        self.project_out = None if same else Linear(codebook_dim, dim)
        self.codebook = EuclideanCodebook(codebook_dim, codebook_size)

    def encode(self, x):
        if self.project_in is not None:
            x = self.project_in(x)
        return self.codebook.encode(x)

    def decode(self, codes):
        x = self.codebook.decode(codes)
        return x if self.project_out is None else self.project_out(x)


class ResidualVectorQuantization(nn.Module):
    def __init__(self, nq: int, dim: int, codebook_size: int,
                 codebook_dim: Optional[int] = None):
        super().__init__()
        self.layers = nn.ModuleList(
            VectorQuantization(dim, codebook_size, codebook_dim) for _ in range(nq))

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """[B, T, D] -> codes [B, nq, T]."""
        codes, residual = [], x
        for layer in self.layers:
            idx = layer.encode(residual)
            residual = residual - layer.decode(idx)
            codes.append(idx)
        return torch.stack(codes, dim=1)

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """codes [B, nq, T] -> [B, T, D]."""
        out = self.layers[0].decode(codes[:, 0])
        for i in range(1, len(self.layers)):
            out = out + self.layers[i].decode(codes[:, i])
        return out


class ResidualVectorQuantizer(nn.Module):
    def __init__(self, dim: int, input_dim: Optional[int],
                 output_dim: Optional[int], nq: int, bins: int,
                 force_projection: bool = False):
        super().__init__()
        input_dim = dim if input_dim is None else input_dim
        output_dim = dim if output_dim is None else output_dim
        self.input_proj = (Linear(input_dim, dim, bias=False)
                           if input_dim != dim or force_projection else None)
        self.output_proj = (Linear(dim, output_dim, bias=False)
                            if output_dim != dim or force_projection else None)
        self.vq = ResidualVectorQuantization(nq, dim, bins)

    def encode(self, x):
        if self.input_proj is not None:
            x = self.input_proj(x)
        return self.vq.encode(x)

    def decode(self, codes):
        out = self.vq.decode(codes)
        return out if self.output_proj is None else self.output_proj(out)


class SplitResidualVectorQuantizer(nn.Module):
    """Semantic (first) plus acoustic (rest) codebooks."""

    def __init__(self, dim: int, input_dim: Optional[int],
                 output_dim: Optional[int], nq: int, bins: int):
        super().__init__()
        self.nq = nq
        self.rvq_first = ResidualVectorQuantizer(dim, input_dim, output_dim, 1,
                                                 bins, force_projection=True)
        self.rvq_rest = ResidualVectorQuantizer(dim, input_dim, output_dim,
                                                nq - 1, bins,
                                                force_projection=True)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        codes = self.rvq_first.encode(x)
        if self.nq > 1:
            codes = torch.cat([codes, self.rvq_rest.encode(x)], dim=1)
        return codes

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        out = self.rvq_first.decode(codes[:, :1])
        if self.nq > 1:
            out = out + self.rvq_rest.decode(codes[:, 1:])
        return out
