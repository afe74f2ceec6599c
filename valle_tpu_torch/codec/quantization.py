"""Residual vector quantization (mirror of
``valle_tpu/codec/quantization.py``): ``rvq_encode``, the nearest-codebook
search, and ``rvq_decode``.

Parameter names follow the ``encodec`` package:
``quantizer.vq.layers.{q}._codebook.embed`` (bins, dim). The search scores
with the package's argmax of -(|x|^2 - 2 x.c + |c|^2), so identical
latents give identical codes. Its product is ``torch.matmul``: the JAX
package computes it in XLA, outside any Pallas kernel.
"""

from __future__ import annotations

import torch
from torch import nn


class EuclideanCodebook(nn.Module):
    def __init__(self, bins: int, dim: int):
        super().__init__()
        self.register_buffer("embed", torch.zeros(bins, dim))


class VectorQuantization(nn.Module):
    def __init__(self, bins: int, dim: int):
        super().__init__()
        self._codebook = EuclideanCodebook(bins, dim)


class ResidualVectorQuantization(nn.Module):
    def __init__(self, num_quantizers: int, bins: int, dim: int):
        super().__init__()
        self.layers = nn.ModuleList(
            VectorQuantization(bins, dim) for _ in range(num_quantizers))


class ResidualVectorQuantizer(nn.Module):
    def __init__(self, num_quantizers: int = 32, bins: int = 1024,
                 dim: int = 128):
        super().__init__()
        self.vq = ResidualVectorQuantization(num_quantizers, bins, dim)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for layer in self.vq.layers:
            layer._codebook.embed.normal_(generator=generator)


def rvq_encode(quantizer: ResidualVectorQuantizer, x: torch.Tensor,
               n_q: int) -> torch.Tensor:
    """x: (B, T, D) latents -> codes (B, T, n_q) int32, quantizer by
    quantizer on the residual."""
    residual = x
    codes = []
    for q in range(n_q):
        cb = quantizer.vq.layers[q]._codebook.embed
        dist = -((residual * residual).sum(-1, keepdim=True)
                 - 2.0 * (residual @ cb.T)
                 + (cb * cb).sum(-1)[None, :])
        idx = dist.argmax(dim=-1)
        residual = residual - cb[idx]
        codes.append(idx.to(torch.int32))
    return torch.stack(codes, dim=-1)


def rvq_decode(quantizer: ResidualVectorQuantizer,
               codes: torch.Tensor) -> torch.Tensor:
    """codes: (B, T, n_q) -> latents (B, T, D), summed in quantizer order."""
    layers = quantizer.vq.layers
    embed0 = layers[0]._codebook.embed
    acc = torch.zeros(codes.shape[0], codes.shape[1], embed0.shape[-1],
                      dtype=embed0.dtype, device=embed0.device)
    for q in range(codes.shape[-1]):
        acc = acc + layers[q]._codebook.embed[codes[..., q].long()]
    return acc
