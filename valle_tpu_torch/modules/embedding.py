"""Token embedding and sinusoidal positional encoding with learnable alpha.

Mirror of ``valle_tpu/modules/embedding.py:41-91`` under the reference's
parameter names (``word_embeddings.weight``, ``alpha``). Dropout waits
for the training port.
"""

from __future__ import annotations

import math

import torch
from torch import nn


class TokenEmbedding(nn.Module):
    def __init__(self, dim: int, vocab_size: int):
        super().__init__()
        self.word_embeddings = nn.Embedding(vocab_size, dim)


class SinePositionalEmbedding(nn.Module):
    """Holds the scalar ``alpha``: trainable for the AR stacks, fixed at 1
    (``requires_grad=False``) for the NAR stacks, as in the reference."""

    def __init__(self, alpha: bool = False):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(1), requires_grad=alpha)


def token_embedding(weight: torch.Tensor, ids: torch.Tensor,
                    dtype=None) -> torch.Tensor:
    """Lookup: ids (...,) int -> (..., D), cast to ``dtype`` first."""
    if dtype is not None:
        weight = weight.to(dtype)
    return weight[ids.long()]


def sine_positional_table(max_len: int, dim: int,
                          device=None) -> torch.Tensor:
    """(max_len, dim) fp32 sin/cos table, interleaved as in the reference."""
    position = torch.arange(max_len, dtype=torch.float32,
                            device=device)[:, None]
    div_term = torch.exp(
        torch.arange(0, dim, 2, dtype=torch.float32, device=device)
        * -(math.log(10000.0) / dim))
    angles = position * div_term
    pe = torch.zeros(max_len, dim, dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(angles)
    pe[:, 1::2] = torch.cos(angles)
    return pe


def apply_sine_positional(alpha: torch.Tensor, x: torch.Tensor,
                          pe_table: torch.Tensor, *,
                          offset: int = 0) -> torch.Tensor:
    """x: (B, T, D) + alpha * pe[offset:offset+T]."""
    T = x.shape[-2]
    pe = pe_table[offset: offset + T]
    return x + alpha.to(x.dtype) * pe.to(x.dtype)
