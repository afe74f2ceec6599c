"""Token embedding and sinusoidal positional encoding with learnable alpha.

Mirror of ``valle_tpu/modules/embedding.py:41-160`` under the reference's
parameter names (``word_embeddings.weight``, ``alpha``), with its 8-bit
dropout.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..ops.philox import keep_threshold


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
                          pe_table: torch.Tensor, *, offset: int = 0,
                          dropout_rate: float = 0.0,
                          seed: Optional[int] = None) -> torch.Tensor:
    """x: (B, T, D) + alpha * pe[offset:offset+T], then dropout."""
    T = x.shape[-2]
    pe = pe_table[offset: offset + T]
    return dropout(x + alpha.to(x.dtype) * pe.to(x.dtype), dropout_rate,
                   seed)


def apply_sine_positional_gather(alpha: torch.Tensor, x: torch.Tensor,
                                 pe_table: torch.Tensor,
                                 pos_ids: torch.Tensor, *,
                                 dropout_rate: float = 0.0,
                                 seed: Optional[int] = None) -> torch.Tensor:
    """Per-position variant for sequence-packed rows, where every segment
    restarts its positions at 0: x (B, T, D) + alpha * pe[max(pos_ids,
    0)], then dropout."""
    pe = pe_table[pos_ids.long().clamp_min(0)]
    return dropout(x + alpha.to(x.dtype) * pe.to(x.dtype), dropout_rate,
                   seed)


def dropout(x: torch.Tensor, rate: float, seed: Optional[int], *,
            shard=None) -> torch.Tensor:
    """Inverted dropout with 8-bit masks (JAX ``dropout``): keep iff a
    uniform byte >= round(rate * 256), kept values divided by the
    quantized keep probability. No seed (or rate 0) is the identity.

    The bytes come from a ``torch.Generator`` seeded with ``seed`` on x's
    device, never from the global generator: activation checkpointing
    restores only the global state, and a seeded draw repeats exactly
    when a layer is recomputed. Under a ``shard``
    (``parallel.tensor.ModelShard``) ``x`` is the shard's columns of a
    tensor ``tp`` times as wide, and its mask is that slice of the whole
    tensor's mask, so the shards drop what one device drops."""
    if seed is None or rate == 0.0:
        return x
    thresh = keep_threshold(rate)
    gen = torch.Generator(device=x.device).manual_seed(seed)
    shape = x.shape if shard is None else (
        *x.shape[:-1], x.shape[-1] * shard.tp)
    byte = torch.randint(0, 256, shape, generator=gen, device=x.device,
                         dtype=torch.uint8)
    if shard is not None:
        byte = byte[..., shard.columns(shape[-1])]
    return torch.where(byte >= thresh, x / (1.0 - thresh / 256.0),
                       torch.zeros_like(x))
