"""Sampling: temperature -> top-k/top-p filtering -> categorical draw.

Mirror of ``valle_tpu/ops/sampling.py``: ``top_k > 0`` keeps logits >=
the k-th largest (ties kept); ``top_p < 1`` drops tokens whose prefix
cumulative probability (sorted descending) exceeds top_p, always keeping
the first. The draw takes an explicit ``torch.Generator``; it cannot
replay JAX's random bits, so tests compare the filtered logits.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = float("-inf")


def top_k_top_p_filtering(logits: torch.Tensor, top_k: int = 0,
                          top_p: float = 1.0,
                          min_tokens_to_keep: int = 1) -> torch.Tensor:
    V = logits.shape[-1]
    if top_k > 0:
        k = min(max(top_k, min_tokens_to_keep), V)
        kth = torch.topk(logits, k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, NEG_INF)
    if top_p < 1.0:
        sorted_logits, order = torch.sort(logits, dim=-1, descending=True,
                                          stable=True)
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        remove_sorted = cum > top_p
        remove_sorted = torch.cat([torch.zeros_like(remove_sorted[..., :1]),
                                   remove_sorted[..., :-1]], dim=-1)
        if min_tokens_to_keep > 1:
            remove_sorted[..., :min_tokens_to_keep] = False
        remove = torch.zeros_like(remove_sorted).scatter(-1, order,
                                                         remove_sorted)
        logits = logits.masked_fill(remove, NEG_INF)
    return logits


def categorical(logits: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                invalid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Draw one index per row of (B, V) logits from softmax(logits).

    argmax(p / q) with q ~ Exp(1): ``torch.multinomial``'s own path for one
    draw, which gives its indices from the same generator state, without
    its input checks, which read the device twice a call. So a decode loop
    draws with no host sync. The rows those checks refuse (probabilities
    that are not finite: a NaN or +inf logit, or no finite logit) are
    or-ed into ``invalid`` (B,) bool, in place, when it is given; the
    caller reads it at its next sync (``check_draws``)."""
    probs = torch.softmax(logits.float(), dim=-1)
    if invalid is not None:
        invalid |= ~torch.isfinite(probs).all(dim=-1)
    q = torch.empty_like(probs).exponential_(1, generator=generator)
    return (probs / q).argmax(dim=-1)


def check_draws(invalid: torch.Tensor, where: str) -> None:
    """Raise where ``torch.multinomial`` would have: if ``categorical``
    marked a row of ``invalid`` (one host read)."""
    if bool(invalid.any()):
        rows = torch.nonzero(invalid).flatten().tolist()
        raise RuntimeError(f"{where}: the sampling probabilities of rows "
                           f"{rows} are not finite (NaN or inf logits)")
