"""One query per row over a TRANSPOSED KV cache, rows in groups of 8:
kernel B9 of the port (decode mode ``grouped``).

Mirror of ``valle_tpu/ops/decode_attention_grouped.py``, which runs 8 rows
per TPU program with block-diagonal dots over a shared buffer and reads up
to the group's largest write position. Each row's result is the one
``ops/decode_attention.py`` computes, so the CUDA kernel is B8's
(``csrc/decode_attention_t.cu``: a block per (row, head), only the row's
own valid keys); this wrapper keeps the mode's contract (B % group == 0,
raised otherwise, as JAX asserts) and its own launch count.

``BLOCK_K`` is the JAX kernel's block: the JAX package rounds the cache of
mode ``grouped`` up to it (``models/inference.py cache_rows``).

Dispatch: CPU tensors run the plain version; CUDA tensors launch the
kernel or raise; other devices raise.
"""

from __future__ import annotations

import torch

from . import cuda_build as cb
from .decode_attention import decode_attention_plain, launch_transposed

BLOCK_K = 128


def _check_group(B: int, group: int) -> None:
    if B % group:
        raise ValueError(f"decode_attention_grouped: batch {B} is not a "
                         f"multiple of the group {group}")


def decode_attention_grouped_plain(q, k_cache, v_cache, x_lens, write_pos,
                                   *, S: int, group: int = 8):
    _check_group(k_cache.shape[0], group)
    return decode_attention_plain(q, k_cache, v_cache, x_lens, write_pos,
                                  S=S)


def decode_attention_grouped(q, k_cache, v_cache, x_lens, write_pos, *,
                             S: int, group: int = 8) -> torch.Tensor:
    """B9: as ``decode_attention`` (q (B, H, 1, Dh), caches (B, H, Dh, T)),
    for B a multiple of ``group``. Returns (B, H, 1, Dh)."""
    name = "decode_attention_grouped"
    if cb.route(name, q, k_cache, v_cache, x_lens, write_pos) == "plain":
        return decode_attention_grouped_plain(q, k_cache, v_cache, x_lens,
                                              write_pos, S=S, group=group)
    _check_group(k_cache.shape[0], group)
    out = launch_transposed(name, q, k_cache, v_cache, x_lens, write_pos,
                            S=S)
    cb.count_launch(name)
    return out
