"""One query per row over lane rows: kernel B11 of the port (decode modes
``lanes`` and ``fused_lanes``; ``mega`` reads the same cache).

Mirror of ``valle_tpu/ops/decode_attention_lanes.py``. The cache (B, T,
H*2Dh) holds one row per position with all heads side by side, head h at
[h*2Dh, (h+1)*2Dh) as [K_h | V_h] (``combine_kv_lanes``: H-major, not a
transposed view). The per-step write is one row (``step_row_lanes``).
Scores are fp32; p is rounded to the cache dtype before P.V, as the TPU
kernel feeds the MXU (l sums the unrounded p). The validity rule and the
output follow ``decode_attention_kv``.

Dispatch: CPU tensors run the plain PyTorch version; CUDA tensors launch
``csrc/decode_attention.cu`` or raise; other devices raise.
"""

from __future__ import annotations

import torch

from . import cuda_build as cb
from .decode_attention_kv import attend_plain, key_valid, launch_decode


def combine_kv_lanes(k, v):
    """k/v (..., H, T, Dh) -> cache rows (..., T, H*2Dh), head-major
    [K_h | V_h] lane blocks."""
    kv = torch.cat([k, v], dim=-1).movedim(-3, -2)     # (..., T, H, 2Dh)
    return kv.reshape(kv.shape[:-2] + (-1,)).contiguous()


def step_row_lanes(k, v):
    """Single-step k/v (B, H, 1, Dh) -> the (B, 1, H*2Dh) cache row."""
    B, H, _, Dh = k.shape
    return torch.cat([k, v], dim=-1)[:, :, 0, :].reshape(B, 1, H * 2 * Dh)


def decode_attention_lanes_plain(q, kv_cache, x_lens, write_pos, *, S: int,
                                 nhead: int):
    B, T, lanes = kv_cache.shape
    Dh = lanes // (2 * nhead)
    kv = kv_cache.view(B, T, nhead, 2 * Dh).transpose(1, 2)  # (B,H,T,2Dh)
    valid = key_valid(x_lens, write_pos, S, T)
    return attend_plain(q, kv[..., :Dh], kv[..., Dh:], valid,
                        p_dtype=kv_cache.dtype)


def decode_attention_lanes(q, kv_cache, x_lens, write_pos, *, S: int,
                           nhead: int) -> torch.Tensor:
    """q (B, H, 1, Dh); kv_cache (B, T, H*2Dh) in q's dtype; x_lens (B,);
    write_pos scalar or (B,). Returns (B, H, 1, Dh)."""
    name = "decode_attention_lanes"
    if cb.route(name, q, kv_cache, x_lens, write_pos) == "plain":
        return decode_attention_lanes_plain(q, kv_cache, x_lens, write_pos,
                                            S=S, nhead=nhead)
    B, T, lanes = kv_cache.shape
    cb.require(kv_cache.dtype == q.dtype
               and lanes == 2 * nhead * q.shape[-1], name,
               f"cache {tuple(kv_cache.shape)} {kv_cache.dtype} does not "
               f"match q {tuple(q.shape)} {q.dtype}")
    out = launch_decode(name, "vt_decode_attention_lanes", q, kv_cache,
                        x_lens, write_pos, S=S, nhead=nhead, T=T)
    cb.count_launch(name)
    return out
