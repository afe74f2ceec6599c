"""One query per row over a TRANSPOSED KV cache: kernel B8 of the port
(decode mode ``per_sample``), and the pieces B9 (``grouped``) shares.

Mirror of ``valle_tpu/ops/decode_attention.py``. K and V are separate
(B, H, Dh, T) caches in the compute dtype. Row b attends to its valid keys,
p < x_len (the text) or S <= p <= write_pos (the audio so far); the text
pad and the unwritten tail are masked. Scores and probabilities are fp32
over the cache upcast to fp32, p stays unrounded for P.V, masked scores
are -1e30, and the output acc / max(l, 1e-30) is cast to q's dtype.

``BLOCK_K`` is the JAX kernel's block, kept because the JAX package rounds
the cache of mode ``per_sample`` up to it (``models/inference.py
cache_rows``); the CUDA kernel needs no rounding.

Dispatch: CPU tensors run the plain PyTorch version; CUDA tensors launch
``csrc/decode_attention_t.cu`` or raise; other devices raise.
"""

from __future__ import annotations

import math

import torch

from . import cuda_build as cb
from .decode_attention_kv import attend_plain, decode_operands, key_valid

# csrc/decode_attention_t.cu is built for these
TRANSPOSED_HEAD_DIMS = (32, 64, 128)

BLOCK_K = 256


def decode_attention_plain(q, k_cache, v_cache, x_lens, write_pos, *,
                           S: int):
    """q (B, H, 1, Dh); k_cache, v_cache (B, H, Dh, T); x_lens (B,);
    write_pos scalar or (B,). Returns (B, H, 1, Dh) in q's dtype."""
    valid = key_valid(x_lens, write_pos, S, k_cache.shape[-1])
    return attend_plain(q, k_cache.transpose(-1, -2),
                        v_cache.transpose(-1, -2), valid)


def launch_transposed(name, q, k_cache, v_cache, x_lens, write_pos, *,
                      S: int):
    """Check the operands and launch ``vt_decode_attention_t`` on q's
    stream. Returns out (B, H, 1, Dh) in q's dtype."""
    B, H, Dh, T = k_cache.shape
    cb.require(k_cache.dtype == q.dtype and v_cache.dtype == q.dtype
               and tuple(q.shape) == (B, H, 1, Dh)
               and v_cache.shape == k_cache.shape, name,
               f"caches {tuple(k_cache.shape)} {k_cache.dtype} / "
               f"{tuple(v_cache.shape)} do not match q {tuple(q.shape)} "
               f"{q.dtype}")
    cb.require(v_cache.is_contiguous() and v_cache.data_ptr() % 16 == 0,
               name, "the caches must be contiguous and 16-byte aligned")
    cb.require(Dh in TRANSPOSED_HEAD_DIMS, name,
               f"head dim {Dh} (the kernel takes {TRANSPOSED_HEAD_DIMS})")
    q3, xl, wp = decode_operands(name, q, k_cache, x_lens, write_pos, H)
    lib = cb.load_library()
    out = torch.empty(B, H, 1, Dh, dtype=q.dtype, device=q.device)
    rc = lib.vt_decode_attention_t(
        cb.DTYPE_CODES[q.dtype], Dh, q3.data_ptr(), q3.stride(0),
        k_cache.data_ptr(), v_cache.data_ptr(), xl.data_ptr(), wp.data_ptr(),
        out.data_ptr(), B, H, T, int(S), 1.0 / math.sqrt(Dh),
        cb.stream_ptr(q))
    cb.check(rc, name)
    return out


def decode_attention(q, k_cache, v_cache, x_lens, write_pos, *,
                     S: int) -> torch.Tensor:
    """B8: q (B, H, 1, Dh); k_cache, v_cache (B, H, Dh, T) in q's dtype;
    x_lens (B,); write_pos scalar or (B,). Returns (B, H, 1, Dh)."""
    name = "decode_attention"
    if cb.route(name, q, k_cache, v_cache, x_lens, write_pos) == "plain":
        return decode_attention_plain(q, k_cache, v_cache, x_lens, write_pos,
                                      S=S)
    out = launch_transposed(name, q, k_cache, v_cache, x_lens, write_pos,
                            S=S)
    cb.LAUNCHES[name] += 1
    return out
