"""One query per row over the combined int8 K|V cache: kernel B3 of the
port (decode modes ``int8``, ``fused_int8`` and the ``auto`` pick for long
caches).

Mirror of ``valle_tpu/ops/decode_attention_int8_grouped.py``. The cache
(B, H, T, 2Dh) int8 holds K in [..., :Dh] and V in [..., Dh:]
(``combine_kv_int8``) with per-position fp32 scales (B, 2H, T), K rows
0:H and V rows H:2H (``stack_scales``), made by ``modules.transformer
.quantize_kv``. Dequantization is folded after the dots, as the TPU kernel
does: s = (q . kq) * ks * sm_scale and acc += (p * vs) . vq; no
dequantized copy of the cache is made. The validity rule, the fp32
softmax and the output follow ``decode_attention_kv``.

Dispatch: CPU tensors run the plain PyTorch version; CUDA tensors launch
``csrc/decode_attention_int8.cu`` or raise; other devices raise. The kernel
takes any batch size (the TPU kernel's 8-row groups are gone) and any
cache length that is a multiple of 4 (the JAX kernel asks for 128); its
operands are checked before anything is built (``launch_int8``).
"""

from __future__ import annotations

import torch

from . import cuda_build as cb
from .decode_attention_kv import attend_plain, key_valid, launch_decode

# the TPU kernel's per-slot VMEM budget, kept only for ``preferred_block``
_VMEM_BUDGET = 4 * 1024 * 1024


def preferred_block(H: int, G: int = 8) -> int:
    """The JAX package's budget-optimal key block (256 at H=16). The int8
    decode modes round the cache length to min(this, 256) so that caches
    compare shape for shape with the JAX package's; the CUDA kernel does
    not need the rounding."""
    bk = _VMEM_BUDGET // (H * G * 128)
    return max(128, (bk // 128) * 128)


def combine_kv_int8(kq, vq):
    """(..., T, Dh) int8 K and V -> (..., T, 2Dh) combined cache."""
    return torch.cat([kq, vq], dim=-1)


def stack_scales(ks, vs):
    """(..., H, T) K and V scales -> (..., 2H, T)."""
    return torch.cat([ks, vs], dim=-2)


def decode_attention_int8_grouped_plain(q, kv_cache, scales, x_lens,
                                        write_pos, *, S: int):
    B, H, T, D2 = kv_cache.shape
    Dh = D2 // 2
    valid = key_valid(x_lens, write_pos, S, T)
    return attend_plain(q, kv_cache[..., :Dh], kv_cache[..., Dh:], valid,
                        k_scale=scales[:, :H].float(),
                        v_scale=scales[:, H:].float())


def launch_int8(name, q, kv_cache, scales, x_lens, write_pos, *, S: int):
    """Check B3's operands, before anything is built, and launch
    ``vt_decode_attention_int8`` on q's stream. Returns out (B, H, 1, Dh)
    in q's dtype."""
    B, H, T, D2 = kv_cache.shape
    cb.require(kv_cache.dtype == torch.int8 and D2 == 2 * q.shape[-1]
               and tuple(q.shape) == (B, H, 1, D2 // 2), name,
               f"cache {tuple(kv_cache.shape)} {kv_cache.dtype}: int8 "
               f"(B, H, T, 2Dh) matching q {tuple(q.shape)} expected")
    cb.require(scales.dtype == torch.float32 and scales.is_contiguous()
               and tuple(scales.shape) == (B, 2 * H, T)
               and scales.data_ptr() % 16 == 0, name,
               f"scales {tuple(scales.shape)} {scales.dtype}: contiguous "
               f"16-byte aligned fp32 {(B, 2 * H, T)} expected")
    cb.require(T % 4 == 0, name, f"cache length {T}: a multiple of 4 (each "
               "scale row is copied from a 16-byte aligned start)")
    return launch_decode(name, "vt_decode_attention_int8", q, kv_cache,
                         x_lens, write_pos, S=S, nhead=H, T=T, scales=scales)


def decode_attention_int8_grouped(q, kv_cache, scales, x_lens, write_pos, *,
                                  S: int) -> torch.Tensor:
    """q (B, H, 1, Dh) fp32/bf16; kv_cache (B, H, T, 2Dh) int8; scales
    (B, 2H, T) fp32; x_lens (B,); write_pos scalar or (B,). Returns
    (B, H, 1, Dh) in q's dtype."""
    name = "decode_attention_int8_grouped"
    if cb.route(name, q, kv_cache, scales, x_lens, write_pos) == "plain":
        return decode_attention_int8_grouped_plain(q, kv_cache, scales,
                                                   x_lens, write_pos, S=S)
    out = launch_int8(name, q, kv_cache, scales, x_lens, write_pos, S=S)
    cb.count_launch(name)
    return out
