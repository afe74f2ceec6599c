"""One query per row over a combined K|V cache: kernel B10 of the port,
and the pieces the decode-attention modules share.

Mirror of ``valle_tpu/ops/decode_attention_kv.py``. The cache (B, H, T,
2Dh) is in the compute dtype with K in [..., :Dh] and V in [..., Dh:]
(``combine_kv``). Row b attends to its valid keys, p < x_len (the text) or
S <= p <= write_pos (the audio so far); the text pad and the unwritten
tail are masked. Scores and probabilities are fp32 over the cache upcast
to fp32 (the TPU kernel's ``.astype(jnp.float32)``), masked scores are
-1e30, and the output acc / max(l, 1e-30) is cast to q's dtype.

``key_valid``, ``attend_plain`` and ``decode_operands`` serve the int8
(B3), lane-row (B11), transposed (B8/B9) and fused-tail (B12) modules too,
``launch_decode`` B10, B11 and B3.

Dispatch: CPU tensors run the plain PyTorch version; CUDA tensors launch
``csrc/decode_attention.cu`` or raise; other devices raise. The kernels
take any batch size and read only each row's own valid keys.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import cuda_build as cb

NEG_INF = -1e30
# the head dims the decode kernels (csrc/decode_attention.cu, B10/B11,
# csrc/decode_attention_int8.cu, B3, and csrc/fused_attn_tail.cu, B12)
# are built for
DECODE_HEAD_DIMS = (32, 64, 128)


def combine_kv(k, v):
    """(..., T, Dh) K and V -> (..., T, 2Dh) combined cache."""
    return torch.cat([k, v], dim=-1)


def key_valid(x_lens, write_pos, S: int, T: int):
    """(B, T) bool: p < x_len or S <= p <= write_pos (scalar or (B,))."""
    kk = torch.arange(T, device=x_lens.device)[None, :]
    wp = write_pos.reshape(-1, 1)
    return (kk < x_lens.reshape(-1, 1)) | ((kk >= S) & (kk <= wp))


def attend_plain(q, k, v, valid, *, k_scale=None, v_scale=None,
                 p_dtype: Optional[torch.dtype] = None):
    """The plain version of the decode kernels. q (B, H, 1, Dh); k, v (B, H,
    T, Dh) of any dtype, upcast to fp32; valid (B, T). Int8 caches pass
    their (B, H, T) scales, folded after the dots as the kernel does:
    s = (q . kq) * ks * sm_scale and acc = (p * vs) . vq. ``p_dtype``
    rounds p before P.V (the lane kernels feed the MXU p in the cache
    dtype); l sums the unrounded p."""
    sm_scale = 1.0 / math.sqrt(q.shape[-1])
    s = q.float() @ k.float().transpose(-1, -2)             # (B, H, 1, T)
    if k_scale is not None:
        s = s * k_scale[:, :, None, :]
    s = (s * sm_scale).masked_fill(~valid[:, None, None, :], NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    pw = p * v_scale[:, :, None, :] if v_scale is not None else p
    if p_dtype is not None:
        pw = pw.to(p_dtype).float()
    acc = pw @ v.float()
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


def decode_attention_kv_plain(q, kv_cache, x_lens, write_pos, *, S: int):
    Dh = kv_cache.shape[-1] // 2
    valid = key_valid(x_lens, write_pos, S, kv_cache.shape[2])
    return attend_plain(q, kv_cache[..., :Dh], kv_cache[..., Dh:], valid)


def decode_operands(name, q, kv_cache, x_lens, write_pos, nhead: int):
    """Check what every decode kernel takes. Returns q as (B, H, Dh) with
    unit head and feature strides (a view where it can be), and x_lens and
    write_pos as contiguous (B,) int32 (a scalar write_pos, as under
    aligned prompts, is expanded on the device: no host sync)."""
    B, H, _, Dh = q.shape
    cb.require(H == nhead, name, f"q has {H} heads, the cache {nhead}")
    cb.require(q.dtype in cb.DTYPE_CODES, name,
               f"dtype {q.dtype} (float32 or bfloat16 only)")
    cb.require(Dh in DECODE_HEAD_DIMS, name,
               f"head dim {Dh} (the kernels take {DECODE_HEAD_DIMS})")
    cb.require(kv_cache.is_contiguous() and kv_cache.data_ptr() % 16 == 0,
               name, "the cache must be contiguous and 16-byte aligned")
    q3 = q.reshape(B, H, Dh)
    if q3.stride(2) != 1 or q3.stride(1) != Dh:
        q3 = q3.contiguous()
    rows = [(x.expand(B) if x.dim() == 0 else x).to(torch.int32).contiguous()
            for x in (x_lens, write_pos)]
    return (q3, *rows)


def launch_decode(name, entry, q, kv_cache, x_lens, write_pos, *, S: int,
                  nhead: int, T: int, scales=None):
    """Check the operands and launch one decode-attention C entry point
    (``entry``) on q's stream. Returns out (B, H, 1, Dh) in q's dtype."""
    B, H, _, Dh = q.shape
    q3, xl, wp = decode_operands(name, q, kv_cache, x_lens, write_pos, nhead)
    lib = cb.load_library()
    out = torch.empty(B, H, 1, Dh, dtype=q.dtype, device=q.device)
    args = [cb.DTYPE_CODES[q.dtype], Dh, q3.data_ptr(), q3.stride(0),
            kv_cache.data_ptr()]
    if scales is not None:
        args.append(scales.data_ptr())
    args += [xl.data_ptr(), wp.data_ptr(), out.data_ptr(), B, H, T, int(S),
             1.0 / math.sqrt(Dh), cb.stream_ptr(q)]
    cb.check(getattr(lib, entry)(*args), name)
    return out


def decode_attention_kv(q, kv_cache, x_lens, write_pos, *,
                        S: int) -> torch.Tensor:
    """q (B, H, 1, Dh); kv_cache (B, H, T, 2Dh) in q's dtype; x_lens (B,);
    write_pos scalar or (B,). Returns (B, H, 1, Dh)."""
    name = "decode_attention_kv"
    if cb.route(name, q, kv_cache, x_lens, write_pos) == "plain":
        return decode_attention_kv_plain(q, kv_cache, x_lens, write_pos, S=S)
    B, H, T, D2 = kv_cache.shape
    cb.require(kv_cache.dtype == q.dtype and D2 == 2 * q.shape[-1], name,
               f"cache {tuple(kv_cache.shape)} {kv_cache.dtype} does not "
               f"match q {tuple(q.shape)} {q.dtype}")
    out = launch_decode(name, "vt_decode_attention_kv", q, kv_cache, x_lens,
                        write_pos, S=S, nhead=H, T=T)
    cb.count_launch(name)
    return out
