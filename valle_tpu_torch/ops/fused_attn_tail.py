"""Attention + dense tail of one AR decode layer: kernel B12 of the port
(decode mode ``mega``).

Mirror of ``valle_tpu/ops/fused_attn_tail.py``: lane-row attention (as
``decode_attention_lanes``), then out-proj + b_out + residual, LN2,
lin1 + activation, lin2 + b2 + residual, with the port's per-layer
weights in PyTorch's (out, in) layout as ``fused_dense.fused_tail`` takes
them. The attention output is cast to the compute dtype before the
out-projection, as the TPU kernel's (H, B, Dh) scratch is.

On CUDA at bf16 the attention and the head-wise out-projection are one
kernel in thread-block clusters of ``cluster_rows(B, D)`` rows of one head:
each block runs its (row, head)'s attention, pushes the row into the
cluster's other blocks, and multiplies its share of that head's out_w
columns by the cluster's rows on the tensor cores, so each cluster reads
its head's weights once. fp32 keeps a block per (row, head) and the
out-projection on the CUDA cores. A second kernel sums the fp32 head
partials in head order, adds b_out and the residual and applies LN2
(``csrc/fused_attn_tail.cu``), and the FFN runs on
``csrc/fused_dense.cu``'s dense kernels. Four launches, counted as one
call; no atomics, so results do not depend on the run.

Dispatch: CPU tensors run the plain PyTorch version; CUDA tensors launch
the kernels or raise; other devices raise.
"""

from __future__ import annotations

import math

import torch

from . import cuda_build as cb
from . import fused_dense as fd
from .decode_attention_kv import decode_operands
from .decode_attention_lanes import decode_attention_lanes_plain


def cluster_rows(B: int, D: int) -> int:
    """Rows of one head a bf16 cluster of B12 holds: 16 (H100's largest
    cluster) for more than 8 rows where each block's share of the D
    output columns, D / 16, is whole 16-column tensor-core tiles; else 8.
    The grid is padded to a multiple; padding blocks run no attention."""
    return 16 if B > 8 and D % (16 * 16) == 0 else 8


def fused_attn_tail_plain(q, h_res, kv_cache, x_lens, write_pos, out_w,
                          out_b, ln2_w, ln2_b, w1, b1, w2, b2, *, S: int,
                          activation: str = "relu", eps: float = 1e-5):
    B, H = q.shape[:2]
    attn = decode_attention_lanes_plain(q.to(h_res.dtype), kv_cache, x_lens,
                                        write_pos, S=S, nhead=H)
    return fd.fused_tail_plain(attn.reshape(B, -1), h_res, out_w, out_b,
                               ln2_w, ln2_b, w1, b1, w2, b2,
                               activation=activation, eps=eps)


def fused_attn_tail(q, h_res, kv_cache, x_lens, write_pos, out_w, out_b,
                    ln2_w, ln2_b, w1, b1, w2, b2, *, S: int,
                    activation: str = "relu",
                    eps: float = 1e-5) -> torch.Tensor:
    """q (B, H, 1, Dh); h_res (B, D) the layer input (residual); kv_cache
    the layer's lane-row cache (B, T, H*2Dh) with this step's row already
    written; x_lens (B,); write_pos scalar or (B,); out_w (D, D), w1
    (F, D), w2 (D, F). Returns the layer output (B, D).

    At bf16 on CUDA, D must be a multiple of 128 (whole 16-column
    tensor-core tiles for each block of an 8-row cluster; the fused decode
    modes ask that of d_model already); other widths raise."""
    name = "fused_attn_tail"
    if cb.route(name, q, h_res, kv_cache, x_lens, write_pos,
                out_w) == "plain":
        return fused_attn_tail_plain(q, h_res, kv_cache, x_lens, write_pos,
                                     out_w, out_b, ln2_w, ln2_b, w1, b1, w2,
                                     b2, S=S, activation=activation, eps=eps)
    lib = cb.load_library()
    fd._check_rows(name, h_res)
    epi = {"relu": fd._EPI_RELU, "gelu": fd._EPI_GELU}.get(activation)
    cb.require(epi is not None, name, f"activation {activation!r}")
    B, H, _, Dh = q.shape
    D, T, dt = h_res.shape[1], kv_cache.shape[1], h_res.dtype
    cb.require(D == H * Dh and tuple(kv_cache.shape) == (B, T, 2 * D)
               and kv_cache.dtype == dt, name,
               f"q {tuple(q.shape)}, h_res {tuple(h_res.shape)} and cache "
               f"{tuple(kv_cache.shape)} {kv_cache.dtype} do not match")
    q3, xl, wp = decode_operands(name, q.to(dt), kv_cache, x_lens,
                                 write_pos, H)
    out_w = fd._weight(name, out_w, None, dt, D, D)[0]
    G = cluster_rows(B, D)
    if dt == torch.bfloat16:
        cb.require(D % (16 * G) == 0, name,
                   f"width {D} must be a multiple of {16 * G} at bf16 "
                   "(16-column tiles for each block of a cluster)")
    part = torch.empty(B, H, D, dtype=torch.float32, device=q.device)
    stream = cb.stream_ptr(h_res)
    cb.check(lib.vt_attn_outproj(
        cb.DTYPE_CODES[dt], Dh, q3.data_ptr(), q3.stride(0),
        kv_cache.data_ptr(), xl.data_ptr(), wp.data_ptr(), out_w.data_ptr(),
        part.data_ptr(), B, H, T, int(S), 1.0 / math.sqrt(Dh), G, stream),
        name)
    h1, n = torch.empty_like(h_res), torch.empty_like(h_res)
    ob, lw, lb = (t.to(dt).contiguous() for t in (out_b, ln2_w, ln2_b))
    cb.check(lib.vt_attn_tail_combine(
        cb.DTYPE_CODES[dt], part.data_ptr(), B, H, D, ob.data_ptr(),
        h_res.data_ptr(), lw.data_ptr(), lb.data_ptr(), h1.data_ptr(),
        n.data_ptr(), float(eps), stream), name)
    ffh = fd._dense(name, n, w1, None, b1, epi=epi)
    out = fd._dense(name, ffh, w2, None, b2, epi=fd._EPI_RESID, resid=h1)
    cb.count_launch(name)
    return out
