"""Dense half of an AR decode layer: kernels 1 and 2 of the port.

Mirror of ``valle_tpu/ops/fused_dense.py``. ``fused_ln_qkv`` computes
LN1(h) -> h W_in^T + b_in; ``fused_tail`` computes a W_out^T + b_out +
residual -> LN2 -> lin1 -> relu/gelu(tanh) -> lin2 -> + residual. Weights
are per layer in PyTorch's (out, in) layout, in the activation dtype or
int8 with per-output-channel fp32 scales (``quantize_weights_per_channel``).

Numerics follow the TPU kernels (ops/fused_dense.py:34-39, ``_mms``):
LayerNorm in fp32 with its parameters first cast to the activation dtype,
cast back; products accumulate in fp32; an int8 scale multiplies the fp32
sum before the cast, then the bias is added in the activation dtype.

Dispatch: CPU tensors run the plain PyTorch version below; CUDA tensors
launch the kernel in ``csrc/fused_dense.cu`` or raise; other devices
raise.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import cuda_build as cb

_EPI_BIAS, _EPI_RELU, _EPI_GELU, _EPI_RESID = 0, 1, 2, 3


def fused_dense_supported(d_model: int, dim_ff: int) -> bool:
    """The JAX package's shape gate for the fused decode modes (all matmul
    dims multiples of 128)."""
    return (d_model % 128 == 0 and (3 * d_model) % 128 == 0
            and dim_ff % 128 == 0)


def quantize_weights_per_channel(w: torch.Tensor, axis: int = -1):
    """Symmetric int8 per-output-channel quantization of a weight in
    PyTorch's (..., out, in) layout: reduce |max| over ``axis`` (the input
    dim). Returns (w_q int8, scale fp32 with the input dim removed)."""
    amax = w.abs().amax(dim=axis)
    scale = (amax / 127.0 + 1e-12).float()
    wq = torch.round(w / scale.unsqueeze(axis)).to(torch.int8)
    return wq, scale


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def _layer_norm_rows(x, w, b, eps: float = 1e-5):
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * w.to(x.dtype).float() + b.to(x.dtype).float()
    return y.to(x.dtype)


def _mms(a, w, s):
    """a (B, K) @ w (N, K)^T with fp32 accumulation, fp32 scale, cast."""
    y = a.float() @ w.to(a.dtype).float().T
    if s is not None:
        y = y * s.float()
    return y.to(a.dtype)


def fused_ln_qkv_plain(h, ln_w, ln_b, in_w, in_b, *, w_scale=None,
                       eps: float = 1e-5):
    n = _layer_norm_rows(h, ln_w, ln_b, eps)
    return _mms(n, in_w, w_scale) + in_b.to(h.dtype)


def _activate(y, activation: str):
    if activation == "relu":
        return torch.clamp_min(y, 0)
    if activation == "gelu":
        return F.gelu(y.float(), approximate="tanh").to(y.dtype)
    raise ValueError(f"unknown activation {activation!r}")


def fused_tail_plain(attn_out, h_res, out_w, out_b, ln2_w, ln2_b, w1, b1,
                     w2, b2, *, activation: str = "relu", w_scales=None,
                     eps: float = 1e-5):
    dt = attn_out.dtype
    os_, s1, s2 = w_scales if w_scales is not None else (None, None, None)
    h1 = h_res.to(dt) + (_mms(attn_out, out_w, os_) + out_b.to(dt))
    n = _layer_norm_rows(h1, ln2_w, ln2_b, eps)
    ffh = _activate(_mms(n, w1, s1) + b1.to(dt), activation)
    return h1 + (_mms(ffh, w2, s2) + b2.to(dt))


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _weight(name, w, scale, dt, n, k):
    """Check one weight (and its scale); returns (weight, scale, is_int8)."""
    cb.require(w.dim() == 2 and tuple(w.shape) == (n, k), name,
               f"weight shape {tuple(w.shape)} != {(n, k)}")
    if scale is not None:
        cb.require(w.dtype == torch.int8, name, "a scale needs int8 weights")
        scale = scale.float().contiguous()
        cb.require(tuple(scale.shape) == (n,), name, "scale must be (out,)")
    elif w.dtype != dt:
        cb.require(w.dtype != torch.int8, name, "int8 weights need a scale")
        w = w.to(dt)
    cb.require(w.is_contiguous() and w.data_ptr() % 16 == 0, name,
               "weight must be contiguous and 16-byte aligned")
    return w, scale, w.dtype == torch.int8


def _aligned(name, *ts):
    cb.require(all(t.data_ptr() % 16 == 0 for t in ts), name,
               "tensors must be 16-byte aligned")


def _layer_norm(name, x, ln_w, ln_b, eps):
    """csrc/fused_dense.cu:ln_rows_kernel -> LN(x), fp32 rows."""
    lib = cb.load_library()
    B, K = x.shape
    cb.require(K % 4 == 0, name, f"width {K} must be a multiple of 4")
    ln_w = ln_w.float().contiguous()
    ln_b = ln_b.float().contiguous()
    _aligned(name, x, ln_w, ln_b)
    out = torch.empty_like(x)
    rc = lib.vt_layer_norm_rows(
        x.data_ptr(), B, K, ln_w.data_ptr(), ln_b.data_ptr(), out.data_ptr(),
        float(eps), cb.stream_ptr(x))
    cb.check(rc, name)
    return out


def _dense(name, x, w, scale, bias, *, epi, resid=None, ln=None):
    """csrc/fused_dense.cu -> epi(LN?(x) @ w^T ...) (B, N): bf16 rows on
    dense_wgmma_kernel, fp32 rows on dense_rows_kernel. ln = (ln_w, ln_b,
    eps) runs LayerNorm in the kernel's prologue (bf16 only)."""
    lib = cb.load_library()
    B, K = x.shape
    N = w.shape[0]
    dt = x.dtype
    w, scale, int8 = _weight(name, w, scale, dt, N, K)
    if dt == torch.bfloat16:
        cb.require(K % 64 == 0 and N % 64 == 0, name,
                   f"widths {K} -> {N} must be multiples of 64")
    else:
        cb.require(K % 16 == 0, name,
                   f"input width {K} must be a multiple of 16")
        cb.require(ln is None, name, "fp32 rows take LayerNorm separately")
    _aligned(name, x, *(t for t in (resid,) if t is not None))
    out = torch.empty(B, N, dtype=dt, device=x.device)
    bias = bias.to(dt).contiguous()
    _aligned(name, bias)
    ln_w = ln_b = None
    eps = 0.0
    if ln is not None:
        ln_w, ln_b, eps = ln
        ln_w, ln_b = ln_w.to(dt).contiguous(), ln_b.to(dt).contiguous()
        _aligned(name, ln_w, ln_b)
    rc = lib.vt_dense_rows(
        cb.DTYPE_CODES[dt], int(int8), epi, x.data_ptr(), B, K, w.data_ptr(),
        N, None if scale is None else scale.data_ptr(), bias.data_ptr(),
        None if resid is None else resid.data_ptr(), out.data_ptr(),
        None if ln_w is None else ln_w.data_ptr(),
        None if ln_b is None else ln_b.data_ptr(), float(eps),
        cb.stream_ptr(x))
    cb.check(rc, name)
    return out


def _check_rows(name, *xs):
    for x in xs:
        cb.require(x.dtype in cb.DTYPE_CODES, name,
                   f"dtype {x.dtype} (float32 or bfloat16 only)")
        cb.require(x.dim() == 2 and x.is_contiguous(), name,
                   "activations must be contiguous (B, D)")
        cb.require(x.dtype == xs[0].dtype and x.shape == xs[0].shape, name,
                   "activations must share dtype and shape")


def fused_ln_qkv(h: torch.Tensor, ln_w, ln_b, in_w, in_b, *,
                 w_scale: Optional[torch.Tensor] = None,
                 eps: float = 1e-5) -> torch.Tensor:
    """h (B, D) -> LayerNorm -> @ in_w^T + in_b -> (B, 3D).

    in_w: (3D, D) in h's dtype, or int8 with ``w_scale`` (3D,) fp32. On
    CUDA one launch at bf16 (LayerNorm in the product's prologue), two at
    fp32.
    """
    name = "fused_ln_qkv"
    if cb.route(name, h, in_w) == "plain":
        return fused_ln_qkv_plain(h, ln_w, ln_b, in_w, in_b,
                                  w_scale=w_scale, eps=eps)
    _check_rows(name, h)
    if h.dtype == torch.bfloat16:
        out = _dense(name, h, in_w, w_scale, in_b, epi=_EPI_BIAS,
                     ln=(ln_w, ln_b, eps))
    else:
        n = _layer_norm(name, h, ln_w, ln_b, eps)
        out = _dense(name, n, in_w, w_scale, in_b, epi=_EPI_BIAS)
    cb.count_launch(name)
    return out


def fused_tail(attn_out: torch.Tensor, h_res: torch.Tensor, out_w, out_b,
               ln2_w, ln2_b, w1, b1, w2, b2, *, activation: str = "relu",
               w_scales: Optional[Tuple[torch.Tensor, ...]] = None,
               eps: float = 1e-5) -> torch.Tensor:
    """attn_out, h_res (B, D) -> out-proj + residual + LN2 + FFN + residual.

    out_w (D, D), w1 (F, D), w2 (D, F) in the activation dtype, or int8
    with ``w_scales`` = (out_s (D,), s1 (F,), s2 (D,)). On CUDA three
    launches at bf16 (out-proj + residual; LN2 + lin1 + activation; lin2
    + residual), four at fp32 (LN2 on its own); counted as one call.
    """
    name = "fused_tail"
    if cb.route(name, attn_out, h_res, out_w) == "plain":
        return fused_tail_plain(attn_out, h_res, out_w, out_b, ln2_w, ln2_b,
                                w1, b1, w2, b2, activation=activation,
                                w_scales=w_scales, eps=eps)
    _check_rows(name, attn_out, h_res)
    epi = {"relu": _EPI_RELU, "gelu": _EPI_GELU}.get(activation)
    cb.require(epi is not None, name, f"activation {activation!r}")
    os_, s1, s2 = w_scales if w_scales is not None else (None, None, None)
    h1 = _dense(name, attn_out, out_w, os_, out_b, epi=_EPI_RESID,
                resid=h_res)
    if attn_out.dtype == torch.bfloat16:
        ffh = _dense(name, h1, w1, s1, b1, epi=epi, ln=(ln2_w, ln2_b, eps))
    else:
        n = _layer_norm(name, h1, ln2_w, ln2_b, eps)
        ffh = _dense(name, n, w1, s1, b1, epi=epi)
    out = _dense(name, ffh, w2, s2, b2, epi=_EPI_RESID, resid=h1)
    cb.count_launch(name)
    return out
