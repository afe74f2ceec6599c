"""Training attention with the mask rebuilt from int32 codes and dropout on
the probabilities: kernels 3 (forward) and 4 (backward) of the port.

Mirror of ``valle_tpu/ops/flash_mha.py:flash_mha_train``: query i sees key
j iff ``kcode[j] <= qcode[i]`` (and ``qseg[i] == kseg[j]`` when segment
ids are given; ``add_diag`` additionally unmasks i == j). Padded keys
carry ``CODE_INVALID``. Masked scores take the finite ``NEG_INF`` so a
fully masked row stays finite and uniform.

Dropout follows JAX's 8-bit rule: keep iff ``byte >= round(rate * 256)``,
kept probabilities rescaled by ``1 / (1 - thresh / 256)``. The bytes come
from Philox4x32-10 under ``seed`` (``ops/philox.py``; the kernels compute
the same function), or from an explicit (B, H, S, T) uint8 ``bits``
tensor, the counterpart of JAX's ``debug_bits``, so tests can hand both
sides the same bytes.

Dispatch: CPU tensors run the plain versions (``reference_mha`` and its
gradient through autograd); CUDA tensors launch
``csrc/flash_mha_fwd.cu`` / ``csrc/flash_mha_bwd.cu`` or raise; other
devices raise.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from . import cuda_build as cb
from .philox import dropout_bytes, keep_scale, keep_threshold

NEG_INF = -1e30         # finite: fully-masked rows stay finite
CODE_INVALID = 1 << 30  # kcode for padded keys: never <= any qcode
FLASH_HEAD_DIMS = (64, 128)  # what csrc/flash_mha_{fwd,bwd}.cu take


def _visible(qcode, kcode, qseg, kseg, add_diag, S, T):
    vis = kcode[:, None, :] <= qcode[:, :, None]          # (B, S, T)
    if qseg is not None:
        vis = vis & (qseg[:, :, None] == kseg[:, None, :])
    if add_diag:
        dev = qcode.device
        eye = (torch.arange(S, device=dev)[:, None]
               == torch.arange(T, device=dev)[None, :])
        vis = vis | eye[None]
    return vis


def _keep_bytes(thresh, seed, bits, B, H, S, T, device):
    if thresh == 0:
        return None
    if bits is not None:
        return bits
    if seed is None:
        raise ValueError("dropout needs a seed or explicit bits")
    return dropout_bytes(seed, B, H, S, T, device=device)


def reference_mha(q, k, v, qcode, kcode, *, qseg=None, kseg=None,
                  add_diag: bool = False, dropout_rate: float = 0.0,
                  seed: Optional[int] = None,
                  bits: Optional[torch.Tensor] = None,
                  return_lse: bool = False):
    """Plain version: scores in fp32, softmax, dropout on the
    probabilities, P rounded to v's dtype, P.V accumulated in fp32.
    q (B, H, S, D); k, v (B, H, T, D). Differentiable."""
    B, H, S, D = q.shape
    T = k.shape[2]
    vis = _visible(qcode, kcode, qseg, kseg, add_diag, S, T)
    s = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(D)
    s = torch.where(vis[:, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    thresh = keep_threshold(dropout_rate)
    byte = _keep_bytes(thresh, seed, bits, B, H, S, T, q.device)
    if byte is not None:
        p = torch.where(byte >= thresh, p * keep_scale(thresh),
                        torch.zeros_like(p))
    out = (p.to(v.dtype).float() @ v.float()).to(v.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1)
    return out


def reference_mha_grads(q, k, v, qcode, kcode, g, **kw):
    """Plain version of the backward: (dq, dk, dv) of ``reference_mha``
    (same keyword options) for the cotangent g, by autograd."""
    with torch.enable_grad():
        qkv = [x.detach().requires_grad_() for x in (q, k, v)]
        return torch.autograd.grad(reference_mha(*qkv, qcode, kcode, **kw),
                                   qkv, g)


def _check(name, q, k, v, qcode, kcode, qseg, kseg, bits):
    """Shapes, types and layout the kernels take; raises otherwise."""
    B, H, S, D = q.shape
    T = k.shape[2]
    cb.require(q.dtype in cb.DTYPE_CODES and k.dtype == q.dtype
               and v.dtype == q.dtype, name,
               "q, k, v must share a float32 or bfloat16 dtype")
    cb.require(tuple(k.shape) == (B, H, T, D) and k.shape == v.shape, name,
               "k, v must be (B, H, T, D) like q")
    cb.require(D in FLASH_HEAD_DIMS, name,
               f"head dim {D} (the kernel takes {FLASH_HEAD_DIMS})")
    cb.require(all(t.is_contiguous() for t in (q, k, v)), name,
               "q, k, v must be contiguous")
    cb.require(all(t.data_ptr() % 16 == 0 for t in (q, k, v)), name,
               "q, k, v must be 16-byte aligned")
    codes = [qcode, kcode] + ([qseg, kseg] if qseg is not None else [])
    for c, n in zip(codes, (S, T, S, T)):
        cb.require(c.dtype == torch.int32 and c.is_contiguous()
                   and tuple(c.shape) == (B, n), name,
                   "codes must be contiguous int32 (B, S) / (B, T)")
    if bits is not None:
        cb.require(bits.dtype == torch.uint8 and bits.is_contiguous()
                   and tuple(bits.shape) == (B, H, S, T), name,
                   "bits must be contiguous uint8 (B, H, S, T)")


def _dropout_args(dropout_rate, seed, bits):
    """(thresh, scale, seed, bits pointer) for the C entry points."""
    thresh = keep_threshold(dropout_rate)
    if thresh and seed is None and bits is None:
        raise ValueError("dropout needs a seed or explicit bits")
    if not thresh:
        return 0, 1.0, 0, None
    return (thresh, keep_scale(thresh),
            0 if seed is None else int(seed) & ((1 << 64) - 1),
            bits.data_ptr() if bits is not None else None)


def _seg_ptrs(qseg, kseg):
    if (qseg is None) != (kseg is None):
        raise ValueError("qseg and kseg go together")
    return ((qseg.data_ptr(), kseg.data_ptr()) if qseg is not None
            else (None, None))


def flash_mha_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      qcode: torch.Tensor, kcode: torch.Tensor, *,
                      qseg: Optional[torch.Tensor] = None,
                      kseg: Optional[torch.Tensor] = None,
                      add_diag: bool = False, dropout_rate: float = 0.0,
                      seed: Optional[int] = None,
                      bits: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward kernel wrapper. Returns (out (B, H, S, D) in q's dtype,
    lse (B, H, S) fp32)."""
    name = "flash_mha_fwd"
    seg = _seg_ptrs(qseg, kseg)
    drop = _dropout_args(dropout_rate, seed, bits)
    if cb.route(name, q, k, v, qcode, kcode) == "plain":
        return reference_mha(q, k, v, qcode, kcode, qseg=qseg, kseg=kseg,
                             add_diag=add_diag, dropout_rate=dropout_rate,
                             seed=seed, bits=bits, return_lse=True)
    _check(name, q, k, v, qcode, kcode, qseg, kseg, bits)
    B, H, S, D = q.shape
    T = k.shape[2]
    lib = cb.load_library()
    out = torch.empty_like(q)
    lse = torch.empty(B, H, S, dtype=torch.float32, device=q.device)
    rc = lib.vt_flash_fwd(
        cb.DTYPE_CODES[q.dtype], D, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        qcode.data_ptr(), kcode.data_ptr(), *seg, int(add_diag), *drop,
        out.data_ptr(), lse.data_ptr(), B, H, S, T, 1.0 / math.sqrt(D),
        cb.stream_ptr(q))
    cb.check(rc, name)
    cb.count_launch(name)
    return out, lse


def flash_mha_backward(q, k, v, qcode, kcode, out, lse, g, *, qseg=None,
                       kseg=None, add_diag: bool = False,
                       dropout_rate: float = 0.0, seed: Optional[int] = None,
                       bits: Optional[torch.Tensor] = None):
    """Backward kernel wrapper: (dq, dk, dv) for the cotangent g of the
    forward's ``out``, P recomputed from q, k and ``lse``. The plain
    version is the gradient of ``reference_mha`` through autograd (it
    ignores ``out`` and ``lse``)."""
    name = "flash_mha_bwd"
    seg = _seg_ptrs(qseg, kseg)
    drop = _dropout_args(dropout_rate, seed, bits)
    if cb.route(name, q, k, v, qcode, kcode, out, lse, g) == "plain":
        return reference_mha_grads(q, k, v, qcode, kcode, g, qseg=qseg,
                                   kseg=kseg, add_diag=add_diag,
                                   dropout_rate=dropout_rate, seed=seed,
                                   bits=bits)
    _check(name, q, k, v, qcode, kcode, qseg, kseg, bits)
    B, H, S, D = q.shape
    T = k.shape[2]
    g = g.contiguous()
    cb.require(out.shape == q.shape and g.shape == q.shape
               and out.dtype == q.dtype and g.dtype == q.dtype
               and out.is_contiguous() and out.data_ptr() % 16 == 0
               and g.data_ptr() % 16 == 0, name,
               "out and g must be contiguous, aligned and like q")
    cb.require(lse.dtype == torch.float32 and lse.is_contiguous()
               and tuple(lse.shape) == (B, H, S), name,
               "lse must be contiguous float32 (B, H, S)")
    lib = cb.load_library()
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    delta = torch.empty(B, H, S, dtype=torch.float32, device=q.device)
    rc = lib.vt_flash_bwd(
        cb.DTYPE_CODES[q.dtype], D, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        qcode.data_ptr(), kcode.data_ptr(), *seg, int(add_diag), *drop,
        out.data_ptr(), lse.data_ptr(), g.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, H, S, T,
        1.0 / math.sqrt(D), cb.stream_ptr(q))
    cb.check(rc, name)
    cb.count_launch(name)
    return dq, dk, dv


class _FlashMHA(torch.autograd.Function):
    """The kernel pair as one differentiable op: the forward saves out and
    the fp32 lse; the backward recomputes P (``jax.custom_vjp`` in the JAX
    package, flash_mha.py:342-363)."""

    @staticmethod
    def forward(ctx, q, k, v, qcode, kcode, qseg, kseg, bits, add_diag,
                dropout_rate, seed):
        out, lse = flash_mha_forward(q, k, v, qcode, kcode, qseg=qseg,
                                     kseg=kseg, add_diag=add_diag,
                                     dropout_rate=dropout_rate, seed=seed,
                                     bits=bits)
        ctx.save_for_backward(q, k, v, qcode, kcode, qseg, kseg, bits, out,
                              lse)
        ctx.opts = (add_diag, dropout_rate, seed)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, qcode, kcode, qseg, kseg, bits, out, lse = ctx.saved_tensors
        add_diag, dropout_rate, seed = ctx.opts
        dq, dk, dv = flash_mha_backward(
            q, k, v, qcode, kcode, out, lse, g, qseg=qseg, kseg=kseg,
            add_diag=add_diag, dropout_rate=dropout_rate, seed=seed,
            bits=bits)
        return dq, dk, dv, None, None, None, None, None, None, None, None


def flash_mha_train(q, k, v, qcode, kcode, *, qseg=None, kseg=None,
                    add_diag: bool = False, dropout_rate: float = 0.0,
                    seed: Optional[int] = None,
                    bits: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Differentiable attention (B, H, S, D) -> out in q's dtype: the
    kernels on CUDA, ``reference_mha`` (gradient by autograd) on the CPU.
    ``dropout_rate`` > 0 needs ``seed`` (a 64-bit int) or ``bits``."""
    if cb.route("flash_mha_train", q, k, v, qcode, kcode) == "plain":
        _dropout_args(dropout_rate, seed, bits)
        return reference_mha(q, k, v, qcode, kcode, qseg=qseg, kseg=kseg,
                             add_diag=add_diag, dropout_rate=dropout_rate,
                             seed=seed, bits=bits)
    return _FlashMHA.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                           qcode, kcode, qseg, kseg, bits, add_diag,
                           dropout_rate, seed)
