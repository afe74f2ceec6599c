"""Attention with the mask rebuilt from int32 codes: kernel 3 of the port.

Mirror of the forward of ``valle_tpu/ops/flash_mha.py:flash_mha_train``:
query i sees key j iff ``kcode[j] <= qcode[i]`` (and ``qseg[i] ==
kseg[j]`` when segment ids are given; ``add_diag`` additionally unmasks
i == j). Padded keys carry ``CODE_INVALID``. Masked scores take the finite
``NEG_INF`` so a fully masked row stays finite and uniform.

Dispatch: CPU tensors run ``reference_mha`` (the plain version); CUDA
tensors launch ``csrc/flash_mha_fwd.cu`` or raise; other devices raise.
Dropout and the backward wait for the training port (ROADMAP B5).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from . import cuda_build as cb

NEG_INF = -1e30         # finite: fully-masked rows stay finite
CODE_INVALID = 1 << 30  # kcode for padded keys: never <= any qcode


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


def reference_mha(q, k, v, qcode, kcode, *, qseg=None, kseg=None,
                  add_diag: bool = False, return_lse: bool = False):
    """Plain version: scores in fp32, softmax, P rounded to v's dtype,
    P.V accumulated in fp32. q (B, H, S, D); k, v (B, H, T, D)."""
    S, D = q.shape[2], q.shape[3]
    T = k.shape[2]
    vis = _visible(qcode, kcode, qseg, kseg, add_diag, S, T)
    s = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(D)
    s = torch.where(vis[:, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = (p.to(v.dtype).float() @ v.float()).to(v.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1)
    return out


def flash_mha_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      qcode: torch.Tensor, kcode: torch.Tensor, *,
                      qseg: Optional[torch.Tensor] = None,
                      kseg: Optional[torch.Tensor] = None,
                      add_diag: bool = False, dropout_rate: float = 0.0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (out (B, H, S, D) in q's dtype, lse (B, H, S) fp32)."""
    name = "flash_mha_fwd"
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "flash attention dropout waits for the training port "
            "(ROADMAP B5)")
    if (qseg is None) != (kseg is None):
        raise ValueError(f"{name}: qseg and kseg go together")
    if cb.route(name, q, k, v, qcode, kcode) == "plain":
        return reference_mha(q, k, v, qcode, kcode, qseg=qseg, kseg=kseg,
                             add_diag=add_diag, return_lse=True)
    B, H, S, D = q.shape
    T = k.shape[2]
    cb.require(q.dtype in cb.DTYPE_CODES and k.dtype == q.dtype
               and v.dtype == q.dtype, name,
               "q, k, v must share a float32 or bfloat16 dtype")
    cb.require(tuple(k.shape) == (B, H, T, D) and k.shape == v.shape, name,
               "k, v must be (B, H, T, D) like q")
    cb.require(D == 64, name, f"head dim {D} (the kernel takes 64)")
    cb.require(all(t.is_contiguous() for t in (q, k, v)), name,
               "q, k, v must be contiguous")
    cb.require(all(t.data_ptr() % 16 == 0 for t in (q, k, v)), name,
               "q, k, v must be 16-byte aligned")
    codes = [qcode, kcode] + ([qseg, kseg] if qseg is not None else [])
    for c, n in zip(codes, (S, T, S, T)):
        cb.require(c.dtype == torch.int32 and c.is_contiguous()
                   and tuple(c.shape) == (B, n), name,
                   "codes must be contiguous int32 (B, S) / (B, T)")
    lib = cb.load_library()
    out = torch.empty_like(q)
    lse = torch.empty(B, H, S, dtype=torch.float32, device=q.device)
    rc = lib.vt_flash_fwd(
        cb.DTYPE_CODES[q.dtype], D, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        qcode.data_ptr(), kcode.data_ptr(),
        qseg.data_ptr() if qseg is not None else None,
        kseg.data_ptr() if kseg is not None else None,
        int(add_diag), out.data_ptr(), lse.data_ptr(), B, H, S, T,
        1.0 / math.sqrt(D), cb.stream_ptr(q))
    cb.check(rc, name)
    cb.LAUNCHES[name] += 1
    return out, lse
