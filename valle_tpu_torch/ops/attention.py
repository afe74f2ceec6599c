"""Attention with an additive bias or a length mask: kernels B6
(``flash_attention``) and B7 (``flash_attention_lens``) of the port, and
the dispatch ``fused_attention``.

Mirror of ``valle_tpu/ops/attention.py``:

- ``naive_attention``: scores in fp32, softmax, p rounded to v's dtype for
  P.V. The plain attention of the port's stacks, and the oracle.
- ``flash_attention``: softmax(q k^T / sqrt(Dh) + bias) v with the bias
  clamped to ``NEG_INF = -1e30`` first, so a fully masked row stays finite
  (uniform). A ``torch.autograd.Function``: the forward is
  ``csrc/flash_attention.cu`` on CUDA and ``naive_attention`` over the
  clamped bias on the CPU; the backward recomputes through
  ``naive_attention`` (``_fa_bwd`` of the JAX package, which has no
  backward kernel).
- ``flash_attention_lens``: the same with the mask rebuilt in the kernel
  from per-row lengths: the AR composite [text; audio] mask
  (``audio_causal``) or the NAR padding-only mask. Its plain version and
  its backward use the bias of ``ops/masks.py``.
- ``fused_attention``: JAX's dispatch rule. The kernel runs under
  ``VALLE_TPU_FLASH_ATTENTION=1`` on CUDA tensors with Dh in (64, 128),
  S > 1 and T >= 128; otherwise ``naive_attention``, the rule itself and
  not a fallback.

The kernel takes q, k, v through their strides (the views of the fused
in-projection need no copy), bias fp32 with a unit key stride and any
other stride 0 (a (B, 1, 1, T) key bias is never broadcast in memory), and
masks the ragged edges itself instead of padding to tiles as JAX does. A
fully masked row therefore averages over the T real keys, where JAX's
padded kernel averages over its padded width too; both are finite.

Dispatch: CPU tensors run the plain versions; CUDA tensors launch the
kernel or raise; other devices raise.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch

from . import cuda_build as cb
from . import masks as M

NEG_INF = -1e30  # finite: fully masked rows stay finite
MIN_KERNEL_T = 128  # JAX's DEFAULT_BLOCK_K: shorter key ranges stay plain


def naive_attention(q, k, v, bias):
    """q (B, H, S, D); k, v (B, H, T, D); bias broadcastable to (B, 1|H,
    S, T) or None. Scores fp32, p rounded to v's dtype for P.V."""
    s = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if bias is not None:
        s = s + bias.to(s.dtype)
    return torch.softmax(s, dim=-1).to(v.dtype) @ v


def _clamp(bias):
    return None if bias is None else torch.clamp_min(bias.float(), NEG_INF)


def _lens_bias(x_lens, y_lens, S_text: int, audio_causal: bool, S: int,
               T: int):
    if audio_causal:
        return M.ar_xy_attn_bias(x_lens, y_lens, S_text, S - S_text)
    return M.padding_attn_bias(x_lens, y_lens, S_text, T - S_text)


def _naive_grads(q, k, v, bias, g):
    """(dq, dk, dv) of ``naive_attention`` for the cotangent g."""
    with torch.enable_grad():
        qkv = [x.detach().requires_grad_() for x in (q, k, v)]
        return torch.autograd.grad(naive_attention(*qkv, bias), qkv, g)


def _check_qkv(name, q, k, v):
    B, H, S, D = q.shape
    T = k.shape[2]
    cb.require(q.dtype in cb.DTYPE_CODES and k.dtype == q.dtype
               and v.dtype == q.dtype, name,
               "q, k, v must share a float32 or bfloat16 dtype")
    cb.require(tuple(k.shape) == (B, H, T, D) and k.shape == v.shape, name,
               "k, v must be (B, H, T, D) like q")
    cb.require(D in (64, 128), name, f"head dim {D} (the kernel takes 64 "
               "or 128)")
    for x in (q, k, v):
        cb.require(x.stride(3) == 1 and x.data_ptr() % 16 == 0
                   and all(s % 8 == 0 for s in x.stride()[:3]), name,
                   "q, k, v need unit feature stride, 16-byte aligned rows")


def _launch(name, q, k, v, bias, lens):
    """Launch the forward kernel: ``bias`` (additive, B6) or ``lens`` =
    (x_lens, y_lens, S_text, audio_causal) (B7). Returns out (B, H, S, D)
    in q's dtype, contiguous."""
    _check_qkv(name, q, k, v)
    B, H, S, D = q.shape
    T = k.shape[2]
    lib = cb.load_library()
    out = torch.empty(B, H, S, D, dtype=q.dtype, device=q.device)
    bias_ptr, bstr = None, (0, 0, 0)
    if bias is not None:
        cb.require(bias.dim() == 4 and bias.shape[1] in (1, H)
                   and bias.shape[-1] == T, name,
                   f"bias {tuple(bias.shape)} must broadcast to "
                   f"(B, 1|H, S, {T})")
        bias = bias.float()
        if bias.stride(-1) != 1:
            bias = bias.contiguous()
        bias = bias.expand(B, bias.shape[1], S, T)   # stride 0 if size 1
        bias_ptr = bias.data_ptr()
        bstr = (bias.stride(0), bias.stride(1) if bias.shape[1] > 1 else 0,
                bias.stride(2))
    xl = yl = None
    s_text, causal = 0, 0
    if lens is not None:
        x_lens, y_lens, s_text, causal = lens
        xl, yl = (x.to(torch.int32).contiguous() for x in (x_lens, y_lens))
        cb.require(xl.shape == (B,) and yl.shape == (B,), name,
                   "x_lens and y_lens must be (B,)")
    rc = lib.vt_flash_attention(
        cb.DTYPE_CODES[q.dtype], D, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], bias_ptr, *bstr,
        None if xl is None else xl.data_ptr(),
        None if yl is None else yl.data_ptr(), int(s_text), int(causal),
        out.data_ptr(), B, H, S, T, 1.0 / math.sqrt(D), cb.stream_ptr(q))
    cb.check(rc, name)
    return out


class _FlashAttention(torch.autograd.Function):
    """B6 (``lens`` None) or B7 forward; the backward recomputes through
    ``naive_attention`` on the clamped bias (``_fa_bwd`` / ``_fal_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, lens):
        ctx.save_for_backward(q, k, v)
        ctx.bias, ctx.lens = bias, lens
        name = "flash_attention" if lens is None else "flash_attention_lens"
        if cb.route(name, q, k, v, bias,
                    *(lens[:2] if lens else ())) == "plain":
            return naive_attention(q, k, v, _plain_bias(q, k, bias, lens))
        out = _launch(name, q, k, v, bias, lens)
        cb.LAUNCHES[name] += 1
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        bias = _plain_bias(q, k, ctx.bias, ctx.lens)
        return (*_naive_grads(q, k, v, bias, g), None, None)


def _plain_bias(q, k, bias, lens):
    """The clamped bias of the plain version: ``bias`` (B6) or the lens
    mask of ``ops/masks.py`` (B7). The kernel clamps as it reads."""
    if lens is None:
        return _clamp(bias)
    return _clamp(_lens_bias(*lens, q.shape[2], k.shape[2]))


def flash_attention(q, k, v, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """B6: q (B, H, S, D); k, v (B, H, T, D); bias additive (B, 1|H, S|1,
    T), finite or -inf (clamped to NEG_INF), or None. Differentiable."""
    return _FlashAttention.apply(q, k, v, bias, None)


def flash_attention_lens(q, k, v, x_lens, y_lens, S_text: int,
                         audio_causal: bool = True) -> torch.Tensor:
    """B7: attention over ``[text (S_text); audio]`` with the mask built
    from the lengths: text keys < x_len and audio keys < y_len are valid;
    with ``audio_causal`` text queries see text keys only and audio
    queries text keys and audio keys up to their own position (S == T),
    else every query sees every valid key. Differentiable."""
    return _FlashAttention.apply(q, k, v, None,
                                 (x_lens, y_lens, int(S_text),
                                  bool(audio_causal)))


def use_flash_kernel(q, k) -> bool:
    """JAX's rule (``fused_attention``): the switch, a CUDA tensor, Dh in
    (64, 128), S > 1 and T >= 128."""
    return (os.environ.get("VALLE_TPU_FLASH_ATTENTION") == "1"
            and q.device.type == "cuda" and q.shape[-1] in (64, 128)
            and q.shape[2] > 1 and k.shape[2] >= MIN_KERNEL_T)


def fused_attention(q, k, v, bias, *,
                    use_kernel: Optional[bool] = None) -> torch.Tensor:
    """``flash_attention`` where ``use_flash_kernel`` (or ``use_kernel``)
    says so, else ``naive_attention``."""
    if use_kernel is None:
        use_kernel = use_flash_kernel(q, k)
    if not use_kernel:
        return naive_attention(q, k, v, bias)
    return flash_attention(q, k, v, bias)
