"""Pre-norm Transformer encoder stacks, plain and kernel decode paths.

Mirror of ``valle_tpu/modules/transformer.py`` (LayerNorm/AdaLN,
attention, ``encoder_stack_apply``, ``encoder_stack_prefill``,
``encoder_stack_decode_step``) under the reference's parameter names
(``layers.{i}.self_attn.in_proj_weight``, ``linear1``, ``norm1.norm``,
``norm1.project_layer``...). Linear weights keep PyTorch's (out, in)
layout; functions cast them to the compute dtype at use, as the JAX
package does. Plain attention (``attend``) is matmul -> softmax -> matmul
like ``valle_tpu/ops/attention.py:33 naive_attention``, not SDPA, so the
plain path stays comparable with the JAX package. Training adds dropout
(attention probabilities, FFN hidden, both residual branches) and
per-layer activation checkpointing (remat "full"). Post-norm stacks and
the cross-attention decoder wait for later work.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.philox import fold_seed
from .embedding import dropout

# ---------------------------------------------------------------------------
# Parameter modules (reference names)
# ---------------------------------------------------------------------------


class MultiheadAttention(nn.Module):
    def __init__(self, d: int, nhead: int):
        super().__init__()
        self.nhead = nhead
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, d))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d))
        self.out_proj = nn.Linear(d, d)


class AdaptiveLayerNorm(nn.Module):
    """Stage-conditioned affine modulation (reference transformer.py:83)."""

    def __init__(self, d: int):
        super().__init__()
        self.project_layer = nn.Linear(d, 2 * d)
        self.norm = nn.LayerNorm(d)


class TransformerEncoderLayer(nn.Module):
    def __init__(self, d: int, nhead: int, dim_ff: int, adaptive: bool):
        super().__init__()
        norm = (lambda: AdaptiveLayerNorm(d)) if adaptive else (
            lambda: nn.LayerNorm(d))
        self.self_attn = MultiheadAttention(d, nhead)
        self.linear1 = nn.Linear(d, dim_ff)
        self.linear2 = nn.Linear(dim_ff, d)
        self.norm1 = norm()
        self.norm2 = norm()


class TransformerEncoder(nn.Module):
    def __init__(self, num_layers: int, d: int, nhead: int, dim_ff: int,
                 adaptive: bool, final_norm: bool = True):
        super().__init__()
        self.nhead = nhead
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(d, nhead, dim_ff, adaptive)
            for _ in range(num_layers))
        self.norm = ((AdaptiveLayerNorm(d) if adaptive else nn.LayerNorm(d))
                     if final_norm else None)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        """Seeded init with the JAX package's distributions: xavier-uniform
        in-projection, zero attention biases, torch-Linear bounds for the
        other linears, unit LayerNorms."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                _uniform_linear(m, gen)
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        for layer in self.layers:
            attn = layer.self_attn
            d = attn.in_proj_weight.shape[1]
            a = math.sqrt(6.0 / (d + 3 * d))
            attn.in_proj_weight.uniform_(-a, a, generator=gen)
            attn.in_proj_bias.zero_()
            attn.out_proj.bias.zero_()


def _uniform_linear(lin: nn.Linear, gen: torch.Generator) -> None:
    fan_in = lin.weight.shape[1]
    bound = math.sqrt(3.0 / fan_in)
    lin.weight.uniform_(-bound, bound, generator=gen)
    if lin.bias is not None:
        b = 1.0 / math.sqrt(fan_in)
        lin.bias.uniform_(-b, b, generator=gen)


# ---------------------------------------------------------------------------
# Norms and linears
# ---------------------------------------------------------------------------


def linear(x, weight, bias=None, dtype=None):
    """x @ weight^T + bias, weights cast to ``dtype`` first."""
    if dtype is not None:
        weight = weight.to(dtype)
        bias = bias.to(dtype) if bias is not None else None
    y = x @ weight.T
    return y + bias if bias is not None else y


def layer_norm(norm: nn.LayerNorm, x, eps: float = 1e-5):
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * norm.weight.float() + norm.bias.float()
    return y.to(x.dtype)


def ada_layer_norm(norm: AdaptiveLayerNorm, x, cond, eps: float = 1e-5):
    """cond: (1|B, d) stage embedding -> weight/bias modulation."""
    p = norm.project_layer
    wb = linear(cond.float(), p.weight.float(), p.bias.float())
    weight, bias = wb.chunk(2, dim=-1)
    y = layer_norm(norm.norm, x, eps)
    return weight[:, None, :].to(x.dtype) * y + bias[:, None, :].to(x.dtype)


def apply_norm(norm, x, cond=None, eps: float = 1e-5):
    if isinstance(norm, AdaptiveLayerNorm):
        return ada_layer_norm(norm, x, cond, eps)
    return layer_norm(norm, x, eps)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def split_qkv(qkv: torch.Tensor, nhead: int):
    """Split the fused in-projection output (B, T, 3D) into q, k, v heads
    (B, H, T, Dh) each."""
    B, T, D3 = qkv.shape
    return [t.view(B, T, nhead, D3 // (3 * nhead)).transpose(1, 2)
            for t in qkv.chunk(3, dim=-1)]


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    B, H, T, Dh = x.shape
    return x.transpose(1, 2).reshape(B, T, H * Dh)


def attend(q, k, v, bias, *, score_bf16: bool = False, flash_spec=None,
           dropout_rate: float = 0.0, seed: Optional[int] = None):
    """Attention (JAX ``_attend``), dropout on the probabilities when
    ``seed`` is given. q (B,H,S,D); k,v (B,H,T,D); bias broadcastable to
    (B,1|H,S,T). ``flash_spec`` (qcode/kcode and optional
    qseg/kseg/add_diag) routes it through the differentiable
    ``ops/flash_mha.py:flash_mha_train``; otherwise scores materialize,
    in bf16 under ``score_bf16`` with bf16 inputs, else in fp32, and the
    probabilities are rounded to v's dtype for P.V."""
    if flash_spec is not None:
        from ..ops.flash_mha import flash_mha_train

        return flash_mha_train(
            q, k, v, flash_spec["qcode"], flash_spec["kcode"],
            qseg=flash_spec.get("qseg"), kseg=flash_spec.get("kseg"),
            add_diag=flash_spec.get("add_diag", False),
            dropout_rate=dropout_rate if seed is not None else 0.0,
            seed=seed)
    if score_bf16 and q.dtype == torch.bfloat16:
        s = (q @ k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    else:
        s = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if bias is not None:
        s = s + bias.to(s.dtype)
    p = dropout(torch.softmax(s, dim=-1), dropout_rate, seed)
    return p.to(v.dtype) @ v


def mha_self(attn: MultiheadAttention, x, bias, *, dtype=None,
             score_bf16=False, flash_spec=None, dropout_rate: float = 0.0,
             seed: Optional[int] = None):
    qkv = linear(x, attn.in_proj_weight, attn.in_proj_bias, dtype)
    q, k, v = split_qkv(qkv, attn.nhead)
    out = merge_heads(attend(q, k, v, bias, score_bf16=score_bf16,
                             flash_spec=flash_spec,
                             dropout_rate=dropout_rate, seed=seed))
    return linear(out, attn.out_proj.weight, attn.out_proj.bias, dtype)


_ACTIVATIONS = {"relu": F.relu,
                "gelu": lambda x: F.gelu(x, approximate="tanh")}


def ffn(layer: TransformerEncoderLayer, x, activation: str, dtype=None,
        dropout_rate: float = 0.0, seed: Optional[int] = None):
    h = _ACTIVATIONS[activation](
        linear(x, layer.linear1.weight, layer.linear1.bias, dtype))
    h = dropout(h, dropout_rate, seed)
    return linear(h, layer.linear2.weight, layer.linear2.bias, dtype)


# ---------------------------------------------------------------------------
# Stacks
# ---------------------------------------------------------------------------


def encoder_layer_apply(layer, x, bias, cond=None, *, activation="relu",
                        dtype=None, score_bf16=False, flash_spec=None,
                        dropout_rate: float = 0.0,
                        seed: Optional[int] = None):
    """One pre-norm encoder layer (reference transformer.py:296-308).
    With a ``seed``, dropout hits the attention probabilities, the
    attention output, the FFN hidden and the FFN output, each under its
    own seed folded from ``seed`` (the JAX layer splits its key in 4)."""
    sd = ([None] * 4 if seed is None
          else [fold_seed(seed, i) for i in range(4)])
    a = mha_self(layer.self_attn, apply_norm(layer.norm1, x, cond), bias,
                 dtype=dtype, score_bf16=score_bf16, flash_spec=flash_spec,
                 dropout_rate=dropout_rate, seed=sd[0])
    x = x + dropout(a, dropout_rate, sd[1])
    f = ffn(layer, apply_norm(layer.norm2, x, cond), activation, dtype,
            dropout_rate, sd[2])
    return x + dropout(f, dropout_rate, sd[3])


def encoder_stack_apply(stack: TransformerEncoder, x, bias, cond=None, *,
                        activation="relu", dtype=None, score_bf16=False,
                        flash_spec=None, dropout_rate: float = 0.0,
                        seeds: Optional[Sequence[int]] = None,
                        remat: str = "none"):
    """Run the layer stack over a full sequence; returns (B, T, D).

    ``seeds`` (one per layer, drawn before the stack) turns dropout on.
    ``remat="full"`` recomputes each layer in the backward
    (``torch.utils.checkpoint``), the JAX stack's ``jax.checkpoint`` of
    the scan body; every dropout mask comes from the layer's seed, so the
    recompute redraws the same masks. "none" keeps all activations."""
    if remat not in ("full", "none"):
        raise ValueError(f"remat must be 'full' or 'none', got {remat!r}")
    for i, layer in enumerate(stack.layers):
        fn = functools.partial(
            encoder_layer_apply, layer, activation=activation, dtype=dtype,
            score_bf16=score_bf16, flash_spec=flash_spec,
            dropout_rate=dropout_rate,
            seed=None if seeds is None else seeds[i])
        if remat == "full" and torch.is_grad_enabled():
            # the masks depend on seeds alone: no global RNG state to keep
            x = checkpoint(fn, x, bias, cond, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = fn(x, bias, cond)
    if stack.norm is not None:
        x = apply_norm(stack.norm, x, cond)
    return x


def encoder_stack_prefill(stack: TransformerEncoder, x, bias, *,
                          cache_len: int, activation="relu", dtype=None):
    """Full forward over the prefix AND build the KV cache.

    Returns (hidden, cache) with cache = {"k", "v"}: (L, B, H, cache_len,
    Dh) tensors whose first T positions are filled. The decode step
    updates this cache in place.
    """
    B, T, D = x.shape
    L, H = len(stack.layers), stack.nhead
    cache = {n: torch.zeros(L, B, H, cache_len, D // H, dtype=x.dtype,
                            device=x.device) for n in ("k", "v")}
    for li, layer in enumerate(stack.layers):
        attn = layer.self_attn
        qkv = linear(apply_norm(layer.norm1, x), attn.in_proj_weight,
                     attn.in_proj_bias, dtype)
        q, k, v = split_qkv(qkv, H)
        out = merge_heads(attend(q, k, v, bias))
        x = x + linear(out, attn.out_proj.weight, attn.out_proj.bias, dtype)
        x = x + ffn(layer, apply_norm(layer.norm2, x), activation, dtype)
        cache["k"][li, :, :, :T] = k
        cache["v"][li, :, :, :T] = v
    if stack.norm is not None:
        x = apply_norm(stack.norm, x)
    return x, cache


def quantize_kv(x, dim: int = -1):
    """Symmetric per-position int8 quantization of a KV cache (mirror of
    ``valle_tpu/modules/transformer.py:253``): x (..., Dh) -> (int8 values,
    fp32 scales (...,)) with scale = max(max|x| / 127, 1e-8), x / scale
    rounded half to even and clipped to +-127, all in fp32."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(dim=dim, keepdim=True) / 127.0,
                            1e-8)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale.squeeze(dim)


def quantize_stack_weights(stack: TransformerEncoder) -> List[Dict]:
    """Per-layer int8 weights + per-output-channel scales for decode mode
    ``fused_w8`` (mirror of ``models/inference.py:77
    quantize_decoder_weights``)."""
    from ..ops.fused_dense import quantize_weights_per_channel as q

    out = []
    for layer in stack.layers:
        in_q, in_s = q(layer.self_attn.in_proj_weight)
        out_q, out_s = q(layer.self_attn.out_proj.weight)
        w1_q, s1 = q(layer.linear1.weight)
        w2_q, s2 = q(layer.linear2.weight)
        out.append({"in_w": in_q, "in_s": in_s, "out_w": out_q,
                    "out_s": out_s, "w1": w1_q, "s1": s1, "w2": w2_q,
                    "s2": s2})
    return out


# decode modes -> the cache kind they keep (None: the (L,B,H,T,Dh) k/v pair)
CACHE_KINDS = {"int8": "int8", "fused_int8": "int8", "bf16": "kv",
               "fused_kv": "kv", "lanes": "lanes", "fused_lanes": "lanes",
               "mega": "lanes"}
# decode modes whose dense half runs fused_ln_qkv (+ fused_tail)
FUSED_MODES = ("fused", "fused_w8", "fused_int8", "fused_kv", "fused_lanes",
               "mega")


def encoder_stack_decode_step(stack: TransformerEncoder, x, cache, pos, bias,
                              *, activation="relu", dtype=None,
                              mode: str = "exact",
                              w8: Optional[List[Dict]] = None,
                              kernel_ctx=None):
    """One decode step through all layers. x: (B, 1, D); pos: (B,) or
    scalar cache write positions; bias: (B, 1, 1, T) additive key mask of
    the plain attention.

    ``mode`` "exact"/"unroll" run the plain dense path; "fused" runs
    ``fused_ln_qkv`` + ``fused_tail``; "fused_w8" the same kernels over
    the int8 weights ``w8`` (``quantize_stack_weights``). These four
    attend on the plain path over the {"k", "v"} (L, B, H, T, Dh) cache.
    The attention-kernel modes keep the cache of ``CACHE_KINDS`` (made
    once after the prefill by ``models.inference.convert_cache``) and take
    ``kernel_ctx`` = (x_lens (B,), write_pos (B,) int32, S):
    - "int8"/"fused_int8": {"kv": (L,B,H,T,2Dh) int8, "scale": (L,B,2H,T)
      fp32}, k and v quantized per step (``quantize_kv``), attention
      ``decode_attention_int8_grouped`` (B3);
    - "bf16"/"fused_kv": {"kv": (L,B,H,T,2Dh)}, ``decode_attention_kv``
      (B10);
    - "lanes"/"fused_lanes": {"kv": (L,B,T,H*2Dh)} with one row written
      per step, ``decode_attention_lanes`` (B11);
    - "mega": the lanes cache, ``fused_ln_qkv`` then ``fused_attn_tail``
      (B12: attention + out-proj + LN2 + FFN).
    The "fused_*" modes run the dense half as "fused" does; "int8",
    "bf16" and "lanes" run it on the plain path. The cache is written IN
    PLACE. Returns the hidden state (B, 1, D).
    """
    from ..ops.fused_dense import fused_ln_qkv, fused_tail

    B = x.shape[0]
    H = stack.nhead
    bidx = torch.arange(B, device=x.device)
    fused = mode in FUSED_MODES
    kind = CACHE_KINDS.get(mode)
    if mode == "fused_w8" and w8 is None:
        raise ValueError("mode 'fused_w8' needs the int8 weights w8")
    if kind is not None and kernel_ctx is None:
        raise ValueError(f"mode {mode!r} needs kernel_ctx (x_lens, "
                         "write_pos, S)")
    for li, layer in enumerate(stack.layers):
        attn = layer.self_attn
        q8 = w8[li] if mode == "fused_w8" else None
        if fused:
            qkv = fused_ln_qkv(
                x[:, 0], layer.norm1.weight, layer.norm1.bias,
                q8["in_w"] if q8 else attn.in_proj_weight,
                attn.in_proj_bias,
                w_scale=q8["in_s"] if q8 else None)[:, None]
        else:
            qkv = linear(apply_norm(layer.norm1, x), attn.in_proj_weight,
                         attn.in_proj_bias, dtype)
        q, k, v = split_qkv(qkv, H)
        _write_step(kind, cache, li, k, v, pos, bidx)
        if mode == "mega":
            from ..ops.fused_attn_tail import fused_attn_tail

            x_lens, write_pos, S = kernel_ctx
            x = fused_attn_tail(
                q, x[:, 0], cache["kv"][li], x_lens, write_pos,
                attn.out_proj.weight, attn.out_proj.bias, layer.norm2.weight,
                layer.norm2.bias, layer.linear1.weight, layer.linear1.bias,
                layer.linear2.weight, layer.linear2.bias, S=S,
                activation=activation)[:, None]
            continue
        out = merge_heads(_attend_cache(kind, cache, li, q, bias, kernel_ctx))
        if fused:
            x = fused_tail(
                out[:, 0], x[:, 0],
                q8["out_w"] if q8 else attn.out_proj.weight,
                attn.out_proj.bias, layer.norm2.weight, layer.norm2.bias,
                q8["w1"] if q8 else layer.linear1.weight,
                layer.linear1.bias,
                q8["w2"] if q8 else layer.linear2.weight,
                layer.linear2.bias, activation=activation,
                w_scales=((q8["out_s"], q8["s1"], q8["s2"]) if q8
                          else None))[:, None]
        else:
            x = x + linear(out, attn.out_proj.weight, attn.out_proj.bias,
                           dtype)
            x = x + ffn(layer, apply_norm(layer.norm2, x), activation, dtype)
    if stack.norm is not None:
        x = apply_norm(stack.norm, x)
    return x


def _write_step(kind, cache, li, k, v, pos, bidx):
    """Write this step's k/v (B, H, 1, Dh) into layer ``li`` of the cache,
    in place, in the layout of its kind."""
    if kind is None:
        ck, cv = cache["k"][li], cache["v"][li]
        ck[bidx, :, pos, :] = k[:, :, 0, :].to(ck.dtype)
        cv[bidx, :, pos, :] = v[:, :, 0, :].to(cv.dtype)
        return
    ckv = cache["kv"][li]
    if kind == "int8":
        # k and v quantized in one call (per position and head, as two)
        kvq, kvs = quantize_kv(torch.stack([k, v], dim=-2))  # (B,H,1,2,Dh)
        B, H = k.shape[:2]
        ckv[bidx, :, pos, :] = kvq[:, :, 0].reshape(B, H, -1)
        cache["scale"][li][bidx, :, pos] = kvs[:, :, 0].transpose(
            1, 2).reshape(B, 2 * H)
    elif kind == "kv":
        ckv[bidx, :, pos, :] = torch.cat([k, v], dim=-1)[:, :, 0, :].to(
            ckv.dtype)
    else:
        from ..ops.decode_attention_lanes import step_row_lanes

        ckv[bidx, pos, :] = step_row_lanes(k, v)[:, 0].to(ckv.dtype)


def _attend_cache(kind, cache, li, q, bias, kernel_ctx):
    """q (B, H, 1, Dh) over layer ``li`` of the cache: the plain path for
    the k/v pair, else the kernel of the cache kind."""
    if kind is None:
        return attend(q, cache["k"][li], cache["v"][li], bias)
    x_lens, write_pos, S = kernel_ctx
    ckv = cache["kv"][li]
    if kind == "int8":
        from ..ops.decode_attention_int8_grouped import (
            decode_attention_int8_grouped)

        return decode_attention_int8_grouped(q, ckv, cache["scale"][li],
                                             x_lens, write_pos, S=S)
    if kind == "kv":
        from ..ops.decode_attention_kv import decode_attention_kv

        return decode_attention_kv(q, ckv, x_lens, write_pos, S=S)
    from ..ops.decode_attention_lanes import decode_attention_lanes

    return decode_attention_lanes(q, ckv, x_lens, write_pos, S=S,
                                  nhead=q.shape[1])
