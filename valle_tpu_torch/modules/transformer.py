"""Transformer stacks: pre- and post-norm encoder stacks, the
cross-attending decoder stack (VALL-F), plain and kernel decode paths.

Mirror of ``valle_tpu/modules/transformer.py`` (LayerNorm/AdaLN,
attention, ``encoder_stack_apply``, ``encoder_stack_prefill``,
``encoder_stack_decode_step``, ``decoder_stack_apply``,
``decoder_stack_prefill``, ``decoder_stack_decode_step``) under the
reference's parameter names (``layers.{i}.self_attn.in_proj_weight``,
``multihead_attn``, ``linear1``, ``norm1.norm``,
``norm1.project_layer``...). A stack's ``norm_first`` picks pre-norm
(``x + f(norm(x))``) or post-norm (``norm(x + f(x))``) layers, as JAX's
``norm_first`` argument does; a post-norm stack has no final norm.
Linear weights keep PyTorch's (out, in) layout; functions cast them to
the compute dtype at use, as the JAX package does. Attention (``attend``)
follows JAX's ``_attend``: without dropout and with fp32 scores it goes
through ``ops/attention.py fused_attention`` (the flash kernel B6 under
VALLE_TPU_FLASH_ATTENTION=1 on CUDA, else ``naive_attention``: matmul ->
softmax -> matmul, not SDPA, so the plain path stays comparable with the
JAX package). Training adds dropout (attention probabilities, FFN hidden,
every residual branch) and per-layer activation checkpointing under the
JAX package's four remat policies (``none``, ``full``, ``dots``,
``scores``), for both kinds of stack.

Tensor parallelism (``parallel/tensor.py``): an attention or a layer
that carries a ``model_shard`` holds its shard's slice of the split
weights; every shard attends over all heads, and the out-projection
(``out_projection``) and the FFN (``ffn``) run its share and sum it
over the shards, the bias added once after the sum. The exact and
unroll decode steps, the prefills and the training stacks all go
through these two; the fused decode modes take whole weights and raise
under a shard.
"""

from __future__ import annotations

import contextlib
import functools
import math
import threading
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..ops.philox import fold_seed
from ..parallel.tensor import (model_shard, row_parallel, shard_columns,
                               to_shards)
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


class TransformerDecoderLayer(TransformerEncoderLayer):
    """An encoder layer plus cross-attention (``multihead_attn``, the
    reference's name) and its norm ``norm3``."""

    def __init__(self, d: int, nhead: int, dim_ff: int, adaptive: bool):
        super().__init__(d, nhead, dim_ff, adaptive)
        self.multihead_attn = MultiheadAttention(d, nhead)
        self.norm3 = AdaptiveLayerNorm(d) if adaptive else nn.LayerNorm(d)


class TransformerEncoder(nn.Module):
    """A stack of ``layer_cls`` layers; pre-norm stacks end in a final
    norm, post-norm ones have none (JAX ``final_norm=cfg.norm_first``)."""

    def __init__(self, num_layers: int, d: int, nhead: int, dim_ff: int,
                 adaptive: bool, norm_first: bool = True,
                 layer_cls=TransformerEncoderLayer):
        super().__init__()
        self.nhead = nhead
        self.norm_first = norm_first
        self.layers = nn.ModuleList(
            layer_cls(d, nhead, dim_ff, adaptive) for _ in range(num_layers))
        self.norm = ((AdaptiveLayerNorm(d) if adaptive else nn.LayerNorm(d))
                     if norm_first else None)

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
        for m in self.modules():
            if isinstance(m, MultiheadAttention):
                d = m.in_proj_weight.shape[1]
                a = math.sqrt(6.0 / (d + 3 * d))
                m.in_proj_weight.uniform_(-a, a, generator=gen)
                m.in_proj_bias.zero_()
                m.out_proj.bias.zero_()


class TransformerDecoder(TransformerEncoder):
    """VALL-F's stack: decoder layers in the same container and names."""

    def __init__(self, num_layers: int, d: int, nhead: int, dim_ff: int,
                 adaptive: bool, norm_first: bool = True):
        super().__init__(num_layers, d, nhead, dim_ff, adaptive, norm_first,
                         TransformerDecoderLayer)


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


_SCORES = threading.local()


@contextlib.contextmanager
def attention_scores():
    """Marks the PyTorch calls made inside as the attention scores and
    probabilities: what JAX names ``attn_scores`` / ``attn_probs``
    (``checkpoint_name``) and remat "scores" recomputes."""
    depth = getattr(_SCORES, "depth", 0)
    _SCORES.depth = depth + 1
    try:
        yield
    finally:
        _SCORES.depth = depth


def attend(q, k, v, bias, *, score_bf16: bool = False, flash_spec=None,
           dropout_rate: float = 0.0, seed: Optional[int] = None):
    """Attention (JAX ``_attend``), dropout on the probabilities when
    ``seed`` is given. q (B,H,S,D); k,v (B,H,T,D); bias broadcastable to
    (B,1|H,S,T). ``flash_spec`` (qcode/kcode and optional
    qseg/kseg/add_diag) routes it through the differentiable
    ``ops/flash_mha.py:flash_mha_train``. Without dropout (no seed, or
    rate 0) and with fp32 scores it is ``ops/attention.py
    fused_attention`` (kernel B6 under the switch, else the plain
    version). Otherwise scores materialize, in bf16 under ``score_bf16``
    with bf16 inputs, else in fp32, and the probabilities are rounded to
    v's dtype for P.V. The scores and probabilities are computed under
    ``attention_scores``: all of a kernel's call (the scores exist only
    inside it), and in the plain path everything before P.V."""
    if flash_spec is not None:
        from ..ops.flash_mha import flash_mha_train

        with attention_scores():
            return flash_mha_train(
                q, k, v, flash_spec["qcode"], flash_spec["kcode"],
                qseg=flash_spec.get("qseg"), kseg=flash_spec.get("kseg"),
                add_diag=flash_spec.get("add_diag", False),
                dropout_rate=dropout_rate if seed is not None else 0.0,
                seed=seed)
    bf16_scores = score_bf16 and q.dtype == torch.bfloat16
    if not bf16_scores and (seed is None or dropout_rate == 0.0):
        from ..ops.attention import fused_attention

        with attention_scores():
            return fused_attention(q, k, v, bias)
    with attention_scores():
        if bf16_scores:
            s = (q @ k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
        else:
            s = ((q.float() @ k.float().transpose(-1, -2))
                 / math.sqrt(q.shape[-1]))
        if bias is not None:
            s = s + bias.to(s.dtype)
        p = dropout(torch.softmax(s, dim=-1), dropout_rate, seed).to(v.dtype)
    return p @ v


def _heads(x: torch.Tensor, nhead: int) -> torch.Tensor:
    """(B, T, D) -> (B, H, T, Dh)."""
    B, T, D = x.shape
    return x.view(B, T, nhead, D // nhead).transpose(1, 2)


def out_projection(attn: MultiheadAttention, out, dtype=None):
    """The out-projection of the heads' output ``out`` (..., D): whole,
    or under the attention's ``model_shard`` the product of its columns
    and its slice of the weight, summed over the shards, then the bias
    (JAX's row-sharded ``out_w``)."""
    shard = model_shard(attn)
    if shard is None:
        return linear(out, attn.out_proj.weight, attn.out_proj.bias, dtype)
    return row_parallel(shard_columns(out, shard), attn.out_proj.weight,
                        attn.out_proj.bias, shard, dtype)


def mha_self(attn: MultiheadAttention, x, bias, *, dtype=None,
             score_bf16=False, flash_spec=None, dropout_rate: float = 0.0,
             seed: Optional[int] = None):
    qkv = linear(x, attn.in_proj_weight, attn.in_proj_bias, dtype)
    q, k, v = split_qkv(qkv, attn.nhead)
    out = merge_heads(attend(q, k, v, bias, score_bf16=score_bf16,
                             flash_spec=flash_spec,
                             dropout_rate=dropout_rate, seed=seed))
    return out_projection(attn, out, dtype)


def mha_kv(attn: MultiheadAttention, memory, dtype=None):
    """The cross-attention's k, v (B, H, S, Dh) of ``memory`` (B, S, D):
    the in-projection's k and v rows (JAX ``mha_self_kv``)."""
    d = memory.shape[-1]
    kv = linear(memory, attn.in_proj_weight[d:], attn.in_proj_bias[d:],
                dtype)
    k, v = kv.chunk(2, dim=-1)
    return _heads(k, attn.nhead), _heads(v, attn.nhead)


def mha_cross(attn: MultiheadAttention, xq, mk, mv, bias, *, dtype=None,
              score_bf16=False, dropout_rate: float = 0.0,
              seed: Optional[int] = None):
    """Cross-attention of ``xq`` (B, T, D) over the memory's k, v
    (``mha_kv``) with the additive ``bias`` (JAX ``mha_cross``)."""
    d = xq.shape[-1]
    q = linear(xq, attn.in_proj_weight[:d], attn.in_proj_bias[:d], dtype)
    out = merge_heads(attend(_heads(q, attn.nhead), mk, mv, bias,
                             score_bf16=score_bf16,
                             dropout_rate=dropout_rate, seed=seed))
    return out_projection(attn, out, dtype)


_ACTIVATIONS = {"relu": F.relu,
                "gelu": lambda x: F.gelu(x, approximate="tanh")}


def ffn(layer: TransformerEncoderLayer, x, activation: str, dtype=None,
        dropout_rate: float = 0.0, seed: Optional[int] = None):
    """linear1 -> activation -> dropout -> linear2. Under the layer's
    ``model_shard`` on the shard's hidden features: linear1's slice, the
    shard's slice of the whole hidden's dropout mask, linear2's share
    summed over the shards (JAX's column-sharded ``lin1``, row-sharded
    ``lin2``)."""
    shard = model_shard(layer)
    if shard is not None:
        x = to_shards(x, shard)
    h = _ACTIVATIONS[activation](
        linear(x, layer.linear1.weight, layer.linear1.bias, dtype))
    h = dropout(h, dropout_rate, seed, shard=shard)
    if shard is not None:
        return row_parallel(h, layer.linear2.weight, layer.linear2.bias,
                            shard, dtype)
    return linear(h, layer.linear2.weight, layer.linear2.bias, dtype)


# ---------------------------------------------------------------------------
# Stacks
# ---------------------------------------------------------------------------


def _residual(norm_first: bool, norm, x, f, cond=None):
    """One residual branch: ``x + f(norm(x))`` pre-norm, ``norm(x +
    f(x))`` post-norm (reference transformer.py:296-308)."""
    if norm_first:
        return x + f(apply_norm(norm, x, cond))
    return apply_norm(norm, x + f(x), cond)


def _layer_seeds(seed: Optional[int], n: int):
    return [None] * n if seed is None else [fold_seed(seed, i)
                                            for i in range(n)]


def encoder_layer_apply(layer, x, bias, cond=None, *, norm_first=True,
                        activation="relu", dtype=None, score_bf16=False,
                        flash_spec=None, dropout_rate: float = 0.0,
                        seed: Optional[int] = None):
    """One pre- or post-norm encoder layer (reference
    transformer.py:296-308). With a ``seed``, dropout hits the attention
    probabilities, the attention output, the FFN hidden and the FFN
    output, each under its own seed folded from ``seed`` (the JAX layer
    splits its key in 4)."""
    sd = _layer_seeds(seed, 4)

    def sa(h):
        return dropout(mha_self(layer.self_attn, h, bias, dtype=dtype,
                                score_bf16=score_bf16, flash_spec=flash_spec,
                                dropout_rate=dropout_rate, seed=sd[0]),
                       dropout_rate, sd[1])

    def ff(h):
        return dropout(ffn(layer, h, activation, dtype, dropout_rate, sd[2]),
                       dropout_rate, sd[3])

    x = _residual(norm_first, layer.norm1, x, sa, cond)
    return _residual(norm_first, layer.norm2, x, ff, cond)


def decoder_layer_apply(layer, x, memory, self_bias, cross_bias, cond=None,
                        *, norm_first=True, activation="relu", dtype=None,
                        score_bf16=False, dropout_rate: float = 0.0,
                        seed: Optional[int] = None):
    """One decoder layer (reference transformer.py:534-557): self-attention,
    cross-attention over ``memory`` (B, S, D) (its k, v projected here, so
    a recompute projects them again, as JAX's scan body does), FFN; with a
    ``seed``, dropout as ``encoder_layer_apply`` for each of the three
    (the JAX layer splits its key in 6)."""
    sd = _layer_seeds(seed, 6)
    mk, mv = mha_kv(layer.multihead_attn, memory, dtype)

    def sa(h):
        return dropout(mha_self(layer.self_attn, h, self_bias, dtype=dtype,
                                score_bf16=score_bf16,
                                dropout_rate=dropout_rate, seed=sd[0]),
                       dropout_rate, sd[1])

    def ca(h):
        return dropout(mha_cross(layer.multihead_attn, h, mk, mv, cross_bias,
                                 dtype=dtype, score_bf16=score_bf16,
                                 dropout_rate=dropout_rate, seed=sd[2]),
                       dropout_rate, sd[3])

    def ff(h):
        return dropout(ffn(layer, h, activation, dtype, dropout_rate, sd[4]),
                       dropout_rate, sd[5])

    x = _residual(norm_first, layer.norm1, x, sa, cond)
    x = _residual(norm_first, layer.norm2, x, ca, cond)
    return _residual(norm_first, layer.norm3, x, ff, cond)


_aten = torch.ops.aten
# the matrix products the einsum and linear routes lower to
_MATMULS = (_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
            _aten.baddbmm.default)
# calls whose value does not depend on their inputs' values
_FACTORIES = (_aten.empty_like, _aten.zeros_like, _aten.ones_like,
              _aten.full_like, _aten.new_empty, _aten.new_zeros,
              _aten.new_full, _aten.new_empty_strided)


def _dots_policy(ctx, func, *args, **kwargs):
    """JAX's ``checkpoint_dots``: keep the matrix products' outputs,
    recompute the rest."""
    return (CheckpointPolicy.MUST_SAVE if func in _MATMULS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _scores_policy(ctx, func, *args, **kwargs):
    """JAX's ``save_anything_except_these_names("attn_scores",
    "attn_probs")``: recompute what runs under ``attention_scores``, keep
    everything else. Views, in-place calls and factories (``empty_like``:
    a kernel writes its output into a fresh buffer) are recomputed too:
    they hold no work, and a kept buffer would be written again by the
    recomputed kernel."""
    if (getattr(_SCORES, "depth", 0) or func.overloadpacket in _FACTORIES
            or func._schema.is_mutable
            or any(r.alias_info is not None for r in func._schema.returns)
            or not any(isinstance(a, torch.Tensor) for a in args)):
        return CheckpointPolicy.MUST_RECOMPUTE
    return CheckpointPolicy.PREFER_SAVE


_REMAT_POLICIES = {"dots": _dots_policy, "scores": _scores_policy}
REMAT_MODES = ("none", "full", "dots", "scores")


def encoder_stack_apply(stack: TransformerEncoder, x, bias, cond=None, *,
                        activation="relu", dtype=None, score_bf16=False,
                        flash_spec=None, dropout_rate: float = 0.0,
                        seeds: Optional[Sequence[int]] = None,
                        remat: str = "none"):
    """Run the layer stack over a full sequence; returns (B, T, D).

    ``seeds`` (one per layer, drawn before the stack) turns dropout on.
    ``remat`` is the JAX stack's policy for its scan body, per layer with
    ``torch.utils.checkpoint``: "none" keeps all activations; "full"
    recomputes each layer in the backward; "dots" keeps the outputs of
    the matrix products and recomputes the rest; "scores" keeps
    everything but the attention scores and probabilities (selective
    checkpointing, ``create_selective_checkpoint_contexts``). Every
    dropout mask comes from the layer's seed, so a recompute redraws the
    same masks. A flash kernel (B4) is one call under
    ``attention_scores``, so "dots", "scores" and "full" all launch it
    again in the backward: the forward kernel runs twice a layer and
    step, the backward kernel once, as under "full"."""
    return _run_stack(stack, encoder_layer_apply, x, (bias, cond),
                      dict(activation=activation, dtype=dtype,
                           score_bf16=score_bf16, flash_spec=flash_spec,
                           dropout_rate=dropout_rate), seeds, remat, cond)


def decoder_stack_apply(stack: TransformerDecoder, x, memory, self_bias,
                        cross_bias, cond=None, *, activation="relu",
                        dtype=None, score_bf16=False,
                        dropout_rate: float = 0.0,
                        seeds: Optional[Sequence[int]] = None,
                        remat: str = "none"):
    """The cross-attending stack (VALL-F) over x (B, T, D) with ``memory``
    (B, S, D): ``self_bias`` masks x's keys, ``cross_bias`` the memory's.
    Seeds and ``remat`` as ``encoder_stack_apply``; a layer's
    checkpointed region holds its memory projections. No flash path, as
    in JAX: its attention is ``attend``'s plain or B6 route."""
    return _run_stack(stack, decoder_layer_apply, x,
                      (memory, self_bias, cross_bias, cond),
                      dict(activation=activation, dtype=dtype,
                           score_bf16=score_bf16,
                           dropout_rate=dropout_rate), seeds, remat, cond)


def _run_stack(stack, layer_fn, x, args, kw, seeds, remat, cond):
    """x through every layer (``layer_fn(layer, x, *args, **kw)``) under
    the remat policy, then the final norm where the stack has one."""
    if remat not in REMAT_MODES:
        raise ValueError(f"remat must be one of {REMAT_MODES}, got "
                         f"{remat!r}")
    context_fn = (functools.partial(create_selective_checkpoint_contexts,
                                    _REMAT_POLICIES[remat])
                  if remat in _REMAT_POLICIES else None)
    for i, layer in enumerate(stack.layers):
        fn = functools.partial(layer_fn, layer, norm_first=stack.norm_first,
                               seed=None if seeds is None else seeds[i],
                               **kw)
        if remat != "none" and torch.is_grad_enabled():
            # the masks depend on seeds alone: no global RNG state to keep
            ckw = {"context_fn": context_fn} if context_fn else {}
            x = checkpoint(fn, x, *args, use_reentrant=False,
                           preserve_rng_state=False, **ckw)
        else:
            x = fn(x, *args)
    if stack.norm is not None:
        x = apply_norm(stack.norm, x, cond)
    return x


def _caching_self_attn(attn, li, cache, bias, dtype):
    """A prefill's self-attention branch: full-sequence attention that
    writes its k, v heads into the first T rows of layer ``li`` of the
    cache."""
    def sa(h):
        q, k, v = split_qkv(linear(h, attn.in_proj_weight,
                                   attn.in_proj_bias, dtype), attn.nhead)
        T = k.shape[2]
        cache["k"][li, :, :, :T] = k
        cache["v"][li, :, :, :T] = v
        out = merge_heads(attend(q, k, v, bias))
        return out_projection(attn, out, dtype)
    return sa


def _ffn_branch(layer, activation, dtype):
    return lambda h: ffn(layer, h, activation, dtype)


def _empty_kv(L, B, H, T, Dh, x):
    return {n: torch.zeros(L, B, H, T, Dh, dtype=x.dtype, device=x.device)
            for n in ("k", "v")}


def encoder_stack_prefill(stack: TransformerEncoder, x, bias, *,
                          cache_len: int, activation="relu", dtype=None):
    """Full forward over the prefix AND build the KV cache.

    Returns (hidden, cache) with cache = {"k", "v"}: (L, B, H, cache_len,
    Dh) tensors whose first T positions are filled. The decode step
    updates this cache in place.
    """
    B, _, D = x.shape
    H, nf = stack.nhead, stack.norm_first
    cache = _empty_kv(len(stack.layers), B, H, cache_len, D // H, x)
    for li, layer in enumerate(stack.layers):
        x = _residual(nf, layer.norm1, x, _caching_self_attn(
            layer.self_attn, li, cache, bias, dtype))
        x = _residual(nf, layer.norm2, x, _ffn_branch(layer, activation,
                                                     dtype))
    if stack.norm is not None:
        x = apply_norm(stack.norm, x)
    return x, cache


def decoder_stack_prefill(stack: TransformerDecoder, x, memory, self_bias,
                          cross_bias, *, cache_len: int, activation="relu",
                          dtype=None):
    """The cross-attending prefill (JAX ``decoder_stack_prefill``): run
    the prefix x (B, T, D) over ``memory`` (B, S, D) AND build the caches.
    Returns (hidden, cache) with cache = {"k", "v" (L, B, H, cache_len,
    Dh) self-attention, first T positions filled; "mk", "mv" (L, B, H, S,
    Dh) the memory's projections, made once here and read by every decode
    step}."""
    B, _, D = x.shape
    H, nf, L = stack.nhead, stack.norm_first, len(stack.layers)
    cache = _empty_kv(L, B, H, cache_len, D // H, x)
    mks, mvs = [], []
    for li, layer in enumerate(stack.layers):
        mk, mv = mha_kv(layer.multihead_attn, memory, dtype)
        x = _residual(nf, layer.norm1, x, _caching_self_attn(
            layer.self_attn, li, cache, self_bias, dtype))
        x = _residual(nf, layer.norm2, x, lambda h: mha_cross(
            layer.multihead_attn, h, mk, mv, cross_bias, dtype=dtype))
        x = _residual(nf, layer.norm3, x, _ffn_branch(layer, activation,
                                                     dtype))
        mks.append(mk)
        mvs.append(mv)
    if stack.norm is not None:
        x = apply_norm(stack.norm, x)
    cache["mk"], cache["mv"] = torch.stack(mks), torch.stack(mvs)
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
               "mega": "lanes", "grouped": "t", "per_sample": "t"}
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
      (B12: attention + out-proj + LN2 + FFN);
    - "grouped"/"per_sample": {"k", "v"} TRANSPOSED (L,B,H,Dh,T) with one
      column written per row and step, ``decode_attention_grouped`` (B9)
      or ``decode_attention`` (B8); the JAX package's
      ``use_decode_kernel`` modes, reached through ``valle_ar_decode``.
    The "fused_*" modes run the dense half as "fused" does; "int8",
    "bf16", "lanes", "grouped" and "per_sample" run it on the plain path.
    A post-norm stack runs the plain dense path around every cache kind;
    the modes of ``FUSED_MODES`` raise for it, as JAX asserts (their
    kernels fold the pre-norm LayerNorms in).
    The cache is written IN PLACE. Returns the hidden state (B, 1, D).
    """
    from ..ops.fused_dense import fused_ln_qkv, fused_tail

    B = x.shape[0]
    H = stack.nhead
    bidx = torch.arange(B, device=x.device)
    fused = mode in FUSED_MODES
    kind = CACHE_KINDS.get(mode)
    nf = stack.norm_first
    if fused and model_shard(stack.layers[0].self_attn) is not None:
        raise ValueError(
            f"decode mode {mode!r} runs the fused dense kernels, which "
            "take whole weight matrices; this stack holds a model shard: "
            "use exact or unroll")
    if fused and not nf:
        raise ValueError(
            f"decode mode {mode!r} runs the fused dense kernels, which "
            "take pre-norm layers only; this stack has post-norm layers "
            "(norm_first=False): use exact, unroll, int8, bf16, lanes, "
            "grouped or per_sample")
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
            qkv = linear(apply_norm(layer.norm1, x) if nf else x,
                         attn.in_proj_weight, attn.in_proj_bias, dtype)
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
        out = merge_heads(_attend_cache(mode, cache, li, q, bias,
                                        kernel_ctx))
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
            sa_out = out_projection(attn, out, dtype)
            x = x + sa_out if nf else apply_norm(layer.norm1, x + sa_out)
            x = _residual(nf, layer.norm2, x, _ffn_branch(layer, activation,
                                                         dtype))
    if stack.norm is not None:
        x = apply_norm(stack.norm, x)
    return x


def decoder_stack_decode_step(stack: TransformerDecoder, x, cache, pos,
                              self_bias, cross_bias, *, activation="relu",
                              dtype=None):
    """One cross-attending decode step (JAX ``decoder_stack_decode_step``)
    on the plain path: x (B, 1, D); ``pos`` (B,) the rows' write
    positions in the self-attention cache, ``self_bias`` (B, 1, 1, T) its
    key mask, ``cross_bias`` (B, 1, 1, S) the memory's; ``cache`` from
    ``decoder_stack_prefill``, its "k"/"v" written IN PLACE. Returns the
    hidden state (B, 1, D)."""
    bidx = torch.arange(x.shape[0], device=x.device)
    nf = stack.norm_first
    for li, layer in enumerate(stack.layers):
        attn = layer.self_attn

        def sa(h):
            q, k, v = split_qkv(linear(h, attn.in_proj_weight,
                                       attn.in_proj_bias, dtype), stack.nhead)
            _write_step(None, cache, li, k, v, pos, bidx)
            out = merge_heads(attend(q, cache["k"][li], cache["v"][li],
                                     self_bias))
            return out_projection(attn, out, dtype)

        x = _residual(nf, layer.norm1, x, sa)
        x = _residual(nf, layer.norm2, x, lambda h: mha_cross(
            layer.multihead_attn, h, cache["mk"][li], cache["mv"][li],
            cross_bias, dtype=dtype))
        x = _residual(nf, layer.norm3, x, _ffn_branch(layer, activation,
                                                     dtype))
    if stack.norm is not None:
        x = apply_norm(stack.norm, x)
    return x


def _write_step(kind, cache, li, k, v, pos, bidx):
    """Write this step's k/v (B, H, 1, Dh) into layer ``li`` of the cache,
    in place, in the layout of its kind."""
    if kind is None or kind == "t":
        ck, cv = cache["k"][li], cache["v"][li]
        if kind is None:
            ck[bidx, :, pos, :] = k[:, :, 0, :].to(ck.dtype)
            cv[bidx, :, pos, :] = v[:, :, 0, :].to(cv.dtype)
        else:   # one column (B, H, Dh) of the transposed cache per row
            ck[bidx, :, :, pos] = k[:, :, 0, :].to(ck.dtype)
            cv[bidx, :, :, pos] = v[:, :, 0, :].to(cv.dtype)
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


def _attend_cache(mode, cache, li, q, bias, kernel_ctx):
    """q (B, H, 1, Dh) over layer ``li`` of the cache: the plain path for
    the k/v pair, else the kernel of the mode's cache kind."""
    kind = CACHE_KINDS.get(mode)
    if kind is None:
        return attend(q, cache["k"][li], cache["v"][li], bias)
    x_lens, write_pos, S = kernel_ctx
    if kind == "t":
        from ..ops.decode_attention import decode_attention
        from ..ops.decode_attention_grouped import decode_attention_grouped

        fn = (decode_attention_grouped if mode == "grouped"
              else decode_attention)
        return fn(q, cache["k"][li], cache["v"][li], x_lens, write_pos, S=S)
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
