"""Tensor parallelism: the 'model' axis of the ('data', 'model') mesh.

The counterpart of ``valle_tpu/parallel/mesh.py``'s ``_spec_from_keys``,
``_guarded_sharding``, ``param_shardings`` and ``opt_state_shardings``.
JAX annotates the parameters and lets GSPMD insert the collectives; the
port does by hand what GSPMD does:

- The rule (:func:`shard_dim`) splits the same leaves over 'model' as
  JAX: the first FFN linear (``linear1`` weight and bias, and the audio
  prenets' second linear, JAX's ``lin1``) by its output features, the
  second (``linear2`` weight, the prenets' third, ``lin2``) and the
  attention out-projection (``self_attn`` / ``multihead_attn``
  ``out_proj.weight``, JAX's ``out_w``) by their input features. Torch
  keeps a Linear's weight as (out, in), JAX as (in, out), so the split
  dimension of a weight is the other one. The packed in-projection, the
  biases added after a sum, norms, embeddings and the text prenets stay
  whole, and a leaf whose split dimension ``tp`` does not divide stays
  whole too (JAX's guard).
- Every shard runs attention over all heads (the in-projection is
  whole), keeps its ``d / tp`` columns of the heads' output for its share
  of the out-projection (:func:`shard_columns`: the slice forward, an
  all-gather backward), and its ``F / tp`` hidden features of the FFN
  (:func:`to_shards`: the identity forward, a sum of the input's
  gradients backward). The partial products are summed over the shards
  (:func:`sum_shards`: a sum forward, the identity backward) and the bias
  is added once, after the sum (:func:`row_parallel`).
- A shard is one rank of a ``torchrun`` job (its model group a process
  group) or one thread of a serving process that holds every shard (a
  :class:`ThreadGroup`): the model code is the same. A module that takes
  part carries its :class:`ModelShard` in ``model_shard``
  (:func:`shard_model`); a module without one runs whole.

The gathers are sums of zero-filled whole tensors (exact at any dtype): a
gloo group on card tensors offers ``all_reduce`` and ``broadcast`` only,
and the same code then runs over gloo and NCCL. A checkpoint holds whole
tensors (:func:`gather_state_dict`), as JAX's holds global arrays, so it
loads at any ``tp``.
"""

from __future__ import annotations

import copy
import dataclasses
import re
import threading
from typing import Dict, List, Mapping, Optional, Sequence, Union

import torch
import torch.distributed as dist

# (pattern on the reference's state-dict name, the torch dim 'model' splits)
_RULES = (
    (re.compile(r"(^|\.)(self_attn|multihead_attn)\.out_proj\.weight$"), 1),
    (re.compile(r"(^|\.)linear1\.(weight|bias)$"), 0),
    (re.compile(r"(^|\.)linear2\.weight$"), 1),
    # the audio prenets' Linears at 0, 3, 6 are JAX's lin0, lin1, lin2
    (re.compile(r"(^|\.)(ar_audio_prenet|nar_audio_prenet|decoder_prenet)"
                r"\.3\.(weight|bias)$"), 0),
    (re.compile(r"(^|\.)(ar_audio_prenet|nar_audio_prenet|decoder_prenet)"
                r"\.6\.weight$"), 1),
)


def shard_dim(name: str, shape: Sequence[int], tp: int) -> Optional[int]:
    """The dimension of the whole tensor ``name`` (of ``shape``) that the
    'model' axis of size ``tp`` splits, or None for a tensor every shard
    holds whole (JAX's spec through the layout flip, then its guard)."""
    for pattern, dim in _RULES:
        if pattern.search(name):
            return dim if shape[dim] % tp == 0 else None
    return None


def param_specs(state: Mapping[str, torch.Tensor], tp: int
                ) -> Dict[str, Optional[int]]:
    """:func:`shard_dim` of every entry of a whole state dict."""
    return {k: shard_dim(k, tuple(v.shape), tp) for k, v in state.items()}


def _slice(n: int, tp: int, index: int) -> slice:
    per = n // tp
    return slice(index * per, (index + 1) * per)


def shard_state_dict(state: Mapping[str, torch.Tensor], tp: int, index: int,
                     dims: Optional[Mapping[str, Optional[int]]] = None
                     ) -> Dict[str, torch.Tensor]:
    """Shard ``index``'s part of a whole state dict: each split tensor's
    slice (a contiguous copy), every other tensor as it is."""
    dims = param_specs(state, tp) if dims is None else dims
    out = {}
    for k, v in state.items():
        d = dims.get(k)
        out[k] = (v if d is None else v.narrow(
            d, index * (v.shape[d] // tp), v.shape[d] // tp).contiguous())
    return out


class ThreadGroup:
    """The model shards of one process, a thread each (a serving mesh):
    ``all_reduce`` returns the sum of every shard's tensor, added in shard
    order on the caller's device, so every shard gets the same bits. Each
    shard waits for its device's queued work before it hands its tensor
    over and after it has read the others', so no stream reads a tensor
    before it is written or after its memory is reused. A shard that fails
    elsewhere calls :meth:`abort`, which releases the others with an
    error; :meth:`reset` readies the group for the next call."""

    def __init__(self, size: int, timeout: float = 600.0):
        self.size = size
        self._parts: List[Optional[torch.Tensor]] = [None] * size
        # a shard that never comes (a diverging host loop) fails the call
        self._barrier = threading.Barrier(size, timeout=timeout)

    def _wait(self) -> None:
        try:
            self._barrier.wait()
        except threading.BrokenBarrierError:
            raise RuntimeError("another model shard of this group failed "
                               "or did not reach the same sum")

    def all_reduce(self, x: torch.Tensor, index: int) -> torch.Tensor:
        _synchronize(x.device)
        self._parts[index] = x
        self._wait()
        total = self._parts[0].to(x.device)
        for part in self._parts[1:]:
            total = total + part.to(x.device)
        _synchronize(x.device)
        self._wait()
        return total

    def abort(self) -> None:
        self._barrier.abort()

    def reset(self) -> None:
        if self._barrier.broken:
            self._barrier.reset()
        self._parts = [None] * self.size


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


@dataclasses.dataclass(frozen=True)
class ModelShard:
    """Shard ``index`` of ``tp``; ``group`` sums over the shards: a
    ``torch.distributed`` group of the ``tp`` ranks, or a
    :class:`ThreadGroup` of the threads of one process."""
    tp: int
    index: int
    group: object = None

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the shards (a new tensor)."""
        if isinstance(self.group, ThreadGroup):
            return self.group.all_reduce(x, self.index)
        out = x.contiguous().clone()
        dist.all_reduce(out, group=self.group)
        return out

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The whole tensor of the shards' slices ``x`` along ``dim``."""
        n = x.shape[dim]
        shape = list(x.shape)
        shape[dim] = n * self.tp
        full = x.new_zeros(shape)
        full.narrow(dim, self.index * n, n).copy_(x)
        return self.all_reduce(full)

    def columns(self, n: int) -> slice:
        """This shard's slice of ``n`` features."""
        return _slice(n, self.tp, self.index)


class _SumShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        return shard.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ToShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.shard.all_reduce(g), None


class _ShardColumns(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return x[..., shard.columns(x.shape[-1])].contiguous()

    @staticmethod
    def backward(ctx, g):
        return ctx.shard.gather(g, g.dim() - 1), None


def sum_shards(x: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    """The sum of the shards' partial ``x``; its gradient passes as it is
    to every shard's part."""
    return _SumShards.apply(x, shard)


def to_shards(x: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    """``x``, whole on every shard, as the input of a split product: the
    shards' gradients of it are summed."""
    return _ToShards.apply(x, shard)


def shard_columns(x: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    """This shard's columns of ``x`` (..., n), whole on every shard; the
    gradient gathers every shard's columns."""
    return _ShardColumns.apply(x, shard)


def row_parallel(x: torch.Tensor, weight: torch.Tensor,
                 bias: Optional[torch.Tensor], shard: ModelShard,
                 dtype=None) -> torch.Tensor:
    """``x @ weight.T + bias`` of a weight split by its input features: the
    shard's product of its features ``x`` (..., in / tp), summed over the
    shards, and then the bias, once. Weights cast to ``dtype`` first."""
    if dtype is not None:
        weight = weight.to(dtype)
        bias = bias.to(dtype) if bias is not None else None
    y = sum_shards(x @ weight.T, shard)
    return y + bias if bias is not None else y


def shard_model(model: torch.nn.Module, shard: ModelShard
                ) -> Dict[str, int]:
    """Cut a whole ``model`` to shard ``shard.index`` in place: every split
    parameter becomes its slice, and the module that runs the split
    product (the attention of an ``out_proj``, the layer of a ``linear1``,
    the prenet of its Linear 3) gets ``model_shard``. ``model`` itself
    keeps ``model_shard`` and ``tp_dims`` (the split parameters' names
    and dimensions). Returns ``tp_dims``."""
    dims = {}
    modules = dict(model.named_modules())
    for name, p in list(model.named_parameters()):
        d = shard_dim(name, tuple(p.shape), shard.tp)
        if d is None:
            continue
        dims[name] = d
        path = name.split(".")
        owner = modules[".".join(path[:-1])]
        n = p.shape[d] // shard.tp
        piece = p.detach().narrow(d, shard.index * n, n).clone()
        setattr(owner, path[-1], torch.nn.Parameter(
            piece, requires_grad=p.requires_grad))
        modules[".".join(path[:-2])].model_shard = shard
    model.model_shard = shard
    model.tp_dims = dims
    return dims


def sharded_copies(model: torch.nn.Module, shards: Sequence[ModelShard],
                   devices: Sequence) -> List[torch.nn.Module]:
    """A copy of the whole ``model`` a shard, on its device, cut to it
    (:func:`shard_model`); ``model`` stays whole."""
    out = []
    for shard, dev in zip(shards, devices):
        m = copy.deepcopy(model).to(dev)
        shard_model(m, shard)
        out.append(m)
    return out


def model_shard(module: torch.nn.Module) -> Optional[ModelShard]:
    """The :class:`ModelShard` a module runs under, None: whole."""
    return getattr(module, "model_shard", None)


def gather_state_dict(state: Union[Mapping[str, torch.Tensor],
                                   Sequence[Mapping[str, torch.Tensor]]],
                      dims: Mapping[str, int],
                      shard: Optional[ModelShard] = None
                      ) -> Dict[str, torch.Tensor]:
    """The whole state dict of the shards' ones: given every shard's dict
    (a list, in shard order), their slices concatenated; given this
    shard's alone, gathered over ``shard.group`` (every shard calls it).
    ``dims`` names the split entries (:func:`shard_model`)."""
    if not isinstance(state, Mapping):
        return {k: (v if k not in dims else torch.cat(
            [s[k] for s in state], dim=dims[k]))
            for k, v in state[0].items()}
    return {k: (v if k not in dims else shard.gather(v, dims[k]))
            for k, v in state.items()}


def _param_dims(params: Sequence[torch.nn.Parameter],
                names: Sequence[str], dims: Mapping[str, int]):
    return [(dims.get(n), tuple(p.shape)) for p, n in zip(params, names)]


def gather_optimizer_state(state: dict, params: Sequence[torch.nn.Parameter],
                           names: Sequence[str], dims: Mapping[str, int],
                           shard: ModelShard) -> dict:
    """An optimizer ``state_dict()`` with whole buffers: every per-
    parameter buffer shaped as its split parameter is gathered (JAX's
    ``opt_state_shardings`` mirrors the parameter's spec onto such
    buffers); the per-tensor statistics are whole already. ``params`` and
    ``names`` are the optimizer's parameters in order (every shard calls
    it)."""
    out = dict(state)
    out["state"] = {}
    for i, (d, shape) in enumerate(_param_dims(params, names, dims)):
        st = state["state"].get(i)
        if st is None:
            continue
        out["state"][i] = {
            k: (shard.gather(v, d) if d is not None and torch.is_tensor(v)
                and tuple(v.shape) == shape else v)
            for k, v in st.items()}
    return out


def shard_optimizer_state(state: dict, params: Sequence[torch.nn.Parameter],
                          names: Sequence[str], dims: Mapping[str, int],
                          shard: ModelShard) -> dict:
    """The inverse of :func:`gather_optimizer_state`: this shard's slice of
    every whole per-parameter buffer of a split parameter."""
    out = dict(state)
    out["state"] = {}
    for i, (d, shape) in enumerate(_param_dims(params, names, dims)):
        st = state["state"].get(i)
        if st is None:
            continue
        full = None if d is None else (
            shape[:d] + (shape[d] * shard.tp,) + shape[d + 1:])
        out["state"][i] = {
            k: (v.narrow(d, shard.index * shape[d], shape[d]).contiguous()
                if full is not None and torch.is_tensor(v)
                and tuple(v.shape) == full else v)
            for k, v in st.items()}
    return out


def model_sums(values: Sequence[torch.Tensor], sharded: Sequence[bool],
               shard: Optional[ModelShard]) -> List[torch.Tensor]:
    """Per-tensor sums ``values`` (scalars, one a parameter) made whole:
    those of split parameters summed over the shards in one collective,
    the others (whole on every shard) as they are."""
    idx = [i for i, s in enumerate(sharded) if s]
    if shard is None or not idx:
        return list(values)
    total = shard.all_reduce(torch.stack([values[i].reshape(())
                                          for i in idx]))
    out = list(values)
    for j, i in enumerate(idx):
        out[i] = total[j]
    return out
