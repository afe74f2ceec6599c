"""Data parallelism: a serving mesh of devices in one process, and
training over ``torch.distributed`` with one process a device.

:func:`make_mesh` is the counterpart of ``valle_tpu/parallel/mesh.py``'s
``make_mesh`` for serving: ``serving.Synthesizer`` and
``serving.ContinuousBatcher`` take its mesh and split their rows over its
devices, one thread a device (``serving.py``).

Training:

The counterpart of ``valle_tpu/parallel/mesh.py``'s data axis. The JAX
trainer runs one SPMD program over a ('data', 'model') mesh: every
process feeds the same global batch, the mesh splits its rows over
'data' and XLA sums the gradients. Here ``torchrun`` starts one process
(rank) a device; every rank still iterates the same global batches,
keeps its own contiguous block of each microbatch's rows
(:func:`local_rows`, the split JAX's ``P("data")`` makes) and, after
backward, SUMS the gradients over the ranks (:func:`all_reduce_gradients`;
the loss is a frame sum, so a mean, as ``DistributedDataParallel`` takes,
would shrink every gradient by the world size and change ScaledAdam's
clipping). Every rank then applies the same update to the same
parameters.

Tensor parallelism (JAX's 'model' axis, ``parallel/tensor.py``): with
``tp`` > 1 the job's ``world`` ranks form ``world / tp`` model groups of
``tp`` consecutive ranks (rank ``r`` is shard ``r % tp`` of data shard
``r // tp``, JAX's device layout) and ``tp`` data groups of the ranks
with the same ``r % tp``. The ranks of a model group hold the same rows
(``local_rows(batch, r // tp, world // tp)``) and their own slices of
the split weights; the gradients, the step's sums and the prenets'
statistics are summed over the data group alone (the model group's
ranks hold the same rows: a sum over the world would count them ``tp``
times).

Launch N ranks on N cards::

    torchrun --nproc-per-node N -m valle_tpu_torch.bin.trainer \\
        --world-size N ...

The backend is NCCL on cards and gloo on the CPU (``--device cpu``).
NCCL refuses two ranks on one card; ``--dp-share-device true`` lets
several ranks share the cards there are, over gloo (whose collectives
on card tensors are ``all_reduce`` and ``broadcast`` only, the two used
here). Host-side agreements (barriers, the preemption flag, metric sums)
run on CPU tensors over a gloo group.

The prenets' BatchNorm takes its batch statistics over the whole global
microbatch in JAX (one program over the mesh, its state replicated); a
rank sums its share over the ranks with :func:`all_reduce_sum`, whose
backward sums the gradients again, as the global statistics' own would.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A serving mesh with JAX's face: ``shape`` is ``{"data": dp,
    "model": tp}`` and ``devices`` its ``dp * tp`` torch devices, data
    shard by data shard: device ``i * tp + j`` holds model shard ``j`` of
    data shard ``i`` (JAX's ``(i // tp, i % tp)`` layout)."""
    devices: List[torch.device]
    tp: int = 1

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": len(self.devices) // self.tp, "model": self.tp}


def _device(d) -> torch.device:
    """``d`` as a torch.device, a card with its index."""
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(dp: Optional[int] = None, tp: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A ('data', 'model') serving mesh of ``dp`` x ``tp`` devices.

    ``devices=None`` takes every card, ``cuda:0`` .. ``cuda:n-1``, and
    raises when there is none (it never takes the CPU). ``dp`` defaults
    to the number of devices; ``dp * tp`` must equal it. A device may
    repeat (``["cpu", "cpu"]``, or ``["cuda:0", "cuda:0"]`` on a one-card
    host): its shards then share one model replica, each on its own
    thread and stream. That is the port's stand-in for the virtual
    devices JAX's tests get from ``--xla_force_host_platform_device_count``.
    With ``tp`` > 1 device ``i`` holds model shard ``i % tp`` of data
    shard ``i // tp``; ``dp`` defaults to the number of devices over
    ``tp``."""
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is available "
                               "(pass devices=['cpu', ...] for the CPU)")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = [_device(d) for d in devices]
    if dp is None:
        if len(devs) % tp:
            raise ValueError(f"tp({tp}) does not divide devices({len(devs)})")
        dp = len(devs) // tp
    if dp < 1 or dp * tp != len(devs):
        raise ValueError(f"dp({dp}) * tp({tp}) != devices({len(devs)})")
    return Mesh(devs, tp)


@dataclasses.dataclass(frozen=True)
class DataParallel:
    """This process's place in the job: rank, world size, device, the
    backend of its gradient collectives and the gloo group of its host
    ones (None: the default group). With ``tp`` > 1 also its data group
    (``data_group``, and ``host_data_group`` for host sums; None: the
    default group) and its model group (``model_group``)."""
    rank: int = 0
    world: int = 1
    device: torch.device = torch.device("cpu")
    backend: Optional[str] = None
    host_group: Optional[object] = None
    tp: int = 1
    data_group: Optional[object] = None
    host_data_group: Optional[object] = None
    model_group: Optional[object] = None

    @property
    def data_rank(self) -> int:
        return self.rank // self.tp

    @property
    def data_world(self) -> int:
        return self.world // self.tp

    @property
    def host_sum_group(self):
        """The gloo group of host sums over the data group."""
        return self.host_data_group if self.tp > 1 else self.host_group

    @property
    def model_shard(self):
        """This rank's ``parallel.tensor.ModelShard`` (None at tp 1)."""
        if self.tp == 1:
            return None
        from .tensor import ModelShard

        return ModelShard(self.tp, self.rank % self.tp, self.model_group)

    def barrier(self) -> None:
        if self.backend is not None:
            dist.barrier(group=self.host_group)

    def any(self, flag: bool) -> bool:
        """Whether ``flag`` is set on any rank (every rank calls it)."""
        if self.backend is None:
            return flag
        t = torch.tensor([int(flag)], dtype=torch.int32)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.host_group)
        return bool(t.item())


# the job this process joined (setup_distributed), whose data group the
# gradient and statistics sums run over
_JOB: Optional[DataParallel] = None


def _data_group():
    return None if _JOB is None else _JOB.data_group


def setup_distributed(device: str = "cuda", share_device: bool = False,
                      tp: int = 1, init_method: Optional[str] = None
                      ) -> DataParallel:
    """Join the job that ``torchrun`` describes in the environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``); without it, one process on ``device``, no process
    group. A rank's card is ``cuda:LOCAL_RANK`` and its backend NCCL;
    ``share_device`` maps local ranks onto the cards there are
    (round-robin) and takes gloo; ``device="cpu"`` takes gloo.
    ``init_method`` replaces the ``tcp://MASTER_ADDR:MASTER_PORT``
    rendezvous (e.g. a ``file://`` path every rank names). With ``tp`` >
    1 and a world it divides, the model and data groups are formed."""
    global _JOB
    dev = torch.device(device)
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return DataParallel(device=dev)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    backend = "gloo"
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        if share_device:
            dev = torch.device("cuda", local % max(cards, 1))
        elif local >= cards:
            raise SystemExit(
                f"local rank {local} has no card of its own ({cards} "
                f"visible); NCCL refuses two ranks on one card: pass "
                f"--dp-share-device true to share the cards over gloo")
        else:
            dev = torch.device("cuda", local)
            backend = "nccl"
        torch.cuda.set_device(dev)
    if init_method is None:
        addr = os.environ.get("MASTER_ADDR", "localhost")
        init_method = f"tcp://{addr}:{os.environ['MASTER_PORT']}"
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)
    host = None if backend == "gloo" else dist.new_group(backend="gloo")
    groups = {}
    if tp > 1 and world % tp == 0:
        groups = _tp_groups(rank, world, tp, backend)
    _JOB = DataParallel(rank=rank, world=world, device=dev, backend=backend,
                        host_group=host, tp=tp if groups else 1, **groups)
    return _JOB


def _tp_groups(rank: int, world: int, tp: int, backend: str) -> dict:
    """This rank's model group (``tp`` consecutive ranks) and data group
    (the ranks of its ``rank % tp``), each a group of the backend, and
    the data group's gloo twin for host sums. Every rank makes every
    group, in one order, as ``new_group`` asks."""
    out = {}
    for i in range(world // tp):
        g = dist.new_group(list(range(i * tp, (i + 1) * tp)))
        if rank // tp == i:
            out["model_group"] = g
    for j in range(tp):
        ranks = list(range(j, world, tp))
        g = dist.new_group(ranks)
        h = g if backend == "gloo" else dist.new_group(ranks,
                                                       backend="gloo")
        if rank % tp == j:
            out["data_group"], out["host_data_group"] = g, h
    return out


def teardown_distributed(dp: DataParallel) -> None:
    global _JOB
    _JOB = None
    if dp.backend is not None and dist.is_initialized():
        dist.destroy_process_group()


def global_stats(micro: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The statistics of one global microbatch that the forwards take over
    every row (``models/valle.py``): rows, frames, the NAR prefix draw's
    minimum length, every row's length (mode 2's starts) and row 0's
    prompt length (mode 4); for packed rows the segments (and for AR rows
    the valid targets, so the accuracy's denominator)."""
    if "audio_lens" in micro:
        lens = np.asarray(micro["audio_lens"], np.int64)
        st = {"frames": lens.sum(), "min_len": lens.min(), "lens": lens}
        if "prompt_lens" in micro:
            st["prompt_len0"] = micro["prompt_lens"][0]
    elif "seg_frames" in micro:          # packed NAR rows
        seg = np.asarray(micro["seg_frames"], np.int64)
        real = seg[seg > 0]
        st = {"frames": seg.sum(), "segments": real.size,
              "min_len": real.min() if real.size else 1 << 30}
    else:                                # packed AR rows
        st = {"frames": np.asarray(micro["row_frames"], np.int64).sum(),
              "segments": (np.asarray(micro["audio_seg"]).max(axis=1)
                           + 1).sum(),
              "targets": (np.asarray(micro["ar_targets"]) >= 0).sum()}
    st["rows"] = len(micro["text"])
    return {k: np.asarray(v, np.int64) for k, v in st.items()}


def local_rows(batch: Dict[str, np.ndarray], rank: int, world: int,
               accum: int = 1) -> Dict[str, np.ndarray]:
    """Rank ``rank``'s contiguous block of each microbatch's rows, with the
    global microbatch's statistics under ``global_<name>`` keys and the
    rank under ``global_rank`` (the counterpart of ``batch_shardings``).
    ``batch`` holds (accum, rows, ...) arrays when ``accum`` > 1, else
    (rows, ...), with rows a multiple of ``world``."""
    micros = ([batch] if accum == 1 else
              [{k: v[i] for k, v in batch.items()} for i in range(accum)])
    outs = []
    for micro in micros:
        n = len(micro["text"])
        if n % world:
            raise ValueError(f"{n} rows do not split over {world} ranks")
        per = n // world
        out = {k: v[rank * per:(rank + 1) * per] for k, v in micro.items()}
        out.update({"global_" + k: v for k, v in global_stats(micro).items()})
        out["global_row0"] = np.int64(rank * per)
        out["global_rank"] = np.int64(rank)
        outs.append(out)
    if accum == 1:
        return outs[0]
    return {k: np.stack([o[k] for o in outs]) for k in outs[0]}


def _flat_groups(tensors: Sequence[torch.Tensor]):
    """Positions of ``tensors`` grouped by dtype, in order."""
    groups: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    return groups


def all_reduce_gradients(params: Sequence[torch.nn.Parameter],
                         extra: Sequence[torch.Tensor] = ()
                         ) -> List[torch.Tensor]:
    """Sum the gradients of ``params`` over the ranks of this rank's data
    group (the world at tp 1), in place: one flat buffer a gradient
    dtype, one ``all_reduce`` each, never one a parameter. Every rank passes the same parameters in the same order;
    a parameter without a gradient adds zeros and is left without one
    (the ranks share the step's draws, so the same parameters have
    gradients on every rank). ``extra`` scalars (the step's loss and
    metric sums) ride in the fp32 buffer; returns them summed."""
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    dev = params[0].device
    tail = [torch.as_tensor(e, dtype=torch.float32, device=dev).reshape(1)
            for e in extra]
    groups = _flat_groups(grads)
    groups.setdefault(torch.float32, [])
    out_extra: List[torch.Tensor] = []
    for dtype, idx in groups.items():
        parts = [grads[i].reshape(-1) for i in idx]
        if dtype == torch.float32:
            parts += tail
        if not parts:
            continue
        flat = torch.cat(parts)
        dist.all_reduce(flat, group=_data_group())
        offset = 0
        for i in idx:
            p = params[i]
            n = p.numel()
            if p.grad is not None:
                p.grad = flat[offset:offset + n].view_as(p)
            offset += n
        if dtype == torch.float32:
            out_extra = list(flat[offset:])
    return out_extra


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        out = x.clone()
        dist.all_reduce(out, group=_data_group())
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=_data_group())
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks of the data group, differentiable:
    the gradient of each rank's share is the sum of every rank's gradient
    of the total (every rank calls it, in the same order, forward and
    backward)."""
    return _AllReduceSum.apply(x)


def ranks_share(batch) -> bool:
    """Whether ``batch`` is a rank's rows (``local_rows``) of a job of more
    than one data shard, whose statistics the ranks then sum."""
    return ("global_rank" in batch and dist.is_available()
            and dist.is_initialized()
            and dist.get_world_size(_data_group()) > 1)


def broadcast_parameters(module: torch.nn.Module) -> None:
    """Overwrite every rank's parameters and buffers with rank 0's: one
    flat buffer a dtype, one ``broadcast`` each."""
    tensors = list(module.parameters()) + list(module.buffers())
    for dtype, idx in _flat_groups(tensors).items():
        flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
        dist.broadcast(flat, src=0)
        offset = 0
        with torch.no_grad():
            for i in idx:
                n = tensors[i].numel()
                tensors[i].copy_(flat[offset:offset + n].view_as(tensors[i]))
                offset += n
