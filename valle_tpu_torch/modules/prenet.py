"""The optional text and audio prenets (``--add-prenet``).

Mirror of ``valle_tpu/modules/prenet.py`` under the reference's
``nn.Sequential`` indices (the names ``valle_tpu/utils/checkpoint.py
export_torch_state_dict`` writes):

- text prenet: 3 x [Conv1d(k 5, same padding) -> BatchNorm1d -> ReLU ->
  Dropout(0.5)], then a Linear: convs at 1, 5 and 9, BatchNorms at 2, 6
  and 10, the Linear at 14;
- audio prenet: Linear(d, 256) -> ReLU -> Dropout(0.25) -> Linear(256,
  256) -> ReLU -> Dropout(0.25) -> Linear(256, d): Linears at 0, 3 and 6.

BatchNorm follows JAX's ``batch_norm``: statistics over (B, T), padded
frames included; the running variance is the unbiased one; momentum 0.1,
eps 1e-5. "Training" is the forward's ``not deterministic``: batch
statistics, the running statistics updated in place (under no_grad), and
dropout only where a seed is given, as JAX draws nothing without a key.
The running statistics are buffers that stay fp32 when the module is cast
(``BatchNorm._apply``): JAX keeps its ``state`` fp32 and casts only the
parameters at use.

Under data parallelism each rank holds its own rows, where JAX's one
program over the mesh takes the statistics over the whole microbatch; so
``reduce_stats`` sums the count, the sums and then the squared deviations
over the ranks (``parallel/mesh.py all_reduce_sum``, differentiable).
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.philox import fold_seed
from .embedding import dropout

MOMENTUM = 0.1
EPS = 1e-5
_STATS = ("running_mean", "running_var")


class BatchNorm(nn.Module):
    """BatchNorm1d's parameters and buffers under its names; the running
    statistics stay fp32 whatever the module is cast to."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long))

    def _apply(self, fn, recurse=True):
        keep = {n: self._buffers[n] for n in _STATS}
        super()._apply(fn, recurse)
        for n, b in keep.items():   # the device moves, the dtype stays
            self._buffers[n] = b.to(self._buffers[n].device)
        return self


def _stat_sums(x, reduce_stats: bool):
    """(count, mean, biased variance) per channel of x (B, T, C) fp32 over
    (B, T), over every rank's rows under ``reduce_stats``."""
    if not reduce_stats:
        mean = x.mean(dim=(0, 1))
        return (x.shape[0] * x.shape[1], mean,
                ((x - mean) ** 2).mean(dim=(0, 1)))
    from ..parallel.mesh import all_reduce_sum

    s = all_reduce_sum(torch.cat([x.sum(dim=(0, 1)),
                                  x.new_full((1,), x.shape[0] * x.shape[1])]))
    n, mean = s[-1], s[:-1] / s[-1]
    return n, mean, all_reduce_sum(((x - mean) ** 2).sum(dim=(0, 1))) / n


def batch_norm(bn: BatchNorm, x, *, training: bool,
               reduce_stats: bool = False):
    """x (B, T, C), normalized per channel in fp32; returns x's dtype.
    ``training`` takes the batch's statistics and moves the running ones
    towards them (JAX ``batch_norm``), else uses the running ones."""
    xf = x.float()
    if training:
        n, mean, var = _stat_sums(xf, reduce_stats)
        with torch.no_grad():
            unbiased = var * n / max(n - 1, 1) if isinstance(n, int) else (
                var * n / (n - 1).clamp_min(1))
            bn.running_mean.copy_((1 - MOMENTUM) * bn.running_mean
                                  + MOMENTUM * mean)
            bn.running_var.copy_((1 - MOMENTUM) * bn.running_var
                                 + MOMENTUM * unbiased)
            bn.num_batches_tracked += 1
    else:
        mean, var = bn.running_mean, bn.running_var
    y = (xf - mean) * torch.rsqrt(var + EPS)
    return (y * bn.weight.float() + bn.bias.float()).to(x.dtype)


class TextPrenet(nn.Module):
    """3 x (conv, BatchNorm) and a Linear at the reference's indices."""

    CONVS, NORMS, OUT = (1, 5, 9), (2, 6, 10), 14

    def __init__(self, d: int, kernel: int = 5):
        super().__init__()
        for c, b in zip(self.CONVS, self.NORMS):
            self.add_module(str(c), nn.Conv1d(d, d, kernel,
                                              padding=kernel // 2))
            self.add_module(str(b), BatchNorm(d))
        self.add_module(str(self.OUT), nn.Linear(d, d))

    def layers(self):
        """[(conv, BatchNorm)] x 3 and the Linear."""
        m = self._modules
        return ([(m[str(c)], m[str(b)])
                 for c, b in zip(self.CONVS, self.NORMS)], m[str(self.OUT)])

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        """JAX ``init_text_prenet``'s distributions: conv weights
        U(+-sqrt(3 / fan_in)), biases U(+-1 / sqrt(fan_in)) (fan_in = d x
        k), unit BatchNorms with fresh statistics, a torch-bounds
        Linear."""
        convs, out = self.layers()
        for conv, bn in convs:
            fan_in = conv.weight.shape[1] * conv.weight.shape[2]
            a = math.sqrt(3.0 / fan_in)
            conv.weight.uniform_(-a, a, generator=gen)
            b = 1.0 / math.sqrt(fan_in)
            conv.bias.uniform_(-b, b, generator=gen)
            bn.weight.fill_(1.0)
            bn.bias.zero_()
            bn.running_mean.zero_()
            bn.running_var.fill_(1.0)
            bn.num_batches_tracked.zero_()
        _uniform(out, gen)


class AudioPrenet(nn.Module):
    """Linear(d_in, 256), Linear(256, 256), Linear(256, d) at 0, 3 and 6;
    ``d_in`` is d unless given (the Transformer TTS's decoder prenet takes
    mel frames)."""

    def __init__(self, d: int, hidden: int = 256,
                 d_in: Optional[int] = None):
        super().__init__()
        for i, (a, b) in zip((0, 3, 6), ((d_in or d, hidden),
                                         (hidden, hidden), (hidden, d))):
            self.add_module(str(i), nn.Linear(a, b))

    def linears(self):
        return [self._modules[k] for k in ("0", "3", "6")]

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        for lin in self.linears():
            _uniform(lin, gen)


def _uniform(lin: nn.Linear, gen: torch.Generator) -> None:
    """torch nn.Linear's bounds (JAX ``init_linear``)."""
    fan_in = lin.weight.shape[1]
    lin.weight.uniform_(-math.sqrt(3.0 / fan_in), math.sqrt(3.0 / fan_in),
                        generator=gen)
    b = 1.0 / math.sqrt(fan_in)
    lin.bias.uniform_(-b, b, generator=gen)


def _linear(lin: nn.Linear, x):
    return x @ lin.weight.to(x.dtype).T + lin.bias.to(x.dtype)


def text_prenet(prenet: TextPrenet, x, *, training: bool,
                seed: Optional[int] = None, reduce_stats: bool = False):
    """x (B, T, d) -> (B, T, d) in x's dtype (weights cast at use).
    Dropout 0.5 after each block under ``training`` with a ``seed``."""
    convs, out = prenet.layers()
    for i, (conv, bn) in enumerate(convs):
        w = conv.weight.to(x.dtype)
        x = F.conv1d(x.transpose(1, 2), w, conv.bias.to(x.dtype),
                     padding=conv.padding).transpose(1, 2)
        x = F.relu(batch_norm(bn, x, training=training,
                              reduce_stats=reduce_stats))
        if training and seed is not None:
            x = dropout(x, 0.5, fold_seed(seed, i))
    return _linear(out, x)


def audio_prenet(prenet: AudioPrenet, x, *, training: bool = False,
                 seed: Optional[int] = None, rate: float = 0.25):
    """x (..., d_in) -> (..., d): pointwise, so it also takes a decode
    step's (B, d_in) rows. Dropout ``rate`` after the first two Linears
    under ``training`` with a ``seed``."""
    lins = prenet.linears()
    for i, lin in enumerate(lins[:2]):
        x = F.relu(_linear(lin, x))
        if training and seed is not None:
            x = dropout(x, rate, fold_seed(seed, i))
    return _linear(lins[2], x)


def batch_norms(module: nn.Module):
    return [m for m in module.modules() if isinstance(m, BatchNorm)]


@contextlib.contextmanager
def kept_statistics(module: nn.Module):
    """Restore every BatchNorm's buffers of ``module`` on exit: for
    forwards that must not move them (the trainer's OOM scan, as JAX's
    drops the scan's new state)."""
    saved = [{n: b.clone() for n, b in bn._buffers.items()}
             for bn in batch_norms(module)]
    try:
        yield
    finally:
        with torch.no_grad():
            for bn, bufs in zip(batch_norms(module), saved):
                for n, b in bufs.items():
                    bn._buffers[n].copy_(b)
