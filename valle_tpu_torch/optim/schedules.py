"""Learning-rate schedules as plain functions of (batch, epoch): mirror of
``valle_tpu/optim/schedules.py`` (reference ``valle/modules/optim.py``
Eden, ``valle/modules/scheduler.py`` Noam and ``get_scheduler``), with
the cosine schedule and the factory."""

from __future__ import annotations

import math


def eden_lr(base_lr: float, batch, epoch, *, lr_batches: float = 5000.0,
            lr_epochs: float = 4.0, warmup_batches: float = 500.0) -> float:
    """lr = base_lr * ((batch^2 + B^2) / B^2)^-0.25
    * ((epoch^2 + E^2) / E^2)^-0.25 * warmup, the warmup going linearly
    from 0.5 to 1 over ``warmup_batches``."""
    batch, epoch = float(batch), float(epoch)
    factor = (((batch ** 2 + lr_batches ** 2) / lr_batches ** 2) ** -0.25
              * ((epoch ** 2 + lr_epochs ** 2) / lr_epochs ** 2) ** -0.25)
    warmup = (1.0 if batch >= warmup_batches
              else 0.5 + 0.5 * batch / warmup_batches)
    return base_lr * factor * warmup


def noam_lr(base_lr: float, step, *, dim_embed: int,
            warmup_steps: int) -> float:
    """Noam; ``step`` is 1-based (clamped to at least 1)."""
    step = max(float(step), 1.0)
    return base_lr * dim_embed ** -0.5 * min(step ** -0.5,
                                             step * warmup_steps ** -1.5)


def cosine_lr(base_lr: float, step, *, total_steps: int,
              eta_min: float = 0.0) -> float:
    """Cosine decay from ``base_lr`` to ``eta_min`` over ``total_steps``,
    held at ``eta_min`` after."""
    step = min(float(step), float(total_steps))
    return eta_min + 0.5 * (base_lr - eta_min) * (
        1.0 + math.cos(math.pi * step / total_steps))


def get_lr_fn(params):
    """``lr(batch_idx, epoch) -> lr`` for ``params.scheduler_name`` (eden,
    noam or cosine, any case), read with ``base_lr``, ``warmup_steps`` and
    (noam) ``decoder_dim``: the reference's ``get_scheduler``. Cosine
    decays over ``warmup_steps`` batches, as in the JAX package. Another
    name raises ``NotImplementedError``."""
    name = params.scheduler_name.lower()
    if name == "eden":
        return lambda batch, epoch: eden_lr(
            params.base_lr, batch, epoch, lr_batches=5000.0, lr_epochs=4.0,
            warmup_batches=params.warmup_steps)
    if name == "noam":
        return lambda batch, epoch: noam_lr(
            params.base_lr, batch, dim_embed=params.decoder_dim,
            warmup_steps=params.warmup_steps)
    if name == "cosine":
        return lambda batch, epoch: cosine_lr(
            params.base_lr, batch, total_steps=params.warmup_steps)
    raise NotImplementedError(params.scheduler_name)
