"""Learning-rate schedules as plain functions of (batch, epoch): mirror of
``valle_tpu/optim/schedules.py`` (reference ``valle/modules/optim.py``
Eden, ``valle/modules/scheduler.py`` Noam)."""

from __future__ import annotations


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
