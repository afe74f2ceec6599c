"""The training step: loss -> backward -> optimizer update, with gradient
accumulation, an explicit compute dtype and stage-filtered parameters.

Mirror of ``valle_tpu/training.py`` (``make_optimizer`` :34,
``make_train_step`` :122). Parameters stay fp32; the forward casts weights
to ``compute_dtype`` at use, as the inference path does, so no loss
scaling is needed for bf16. Only the train stage's parameters are given to
the optimizer; the others get no update. Metrics are sums over the
(accumulated) batch with the top-10 accuracies weighted by frames, so they
normalize at logging time; the step returns the JAX step's keys. The
trainer CLI that drives these over a manifest directory, with
checkpoints and resume, is ``bin/trainer.py``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional

import torch

from .models.valle import VALLE, stage_params_mask, valle_forward
from .optim.schedules import eden_lr, noam_lr


@dataclasses.dataclass
class TrainState:
    model: VALLE
    optimizer: torch.optim.Optimizer
    step: int = 0          # batch counter, read by the lr schedule


def make_optimizer(model: VALLE, *, base_lr: float = 0.05,
                   clipping_scale: Optional[float] = 2.0,
                   train_stage: int = 0, warmup_steps: float = 200.0,
                   lr_batches: float = 5000.0, lr_epochs: float = 4.0,
                   optimizer_name: str = "ScaledAdam",
                   scheduler_name: str = "Eden", decoder_dim: int = 1024,
                   state_dtype="float32", device="cuda"):
    """Moves ``model`` to ``device`` and builds the optimizer over the
    train stage's parameters (the reference's optimizer build,
    ``bin/trainer.py:917-977``): ScaledAdam (default), Eve, AdamW or Adam;
    schedule Eden (default) or Noam. Returns (optimizer,
    lr_fn(batch, epoch))."""
    model.to(device)
    mask = stage_params_mask(model, train_stage)
    params = [p for n, p in model.named_parameters() if mask.get(n, False)]
    oname = optimizer_name.lower()
    if oname == "scaledadam":
        from .optim.scaled_adam import ScaledAdam

        opt = ScaledAdam(params, lr=base_lr, clipping_scale=clipping_scale,
                         state_dtype=(state_dtype
                                      if isinstance(state_dtype, torch.dtype)
                                      else getattr(torch, state_dtype)))
    elif oname == "eve":
        from .optim.eve import Eve

        opt = Eve(params, lr=base_lr)
    elif oname == "adamw":  # reference betas / weight decay
        opt = torch.optim.AdamW(params, lr=base_lr, betas=(0.9, 0.95),
                                weight_decay=1e-2, eps=1e-8)
    elif oname == "adam":
        opt = torch.optim.Adam(params, lr=base_lr, betas=(0.9, 0.95),
                               eps=1e-8)
    else:
        raise NotImplementedError(f"optimizer {optimizer_name}")
    sname = scheduler_name.lower()
    if sname == "eden":
        lr_fn = functools.partial(eden_lr, base_lr, lr_batches=lr_batches,
                                  lr_epochs=lr_epochs,
                                  warmup_batches=warmup_steps)
    elif sname == "noam":
        def lr_fn(batch, epoch):
            return noam_lr(base_lr, batch, dim_embed=decoder_dim,
                           warmup_steps=warmup_steps)
    else:
        raise NotImplementedError(f"scheduler {scheduler_name}")
    return opt, lr_fn


_ACCURACIES = ("ArTop10Accuracy", "NarTop10Accuracy")


def _frames_weighted(metrics: Dict[str, torch.Tensor]):
    """acc -> acc * frames, so sums normalize correctly at logging time."""
    out = {k: torch.as_tensor(v).detach().float() for k, v in metrics.items()}
    for k in _ACCURACIES:
        if k in out:
            out[k] = out[k] * out["frames"]
    return out


def forward_backward(model: VALLE, batch, *, train_stage: int = 0,
                     accum_steps: int = 1, compute_dtype=torch.float32,
                     forward_fn: Optional[Callable] = None,
                     generator: Optional[torch.Generator] = None,
                     device="cuda"):
    """The step's loss and gradients without the update: ``batch`` as
    ``make_train_step`` takes it moves to ``device``, each microbatch runs
    forward and backward (gradients accumulate in ``p.grad``). Returns
    (loss sum, frames-weighted metric sums), detached."""
    forward_fn = forward_fn or valle_forward
    device = torch.device(device)
    batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    micros = ([batch] if accum_steps == 1 else
              [{k: v[i] for k, v in batch.items()}
               for i in range(accum_steps)])
    loss_sum, sums = torch.zeros((), device=device), {}
    for micro in micros:
        loss, metrics = forward_fn(
            model, micro, train_stage=train_stage, generator=generator,
            deterministic=False, compute_dtype=compute_dtype)
        loss.backward()
        loss_sum = loss_sum + loss.detach()
        for k, v in _frames_weighted(metrics).items():
            sums[k] = sums[k] + v if k in sums else v
    return loss_sum, sums


def make_train_step(lr_fn: Callable, *, train_stage: int = 0,
                    accum_steps: int = 1, compute_dtype=torch.float32,
                    forward_fn: Optional[Callable] = None, device="cuda"):
    """Build ``step_fn(state, batch, epoch, generator=None) -> metrics``.

    ``batch`` maps names to arrays of shape (accum_steps, micro_batch, ...)
    when ``accum_steps`` > 1, else (batch, ...); they move to ``device``.
    ``forward_fn(model, micro, *, train_stage, generator, deterministic,
    compute_dtype) -> (loss, metrics)`` defaults to ``valle_forward``;
    ``generator`` (on the CPU) draws its random seeds. The step updates
    ``state.model`` in place, advances ``state.step`` and returns the sums
    with ``loss``, ``lr`` and ``grad_norm`` (the global norm of the raw
    accumulated gradients)."""
    def step_fn(state: TrainState, batch, epoch, generator=None):
        model, opt = state.model, state.optimizer
        opt.zero_grad(set_to_none=True)
        loss_sum, sums = forward_backward(
            model, batch, train_stage=train_stage, accum_steps=accum_steps,
            compute_dtype=compute_dtype, forward_fn=forward_fn,
            generator=generator, device=device)
        grads = [p.grad.float() for p in model.parameters()
                 if p.grad is not None]
        grad_norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        lr = lr_fn(state.step, epoch)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        state.step += 1
        return {**sums, "loss": loss_sum, "lr": lr, "grad_norm": grad_norm}

    return step_fn
