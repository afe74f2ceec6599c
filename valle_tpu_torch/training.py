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

Data parallelism (``reduce_gradients``, ``parallel/mesh.py``): each rank's
batch holds its own rows; after backward the step sums the gradients,
the loss and the metric sums over the ranks of its data group, before
the gradient norm and the optimizer's clipping, so every rank applies
the same update. Tensor parallelism (a model cut by
``parallel.tensor.shard_model``): the gradient norm and the optimizer's
per-tensor statistics are those of the whole tensors (summed over the
model shards), as JAX's SPMD step computes them.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional

import torch

from .models.valle import VALLE, stage_params_mask, valle_forward
from .optim.schedules import eden_lr, noam_lr
from .parallel.tensor import model_shard, model_sums


def default_forward(model) -> Callable:
    """``valle_forward``, or for the Transformer TTS
    ``transformer_tts_forward``."""
    if isinstance(model, VALLE):
        return valle_forward
    from .models.transformer import transformer_tts_forward

    return transformer_tts_forward


def trainable_mask(model, train_stage: int) -> Dict[str, bool]:
    """``stage_params_mask`` for VALL-E / VALL-F; every trainable
    parameter of the Transformer TTS, whatever the stage (JAX masks only
    trees with ``ar`` and ``nar`` halves)."""
    if isinstance(model, VALLE):
        return stage_params_mask(model, train_stage)
    return {n: True for n, p in model.named_parameters() if p.requires_grad}


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
    lr_fn(batch, epoch)). A model cut to a shard gives ScaledAdam and Eve
    its split parameters and shard."""
    model.to(device)
    mask = trainable_mask(model, train_stage)
    names = [n for n, _ in model.named_parameters() if mask.get(n, False)]
    params = [p for n, p in model.named_parameters() if mask.get(n, False)]
    shard = model_shard(model)
    tp_kw = {} if shard is None else dict(
        sharded=[n in model.tp_dims for n in names], model_shard=shard)
    oname = optimizer_name.lower()
    if oname == "scaledadam":
        from .optim.scaled_adam import ScaledAdam

        opt = ScaledAdam(params, lr=base_lr, clipping_scale=clipping_scale,
                         state_dtype=(state_dtype
                                      if isinstance(state_dtype, torch.dtype)
                                      else getattr(torch, state_dtype)),
                         **tp_kw)
    elif oname == "eve":
        from .optim.eve import Eve

        opt = Eve(params, lr=base_lr, **tp_kw)
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
    forward_fn = forward_fn or default_forward(model)
    device = torch.device(device)
    # the global microbatch's statistics (``global_*``) stay on the host
    batch = {k: torch.as_tensor(
        v, device=None if k.startswith("global_") else device)
        for k, v in batch.items()}
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
                    forward_fn: Optional[Callable] = None, device="cuda",
                    reduce_gradients: bool = False):
    """Build ``step_fn(state, batch, epoch, generator=None) -> metrics``.

    ``batch`` maps names to arrays of shape (accum_steps, micro_batch, ...)
    when ``accum_steps`` > 1, else (batch, ...); they move to ``device``.
    ``forward_fn(model, micro, *, train_stage, generator, deterministic,
    compute_dtype) -> (loss, metrics)`` defaults to ``default_forward``;
    ``generator`` (on the CPU) draws its random seeds. The step updates
    ``state.model`` in place, advances ``state.step`` and returns the sums
    with ``loss``, ``lr`` and ``grad_norm`` (the global norm of the raw
    accumulated gradients, over whole tensors under a model shard). With
    ``reduce_gradients`` (a process group joined) ``batch`` is the rank's
    ``parallel.mesh.local_rows`` and the gradients and returned sums are
    the total over the ranks of its data group."""
    def step_fn(state: TrainState, batch, epoch, generator=None):
        model, opt = state.model, state.optimizer
        opt.zero_grad(set_to_none=True)
        loss_sum, sums = forward_backward(
            model, batch, train_stage=train_stage, accum_steps=accum_steps,
            compute_dtype=compute_dtype, forward_fn=forward_fn,
            generator=generator, device=device)
        if reduce_gradients:
            # a SUM over the ranks (the loss is a frame sum), over the
            # stage's parameters in one order on every rank
            from .parallel.mesh import all_reduce_gradients

            mask = trainable_mask(model, train_stage)
            keys = sorted(sums)
            total = all_reduce_gradients(
                [p for n, p in model.named_parameters() if mask.get(n)],
                [loss_sum] + [sums[k] for k in keys])
            loss_sum, sums = total[0], dict(zip(keys, total[1:]))
        grads = [(n, p.grad.float()) for n, p in model.named_parameters()
                 if p.grad is not None]
        shard = model_shard(model)
        if shard is None:
            grad_norm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g) for _, g in grads]))
        else:
            grad_norm = torch.stack(model_sums(
                [g.pow(2).sum() for _, g in grads],
                [n in model.tp_dims for n, _ in grads], shard)).sum().sqrt()
        lr = lr_fn(state.step, epoch)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        state.step += 1
        return {**sums, "loss": loss_sum, "lr": lr, "grad_norm": grad_norm}

    return step_fn
