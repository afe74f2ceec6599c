#!/usr/bin/env python3
"""The trainer CLI of the port (mirror of ``valle_tpu/bin/trainer.py``):
VALL-E, VALL-F, or the Transformer TTS (``--model-name transformer``, on
fbank features; ``--scaling-xformers``).

The JAX trainer's flag surface: epochs, start-epoch / start-batch resume,
exp-dir, optimizer / scheduler / base-lr / warmup, seed, inf-check,
save-every-n + keep-last-k, valid-interval, average-period model
averaging, accumulate-grad-steps, dtype, duration filters, train-stage
0/1/2, oom-check, plus the model flags (``models.add_model_arguments``)
and the data flags (``data.datamodule.TtsDataModule``). It trains on
``--device`` (default ``cuda``; without a card it raises) through
``training.make_train_step``, whose attention on the card is the flash
kernel pair (B4/B5).

Checkpoints are single ``.pt`` files in the upstream reference's layout
(``utils/checkpoint.py``): ``epoch-N.pt``, ``checkpoint-<batch>.pt``,
``best-train-loss.pt``, ``best-valid-loss.pt`` and ``preempted.pt``.
``models.load_model`` (and so ``bin/infer.py``) and the JAX package's
``load_torch_checkpoint`` rebuild the model from one alone.

Randomness: each step's dropout seeds and NAR stage come from a CPU
``torch.Generator`` seeded with ``fold_seed(--seed, step)``, as the JAX
trainer folds the step into its key; a resumed run draws what an
uninterrupted one would. A mid-epoch resume also goes on in the
checkpoint's epoch and continues the epoch's batch numbering and running
loss, so it logs what the uninterrupted run logs.

Sequence packing (``--ar-pack`` in stage 1, ``--nar-pack`` in stage 2
with prefix mode 0/1): several utterances share each fixed-shape row of
``--pack-max-text`` + ``--pack-max-frames`` positions, ``--pack-rows``
rows a batch (``data/packing.py``), through
``models.valle.valle_{ar,nar}_forward_packed``; on the card the flash
kernels take the rows' segment ids.

Data parallelism (``parallel/mesh.py``): ``torchrun --nproc-per-node N
-m valle_tpu_torch.bin.trainer --world-size N ...`` runs one rank a card
(NCCL); ``--dp-share-device true`` lets the ranks share the cards there
are, over gloo (``--device cpu`` takes gloo too). Every rank iterates the
same global batches and trains on its own contiguous block of each
microbatch's rows; the gradients are summed over the ranks, so every rank
holds the same parameters. Rank 0 alone writes checkpoints and
TensorBoard; each rank logs to its own file. The ranks share the NAR
stage and prefix draws but not their dropout masks (the rank is folded
into the dropout seeds; the JAX trainer draws one mask over the global
batch, which PyTorch cannot replay), so with dropout on, N ranks do not
train what one process does; at dropout 0 they do, to the round-off of
the reduction's order. ``--world-size-data`` (the sampler's own rank
split) stays 1 under several processes; in one process it trains on the
sampler's share ``--rank-data``.

``--visualize``: after each validation, rank 0 writes heatmaps of the
first dev batch (encoder output, model output, target features) to
``exp-dir/eval_epoch<N>/<utt_id>.png`` (``models/visualizer.py``; needs
matplotlib, and the run refuses to start without it).

Not ported here: tensor parallelism (``--tp`` > 1, out of scope); it
raises.

Example (LibriTTS AR stage, the JAX trainer's recipe):
  python3 -m valle_tpu_torch.bin.trainer --max-duration 80 \\
      --dtype bfloat16 --save-every-n 10000 --valid-interval 20000 \\
      --model-name valle --share-embedding true --norm-first true \\
      --add-prenet false --decoder-dim 1024 --nhead 16 \\
      --num-decoder-layers 12 --prefix-mode 1 --base-lr 0.05 \\
      --warmup-steps 200 --average-period 0 --train-stage 1 \\
      --num-epochs 20 --start-epoch 1 --accumulate-grad-steps 4 \\
      --exp-dir exp/valle
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import random
import signal
import threading
import time
import uuid
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models import add_model_arguments, get_model
from ..ops.philox import fold_seed
from ..utils import AttributeDict, get_env_info, setup_logger, str2bool
from ..utils import checkpoint as ckpt_lib
from ..utils.metrics import MetricsTracker


def get_parser():
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--world-size", type=int, default=1,
                        help="Data-parallel processes; must equal the "
                             "WORLD_SIZE torchrun sets (1 without "
                             "torchrun).")
    parser.add_argument("--dp-share-device", type=str2bool, default=False,
                        help="Let several ranks share the cards there are "
                             "(round-robin over gloo; NCCL refuses two "
                             "ranks on one card).")
    parser.add_argument("--tensorboard", type=str2bool, default=True)
    parser.add_argument("--num-epochs", type=int, default=20)
    parser.add_argument("--start-epoch", type=int, default=1,
                        help="Resume from exp-dir/epoch-{start_epoch-1}.pt.")
    parser.add_argument("--start-batch", type=int, default=0,
                        help="If positive, resume from "
                             "exp-dir/checkpoint-{start_batch}.pt.")
    parser.add_argument("--exp-dir", type=str, default="exp/valle_dev")
    parser.add_argument("--optimizer-name", type=str, default="ScaledAdam")
    parser.add_argument("--optim-state-dtype", type=str, default="float32",
                        choices=("float32", "bfloat16"),
                        help="Storage dtype of the per-parameter-sized "
                             "ScaledAdam buffers (momentum + second "
                             "moments); arithmetic stays fp32. Ignored by "
                             "other optimizers.")
    parser.add_argument("--scheduler-name", type=str, default="Eden")
    parser.add_argument("--base-lr", type=float, default=0.05)
    parser.add_argument("--warmup-steps", type=int, default=200)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--inf-check", type=str2bool, default=False)
    parser.add_argument("--save-every-n", type=int, default=10000)
    parser.add_argument("--valid-interval", type=int, default=10000)
    parser.add_argument("--keep-last-k", type=int, default=20)
    parser.add_argument("--average-period", type=int, default=0)
    parser.add_argument("--accumulate-grad-steps", type=int, default=1)
    parser.add_argument("--dtype", type=str, default="float32",
                        help="float32 | bfloat16 (float16 maps to "
                             "bfloat16: parameters stay fp32 and no loss "
                             "scaling is needed).")
    parser.add_argument("--filter-min-duration", type=float, default=0.0)
    parser.add_argument("--filter-max-duration", type=float, default=20.0)
    parser.add_argument("--train-stage", type=int, default=0,
                        help="0: all, 1: AR decoder, 2: NAR decoders.")
    parser.add_argument("--tp", type=int, default=1,
                        help="Tensor-parallel size (only 1: tensor "
                             "parallelism is out of scope for the port).")
    parser.add_argument("--visualize", type=str2bool, default=False,
                        help="After each validation, write heatmaps of the "
                             "first dev batch to exp-dir/eval_epoch<N> "
                             "(needs matplotlib).")
    parser.add_argument("--profile", type=str2bool, default=False,
                        help="Write a torch.profiler trace of training "
                             "steps 10-20 to exp-dir/profile.")
    parser.add_argument("--oom-check", type=str2bool, default=True,
                        help="Run forward and backward on the largest "
                             "batch of each bucket shape before training "
                             "(no update).")
    parser.add_argument("--rng-impl", type=str, default="rbg",
                        choices=("rbg", "threefry"),
                        help="The JAX trainer's dropout PRNG; no effect "
                             "here (seeds come from --seed and the step).")
    parser.add_argument("--log-interval", type=int, default=100)
    parser.add_argument("--max-steps-per-epoch", type=int, default=0,
                        help="Debug: cap the batch index of an epoch "
                             "(0 = unlimited).")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda | cpu")
    add_model_arguments(parser)
    from ..data.datamodule import TtsDataModule

    TtsDataModule.add_arguments(parser)
    return parser


def get_params() -> AttributeDict:
    return AttributeDict({
        "best_train_loss": float("inf"),
        "best_valid_loss": float("inf"),
        "best_train_epoch": -1,
        "best_valid_epoch": -1,
        "batch_idx_train": 0,
        "log_interval": 100,
        "reset_interval": 200,
        "valid_interval": 10000,
        "env_info": get_env_info(),
    })


def filter_short_and_long_utterances(cuts, min_duration, max_duration):
    def keep(c):
        return min_duration < c.duration < max_duration

    return cuts.filter(keep)


def _model_batch(batch, accum: int, dp: int = 1):
    """Host batch dict -> model inputs (numpy), reshaped for gradient
    accumulation: the batch is rounded to a multiple of ``accum * dp``
    (tiny batches are duplicated up, oversized remainders dropped), as
    the JAX trainer does, so each microbatch splits evenly over ``dp``
    ranks."""
    from ..data.input_strategies import PromptedFeatures

    if "ar_inputs" in batch or "nar_codes" in batch:
        # a sequence-packed batch (AR or NAR): already model-ready
        out = {k: np.asarray(v) for k, v in batch.items() if k != "utt_id"}
        return _group_batch(out, accum, dp)

    feats = batch["audio_features"]
    lens = batch["audio_features_lens"]
    out = {
        "text": np.asarray(batch["text_tokens"], np.int32),
        "text_lens": np.asarray(batch["text_tokens_lens"], np.int32),
    }
    if isinstance(feats, PromptedFeatures):
        prompts, features = feats.data
        p_lens, f_lens = lens.data
        out["audio"] = np.asarray(features, np.int32)
        out["audio_lens"] = np.asarray(f_lens, np.int32)
        out["prompt_codes"] = np.asarray(prompts, np.int32)
        out["prompt_lens"] = np.asarray(p_lens, np.int32)
    else:
        feats = np.asarray(feats)
        if np.issubdtype(feats.dtype, np.floating):
            out["audio"] = feats.astype(np.float32)  # mel features
        else:
            out["audio"] = feats.astype(np.int32)    # codec tokens
        out["audio_lens"] = np.asarray(lens, np.int32)

    return _group_batch(out, accum, dp)


def _group_batch(out, accum: int, dp: int = 1):
    group = accum * dp
    if group > 1:
        B = out["text"].shape[0]
        usable = (B // group) * group
        if usable == 0:  # duplicate to fill the microbatches / ranks
            reps = -(-group // B)
            out = {k: np.concatenate([v] * reps)[:group]
                   for k, v in out.items()}
            usable = group
        if accum > 1:
            out = {k: v[:usable].reshape(accum, usable // accum,
                                         *v.shape[1:])
                   for k, v in out.items()}
        else:
            out = {k: v[:usable] for k, v in out.items()}
    return out


def _rank_batch(mb, dp, accum: int):
    """The rank's rows of a grouped batch, with the global microbatch's
    statistics (``parallel.mesh.local_rows``); the batch itself in one
    process."""
    if dp.world == 1:
        return mb
    from ..parallel.mesh import local_rows

    return local_rows(mb, dp.rank, dp.world, accum)


def _forward_fn(args):
    """The step's forward: the packed forwards under ``--ar-pack`` /
    ``--nar-pack`` (with the JAX trainer's checks), else None (the
    default ``valle_forward``)."""
    if args.ar_pack:
        if args.train_stage != 1 or args.model_name.lower() != "valle":
            raise SystemExit(
                "--ar-pack requires --train-stage 1 and --model-name valle")
        from ..models.valle import valle_ar_forward_packed

        return valle_ar_forward_packed
    if args.nar_pack:
        if (args.train_stage != 2 or args.model_name.lower() != "valle"
                or args.prefix_mode not in (0, 1)):
            raise SystemExit(
                "--nar-pack requires --train-stage 2, --model-name valle "
                "and --prefix-mode 0/1")
        from ..models.valle import valle_nar_forward_packed

        return valle_nar_forward_packed
    return None


def _check_flags(args) -> None:
    """Raise for the flags whose feature the port does not have, and for
    ``--visualize`` without matplotlib (before any training)."""
    if args.tp > 1:
        raise NotImplementedError(
            "--tp > 1: tensor parallelism is out of scope for the port")
    if args.visualize:
        from ..models.visualizer import require_matplotlib

        require_matplotlib()


def _device(args) -> torch.device:
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but there is no CUDA device; "
                           "pass --device cpu to train on the CPU")
    return device


def _compute_dtype(name: str) -> torch.dtype:
    return (torch.bfloat16 if name.lower() in
            ("bfloat16", "bf16", "float16", "fp16") else torch.float32)


def _step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of step ``step`` (JAX: ``fold_in(key, step)``)."""
    return torch.Generator().manual_seed(fold_seed(seed, step))


def _sampler_core(sampler):
    """The bucketing sampler itself (``SimpleCutSampler`` wraps one)."""
    return getattr(sampler, "inner", sampler)


@dataclasses.dataclass
class TrainState:
    """The model and optimizer the step updates in place, the step
    counter and the float64 running average (``--average-period``)."""
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    model_avg: Optional[Dict[str, torch.Tensor]] = None


@dataclasses.dataclass
class RunStats:
    """What a ``run`` did, for its caller: the final state, the steps
    taken with each step's batch shape (rows, text width, audio frames),
    the batches of the ``--oom-check`` scan and of validation, and host
    seconds: the epochs' step loops (validation and checkpoint writes
    excluded; synchronized with the device at both ends), the part of
    them spent waiting for the loader, each checkpoint write (name,
    seconds, bytes; rank 0's alone), and every step's (loss sum, frames,
    grad norm) as the log reads them (over every rank's rows)."""
    state: Optional[TrainState] = None
    steps: int = 0
    batch_shapes: List[Tuple[int, int, int]] = dataclasses.field(
        default_factory=list)
    scan_batches: int = 0
    valid_batches: int = 0
    loop_seconds: float = 0.0
    loader_wait_seconds: float = 0.0
    checkpoint_writes: List[Tuple[str, float, int]] = dataclasses.field(
        default_factory=list)
    resumed_from: Optional[str] = None
    optimizer_restored: bool = False
    step_metrics: List[Tuple[float, float, float]] = dataclasses.field(
        default_factory=list)


def load_checkpoint_if_available(params, exp_dir: Path, state: TrainState
                                 ) -> Optional[dict]:
    """Resume logic incl. the stage switch (reference trainer.py:331-483).

    Loads the model weights of ``checkpoint-<start_batch>.pt``, else of
    ``preempted.pt`` (an automatic resume after preemption), else of
    ``epoch-<start_epoch - 1>.pt``, and returns the checkpoint dict (None
    if there is none). When the saved train stage differs from the
    requested one, the optimizer state is dropped and the per-stage best
    losses stay reset (reference :383-416); otherwise the optimizer, the
    best losses and the batch counter are restored."""
    path = None
    if params.start_batch > 0:
        path = exp_dir / f"checkpoint-{params.start_batch}.pt"
    elif (exp_dir / "preempted.pt").exists():
        path = exp_dir / "preempted.pt"
    elif params.start_epoch > 1:
        path = exp_dir / f"epoch-{params.start_epoch - 1}.pt"
    if path is None or not path.exists():
        return None
    logging.info(f"Loading checkpoint from {path}")
    ckpt = ckpt_lib.load_checkpoint(path)
    ckpt["path"] = str(path)
    state.model.load_state_dict(ckpt["model"], strict=True)
    saved_stage = ckpt.get("train_stage", 0)
    if saved_stage != params.train_stage:
        logging.info(
            f"Switching training stage {saved_stage} -> "
            f"{params.train_stage}: dropping optimizer state")
        ckpt.pop("optimizer", None)
        ckpt.pop("tot_loss", None)
    else:
        for k in ("best_train_loss", "best_valid_loss", "batch_idx_train"):
            if k in ckpt:
                params[k] = ckpt[k]
        if "optimizer" in ckpt:
            state.optimizer.load_state_dict(ckpt["optimizer"])
    return ckpt


def compute_validation_loss(params, model, valid_dl, compute_dtype,
                            device, dp=None) -> Tuple[MetricsTracker, int]:
    """Deterministic validation (no dropout, NAR stage 1) over the whole
    dev loader; every batch is dispatched before the scalars are read in
    one transfer. Under data parallelism (``dp``) each rank takes its
    rows of every batch and the sums are reduced over the ranks. Updates
    the best validation loss; returns (the summed tracker, the batches
    run)."""
    from ..models.valle import VALLE
    from ..parallel.mesh import DataParallel
    from ..training import default_forward

    forward = default_forward(model)
    # VALL-E validates the NAR's first stage (JAX: nar_stage 1)
    extra = {"nar_stage": 1} if isinstance(model, VALLE) else {}
    dp = dp or DataParallel(device=torch.device(device))
    tot = MetricsTracker()
    pending, n_utts = [], []
    with torch.no_grad():
        for batch in valid_dl:
            mb = _rank_batch(_model_batch(batch, accum=1, dp=dp.world), dp,
                             accum=1)
            mb = {k: torch.as_tensor(
                v, device=None if k.startswith("global_") else device)
                for k, v in mb.items()}
            loss, metrics = forward(
                model, mb, train_stage=params.train_stage,
                deterministic=True, compute_dtype=compute_dtype, **extra)
            pending.append(dict(metrics, loss=loss))
            n_utts.append(len(mb["text"]))
        if pending:
            keys = sorted(pending[0])
            stacked = torch.stack([
                torch.stack([m[k].float() for k in keys])
                for m in pending]).cpu().numpy()
            for row, n in zip(stacked, n_utts):
                vals = dict(zip(keys, row))
                frames = float(vals["frames"])
                tot["loss"] += float(vals["loss"])
                tot["frames"] += frames
                tot["utterances"] += n
                for k in ("ArTop10Accuracy", "NarTop10Accuracy"):
                    if k in vals:
                        tot[k] += float(vals[k]) * frames
    tot.reduce(dp.host_group)
    if tot["frames"] == 0:
        logging.warning("validation loader produced no batches; "
                        "skipping best-valid tracking")
        return tot, len(pending)
    loss_value = tot["loss"] / max(tot["frames"], 1)
    if loss_value < params.best_valid_loss:
        params.best_valid_epoch = params.cur_epoch
        params.best_valid_loss = loss_value
    return tot, len(pending)


# Preemption-aware save: SIGTERM/SIGUSR1 (the signals cloud schedulers
# send before eviction) set this flag; the train loop finishes the
# in-flight step, writes preempted.pt with the sampler state, and exits 0
# so the same command resumes mid-epoch.
_PREEMPT = {"signum": None}


def _on_preempt_signal(signum, frame):
    _PREEMPT["signum"] = signum
    logging.warning(
        f"received signal {signum}: will checkpoint and exit after the "
        "current step")


def install_preemption_handler():
    """Install SIGTERM/SIGUSR1 checkpoint-and-exit handlers; returns a
    zero-argument restorer of the handlers that were active before
    (``run`` calls it on every exit path, so a host that embeds the
    trainer does not keep swallowing SIGTERM afterwards)."""
    if threading.current_thread() is not threading.main_thread():
        return lambda: None  # signals only reach the main thread
    previous = {}
    for sig in (signal.SIGTERM, signal.SIGUSR1):
        previous[sig] = signal.getsignal(sig)
        signal.signal(sig, _on_preempt_signal)

    def restore():
        for sig, handler in previous.items():
            if signal.getsignal(sig) is _on_preempt_signal:
                signal.signal(sig, handler)

    return restore


def save_checkpoint(exp_dir: Path, name: str, params, state: TrainState,
                    stats: RunStats, sampler_state=None,
                    tot_loss: Optional[MetricsTracker] = None,
                    dp=None) -> None:
    """``exp_dir/<name>.pt``: weights, optimizer, model_avg, sampler state,
    the running loss of a mid-epoch save, and every run parameter at the
    top level (the model flags among them). Under data parallelism
    (``dp``) rank 0 writes and the others wait for it."""
    if dp is not None and dp.world > 1:
        if dp.rank == 0:
            save_checkpoint(exp_dir, name, params, state, stats,
                            sampler_state, tot_loss)
        dp.barrier()
        return
    extra = {"model_name": params.model_name,
             "text_tokens": str(params.text_tokens)}
    if tot_loss is not None:
        extra["tot_loss"] = dict(tot_loss)
    t0 = time.perf_counter()
    nbytes = ckpt_lib.save_checkpoint(
        exp_dir / f"{name}.pt", model_state=state.model.state_dict(),
        optimizer_state=state.optimizer.state_dict(),
        model_avg=state.model_avg, sampler_state=sampler_state,
        params={**params, **extra})
    seconds = time.perf_counter() - t0
    stats.checkpoint_writes.append((name, seconds, nbytes))
    logging.info(f"saved {exp_dir / name}.pt ({nbytes / 2**20:.1f} MiB, "
                 f"{seconds:.2f} s)")


def run(args) -> RunStats:
    """Train; preemption handlers are scoped to the call (restored on
    every exit path, including the preemption SystemExit itself), and so
    is the process group of a ``torchrun`` job."""
    from ..parallel.mesh import setup_distributed, teardown_distributed

    _check_flags(args)
    _device(args)
    _PREEMPT["signum"] = None
    restore = install_preemption_handler()
    dp = None
    try:
        dp = setup_distributed(args.device, args.dp_share_device)
        return _run(args, dp)
    finally:
        restore()
        if dp is not None:
            teardown_distributed(dp)


def _check_world(args, dp) -> None:
    """The JAX trainer's multi-process policy: --world-size names the job's
    processes, and --world-size-data stays 1 under several."""
    if args.world_size != dp.world:
        raise SystemExit(
            f"--world-size {args.world_size} but this job has {dp.world} "
            f"process(es): launch N ranks with torchrun --nproc-per-node N "
            f"and pass --world-size N")
    if dp.world > 1 and args.world_size_data != 1:
        raise SystemExit(
            "--world-size-data must stay 1 under multi-process training: "
            "every rank iterates the same global batches and keeps its own "
            "rows; rank-sharded sampling would give the ranks different "
            "batch shapes for the same step")


def _run(args, dp) -> RunStats:
    from ..data.datamodule import TtsDataModule
    from ..parallel.mesh import broadcast_parameters
    from ..training import make_optimizer, make_train_step

    _check_world(args, dp)
    forward_fn = _forward_fn(args)
    device = dp.device
    params = get_params()
    params.update(vars(args))

    exp_dir = Path(args.exp_dir)
    exp_dir.mkdir(parents=True, exist_ok=True)
    setup_logger(f"{exp_dir}/log/log-train", rank=dp.rank,
                 world_size=dp.world)
    logging.info("Training started")
    logging.info(params)
    logging.info(f"--rng-impl {args.rng_impl} has no effect here: each "
                 "step's seeds come from --seed and the step")

    random.seed(args.seed)
    np.random.seed(args.seed)
    torch.manual_seed(args.seed)

    tb_writer = None
    if args.tensorboard and dp.rank == 0:
        from tensorboardX import SummaryWriter

        tb_writer = SummaryWriter(
            log_dir=f"{exp_dir}/tensorboard_stage{args.train_stage}")

    compute_dtype = _compute_dtype(args.dtype)
    model = get_model(params, device=device)
    model.reset_parameters(torch.Generator(device).manual_seed(args.seed))
    logging.info(f"Model config: {model.cfg}")
    n_params = sum(p.numel() for p in model.parameters())
    logging.info(f"Number of model parameters: {n_params}")

    opt, lr_fn = make_optimizer(
        model, base_lr=args.base_lr,
        clipping_scale=2.0 if args.optimizer_name == "ScaledAdam" else None,
        train_stage=args.train_stage, warmup_steps=args.warmup_steps,
        optimizer_name=args.optimizer_name,
        scheduler_name=args.scheduler_name, decoder_dim=args.decoder_dim,
        state_dtype=args.optim_state_dtype, device=device)
    state = TrainState(model, opt)
    stats = RunStats(state=state)

    ckpt = load_checkpoint_if_available(params, exp_dir, state)
    sampler_state, resumed_tot = None, None
    first_epoch = args.start_epoch
    if ckpt is not None:
        state.step = params.batch_idx_train
        if ckpt.get("model_avg") is not None:
            state.model_avg = {k: v.to(device, torch.float64)
                               for k, v in ckpt["model_avg"].items()}
        sampler_state = ckpt.get("sampler")
        resumed_tot = ckpt.get("tot_loss")
        if resumed_tot is not None:
            # a mid-epoch checkpoint of this stage: go on in its epoch,
            # whatever --start-epoch the restarted command gives
            first_epoch = ckpt.get("cur_epoch", first_epoch)
        stats.resumed_from = ckpt["path"]
        stats.optimizer_restored = "optimizer" in ckpt
    if dp.world > 1:
        broadcast_parameters(model)   # every rank starts from rank 0's
    if args.average_period > 0 and state.model_avg is None:
        state.model_avg = {k: v.detach().to(torch.float64, copy=True)
                           for k, v in model.state_dict().items()}

    step_fn = make_train_step(
        lr_fn, train_stage=args.train_stage,
        accum_steps=args.accumulate_grad_steps,
        compute_dtype=compute_dtype, forward_fn=forward_fn, device=device,
        reduce_gradients=dp.backend is not None)

    dm = TtsDataModule(args)
    train_cuts = filter_short_and_long_utterances(
        dm.train_cuts(), args.filter_min_duration, args.filter_max_duration)
    valid_cuts = dm.dev_cuts()
    train_dl = dm.train_dataloaders(train_cuts,
                                    sampler_state_dict=sampler_state)
    valid_dl = dm.valid_dataloaders(valid_cuts)

    if args.oom_check:
        stats.scan_batches = scan_largest_batches_for_compile(
            args, state, train_dl, compute_dtype, dp)

    for epoch in range(first_epoch, args.num_epochs + 1):
        params.cur_epoch = epoch
        train_dl.sampler.set_epoch(epoch - 1)
        train_one_epoch(args, params, state, step_fn, train_dl, valid_dl,
                        compute_dtype, dp, tb_writer, epoch, exp_dir,
                        stats, resumed_tot)
        resumed_tot = None
        save_checkpoint(exp_dir, f"epoch-{epoch}", params, state, stats,
                        sampler_state=train_dl.state_dict(), dp=dp)
    if tb_writer is not None:
        tb_writer.close()
    logging.info("Done!")
    return stats


def scan_largest_batches_for_compile(args, state: TrainState, train_dl,
                                     compute_dtype, dp) -> int:
    """The reference's pessimistic-batch scan (trainer.py:1096-1140):
    forward and backward on the largest batch of each bucket shape, then
    the gradients are dropped. No update: the parameters, the prenets'
    statistics (JAX drops the scan's new state), the optimizer, the step
    counter and the sampler's resume point stay as they were. Each rank
    runs its own rows. Returns the number of batches run."""
    from ..modules.prenet import kept_statistics
    from ..training import forward_backward

    shapes = {}
    core = _sampler_core(train_dl.sampler)
    resume_consumed = core._resume_consumed   # iterating pops it
    for b in train_dl.sampler:
        key = (b.pad_audio_to, b.pad_text_to)
        if key not in shapes:
            shapes[key] = b
    core._resume_consumed = resume_consumed
    logging.info(f"OOM scan over {len(shapes)} bucket shapes")
    for key, b in sorted(shapes.items(), reverse=True):
        batch = train_dl.dataset.__getitem__(
            b.cuts, pad_audio_to=b.pad_audio_to, pad_text_to=b.pad_text_to)
        accum = args.accumulate_grad_steps
        mb = _rank_batch(_model_batch(batch, accum, dp.world), dp, accum)
        try:
            with kept_statistics(state.model):
                loss, _ = forward_backward(
                    state.model, mb, train_stage=args.train_stage,
                    accum_steps=accum, compute_dtype=compute_dtype,
                    forward_fn=_forward_fn(args),
                    generator=torch.Generator().manual_seed(args.seed),
                    device=dp.device)
            logging.info(f"  shape {key}: ok (loss {float(loss):.1f})")
        except Exception:
            logging.exception(f"OOM scan failed on shape {key} "
                              f"(batch of {len(b.cuts)} cuts)")
            raise
        finally:
            state.model.zero_grad(set_to_none=True)
    return len(shapes)


def _diagnose_nonfinite_step(args, state: TrainState, prev_params, mb,
                             step: int, compute_dtype, device) -> str:
    """Name the non-finite parameters and gradients and the first
    non-finite call of the failed step (reference --inf-check hooks,
    trainer.py:177-180), rerun from the parameters and buffers (the
    prenets' statistics) before the step with its own random draws; the
    first microbatch under accumulation, the rank's own rows."""
    from ..training import default_forward
    from ..utils.inf_check import diagnose_nonfinite

    with torch.no_grad():
        for name, p in _params_and_buffers(state.model):
            p.copy_(prev_params[name])
    micro = mb if args.accumulate_grad_steps == 1 else {
        k: v[0] for k, v in mb.items()}
    forward_fn = _forward_fn(args) or default_forward(state.model)
    micro = {k: torch.as_tensor(
        v, device=None if k.startswith("global_") else device)
        for k, v in micro.items()}

    def loss_fn(model, batch):
        loss, _ = forward_fn(
            model, batch, train_stage=args.train_stage,
            generator=_step_generator(args.seed, step),
            deterministic=False, compute_dtype=compute_dtype)
        return loss

    try:
        return diagnose_nonfinite(loss_fn, state.model, micro)
    except Exception as e:  # never mask the original failure
        return f"(diagnosis failed: {e})"


def visualize_one_batch(model, valid_dl, exp_dir: Path, epoch: int,
                        device) -> Path:
    """Heatmaps of the first dev batch (JAX ``visualize_one_batch``): the
    model's encoder output and its output (the predicted mel; VALL-E's
    codes) beside the target features, in ``exp_dir/eval_epoch<epoch>``.
    Returns that directory."""
    from ..models.valle import VALLE, valle_visualize_outputs
    from ..models.transformer import transformer_visualize_outputs
    from ..models.visualizer import visualize

    out_dir = exp_dir / f"eval_epoch{epoch}"
    out_dir.mkdir(parents=True, exist_ok=True)
    batch = next(iter(valid_dl))
    mb = {k: torch.as_tensor(v, device=device)
          for k, v in _model_batch(batch, accum=1).items()}
    fn = (valle_visualize_outputs if isinstance(model, VALLE)
          else transformer_visualize_outputs)
    visualize(fn(model, mb), batch, str(out_dir))
    logging.info(f"visualizations written to {out_dir}")
    return out_dir


def _params_and_buffers(model):
    return list(model.named_parameters()) + list(model.named_buffers())


def _dump_batch(exp_dir: Path, mb) -> Path:
    fname = exp_dir / f"batch-{uuid.uuid4()}.npz"
    np.savez(fname, **{k: np.asarray(v) for k, v in mb.items()})
    return fname


_METRIC_KEYS = ("loss", "frames", "lr", "grad_norm")


def train_one_epoch(args, params, state: TrainState, step_fn, train_dl,
                    valid_dl, compute_dtype, dp, tb_writer, epoch,
                    exp_dir, stats: RunStats,
                    resumed_tot: Optional[dict] = None) -> None:
    device = dp.device
    # a mid-epoch resume continues the epoch's batch numbering and the
    # running loss the checkpoint carries
    skip = _sampler_core(train_dl.sampler)._resume_consumed
    tot_loss = MetricsTracker()
    if skip and resumed_tot:
        tot_loss.update(resumed_tot)

    # Deferred metric reads: the step's metrics stay on the device and are
    # fetched in one transfer per log interval (or checkpoint); the
    # MetricsTracker recurrence then replays per step in order, so the
    # logged values equal the per-step reads of --inf-check, which keeps
    # a sync every step to catch the first non-finite one.
    defer = not args.inf_check
    pending = []                     # [(batch_idx_train, metrics)]
    last = None                      # (loss, frames, lr, grad_norm)

    def flush_pending():
        nonlocal tot_loss, pending, last
        if not pending:
            return
        vals = torch.stack([
            torch.stack([torch.as_tensor(m[k], dtype=torch.float32,
                                         device=device)
                         for k in _METRIC_KEYS])
            for _, m in pending]).cpu().numpy()
        for row in vals:
            l, f = float(row[0]), float(row[1])
            cur = MetricsTracker()
            cur["loss"] = l
            cur["frames"] = f
            tot_loss = (tot_loss * (1 - 1.0 / params.reset_interval)) + cur
            last = (l, f, float(row[2]), float(row[3]))
            stats.step_metrics.append((l, f, float(row[3])))
        pending = []

    def sync_time():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    prof = None
    batch_idx = skip - 1
    it = iter(train_dl)
    t_loop = sync_time()
    while True:
        t0 = time.perf_counter()
        try:
            batch = next(it)
        except StopIteration:
            break
        stats.loader_wait_seconds += time.perf_counter() - t0
        batch_idx += 1
        params.batch_idx_train += 1
        if args.profile and epoch == args.start_epoch:
            if batch_idx == 10 and prof is None:
                prof = _start_profiler(device)
            elif batch_idx == 20 and prof is not None:
                _stop_profiler(prof, exp_dir)
                prof = None
        accum = args.accumulate_grad_steps
        mb = _rank_batch(_model_batch(batch, accum, dp.world), dp, accum)
        prev_params = ({n: p.detach().clone()
                        for n, p in _params_and_buffers(state.model)}
                       if args.inf_check else None)
        step = state.step
        try:
            # the reference steps Eden with epoch - 1 (trainer.py:1033)
            metrics = step_fn(state, mb, epoch - 1,
                              _step_generator(args.seed, step))
        except Exception:
            fname = _dump_batch(exp_dir, mb)
            logging.exception(f"train step failed; batch saved to {fname}")
            if defer:
                flush_pending()  # tot_loss reflects every completed step
            raise
        stats.steps += 1
        frames = (mb["ar_inputs"].shape[-1] if "ar_inputs" in mb
                  else mb.get("audio", mb.get("nar_codes")).shape[-2])
        stats.batch_shapes.append(
            (int(np.prod(mb["text"].shape[:-1])), mb["text"].shape[-1],
             frames))

        if defer:
            pending.append((params.batch_idx_train, metrics))
        else:
            loss = float(metrics["loss"])
            frames = float(metrics["frames"])
            grad_norm = float(metrics["grad_norm"])
            if not (np.isfinite(loss) and np.isfinite(grad_norm)):
                fname = _dump_batch(exp_dir, mb)
                report = _diagnose_nonfinite_step(
                    args, state, prev_params, mb, step, compute_dtype,
                    device)
                raise FloatingPointError(
                    f"non-finite loss {loss} / grad_norm {grad_norm} at "
                    f"batch {params.batch_idx_train}; batch saved to "
                    f"{fname}\n{report}")
            cur = MetricsTracker()
            cur["loss"] = loss
            cur["frames"] = frames
            tot_loss = (tot_loss * (1 - 1.0 / params.reset_interval)) + cur
            last = (loss, frames, float(metrics["lr"]), grad_norm)
            stats.step_metrics.append((loss, frames, grad_norm))

        if args.average_period > 0 and (
                params.batch_idx_train % args.average_period == 0):
            # model_avg += (model - model_avg) * period / batch_idx
            # (icefall update_averaged_model, reference trainer.py:703-714)
            w = args.average_period / max(params.batch_idx_train,
                                          args.average_period)
            with torch.no_grad():
                for k, v in state.model.state_dict().items():
                    avg = state.model_avg[k]
                    state.model_avg[k] = avg + (v.to(torch.float64) - avg) * w

        # a signal may reach one rank only: the ranks agree every step
        preempted = dp.any(_PREEMPT["signum"] is not None)
        names = ([f"checkpoint-{params.batch_idx_train}"]
                 if params.batch_idx_train % args.save_every_n == 0 else [])
        names += ["preempted"] if preempted else []
        if names:
            flush_pending()  # the checkpoint's tot_loss covers every step
            t_pause = sync_time()
            for name in names:
                save_checkpoint(exp_dir, name, params, state, stats,
                                sampler_state=train_dl.state_dict(),
                                tot_loss=tot_loss, dp=dp)
            if dp.rank == 0:    # the single writer prunes too
                ckpt_lib.remove_checkpoints(exp_dir, args.keep_last_k)
            t_loop += time.perf_counter() - t_pause

        if batch_idx % params.log_interval == 0:
            flush_pending()
            loss, frames, lr, grad_norm = last
            logging.info(
                f"Epoch {epoch}, batch {batch_idx}, train_stage "
                f"{args.train_stage}, "
                f"loss[{loss / max(frames, 1):.4f}], "
                f"tot_loss[{tot_loss['loss'] / max(tot_loss['frames'], 1):.4f}]"
                f", lr: {lr:.2e}")
            if tb_writer is not None:
                tb_writer.add_scalar("train/grad_norm", grad_norm,
                                     params.batch_idx_train)
                tb_writer.add_scalar("train/learning_rate", lr,
                                     params.batch_idx_train)
                tb_writer.add_scalar("train/current_loss",
                                     loss / max(frames, 1),
                                     params.batch_idx_train)
                tb_writer.add_scalar(
                    "train/tot_loss",
                    tot_loss["loss"] / max(tot_loss["frames"], 1),
                    params.batch_idx_train)

        if preempted:  # after the step's log line, before validation
            stats.loop_seconds += time.perf_counter() - t_loop
            logging.warning(
                f"preemption checkpoint saved to {exp_dir}/preempted.pt "
                f"(signal {_PREEMPT['signum']}, batch "
                f"{params.batch_idx_train}); exiting")
            raise SystemExit(0)

        if params.batch_idx_train % params.valid_interval == 0:
            t_pause = sync_time()
            logging.info("Computing validation loss")
            valid_info, n_valid = compute_validation_loss(
                params, state.model, valid_dl, compute_dtype, device, dp)
            stats.valid_batches += n_valid
            logging.info(f"Epoch {epoch}, validation: {valid_info}")
            if args.visualize and dp.rank == 0:
                visualize_one_batch(state.model, valid_dl, exp_dir, epoch,
                                    device)
            if tb_writer is not None:
                valid_info.write_summary(tb_writer, "train/valid_",
                                         params.batch_idx_train)
            if params.best_valid_epoch == epoch:
                save_checkpoint(exp_dir, "best-valid-loss", params, state,
                                stats, dp=dp)
            t_loop += time.perf_counter() - t_pause

        if args.max_steps_per_epoch and (
                batch_idx + 1 >= args.max_steps_per_epoch):
            break

    if prof is not None:  # the epoch ended before batch 20
        _stop_profiler(prof, exp_dir)
    flush_pending()       # steps since the last log window
    stats.loop_seconds += sync_time() - t_loop
    epoch_loss = tot_loss["loss"] / max(tot_loss["frames"], 1)
    if epoch_loss < params.best_train_loss:
        params.best_train_epoch = epoch
        params.best_train_loss = epoch_loss
        save_checkpoint(exp_dir, "best-train-loss", params, state, stats,
                        dp=dp)


def _start_profiler(device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else [])
    prof = profile(activities=acts)
    prof.__enter__()
    return prof


def _stop_profiler(prof, exp_dir: Path) -> None:
    prof.__exit__(None, None, None)
    out = exp_dir / "profile"
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "trace.json"))
    logging.info(f"profiler trace written to {out}")


def main(argv=None):
    parser = get_parser()
    args = parser.parse_args(argv)
    run(args)


if __name__ == "__main__":
    main()
