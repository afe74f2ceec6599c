"""One rank of the port's data- and tensor-parallel tests
(``tests/test_torch_port_distributed.py``), started with the environment
``torchrun`` gives a rank (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``) on
the CPU:

    python tests/torch_port_dp_worker.py SPEC.json OUT_DIR

SPEC holds a list of jobs, each with its own rendezvous file (``rdzv``:
the ranks meet through a ``file://`` store, so no port is picked and
freed before a rank binds it); the rank runs them in order and writes
what each gave to ``OUT_DIR/rank<r>.json`` (and ``.pt`` files for
parameters). Jobs: ``train`` (the trainer CLI with ``argv``; ``dropout:
false`` draws no dropout seeds), ``collectives`` (``MetricsTracker.
reduce``, local gradients with dropout on identical rows, one train step
on the rank's rows of a global batch), ``tp_collectives`` (one train
step of the two ranks as the two shards of a tp=2 model on the whole
batch). Imports no JAX."""

import contextlib
import functools
import hashlib
import json
import os
import sys
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist


def no_dropout_seeds():
    """Patch the forwards to draw their dropout seeds from the generator
    and then drop them: the NAR stage and prefix draws stay as they are,
    and no mask is applied (dropout 0)."""
    from valle_tpu_torch.models import valle

    draw = valle._draw_seeds

    def drawn_then_dropped(generator, training, batch, n=8):
        return [None] * len(draw(generator, training, batch, n))

    valle._draw_seeds = drawn_then_dropped
    stack = contextlib.ExitStack()
    stack.callback(setattr, valle, "_draw_seeds", draw)
    return stack


def param_digest(model):
    h = hashlib.sha256()
    for name, p in model.state_dict().items():
        h.update(name.encode())
        h.update(p.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def run_train(job, rank, out_dir):
    from valle_tpu_torch.bin import trainer

    args = trainer.get_parser().parse_args(job["argv"])
    stack = (no_dropout_seeds() if not job.get("dropout", True)
             else contextlib.ExitStack())
    with stack:
        try:
            stats = trainer.run(args)
        except SystemExit as e:
            return {"exit": str(e.code)}
    path = out_dir / f"{job['name']}-rank{rank}.pt"
    torch.save(stats.state.model.state_dict(), path)
    return {"step_metrics": stats.step_metrics, "steps": stats.steps,
            "valid_batches": stats.valid_batches,
            "writes": [w[0] for w in stats.checkpoint_writes],
            "digest": param_digest(stats.state.model), "params": str(path),
            "resumed_from": stats.resumed_from,
            "optimizer_restored": stats.optimizer_restored}


def _pinned_forward(pins):
    from valle_tpu_torch.models.valle import valle_forward

    def pinned(model, micro, *, train_stage, generator, deterministic,
               compute_dtype):
        return valle_forward(model, micro, train_stage=train_stage,
                             deterministic=True,
                             compute_dtype=compute_dtype, **pins)
    return pinned


def run_tp_collectives(job, rank, out_dir):
    """One fp32 step of a tp=2 model, shard ``rank`` on this rank, on the
    whole batch (one data shard), draws pinned: the step's metrics and the
    gathered parameters."""
    from valle_tpu_torch.models.valle import VALLE, ValleConfig
    from valle_tpu_torch.parallel.mesh import (setup_distributed,
                                               teardown_distributed)
    from valle_tpu_torch.parallel.tensor import (gather_state_dict,
                                                 shard_model)
    from valle_tpu_torch.training import (TrainState, make_optimizer,
                                          make_train_step)

    dp = setup_distributed("cpu", tp=2)
    try:
        m = VALLE(ValleConfig(**job["cfg"]))
        m.load_state_dict(torch.load(job["state"]))
        dims = shard_model(m, dp.model_shard)
        opt, lr_fn = make_optimizer(m, train_stage=0, device="cpu")
        step = make_train_step(lr_fn, train_stage=0,
                               forward_fn=_pinned_forward(job["pins"]),
                               device="cpu", reduce_gradients=True)
        batch = {k: np.asarray(v) for k, v in job["batch"].items()}
        out = step(TrainState(m, opt), batch, 0)
        whole = gather_state_dict(m.state_dict(), dims, dp.model_shard)
        path = out_dir / f"tp_step-rank{rank}.pt"
        torch.save(whole, path)
        return {"step": {k: float(v) for k, v in out.items()},
                "step_params": str(path), "shard": dp.model_shard.index,
                "data_world": dp.data_world}
    finally:
        teardown_distributed(dp)


def run_collectives(job, rank, out_dir):
    from valle_tpu_torch.models.valle import VALLE, ValleConfig
    from valle_tpu_torch.parallel.mesh import (local_rows,
                                               setup_distributed,
                                               teardown_distributed)
    from valle_tpu_torch.training import (TrainState, forward_backward,
                                          make_optimizer, make_train_step)
    from valle_tpu_torch.utils.metrics import MetricsTracker

    dp = setup_distributed("cpu")
    try:
        res = {}
        tot = MetricsTracker()
        tot["loss"], tot["frames"] = rank + 1.5, 10.0 * (rank + 1)
        res["reduced"] = dict(tot.reduce(dp.host_group))

        cfg = ValleConfig(**job["cfg"])
        state_dict = torch.load(job["state"])
        batch = {k: np.asarray(v) for k, v in job["batch"].items()}
        pins = job["pins"]

        def model():
            m = VALLE(cfg)
            m.load_state_dict(state_dict)
            return m

        # identical rows on both ranks, dropout on: local gradients
        same = {k: np.concatenate([v[:1], v[:1]]) for k, v in batch.items()}
        mine = local_rows(same, dp.rank, dp.world)
        digests = {}
        for dropout in (True, False):
            m = model()
            stack = (contextlib.ExitStack() if dropout
                     else no_dropout_seeds())
            with stack:
                forward_backward(m, mine, train_stage=0, device="cpu",
                                 generator=torch.Generator().manual_seed(7))
            digests[str(dropout)] = hashlib.sha256(b"".join(
                p.grad.numpy().tobytes() for p in m.parameters()
                if p.grad is not None)).hexdigest()
        res["grad_digests"] = digests

        # one step on the rank's rows of the global batch, draws pinned
        m = model()
        opt, lr_fn = make_optimizer(m, train_stage=0, device="cpu")
        step = make_train_step(lr_fn, train_stage=0,
                               forward_fn=_pinned_forward(pins),
                               device="cpu", reduce_gradients=True)
        out = step(TrainState(m, opt), local_rows(batch, dp.rank, dp.world),
                   0)
        res["step"] = {k: float(v) for k, v in out.items()}
        path = out_dir / f"step-rank{rank}.pt"
        torch.save(m.state_dict(), path)
        res["step_params"] = str(path)
        return res
    finally:
        teardown_distributed(dp)


@contextlib.contextmanager
def rendezvous(path):
    """Every ``setup_distributed`` of the job meets at the ``file://``
    store ``path`` (the trainer CLI calls it with torchrun's arguments)."""
    from valle_tpu_torch.parallel import mesh

    setup = mesh.setup_distributed
    mesh.setup_distributed = functools.partial(
        setup, init_method=f"file://{path}")
    try:
        yield
    finally:
        mesh.setup_distributed = setup


RUN = {"train": run_train, "collectives": run_collectives,
       "tp_collectives": run_tp_collectives}


def main():
    spec = json.loads(Path(sys.argv[1]).read_text())
    out_dir = Path(sys.argv[2])
    rank = int(os.environ["RANK"])
    torch.set_num_threads(1)
    results = {}
    for job in spec["jobs"]:
        try:
            with rendezvous(job["rdzv"]):
                results[job["name"]] = RUN[job["kind"]](job, rank, out_dir)
        except Exception:
            results[job["name"]] = {"error": traceback.format_exc()}
        finally:        # a job that failed may leave its group behind
            if dist.is_initialized():
                dist.destroy_process_group()
        print(f"rank {rank}: {job['name']} done", flush=True)
    (out_dir / f"rank{rank}.json").write_text(json.dumps(results))


if __name__ == "__main__":
    main()
