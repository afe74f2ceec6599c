"""Data parallelism in the port on the CPU: two gloo ranks
(``tests/torch_port_dp_worker.py``, started with the environment
``torchrun`` gives a rank, one intra-op thread each) against one process
on the same global batches. At fp32 with dropout off (no dropout seeds;
the NAR stage and prefix still drawn) the trainer's per-step losses agree
to 1e-5 relative, its gradient norms (the gradients are summed, not
averaged) to 1e-4 and its parameters to 1e-4, the two ranks' parameters
are bit-equal and rank 0 alone writes the checkpoints: stage 0 with
prefix mode 1 over halves of different minimum length (the prefix draw
and loss scale then need the global batch's statistics), and
``--nar-pack``. ``MetricsTracker.reduce`` sums, the validation line is
one process's, ranks given identical rows draw different dropout masks,
one step of the two ranks equals JAX's ``make_train_step`` on the global
batch, and the multi-process flag checks raise."""

import json
import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from valle_tpu.models import valle_forward as jax_forward
from valle_tpu.training import TrainState as JaxTrainState
from valle_tpu.training import make_optimizer as jax_make_optimizer
from valle_tpu.training import make_train_step as jax_make_train_step
from valle_tpu_torch.bin import trainer
from valle_tpu_torch.data.datamodule import TtsDataModule
from valle_tpu_torch.models import load_model
from valle_tpu_torch.parallel.mesh import global_stats, local_rows
from valle_tpu_torch.utils.convert import valle_state_dict_from_jax

from torch_port_corpus import write_corpus
from torch_port_dp_worker import no_dropout_seeds
from torch_port_helpers import TRAIN_SMALL, make_pair, train_batch

TESTS = Path(__file__).resolve().parent
WORKER = TESTS / "torch_port_dp_worker.py"
SMALL = ["--decoder-dim", "64", "--nhead", "4", "--num-decoder-layers", "2",
         "--model-name", "valle", "--prefix-mode", "1"]
# the NAR draws of the step compared with JAX
PINS = {"nar_stage": 3, "nar_prefix_len": 5}
# JAX's padded NAR tables and the heads tied to them (state-dict aliases)
PADDED = ({f"nar_audio_embeddings.{j}.word_embeddings.weight"
           for j in range(1, 8)}
          | {f"nar_predict_layers.{j}.weight" for j in range(6)})
RUNS = {
    # stage 0: both decoders, the OOM scan, validation at step 2
    "stage0": ["--train-stage", "0", "--max-duration", "4",
               "--valid-interval", "2"],
    "nar_pack": ["--train-stage", "2", "--nar-pack", "true",
                 "--pack-max-frames", "80", "--pack-max-text", "48",
                 "--pack-rows", "4"],
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_corpus(tmp_path_factory.mktemp("port_dp"), n_train=16,
                        n_dev=4, train_frames=(20, 70), seed=3)


def _argv(corpus, exp, name, world):
    return ["--device", "cpu", "--manifest-dir", str(corpus),
            "--text-tokens", str(corpus / "unique_text_tokens.k2symbols"),
            "--exp-dir", str(exp), *SMALL, "--num-epochs", "1",
            "--num-buckets", "2", "--base-lr", "0.05", "--warmup-steps",
            "10", "--save-every-n", "100", "--log-interval", "1",
            "--num-workers", "0", "--max-steps-per-epoch", "3",
            "--tensorboard", "false", "--world-size", str(world),
            *RUNS[name]]


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


@pytest.fixture(scope="module")
def two_ranks(corpus, tmp_path_factory):
    """Both ranks' results of every job (see the worker), and the one-
    process runs beside them (run here while the ranks run)."""
    d = tmp_path_factory.mktemp("dp_runs")
    jcfg, params, model = make_pair(prefix_mode=1, **TRAIN_SMALL)
    torch.save(model.state_dict(), d / "init.pt")
    ports = _free_ports(len(RUNS) + 2)
    jobs = [{"name": name, "kind": "train", "dropout": False,
             "port": ports[i], "argv": _argv(corpus, d / f"dp_{name}", name,
                                             2)}
            for i, name in enumerate(RUNS)]
    jobs.append({"name": "world_size_data", "kind": "train",
                 "port": ports[-2],
                 "argv": _argv(corpus, d / "dp_wsd", "stage0", 2)
                 + ["--world-size-data", "2"]})
    jobs.append({"name": "collectives", "kind": "collectives",
                 "port": ports[-1], "state": str(d / "init.pt"),
                 "cfg": dict(prefix_mode=1, **TRAIN_SMALL),
                 "batch": {k: v.tolist() for k, v in train_batch().items()},
                 "pins": PINS})
    (d / "spec.json").write_text(json.dumps({"jobs": jobs}))
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2",
                   LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                   OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(
                       [str(TESTS.parent), str(TESTS)]
                       + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        procs.append(subprocess.Popen(
            [sys.executable, str(WORKER), str(d / "spec.json"), str(d)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    single = {}
    grouped = trainer._model_batch
    with no_dropout_seeds(), pytest.MonkeyPatch.context() as mp:
        # one process on the ranks' global batches: rows rounded to even
        mp.setattr(trainer, "_model_batch",
                   lambda batch, accum, dp=1: grouped(batch, accum, 2))
        for name in RUNS:
            exp = d / f"one_{name}"
            single[name] = (exp, trainer.run(trainer.get_parser().parse_args(
                _argv(corpus, exp, name, 1))))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    ranks = [json.loads((d / f"rank{r}.json").read_text()) for r in (0, 1)]
    for res in ranks:
        for name, job in res.items():
            assert "error" not in job, (name, job.get("error"))
    return d, ranks, single, (jcfg, params)


def test_uneven_halves(corpus):
    """The stage-0 run's batches split into halves whose prefix draws
    differ: int(min_len / 4) of one half is not the other's."""
    args = trainer.get_parser().parse_args(
        _argv(corpus, corpus / "unused", "stage0", 2))
    dm = TtsDataModule(args)
    dl = dm.train_dataloaders(dm.train_cuts())
    lows = []
    for i, batch in zip(range(3), dl):
        mb = trainer._model_batch(batch, 1, 2)
        halves = [local_rows(mb, r, 2) for r in (0, 1)]
        lows.append([int(h["audio_lens"].min()) // 4 for h in halves])
        assert (halves[0]["global_min_len"] == mb["audio_lens"].min()
                == global_stats(mb)["min_len"])
    assert any(a != b for a, b in lows), lows


@pytest.mark.parametrize("name", list(RUNS))
def test_two_ranks_train_what_one_process_trains(two_ranks, name):
    d, ranks, single, _ = two_ranks
    exp_one, stats = single[name]
    got = [r[name] for r in ranks]
    assert got[0]["steps"] == got[1]["steps"] == stats.steps == 3
    want = np.array(stats.step_metrics)      # (loss, frames, grad norm)
    for r in got:
        have = np.array(r["step_metrics"])
        np.testing.assert_allclose(have[:, :2], want[:, :2], rtol=1e-5)
        np.testing.assert_allclose(have[:, 2], want[:, 2], rtol=1e-4)
    assert got[0]["digest"] == got[1]["digest"]
    a = torch.load(got[0]["params"])
    b = load_model(str(exp_one / "epoch-1.pt"), device="cpu")[0].state_dict()
    for k, v in b.items():
        np.testing.assert_allclose(a[k].numpy(), v.numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    # rank 0 alone writes; the epoch checkpoint loads
    assert got[1]["writes"] == []
    assert "epoch-1" in got[0]["writes"]
    assert got[0]["writes"] == [w[0] for w in stats.checkpoint_writes]
    model, _ = load_model(str(d / f"dp_{name}" / "epoch-1.pt"),
                          device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(v, a[k]), k


def _validation_lines(exp, rank_suffix):
    lines = []
    for f in sorted((exp / "log").glob("log-train*")):
        if rank_suffix is None or f.name.endswith(f"-{rank_suffix}"):
            lines += [raw[raw.index("validation:"):]
                      for raw in f.read_text().splitlines()
                      if "validation:" in raw]
    return lines


def test_validation_and_logs_per_rank(two_ranks):
    """Each rank logs to its own file; both print the one-process
    validation line (the sums reduced over the ranks)."""
    d, ranks, single, _ = two_ranks
    exp_one, stats = single["stage0"]
    assert stats.valid_batches > 0
    assert ranks[0]["stage0"]["valid_batches"] == stats.valid_batches
    want = _validation_lines(exp_one, None)
    assert len(want) == 1
    for r in (0, 1):
        assert _validation_lines(d / "dp_stage0", r) == want


def test_collectives(two_ranks):
    """reduce sums; identical rows draw different masks on the two ranks
    (and equal gradients without dropout)."""
    _, ranks, _, _ = two_ranks
    got = [r["collectives"] for r in ranks]
    for g in got:
        assert g["reduced"] == {"loss": 1.5 + 2.5, "frames": 30.0}
    assert got[0]["grad_digests"]["True"] != got[1]["grad_digests"]["True"]
    assert got[0]["grad_digests"]["False"] == got[1]["grad_digests"]["False"]


def test_two_rank_step_matches_jax(two_ranks):
    """One step of the two ranks, each on one row of train_batch(), equals
    JAX's make_train_step on both rows (draws pinned): the metrics to
    1e-5, the parameters to 1e-5 (the padded NAR tables to 1e-3, see
    test_torch_port_train_step.py)."""
    _, ranks, _, (jcfg, params) = two_ranks

    def pinned(params, cfg, micro, *, train_stage, rng, deterministic,
               compute_dtype, state):
        return jax_forward(params, cfg, micro, train_stage=train_stage,
                           deterministic=True, compute_dtype=compute_dtype,
                           state=state,
                           **{k: jnp.int32(v) for k, v in PINS.items()})

    jopt, jlr = jax_make_optimizer(params, train_stage=0)
    jstate = JaxTrainState(params, jopt.init(params), {"ar": {}, "nar": {}},
                           jnp.zeros((), jnp.int32))
    jstep = jax.jit(jax_make_train_step(jcfg, jopt, jlr, train_stage=0,
                                        forward_fn=pinned))
    jstate, jout = jstep(jstate, {k: jnp.asarray(v) for k, v in
                                  train_batch().items()}, 0,
                         jax.random.PRNGKey(0))
    want = valle_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, jstate.params), jcfg)
    for r in ranks:
        out = r["collectives"]["step"]
        assert set(out) == set(jout)
        for k, v in jout.items():
            np.testing.assert_allclose(out[k], float(v), rtol=1e-5,
                                       atol=1e-6, err_msg=k)
    a, b = (torch.load(r["collectives"]["step_params"]) for r in ranks)
    for name, v in a.items():
        assert torch.equal(v, b[name]), name
        if name in want:
            tol = 1e-3 if name in PADDED else 1e-5
            np.testing.assert_allclose(v.numpy(), want[name], rtol=tol,
                                       atol=tol * 1e-1, err_msg=name)


def test_flag_checks(two_ranks, corpus, tmp_path):
    """--world-size-data 2 under two processes raises (JAX's policy);
    --world-size 2 without torchrun's environment raises its mismatch;
    --tp 2 still raises."""
    _, ranks, _, _ = two_ranks
    for r in ranks:
        assert re.search("--world-size-data must stay 1",
                         r["world_size_data"]["exit"])
    argv = _argv(corpus, tmp_path, "stage0", 2)
    with pytest.raises(SystemExit, match="--world-size 2 but this job has 1"):
        trainer.run(trainer.get_parser().parse_args(argv))
    with pytest.raises(NotImplementedError, match="out of scope"):
        trainer.run(trainer.get_parser().parse_args(argv + ["--tp", "2"]))
