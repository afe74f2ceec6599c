"""Data parallelism in the port on the CPU: two gloo ranks
(``tests/torch_port_dp_worker.py``, started with the environment
``torchrun`` gives a rank, one intra-op thread each) against one process
on the same global batches. At fp32 with dropout off (no dropout seeds;
the NAR stage and prefix still drawn) the trainer's per-step losses agree
to 1e-5 relative, its gradient norms (the gradients are summed, not
averaged) to 1e-4 and its parameters to 1e-4, the two ranks' parameters
are bit-equal and rank 0 alone writes the checkpoints: stage 0 with
prefix mode 1 over halves of different minimum length (the prefix draw
and loss scale then need the global batch's statistics), ``--nar-pack``,
and stage 0 with prenets (their BatchNorm statistics, summed over the
ranks, equal one process's, running statistics included). ``MetricsTracker.reduce`` sums, the validation line is
one process's, ranks given identical rows draw different dropout masks,
one step of the two ranks equals JAX's ``make_train_step`` on the global
batch, and the multi-process flag checks raise.

Tensor parallelism over the same two ranks (``--tp 2``: one data shard,
two model shards): at fp32 with dropout off the trainer's losses,
gradient norms and parameters (the ranks' slices put together) agree
with one process's as above, and so with dropout on (each rank's FFN and
prenet masks are its slices of the whole masks), prenets included; the
tp=2 checkpoint holds whole tensors that load at tp=1 with
``strict=True`` and equal the ranks' slices put together; a resume of it
at tp=2 takes the next epoch's steps as one process resuming its own;
and one step of the two shards equals JAX's ``make_train_step`` on a
dp1 x tp2 mesh (loss 1e-5, grad norm 1e-4, parameters rtol 3e-5: JAX's
own tolerances in ``tests/test_tp_equivalence.py``).

The ranks meet through a ``file://`` store in the fixture's directory
(``torch_port_dp_worker.py rendezvous``), and the fixture waits
``RANK_WAIT`` seconds for them; past it the test fails with both ranks'
output."""

import json
import os
import re
import shutil
import subprocess
import sys
import time
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
from valle_tpu.training import shard_train_state as jax_shard_train_state
from valle_tpu.parallel.mesh import batch_shardings as jax_batch_shardings
from valle_tpu.parallel.mesh import make_mesh as jax_make_mesh
from valle_tpu_torch.bin import trainer
from valle_tpu_torch.data.datamodule import TtsDataModule
from valle_tpu_torch.models import load_model
from valle_tpu_torch.parallel.mesh import global_stats, local_rows
from valle_tpu_torch.parallel.tensor import gather_state_dict, param_specs
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
    # the prenets' batch statistics summed over the ranks
    "prenet": ["--train-stage", "0", "--max-duration", "4",
               "--add-prenet", "true"],
}
# --tp 2 over the two ranks, beside one process (no row rounding: one
# data shard); "tp_dropout" keeps its dropout masks on both sides;
# "tp_resume" goes on from the ranks' tp_stage0 epoch-1.pt at tp 2 and, in
# one process, from a copy of it
TP_RUNS = {
    "tp_stage0": ["--train-stage", "0", "--max-duration", "4",
                  "--valid-interval", "2"],
    "tp_dropout": ["--train-stage", "0", "--max-duration", "4",
                   "--add-prenet", "true"],
    "tp_resume": ["--train-stage", "0", "--max-duration", "4",
                  "--valid-interval", "2", "--num-epochs", "2",
                  "--start-epoch", "2"],
}
TP_DIR = {"tp_resume": "tp_stage0"}
# The two ranks' jobs take about 40 s alone and 60-70 s beside a loaded
# suite; twice that and some
RANK_WAIT = 180


# A conv bias before a BatchNorm gets no gradient but rounding noise (the
# batch mean takes the bias out), which ScaledAdam's normalized step turns
# into moves of the learning rate's size that differ with the order of the
# sums; the running means carry those biases. The running variances, which
# a bias does not shift, are held like every other tensor.
ROUNDING_NOISE = re.compile(r"_text_prenet\.(1|5|9)\.bias$|running_mean$")


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
    """The trainer's flags of run ``name`` in a job of ``world`` ranks
    (a TP run's ranks add ``--tp 2``)."""
    tp = ["--tp", "2"] if name in TP_RUNS and world == 2 else []
    return ["--device", "cpu", "--manifest-dir", str(corpus),
            "--text-tokens", str(corpus / "unique_text_tokens.k2symbols"),
            "--exp-dir", str(exp), *SMALL, "--num-epochs", "1",
            "--num-buckets", "2", "--base-lr", "0.05", "--warmup-steps",
            "10", "--save-every-n", "100", "--log-interval", "1",
            "--num-workers", "0", "--max-steps-per-epoch", "3",
            "--tensorboard", "false", "--world-size", str(world),
            *{**RUNS, **TP_RUNS}[name], *tp]


def _wait(procs, seconds):
    """Both ranks' output once they have exited; past ``seconds`` they are
    killed and the test fails with what each printed."""
    deadline = time.monotonic() + seconds
    try:
        return [p.communicate(timeout=max(deadline - time.monotonic(),
                                          1))[0] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        outs = [p.communicate()[0] for p in procs]
        pytest.fail(f"the ranks did not finish in {seconds} s:\n" + "\n".join(
            f"--- rank {r} ---\n{out[-6000:]}" for r, out in enumerate(outs)))
    finally:
        for p in procs:
            p.kill()


@pytest.fixture(scope="module")
def two_ranks(corpus, tmp_path_factory):
    """Both ranks' results of every job (see the worker), and the one-
    process runs beside them (run here while the ranks run)."""
    d = tmp_path_factory.mktemp("dp_runs")
    jcfg, params, model = make_pair(prefix_mode=1, **TRAIN_SMALL)
    torch.save(model.state_dict(), d / "init.pt")
    jobs = [{"name": name, "kind": "train", "dropout": False,
             "argv": _argv(corpus, d / f"dp_{name}", name, 2)}
            for name in RUNS]
    jobs += [{"name": name, "kind": "train",
              "dropout": name == "tp_dropout",
              "argv": _argv(corpus, d / f"dp_{TP_DIR.get(name, name)}",
                            name, 2)} for name in TP_RUNS]
    jobs.append({"name": "world_size_data", "kind": "train",
                 "argv": _argv(corpus, d / "dp_wsd", "stage0", 2)
                 + ["--world-size-data", "2"]})
    common = {"state": str(d / "init.pt"),
              "cfg": dict(prefix_mode=1, **TRAIN_SMALL),
              "batch": {k: v.tolist() for k, v in train_batch().items()},
              "pins": PINS}
    jobs.append({"name": "collectives", "kind": "collectives", **common})
    jobs.append({"name": "tp_collectives", "kind": "tp_collectives",
                 **common})
    for job in jobs:
        job["rdzv"] = str(d / f"rdzv_{job['name']}")
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
    def one(name, exp):
        with (no_dropout_seeds() if name != "tp_dropout"
              else pytest.MonkeyPatch.context()):
            single[name] = (exp, trainer.run(trainer.get_parser().parse_args(
                _argv(corpus, exp, name, 1))))

    for name in ("tp_stage0", "tp_dropout"):
        one(name, d / f"one_{name}")
    outs = _wait(procs, RANK_WAIT)
    # the tp=2 checkpoint resumed at tp=1 (its optimizer's whole buffers)
    (d / "one_tp_resume").mkdir()
    shutil.copy(d / "dp_tp_stage0" / "epoch-1.pt",
                d / "one_tp_resume" / "epoch-1.pt")
    one("tp_resume", d / "one_tp_resume")
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
        if ROUNDING_NOISE.search(k):
            continue
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
    --tp 2 in one process raises JAX's "does not divide device count"."""
    _, ranks, _, _ = two_ranks
    for r in ranks:
        assert re.search("--world-size-data must stay 1",
                         r["world_size_data"]["exit"])
    argv = _argv(corpus, tmp_path, "stage0", 2)
    with pytest.raises(SystemExit, match="--world-size 2 but this job has 1"):
        trainer.run(trainer.get_parser().parse_args(argv))
    argv = _argv(corpus, tmp_path, "stage0", 1)
    with pytest.raises(SystemExit,
                       match="--tp 2 does not divide device count 1"):
        trainer.run(trainer.get_parser().parse_args(argv + ["--tp", "2"]))


def _ranks_whole(ranks, name):
    """The two ranks' parameter slices of run ``name`` put together."""
    parts = [torch.load(r[name]["params"]) for r in ranks]
    dims = {k: v for k, v in param_specs(
        load_model_state(ranks, name), 2).items() if v is not None}
    return gather_state_dict(parts, dims)


def load_model_state(ranks, name):
    """The whole state dict of run ``name``'s last epoch checkpoint."""
    exp = (Path(ranks[0][name]["params"]).parent
           / f"dp_{TP_DIR.get(name, name)}")
    epochs = sorted(exp.glob("epoch-*.pt"))
    return load_model(str(epochs[-1]), device="cpu")[0].state_dict()


@pytest.mark.parametrize("name", list(TP_RUNS))
def test_tp_ranks_train_what_one_process_trains(two_ranks, name):
    """--tp 2: the two model shards' losses and gradient norms equal one
    process's (dropout on in tp_dropout, with its prenets); their slices
    put together equal its parameters and equal, bit for bit, rank 0's
    checkpoint of whole tensors, which loads at tp=1 (strict); the resume
    of that checkpoint takes the same next epoch at tp=2 as at tp=1, both
    restoring its optimizer. Every layer sums two partial products where one
    process makes one, and ScaledAdam's steps carry that round-off (an
    element of a gradient near its eps moves with it), so after three
    steps each parameter is held to 1e-4 of its tensor's largest entry
    (and at least 1e-4, as the data-parallel runs' atol)."""
    d, ranks, single, _ = two_ranks
    exp_one, stats = single[name]
    got = [r[name] for r in ranks]
    for r in got:
        assert "exit" not in r, r
    assert got[0]["steps"] == got[1]["steps"] == stats.steps == 3
    want = np.array(stats.step_metrics)      # (loss, frames, grad norm)
    for r in got:
        have = np.array(r["step_metrics"])
        np.testing.assert_allclose(have[:, :2], want[:, :2], rtol=1e-5)
        np.testing.assert_allclose(have[:, 2], want[:, 2], rtol=1e-4)
    whole = _ranks_whole(ranks, name)
    epoch = 2 if name == "tp_resume" else 1
    b = load_model(str(exp_one / f"epoch-{epoch}.pt"),
                   device="cpu")[0].state_dict()
    assert whole.keys() == b.keys()
    for k, v in b.items():
        if ROUNDING_NOISE.search(k) or not v.is_floating_point():
            continue
        err = (whole[k] - v).abs().max().item()
        assert err <= 1e-4 * max(v.abs().max().item(), 1.0), (k, err)
    assert got[1]["writes"] == []
    assert f"epoch-{epoch}" in got[0]["writes"]
    model, _ = load_model(str(d / f"dp_{TP_DIR.get(name, name)}"
                              / f"epoch-{epoch}.pt"), device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(v, whole[k]), k
    if name == "tp_resume":
        for r in got:
            assert r["resumed_from"].endswith("epoch-1.pt")
            assert r["optimizer_restored"]
        assert stats.optimizer_restored


def test_tp_step_matches_jax(two_ranks):
    """One fp32 step of the two ranks as the two shards of a tp=2 model
    (draws pinned, dropout off) equals JAX's make_train_step on a dp1 x
    tp2 mesh over the same batch (``test_tp_equivalence.py``'s recipe):
    loss 1e-5, grad norm 1e-4, the gathered parameters rtol 3e-5, atol
    1e-6 (the padded NAR tables 1e-3, ROADMAP C5); both ranks gather the
    same whole tensors."""
    _, ranks, _, (jcfg, params) = two_ranks

    def pinned(params, cfg, micro, *, train_stage, rng, deterministic,
               compute_dtype, state):
        return jax_forward(params, cfg, micro, train_stage=train_stage,
                           deterministic=True, compute_dtype=compute_dtype,
                           state=state,
                           **{k: jnp.int32(v) for k, v in PINS.items()})

    mesh = jax_make_mesh(dp=1, tp=2, devices=jax.devices()[:2])
    jopt, jlr = jax_make_optimizer(params, train_stage=0)
    jstate = jax_shard_train_state(JaxTrainState(
        params, jopt.init(params), {"ar": {}, "nar": {}},
        jnp.zeros((), jnp.int32)), mesh)
    jstep = jax.jit(jax_make_train_step(jcfg, jopt, jlr, train_stage=0,
                                        forward_fn=pinned))
    batch = {k: jnp.asarray(v) for k, v in train_batch().items()}
    batch = jax.device_put(batch, jax_batch_shardings(batch, mesh))
    jstate, jout = jstep(jstate, batch, 0, jax.random.PRNGKey(0))
    want = valle_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, jstate.params), jcfg)
    for r in ranks:
        out = r["tp_collectives"]
        assert out["data_world"] == 1
        assert set(out["step"]) == set(jout)
        np.testing.assert_allclose(out["step"]["loss"], float(jout["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(out["step"]["grad_norm"],
                                   float(jout["grad_norm"]), rtol=1e-4)
        for k, v in jout.items():
            if k != "grad_norm":
                np.testing.assert_allclose(out["step"][k], float(v),
                                           rtol=1e-5, atol=1e-6, err_msg=k)
    assert [r["tp_collectives"]["shard"] for r in ranks] == [0, 1]
    a, b = (torch.load(r["tp_collectives"]["step_params"]) for r in ranks)
    assert a.keys() == set(want)
    for name, v in a.items():
        assert torch.equal(v, b[name]), name
        tol = (1e-3, 1e-4) if name in PADDED else (3e-5, 1e-6)
        np.testing.assert_allclose(v.numpy(), want[name], rtol=tol[0],
                                   atol=tol[1], err_msg=name)
