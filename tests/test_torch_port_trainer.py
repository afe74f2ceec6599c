"""The port's trainer CLI (``valle_tpu_torch.bin.trainer``) on the CPU, on
a seeded HDF5 corpus (2 layers, d_model 64, fp32): logged finite losses,
a mid-epoch resume and a preemption resume that equal an uninterrupted
run bit for bit, the stage switch, deferred metric reads and the OOM scan
that change nothing, the non-finite diagnosis, model averaging against
the JAX trainer's recurrence, and checkpoints that the port's
``load_model`` and the JAX package's ``load_torch_checkpoint`` read,
with the JAX package's validation loss on the same weights."""

import re
import shutil
import signal

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from valle_tpu.bin import trainer as jax_trainer
from valle_tpu.data.datamodule import TtsDataModule as JaxDataModule
from valle_tpu.models import get_model as jax_get_model
from valle_tpu.utils import AttributeDict as JaxAttributeDict
from valle_tpu.utils.checkpoint import load_torch_checkpoint
from valle_tpu_torch import training
from valle_tpu_torch.bin import trainer
from valle_tpu_torch.data.datamodule import TtsDataModule
from valle_tpu_torch.models import load_model
from valle_tpu_torch.models.valle import stage_params_mask
from valle_tpu_torch.utils.checkpoint import load_checkpoint

from torch_port_corpus import write_corpus

SMALL = ["--decoder-dim", "64", "--nhead", "4", "--num-decoder-layers", "2",
         "--prefix-mode", "1"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: bit-exact comparisons between runs (with
    several, the CPU's accumulation of the embedding gradients varies
    between two identical runs in the last bit), and no oversubscribed
    cores beside the other test workers (the many small ops of these
    runs then spend most of their time waiting for each other)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_corpus(tmp_path_factory.mktemp("port_trainer"),
                        n_train=14, n_dev=3, train_frames=(40, 120))


def _argv(corpus, exp, *extra):
    """Four steps of stage 0 (both decoders), checkpoints every 2, model
    averaging every 2, a log line every step."""
    return ["--device", "cpu", "--manifest-dir", str(corpus),
            "--text-tokens", str(corpus / "unique_text_tokens.k2symbols"),
            "--exp-dir", str(exp), *SMALL, "--train-stage", "0",
            "--num-epochs", "1", "--max-duration", "6", "--num-buckets", "2",
            "--base-lr", "0.05", "--warmup-steps", "10",
            "--save-every-n", "2", "--keep-last-k", "1",
            "--valid-interval", "100", "--log-interval", "1",
            "--num-workers", "0", "--max-steps-per-epoch", "4",
            "--average-period", "2", "--tensorboard", "false", *extra]


def _run(corpus, exp, *extra):
    return trainer.run(trainer.get_parser().parse_args(
        _argv(corpus, exp, *extra)))


def _log_lines(exp):
    """The step lines of every run in ``exp``, from "Epoch" on."""
    lines = []
    for f in sorted(exp.glob("log/log-train*")):
        lines += [raw[raw.index("Epoch"):]
                  for raw in f.read_text().splitlines() if "tot_loss[" in raw]
    return lines


def _assert_same_training(path, ref_path):
    """Two checkpoints with equal weights, optimizer state and average."""
    a, b = load_checkpoint(path), load_checkpoint(ref_path)
    for key in ("model", "model_avg"):
        assert a[key].keys() == b[key].keys()
        for k in a[key]:
            assert torch.equal(a[key][k], b[key][k]), (key, k)
    oa, ob = a["optimizer"], b["optimizer"]
    assert oa["state"].keys() == ob["state"].keys()
    for i in oa["state"]:
        for k, v in oa["state"][i].items():
            assert torch.equal(v, ob["state"][i][k]), (i, k)
    for k, v in oa["scaled_adam"].items():
        assert (torch.equal(v, ob["scaled_adam"][k])
                if isinstance(v, torch.Tensor) else v == ob["scaled_adam"][k])
    assert a["batch_idx_train"] == b["batch_idx_train"]


@pytest.fixture(scope="module")
def baseline(corpus, tmp_path_factory):
    """The uninterrupted run, with the float64 parameters before and after
    every step."""
    exp = tmp_path_factory.mktemp("baseline")
    snaps = []
    plain = training.make_train_step

    def recording(*a, **k):
        step = plain(*a, **k)

        def wrapped(state, batch, epoch, generator=None):
            def snap():
                return {n: v.detach().double().numpy().copy()
                        for n, v in state.model.state_dict().items()}
            if not snaps:
                snaps.append(snap())
            out = step(state, batch, epoch, generator)
            snaps.append(snap())
            return out
        return wrapped

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(training, "make_train_step", recording)
        stats = _run(corpus, exp)
    return exp, stats, snaps


def test_trainer_logs_finite_losses(baseline):
    exp, stats, snaps = baseline
    assert stats.steps == 4 and len(snaps) == 5
    assert stats.scan_batches > 0 and stats.valid_batches == 0
    lines = _log_lines(exp)
    assert len(lines) == 4
    for i, line in enumerate(lines):
        assert line.startswith(f"Epoch 1, batch {i}, train_stage 0")
        vals = [float(v) for v in re.findall(r"\[([-0-9.e+]+)\]", line)]
        assert len(vals) == 2 and all(np.isfinite(vals))
    assert sorted(p.name for p in exp.glob("*.pt")) == [
        "best-train-loss.pt", "checkpoint-4.pt", "epoch-1.pt"]
    assert [w[0] for w in stats.checkpoint_writes] == [
        "checkpoint-2", "checkpoint-4", "best-train-loss", "epoch-1"]


def test_resume_mid_epoch_is_bit_exact(corpus, baseline, tmp_path):
    """2 steps + a resume from checkpoint-2.pt + 2 steps == 4 steps:
    weights, optimizer state, model average and logged lines."""
    exp, _, _ = baseline
    first = _run(corpus, tmp_path, "--max-steps-per-epoch", "2")
    assert first.steps == 2 and (tmp_path / "checkpoint-2.pt").exists()
    sampler = load_checkpoint(tmp_path / "checkpoint-2.pt")["sampler"]
    assert sampler == {"epoch": 0, "seed": 0, "consumed": 2}
    second = _run(corpus, tmp_path, "--start-batch", "2")
    assert second.steps == 2 and second.optimizer_restored
    assert second.resumed_from.endswith("checkpoint-2.pt")
    _assert_same_training(tmp_path / "epoch-1.pt", exp / "epoch-1.pt")
    assert _log_lines(tmp_path) == _log_lines(exp)


def test_preemption_saves_and_resumes(corpus, baseline, tmp_path):
    """A preemption signal after step 2 (the handler called directly)
    writes preempted.pt with the sampler state and exits 0; the same
    command then resumes from it and ends where the uninterrupted run
    does. The handlers found before are back after each run."""
    exp, _, _ = baseline
    plain = training.make_train_step

    def preempting(*a, **k):
        step = plain(*a, **k)

        def wrapped(state, batch, epoch, generator=None):
            out = step(state, batch, epoch, generator)
            if state.step == 2:
                trainer._on_preempt_signal(signal.SIGTERM, None)
            return out
        return wrapped

    def mine(signum, frame):  # pragma: no cover - never delivered
        pass

    saved = {s: signal.getsignal(s) for s in (signal.SIGTERM,
                                               signal.SIGUSR1)}
    try:
        for s in saved:
            signal.signal(s, mine)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(training, "make_train_step", preempting)
            with pytest.raises(SystemExit) as exit_info:
                _run(corpus, tmp_path)
        assert exit_info.value.code == 0
        assert all(signal.getsignal(s) is mine for s in saved)
        ckpt = load_checkpoint(tmp_path / "preempted.pt")
        assert ckpt["sampler"] == {"epoch": 0, "seed": 0, "consumed": 2}
        assert ckpt["batch_idx_train"] == 2
        stats = _run(corpus, tmp_path)
        assert all(signal.getsignal(s) is mine for s in saved)
    finally:
        for s, handler in saved.items():
            signal.signal(s, handler)
    assert stats.resumed_from.endswith("preempted.pt") and stats.steps == 2
    _assert_same_training(tmp_path / "epoch-1.pt", exp / "epoch-1.pt")
    assert _log_lines(tmp_path) == _log_lines(exp)


def test_preemption_in_a_later_epoch_resumes_there(corpus, tmp_path):
    """Preempted after step 3 of a 2-epoch run (2 steps an epoch), the
    same command goes on in epoch 2, not from --start-epoch 1, and ends
    where the uninterrupted run does."""
    plain = training.make_train_step
    extra = ("--num-epochs", "2", "--max-steps-per-epoch", "2")

    def preempting(*a, **k):
        step = plain(*a, **k)

        def wrapped(state, batch, epoch, generator=None):
            out = step(state, batch, epoch, generator)
            if state.step == 3:
                trainer._on_preempt_signal(signal.SIGUSR1, None)
            return out
        return wrapped

    _run(corpus, tmp_path / "whole", *extra)
    saved = {s: signal.getsignal(s) for s in (signal.SIGTERM,
                                               signal.SIGUSR1)}
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(training, "make_train_step", preempting)
            with pytest.raises(SystemExit):
                _run(corpus, tmp_path / "cut", *extra)
        stats = _run(corpus, tmp_path / "cut", *extra)
    finally:
        for s, handler in saved.items():
            signal.signal(s, handler)
    assert stats.steps == 1
    _assert_same_training(tmp_path / "cut" / "epoch-2.pt",
                          tmp_path / "whole" / "epoch-2.pt")
    assert _log_lines(tmp_path / "cut") == _log_lines(tmp_path / "whole")


def test_stage_switch_drops_optimizer(corpus, baseline, tmp_path):
    """Stage 2 from stage 0's epoch-1.pt: the optimizer state is dropped
    (the new one holds the NAR parameters only), the best losses and the
    batch counter restart, and the AR parameters do not move."""
    exp, _, _ = baseline
    shutil.copy(exp / "epoch-1.pt", tmp_path / "epoch-1.pt")
    stats = _run(corpus, tmp_path, "--train-stage", "2", "--start-epoch",
                 "2", "--num-epochs", "2", "--max-steps-per-epoch", "2")
    assert stats.steps == 2 and not stats.optimizer_restored
    logs = "".join(f.read_text() for f in tmp_path.glob("log/log-train*"))
    assert "Switching training stage 0 -> 2: dropping optimizer state" in logs
    before = load_checkpoint(tmp_path / "epoch-1.pt")
    after = load_checkpoint(tmp_path / "epoch-2.pt")
    assert after["train_stage"] == 2 and after["batch_idx_train"] == 2
    model, _ = load_model(str(tmp_path / "epoch-2.pt"), device="cpu")
    nar = [n for n, on in stage_params_mask(model, 2).items() if on]
    assert len(after["optimizer"]["state"]) == len(nar)
    assert after["optimizer"]["scaled_adam"]["step_count"] == 2
    moved = {k for k, v in before["model"].items()
             if not torch.equal(v, after["model"][k])}
    assert moved and all(k.startswith("nar_") for k in moved)


@pytest.mark.parametrize("flag", ["--inf-check", "--oom-check"])
def test_flags_change_nothing(corpus, baseline, tmp_path, flag):
    """--inf-check true (a metric read every step) logs the lines of the
    deferred reads; --oom-check false (no scan) trains what the scan's run
    trains: the scan leaves no trace."""
    exp, stats, _ = baseline
    value = "true" if flag == "--inf-check" else "false"
    other = _run(corpus, tmp_path, flag, value)
    assert (other.scan_batches == 0) == (flag == "--oom-check")
    assert stats.scan_batches > 0
    _assert_same_training(tmp_path / "epoch-1.pt", exp / "epoch-1.pt")
    assert _log_lines(tmp_path) == _log_lines(exp)


def test_nonfinite_parameter_is_diagnosed(corpus, tmp_path):
    bad = "ar_decoder.layers.1.linear1.weight"
    plain = training.make_optimizer

    def poisoned(model, **kw):
        with torch.no_grad():
            dict(model.named_parameters())[bad][0, 0] = float("nan")
        return plain(model, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(training, "make_optimizer", poisoned)
        with pytest.raises(FloatingPointError) as err:
            _run(corpus, tmp_path, "--inf-check", "true", "--oom-check",
                 "false")
    msg = str(err.value)
    assert "non-finite loss nan" in msg and "at batch 1" in msg
    assert f"non-finite PARAM leaves: ['{bad}']" in msg
    assert "non-finite GRAD leaves" in msg
    assert ("first NaN op: forward: " in msg
            and "in module ar_decoder.layers.1.linear1 (non-finite "
                f"parameter ['{bad}'])" in msg), msg
    assert len(list(tmp_path.glob("batch-*.npz"))) == 1


def test_model_avg_matches_jax_recurrence(baseline):
    """model_avg is the JAX trainer's float64 recurrence
    (valle_tpu/bin/trainer.py:786-795) over the parameters after each
    step, from the initial ones."""
    exp, _, snaps = baseline
    period = 2
    avg = dict(snaps[0])
    for batch_idx, params in enumerate(snaps[1:], start=1):
        if batch_idx % period == 0:
            w = period / max(batch_idx, period)
            avg = {k: a + (params[k] - a) * w for k, a in avg.items()}
    got = load_checkpoint(exp / "epoch-1.pt")["model_avg"]
    assert got.keys() == avg.keys()
    for k, v in got.items():
        assert v.dtype == torch.float64
        np.testing.assert_array_equal(v.numpy(), avg[k], err_msg=k)


def test_checkpoint_loads_in_both_packages(corpus, baseline):
    """epoch-1.pt loads strictly in models.load_model; JAX's
    load_torch_checkpoint rebuilds the model from the file alone, and the
    JAX trainer's validation (deterministic valle_forward) on those
    parameters gives the port's validation to 1e-5."""
    exp, _, _ = baseline
    path = str(exp / "epoch-1.pt")
    model, tokens = load_model(path, device="cpu")
    assert tokens == str(corpus / "unique_text_tokens.k2symbols")
    jparams, jstate, ckpt = load_torch_checkpoint(path)
    jmodel = jax_get_model(JaxAttributeDict(ckpt))
    for f in ("d_model", "nhead", "num_layers", "prefix_mode",
              "share_embedding", "prepend_bos", "num_quantizers"):
        assert getattr(jmodel.cfg, f) == getattr(model.cfg, f), f

    args = trainer.get_parser().parse_args(_argv(corpus, exp))
    params = trainer.get_params()
    params.update(vars(args), cur_epoch=1)
    dm = TtsDataModule(args)
    tot, n = trainer.compute_validation_loss(
        params, model, dm.valid_dataloaders(dm.dev_cuts()), torch.float32,
        torch.device("cpu"))
    jargs = jax_trainer.get_parser().parse_args(_argv(corpus, exp)[2:])
    jparams_run = jax_trainer.get_params()
    jparams_run.update(vars(jargs), cur_epoch=1)
    jdm = JaxDataModule(jargs)
    jtot = jax_trainer.compute_validation_loss(
        jparams_run, jmodel, jparams, jstate,
        jdm.valid_dataloaders(jdm.dev_cuts()), jnp.float32)
    assert n == 1 and tot.keys() == jtot.keys()
    assert tot["frames"] == jtot["frames"] > 0
    assert tot["utterances"] == jtot["utterances"] == 3
    for k in ("loss", "ArTop10Accuracy", "NarTop10Accuracy"):
        assert tot[k] == pytest.approx(jtot[k], rel=1e-5), k
    assert params.best_valid_loss == pytest.approx(
        jparams_run.best_valid_loss, rel=1e-5)


def test_refused_flags(corpus, tmp_path):
    for extra, error, item in (
            (["--tp", "2"], NotImplementedError, "out of scope"),
            (["--world-size", "2"], SystemExit,
             "--world-size 2 but this job has 1 process"),
            (["--ar-pack", "true", "--train-stage", "2"], SystemExit,
             "--ar-pack requires --train-stage 1"),
            (["--model-name", "transformer", "--add-prenet", "true",
              "--scaling-xformers", "true"], ValueError,
             "do not go together")):
        with pytest.raises(error, match=item):
            _run(corpus, tmp_path, *extra)
    if not torch.cuda.is_available():
        args = trainer.get_parser().parse_args(
            _argv(corpus, tmp_path)[2:])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            trainer.run(args)
