"""The port's trainer CLI with VALL-F and with a prenet post-norm VALL-E on
the CPU (a seeded corpus, 2 layers, d 64, fp32, one intra-op thread as
``tests/test_torch_port_trainer.py`` runs): 2 steps of stage 0 write
``.pt`` files whose model ``models.load_model`` and ``bin/infer.py`` read;
the prenets' statistics move once a step and branch (the OOM scan and
validation move them not at all); 1 step, a resume from checkpoint-1.pt
and 1 more step end bit for bit where the 2 uninterrupted steps do,
statistics included; packed rows refuse VALL-F as JAX's trainer does.

The Transformer TTS (plain and ``--scaling-xformers``, d 32, on a seeded
fbank corpus): 2 steps with a validation pass and ``--visualize`` write
the dev batch's PNGs and checkpoints that ``load_model`` rebuilds, and
the resume ends bit for bit where the uninterrupted run does.
``--visualize`` writes VALL-E's PNGs too, and refuses to start without
matplotlib."""

import sys

import numpy as np
import pytest
import torch

from valle_tpu_torch import native
from valle_tpu_torch.bin import infer, trainer
from valle_tpu_torch.models import load_model
from valle_tpu_torch.models.transformer import TransformerTtsModel
from valle_tpu_torch.utils.checkpoint import load_checkpoint

from torch_port_corpus import write_corpus
from torch_port_helpers import mirror_state_dict

VARIANTS = {"vallf": ["--model-name", "VALL-F"],
            "prenet_postnorm": ["--add-prenet", "true", "--norm-first",
                                "false"]}
STATS = ("running_mean", "running_var", "num_batches_tracked")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_corpus(tmp_path_factory.mktemp("port_variants"),
                        n_train=10, n_dev=2, train_frames=(40, 100))


def _run(corpus, exp, variant, *extra):
    argv = ["--device", "cpu", "--manifest-dir", str(corpus),
            "--text-tokens", str(corpus / "unique_text_tokens.k2symbols"),
            "--exp-dir", str(exp), "--decoder-dim", "64", "--nhead", "4",
            "--num-decoder-layers", "2", "--prefix-mode", "1",
            "--train-stage", "0", "--num-epochs", "1", "--max-duration", "6",
            "--num-buckets", "2", "--base-lr", "0.05", "--warmup-steps",
            "10", "--save-every-n", "1", "--valid-interval", "2",
            "--log-interval", "1", "--num-workers", "0",
            "--max-steps-per-epoch", "2", "--tensorboard", "false",
            *VARIANTS[variant], *extra]
    return trainer.run(trainer.get_parser().parse_args(argv))


def _stats(sd):
    return {k: v for k, v in sd.items() if k.endswith(STATS)}


@pytest.fixture(scope="module")
def uninterrupted(corpus, tmp_path_factory):
    out = {}
    for variant in VARIANTS:
        exp = tmp_path_factory.mktemp(f"two_steps_{variant}")
        out[variant] = (exp, _run(corpus, exp, variant))
    return out


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_two_steps_write_checkpoints_that_infer_reads(uninterrupted, variant,
                                                      tmp_path):
    exp, stats = uninterrupted[variant]
    assert stats.steps == 2 and stats.scan_batches > 0
    assert stats.valid_batches > 0
    assert all(np.isfinite(loss) for loss, _, _ in stats.step_metrics)
    model, _ = load_model(str(exp / "epoch-1.pt"), device="cpu")
    cfg = model.cfg
    assert (cfg.model_name, cfg.add_prenet, cfg.norm_first) == {
        "vallf": ("vallf", False, True),
        "prenet_postnorm": ("valle", True, False)}[variant]
    assert cfg.attn_impl == "einsum"
    st = _stats(load_checkpoint(exp / "epoch-1.pt")["model"])
    assert bool(st) == cfg.add_prenet
    for k, v in st.items():
        if k.endswith("num_batches_tracked"):
            assert int(v) == 2, k    # one a step and branch; not the scan
        elif k.endswith("running_var"):
            assert not torch.equal(v, torch.ones_like(v)), k
    codec = tmp_path / "codec.th"
    torch.save(mirror_state_dict(), codec)
    prompt = tmp_path / "p.wav"
    native.write_wav(str(prompt), np.zeros(4800, np.float32), 16000)
    infer.main(["--checkpoint", str(exp / "epoch-1.pt"), "--text-extractor",
                "char", "--audio-prompts", str(prompt), "--text", "abc",
                "--max-gen-len", "6", "--top-k", "1", "--encodec-weights",
                str(codec), "--output-dir", str(tmp_path / "out"),
                "--device", "cpu"])
    wav, sr = native.read_wav(str(tmp_path / "out" / "0.wav"))
    assert sr == 24000 and wav.shape[0] % 320 == 0


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_resume_restores_statistics(corpus, uninterrupted, variant,
                                    tmp_path):
    exp, _ = uninterrupted[variant]
    first = _run(corpus, tmp_path, variant, "--max-steps-per-epoch", "1")
    assert first.steps == 1
    second = _run(corpus, tmp_path, variant, "--start-batch", "1")
    assert second.steps == 1 and second.resumed_from.endswith(
        "checkpoint-1.pt")
    a = load_checkpoint(tmp_path / "epoch-1.pt")["model"]
    b = load_checkpoint(exp / "epoch-1.pt")["model"]
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_packing_refuses_vallf(corpus, tmp_path):
    with pytest.raises(SystemExit, match="--model-name valle"):
        _run(corpus, tmp_path, "vallf", "--train-stage", "1", "--ar-pack",
             "true")


TTS = {"transformer": [],
       "transformer_scaling": ["--scaling-xformers", "true"]}


@pytest.fixture(scope="module")
def fbank_corpus(tmp_path_factory):
    return write_corpus(tmp_path_factory.mktemp("port_tts"), n_train=10,
                        n_dev=2, train_frames=(40, 100), features="fbank")


def _run_tts(corpus, exp, variant, *extra):
    argv = ["--device", "cpu", "--manifest-dir", str(corpus),
            "--text-tokens", str(corpus / "unique_text_tokens.k2symbols"),
            "--exp-dir", str(exp), "--model-name", "transformer",
            "--decoder-dim", "32", "--nhead", "2", "--num-decoder-layers",
            "2", "--num-epochs", "1", "--max-duration", "6",
            "--num-buckets", "2", "--base-lr", "0.05", "--warmup-steps",
            "10", "--save-every-n", "1", "--valid-interval", "2",
            "--log-interval", "1", "--num-workers", "0",
            "--max-steps-per-epoch", "2", "--tensorboard", "false",
            *TTS[variant], *extra]
    return trainer.run(trainer.get_parser().parse_args(argv))


@pytest.fixture(scope="module")
def tts_runs(fbank_corpus, tmp_path_factory):
    out = {}
    for variant in TTS:
        exp = tmp_path_factory.mktemp(f"tts_{variant}")
        out[variant] = (exp, _run_tts(fbank_corpus, exp, variant,
                                      "--visualize", "true"))
    return out


@pytest.mark.parametrize("variant", list(TTS))
def test_transformer_tts_trains_and_visualizes(tts_runs, variant):
    exp, stats = tts_runs[variant]
    assert stats.steps == 2 and stats.scan_batches > 0
    assert stats.valid_batches > 0
    assert all(np.isfinite(loss) for loss, _, _ in stats.step_metrics)
    assert stats.batch_shapes[0][2] > 0
    pngs = sorted(p.name for p in (exp / "eval_epoch1").glob("*.png"))
    assert pngs == ["dev_000.png", "dev_001.png"]
    model, _ = load_model(str(exp / "epoch-1.pt"), device="cpu")
    assert isinstance(model, TransformerTtsModel)
    assert model.cfg.scaling_xformers == (variant == "transformer_scaling")
    assert model.cfg.num_mel_bins == 100


@pytest.mark.parametrize("variant", list(TTS))
def test_transformer_tts_resume(fbank_corpus, tts_runs, variant, tmp_path):
    exp, _ = tts_runs[variant]
    first = _run_tts(fbank_corpus, tmp_path, variant,
                     "--max-steps-per-epoch", "1")
    assert first.steps == 1
    second = _run_tts(fbank_corpus, tmp_path, variant, "--start-batch", "1")
    assert second.steps == 1 and second.optimizer_restored
    a = load_checkpoint(tmp_path / "epoch-1.pt")["model"]
    b = load_checkpoint(exp / "epoch-1.pt")["model"]
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_visualize_valle_and_without_matplotlib(corpus, tmp_path,
                                                monkeypatch):
    stats = _run(corpus, tmp_path, "vallf", "--visualize", "true")
    assert stats.valid_batches > 0
    assert len(list((tmp_path / "eval_epoch1").glob("dev_*.png"))) == 2
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        _run(corpus, tmp_path / "none", "vallf", "--visualize", "true")
    assert not (tmp_path / "none").exists()
