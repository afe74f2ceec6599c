"""The port's recipe scripts (``egs/*/prepare_torch.sh``,
``egs/libritts/run_torch.sh``) on synthetic corpora on the CPU, and its
learning-rate schedules (``optim.cosine_lr``, ``optim.get_lr_fn``)
against the JAX package's. The run_torch.sh drill's training stages run
on the card (``chip_smoke.py`` phase 9d); here its demo stage runs alone
from a checkpoint the test writes."""

import os
import subprocess
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from valle_tpu.optim import cosine_lr as jax_cosine
from valle_tpu.optim import get_lr_fn as jax_get_lr_fn
from valle_tpu_torch import native
from valle_tpu_torch.data.manifests import CutSet
from valle_tpu_torch.models.valle import VALLE, ValleConfig
from valle_tpu_torch.optim import cosine_lr, get_lr_fn

REPO = Path(__file__).resolve().parent.parent
STEPS = [0, 1, 2, 7, 50, 199, 200, 201, 500, 1000, 4999, 5000, 12345]


def test_cosine_and_schedule_factory_match_jax():
    """The three schedules through ``get_lr_fn`` and ``cosine_lr`` alone
    (past its end too) give JAX's values to 1e-6 relative; another name
    raises NotImplementedError in both. JAX computes in float32 and the
    port in Python floats, so where the cosine nears its end and 1 + cos
    cancels, JAX's value carries float32's error of about 1e-8 x base_lr
    (3.5e-10 at step 199 of 200, lr 0.05): the values are also allowed
    1e-6 x base_lr apart."""
    for name in ("eden", "Noam", "cosine"):
        params = types.SimpleNamespace(scheduler_name=name, base_lr=0.05,
                                       warmup_steps=200, decoder_dim=1024)
        port, ref = get_lr_fn(params), jax_get_lr_fn(params)
        for epoch in (1, 3):
            for step in STEPS:
                np.testing.assert_allclose(
                    port(step, epoch), float(ref(step, epoch)), rtol=1e-6,
                    atol=1e-6 * params.base_lr,
                    err_msg=f"{name} step {step} epoch {epoch}")
    for step in STEPS:
        np.testing.assert_allclose(
            cosine_lr(0.1, step, total_steps=1000, eta_min=1e-3),
            float(jax_cosine(0.1, step, total_steps=1000, eta_min=1e-3)),
            rtol=1e-6, atol=1e-7)
    bad = types.SimpleNamespace(scheduler_name="linear", base_lr=0.05,
                                warmup_steps=200, decoder_dim=1024)
    for fn in (get_lr_fn, jax_get_lr_fn):
        with pytest.raises(NotImplementedError):
            fn(bad)


def _sine_wav(path, dur, sr, seed):
    rng = np.random.RandomState(seed)
    t = np.arange(int(dur * sr)) / sr
    w = (0.3 * np.sin(2 * np.pi * (180 + 20 * seed) * t)
         + 0.04 * rng.randn(t.size)).astype(np.float32)
    native.write_wav(str(path), w, sr)


def _ljspeech(root: Path):
    (root / "wavs").mkdir(parents=True)
    lines = []
    for i in range(6):
        uid = f"LJ001-{i:04d}"
        _sine_wav(root / "wavs" / f"{uid}.wav", 0.6 + 0.1 * (i % 3), 22050, i)
        lines.append(f"{uid}|some text here|some text here")
    (root / "metadata.csv").write_text("\n".join(lines))
    return {}, 6


def _libritts(root: Path):
    for part, n in (("train-clean-100", 4), ("dev-clean", 2),
                    ("test-clean", 1)):
        for i in range(n):
            spk, book = 100 + i % 2, 200 + i
            d = root / part / str(spk) / str(book)
            d.mkdir(parents=True, exist_ok=True)
            uid = f"{spk}_{book}_000001_000000"
            _sine_wav(d / f"{uid}.wav", 0.6 + 0.1 * i, 24000, i)
            (d / f"{uid}.normalized.txt").write_text("hello from libritts")
    return {"train_parts": "train-clean-100"}, 4


def _aishell1(root: Path):
    lines = []
    for split, n in (("train", 4), ("dev", 1), ("test", 1)):
        for i in range(n):
            d = root / "wav" / split / f"S{i % 2:04d}"
            d.mkdir(parents=True, exist_ok=True)
            uid = f"BAC009{split[:2].upper()}{i:04d}"
            _sine_wav(d / f"{uid}.wav", 0.5 + 0.1 * i, 16000, i)
            lines.append(f"{uid} 你 好 世 界")
    (root / "transcript").mkdir(parents=True)
    (root / "transcript" / "aishell_transcript_v0.8.txt").write_text(
        "\n".join(lines), encoding="utf-8")
    return {}, 4


@pytest.mark.parametrize("corpus,make", [("ljspeech", _ljspeech),
                                         ("libritts", _libritts),
                                         ("aishell1", _aishell1)])
def test_prepare_torch_sh(tmp_path, corpus, make):
    """Stages 1-3 (manifests, EnCodec codes and char tokens on
    ``device=cpu``, statistics) of each corpus's prepare_torch.sh, as
    ``tests/test_recipe_scripts.py`` runs JAX's prepare.sh: every train
    cut has tokens and (frames, 8) codes. The script calls the port's CLIs
    only."""
    script = (REPO / f"egs/{corpus}/prepare_torch.sh").read_text()
    assert "valle_tpu.bin" not in script and "valle_tpu_torch.bin" in script
    extra, n_train = make(tmp_path / "corpus")
    data_dir = tmp_path / "data"
    env = dict(os.environ, stage="1", stop_stage="3",
               corpus_dir=str(tmp_path / "corpus"), text_extractor="char",
               data_dir=str(data_dir), device="cpu", **extra)
    proc = subprocess.run(
        ["bash", str(REPO / f"egs/{corpus}/prepare_torch.sh")], env=env,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert f"Cuts count: {n_train}" in proc.stdout
    cuts = CutSet.from_file(data_dir / "tokenized" / "cuts_train.jsonl.gz")
    assert len(cuts) == n_train
    for c in cuts:
        assert c.tokens
        assert c.load_features().shape == (c.features.num_frames, 8)
    assert (data_dir / "tokenized" / "unique_text_tokens.k2symbols").exists()


def test_run_torch_sh_demo_stage(tmp_path):
    """run_torch.sh stage 6 alone on ``device=cpu``: the demo synthesis
    from the best checkpoint there is (``best-train-loss.pt`` when no
    ``best-valid-loss.pt`` was written) writes a wav of whole frames."""
    assert "valle_tpu.bin" not in (REPO / "egs/libritts/run_torch.sh"
                                   ).read_text()
    symbols = sorted(set("abcdefghijklmnopqrstuvwxyz_"))
    tokenized = tmp_path / "data" / "tokenized"
    tokenized.mkdir(parents=True)
    (tokenized / "unique_text_tokens.k2symbols").write_text("".join(
        f"{s} {i}\n" for i, s in enumerate(["<pad>"] + symbols)))
    exp = tmp_path / "exp"
    exp.mkdir()
    model = VALLE(ValleConfig(d_model=32, nhead=2, num_layers=1,
                              prefix_mode=1),
                  generator=torch.Generator().manual_seed(0))
    torch.save({"model": model.state_dict(), "decoder_dim": 32, "nhead": 2,
                "num_decoder_layers": 1, "prefix_mode": 1},
               exp / "best-train-loss.pt")
    env = dict(os.environ, stage="6", stop_stage="6",
               data_dir=str(tmp_path / "data"), exp_dir=str(exp),
               device="cpu", demo_text="hello from the port",
               infer_extra="--text-extractor char --max-gen-len 8")
    proc = subprocess.run(
        ["bash", str(REPO / "egs/libritts/run_torch.sh")], env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    wavs = list((exp / "demos").glob("*.wav"))
    assert len(wavs) == 1
    audio, sr = native.read_wav(str(wavs[0]))
    assert sr == 24000 and 0 < audio.shape[0] and audio.shape[0] % 320 == 0
