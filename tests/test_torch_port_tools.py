"""The port's offline tools on the CPU, each beside the JAX package's:

- ``bin/prepare_manifests.py`` on a tiny LJSpeech layout (3 one-second
  seeded wavs at 22.05 kHz) writes the manifests JAX's writes;
- ``bin/tokenizer.py`` (``--text-extractor char``; ``Fbank`` and
  ``Encodec`` on the codec weights of ``tests/encodec_torch_mirror.py``)
  writes the cuts and symbol table JAX's tokenizer writes on the same
  files, with fbank features within 1e-4 and codes on >= 98% of frames;
- ``bin/display_manifest_statistics.py`` prints what JAX's prints;
- ``bin/verify_encodec.py`` on the mirror's seeded weights runs its five
  checks, fails the SNR check and exits 1, as JAX's does on random
  weights;
- ``bin/export_torch.py`` turns a port trainer checkpoint (VALL-E, and the
  Transformer TTS) into a reference-format ``.pt`` that the port's
  ``load_model`` and JAX's ``load_torch_checkpoint`` read."""

import sys

import numpy as np
import pytest
import torch

from valle_tpu.bin import display_manifest_statistics as jax_stats
from valle_tpu.bin import prepare_manifests as jax_prepare
from valle_tpu.bin import tokenizer as jax_tokenizer
from valle_tpu.utils.checkpoint import load_torch_checkpoint
from valle_tpu_torch import native
from valle_tpu_torch.bin import (display_manifest_statistics, export_torch,
                                 prepare_manifests, tokenizer,
                                 verify_encodec)
from valle_tpu_torch.data.manifests import CutSet, Hdf5FeatureStore
from valle_tpu_torch.models import load_model
from valle_tpu_torch.models.transformer import (TransformerTtsConfig,
                                                TransformerTtsModel)
from valle_tpu_torch.models.valle import VALLE, ValleConfig
from valle_tpu_torch.utils.checkpoint import save_checkpoint

from torch_port_helpers import mirror_state_dict

TEXTS = ["Printing, in the only sense.", "With which we are at present",
         "concerned, differs from most"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """An LJSpeech layout: metadata.csv and wavs/ of 3 seeded wavs."""
    root = tmp_path_factory.mktemp("tools")
    lj = root / "LJSpeech-1.1"
    (lj / "wavs").mkdir(parents=True)
    rng = np.random.RandomState(5)
    lines = []
    for i, text in enumerate(TEXTS):
        t = np.arange(22050) / 22050.0
        wav = (0.3 * np.sin(2 * np.pi * (150 + 60 * i) * t)
               + 0.05 * rng.randn(t.size)).astype(np.float32)
        native.write_wav(str(lj / "wavs" / f"LJ001-{i:04d}.wav"), wav, 22050)
        lines.append(f"LJ001-{i:04d}|{text}|{text}")
    (lj / "metadata.csv").write_text("\n".join(lines) + "\n")
    codec = root / "encodec.th"
    torch.save(mirror_state_dict(), codec)
    return root, lj, codec


def _jax_main(monkeypatch, module, argv):
    monkeypatch.setattr(sys, "argv", [module.__name__] + argv)
    return module.main()


def _lines(path):
    import gzip

    with gzip.open(path, "rt") as f:
        return f.read().splitlines()


@pytest.fixture(scope="module")
def manifests(corpus):
    root, lj, _ = corpus
    out = root / "manifests"
    prepare_manifests.main(["--dataset", "ljspeech", "--corpus-dir",
                            str(lj), "--output-dir", str(out)])
    return out


def test_prepare_manifests(corpus, manifests, monkeypatch):
    root, lj, _ = corpus
    jout = root / "manifests_jax"
    _jax_main(monkeypatch, jax_prepare, [
        "--dataset", "ljspeech", "--corpus-dir", str(lj), "--output-dir",
        str(jout)])
    for part in ("train", "dev", "test"):
        name = f"cuts_{part}.jsonl.gz"
        assert _lines(manifests / name) == _lines(jout / name), part
    cuts = CutSet.from_file(manifests / "cuts_train.jsonl.gz")
    assert [c.text for c in cuts] == TEXTS
    assert all(c.recording.sample_rate == 22050 and c.duration == 1.0
               for c in cuts)


def _features(cuts):
    return {c.id: Hdf5FeatureStore(c.features.storage_path).read(
        c.features.storage_key) for c in cuts}


@pytest.mark.parametrize("extractor", ["Fbank", "Encodec"])
def test_tokenizer(corpus, manifests, extractor, monkeypatch, capsys):
    root, _, codec = corpus
    common = ["--src-dir", str(manifests), "--partitions", "train,dev",
              "--audio-extractor", extractor, "--text-extractor", "char",
              "--encodec-weights", str(codec)]
    out, jout = root / f"tok_{extractor}", root / f"tok_{extractor}_jax"
    tokenizer.main(common + ["--output-dir", str(out), "--device", "cpu"])
    _jax_main(monkeypatch, jax_tokenizer, common + ["--output-dir",
                                                    str(jout)])
    table = "unique_text_tokens.k2symbols"
    assert (out / table).read_text() == (jout / table).read_text()
    for part in ("train", "dev"):
        cuts = CutSet.from_file(out / f"cuts_{part}.jsonl.gz")
        jcuts = CutSet.from_file(jout / f"cuts_{part}.jsonl.gz")
        assert len(cuts) == len(jcuts) == (3 if part == "train" else 0)
        for c, j in zip(cuts, jcuts):
            assert (c.id, c.text, c.tokens, c.duration, c.speaker) == (
                j.id, j.text, j.tokens, j.duration, j.speaker)
            f, jf = c.features, j.features
            assert (f.storage_key, f.num_frames, f.num_features,
                    f.frame_shift) == (jf.storage_key, jf.num_frames,
                                       jf.num_features, jf.frame_shift)
        if part == "train":
            got, want = _features(cuts), _features(jcuts)
            for k in want:
                assert got[k].dtype == want[k].dtype
                assert got[k].shape == want[k].shape
                if extractor == "Fbank":
                    assert got[k].shape == (94, 100)
                    assert np.abs(got[k] - want[k]).max() <= 1e-4, k
                else:
                    assert got[k].shape == (75, 8)
                    assert (got[k] == want[k]).mean() >= 0.98, k
            assert list(cuts)[0].tokens[:3] == ["p", "r", "i"]

    capsys.readouterr()
    display_manifest_statistics.main(["--manifest-dir", str(out),
                                      "--partitions", "train,dev,test"])
    ours = capsys.readouterr().out
    _jax_main(monkeypatch, jax_stats, ["--manifest-dir", str(out),
                                       "--partitions", "train,dev,test"])
    assert ours == capsys.readouterr().out
    assert "Cuts count: 3" in ours and "(missing" in ours


def test_verify_encodec_on_seeded_weights(corpus, capsys, tmp_path):
    _, _, codec = corpus
    rc = verify_encodec.main(["--weights", str(codec), "--device", "cpu",
                              "--golden", str(tmp_path / "none.npz")])
    out = capsys.readouterr().out.splitlines()
    assert rc == 1
    assert out[0].startswith("imported")
    assert out[1].startswith("encoded fixture: codes shape (113, 8)")
    assert out[2].startswith("no golden at")
    assert out[3].startswith("reconstruction SNR")
    assert out[4].startswith("FAIL: SNR below threshold")
    assert "self-consistency" in out[5] and out[-1] == "FAIL"


def _trainer_checkpoint(path, model, flags, tokens):
    save_checkpoint(path, model_state=model.state_dict(),
                    optimizer_state={"state": {}},
                    params={**flags, "text_tokens": tokens, "seed": 42})


@pytest.mark.parametrize("name", ["valle", "transformer"])
def test_export_torch_round_trip(name, tmp_path):
    gen = torch.Generator().manual_seed(0)
    if name == "valle":
        flags = {"model_name": "VALL-E", "decoder_dim": 32, "nhead": 2,
                 "num_decoder_layers": 1, "prefix_mode": 1}
        model = VALLE(ValleConfig(d_model=32, nhead=2, num_layers=1,
                                  prefix_mode=1), generator=gen)
    else:
        flags = {"model_name": "transformer", "decoder_dim": 32, "nhead": 2,
                 "num_decoder_layers": 1, "scaling_xformers": True,
                 "norm_first": False}
        model = TransformerTtsModel(TransformerTtsConfig(
            d_model=32, nhead=2, num_layers=1, scaling_xformers=True,
            norm_first=False), generator=gen)
    src, out = tmp_path / "epoch-1.pt", tmp_path / "export.pt"
    _trainer_checkpoint(src, model, flags, "tokens.k2symbols")
    assert export_torch.main([str(src), str(out)]) == 0
    blob = torch.load(out, weights_only=False)
    assert "optimizer" not in blob and "seed" not in blob
    assert blob["text_tokens"] == "tokens.k2symbols"
    back, tokens = load_model(str(out), device="cpu")
    assert type(back) is type(model)
    fields = ("d_model", "nhead", "num_layers", "norm_first", "add_prenet")
    assert all(getattr(back.cfg, f) == getattr(model.cfg, f)
               for f in fields)
    want = model.state_dict()
    assert back.state_dict().keys() == want.keys()
    for k, v in back.state_dict().items():
        assert torch.equal(v, want[k]), k
    if name == "valle":
        assert blob["model_name"] == "VALL-E"
        params, _, _ = load_torch_checkpoint(str(out))
        assert np.array_equal(np.asarray(params["ar"]["text_emb"]["weight"]),
                              want["ar_text_embedding.word_embeddings.weight"
                                   ].numpy())
    else:
        assert blob["model_name"] == "Transformer"
        assert blob["scaling_xformers"] is True
    assert export_torch.main([str(src)]) == 2
