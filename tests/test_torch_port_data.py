"""The port's data module against the JAX package's, numpy on both sides:
manifests, loaders (two epochs, a mid-epoch resume, the delivered count
with loader threads), the prompted input strategy, SpecAugment, the
BigVGAN filterbank and the trainer's ``_model_batch``, all bit for bit on
a seeded HDF5 corpus."""

import time

import numpy as np
import pytest

from valle_tpu.bin.trainer import _model_batch as jax_model_batch
from valle_tpu.bin.trainer import get_parser as jax_parser
from valle_tpu.data import augment as jax_augment
from valle_tpu.data import fbank as jax_fbank
from valle_tpu.data.datamodule import TtsDataModule as JaxDataModule
from valle_tpu.data.input_strategies import (
    PromptedPrecomputedFeatures as JaxPrompted)
from valle_tpu.data.manifests import CutSet as JaxCutSet
from valle_tpu_torch.bin.trainer import _model_batch, get_parser
from valle_tpu_torch.data import augment, fbank
from valle_tpu_torch.data.datamodule import TtsDataModule
from valle_tpu_torch.data.input_strategies import (
    PromptedFeatures, PromptedPrecomputedFeatures)
from valle_tpu_torch.data.manifests import CutSet

from torch_port_corpus import write_corpus


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_corpus(tmp_path_factory.mktemp("port_data"), n_train=28,
                        n_dev=4, train_frames=(40, 300))


def _argv(root, *extra):
    return ["--manifest-dir", str(root), "--text-tokens",
            str(root / "unique_text_tokens.k2symbols"), "--max-duration",
            "12", "--num-buckets", "3", *extra]


def _modules(root, *extra):
    return (TtsDataModule(get_parser().parse_args(_argv(root, *extra))),
            JaxDataModule(jax_parser().parse_args(_argv(root, *extra))))


def _arrays(batch):
    """The batch's arrays by name (prompted features as two entries)."""
    out = {k: batch[k] for k in ("text_tokens", "text_tokens_lens")}
    for k in ("audio_features", "audio_features_lens"):
        v = batch[k]
        if isinstance(v, PromptedFeatures) or hasattr(v, "prompts"):
            out[k + ".prompts"], out[k] = v.data
        else:
            out[k] = v
    return out


def _same_batches(got, ref, prompts=True):
    """Equal batches; ``prompts=False`` skips the drawn prompts, which
    depend on the strategy's draws so far."""
    assert len(got) == len(ref) > 0
    for a, b in zip(got, ref):
        assert a["utt_id"] == b["utt_id"] and a["text"] == b["text"]
        xa, xb = _arrays(a), _arrays(b)
        assert xa.keys() == xb.keys()
        for k in xa:
            if k.endswith(".prompts") and not prompts:
                continue
            assert xa[k].dtype == xb[k].dtype, k
            np.testing.assert_array_equal(xa[k], xb[k], err_msg=k)


def _epochs(dl, epochs, first_epoch=0):
    """The batches of each epoch, a list per epoch."""
    out = []
    for e in range(first_epoch, first_epoch + epochs):
        dl.sampler.set_epoch(e)
        out.append(list(dl))
    return out


def test_cutset_round_trip(corpus, tmp_path):
    cuts = CutSet.from_file(corpus / "cuts_train.jsonl.gz")
    jcuts = JaxCutSet.from_file(corpus / "cuts_train.jsonl.gz")
    assert [c.to_dict() for c in cuts] == [c.to_dict() for c in jcuts]
    cuts.to_file(tmp_path / "port.jsonl.gz")
    jcuts.to_file(tmp_path / "jax.jsonl")
    again = JaxCutSet.from_file(tmp_path / "port.jsonl.gz")
    back = CutSet.from_file(tmp_path / "jax.jsonl")
    assert ([c.to_dict() for c in again] == [c.to_dict() for c in back]
            == [c.to_dict() for c in cuts])
    np.testing.assert_array_equal(cuts[3].load_features(),
                                  jcuts[3].load_features())
    assert cuts.describe() == jcuts.describe()


@pytest.mark.parametrize("strategy,workers", [
    ("PrecomputedFeatures", "2"), ("PromptedPrecomputedFeatures", "0")])
def test_train_batches_match_jax(corpus, strategy, workers):
    """Two epochs from both loaders, then a resume from the port loader's
    state after 3 delivered batches. The prompted strategy draws from one
    generator in the order batches load, so it runs without loader
    threads (with them, both packages' prompts depend on the threads'
    timing)."""
    dm, jdm = _modules(corpus, "--num-workers", workers,
                       "--input-strategy", strategy)
    dl = dm.train_dataloaders(dm.train_cuts())
    ref = _epochs(jdm.train_dataloaders(jdm.train_cuts()), 2)
    got = _epochs(dl, 2)
    for a, b in zip(got, ref):
        _same_batches(a, b)
    for accum in (1, 2, 4):
        for a, b in zip(got[0], ref[0]):
            x, y = _model_batch(a, accum), jax_model_batch(b, accum)
            assert x.keys() == y.keys()
            for k in x:
                assert x[k].dtype == y[k].dtype, k
                np.testing.assert_array_equal(x[k], y[k], err_msg=k)

    dl.sampler.set_epoch(1)
    it = iter(dl)
    first = [next(it) for _ in range(3)]
    state = dl.state_dict()
    it.close()
    assert state == {"epoch": 1, "seed": 0, "consumed": 3}
    # the loaders met here have drawn other prompts before (an extra
    # epoch), so only the fresh loaders below compare theirs
    _same_batches(first, ref[1][:3], prompts=False)
    rest = _epochs(dm.train_dataloaders(dm.train_cuts(),
                                        sampler_state_dict=state), 1, 1)[0]
    jrest = _epochs(jdm.train_dataloaders(jdm.train_cuts(),
                                          sampler_state_dict=state), 1, 1)[0]
    _same_batches(rest, jrest)
    _same_batches(rest, ref[1][3:], prompts=False)


def test_delivered_not_prefetched(corpus):
    """With two loader threads the sampler runs ahead of the consumer;
    the state counts what was delivered, as the JAX loader's does."""
    dm, jdm = _modules(corpus, "--num-workers", "2")
    dl = dm.train_dataloaders(dm.train_cuts())
    it = iter(dl)
    for _ in range(2):
        next(it)
    deadline = time.monotonic() + 10
    while dl.sampler._consumed <= 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert dl.sampler._consumed > 2          # prefetched past the consumer
    state = dl.state_dict()
    it.close()
    jdm.args.num_workers = 0
    jdl = jdm.train_dataloaders(jdm.train_cuts())
    jit = iter(jdl)
    for _ in range(2):
        next(jit)
    assert state == jdl.state_dict() == {"epoch": 0, "seed": 0,
                                         "consumed": 2}
    jit.close()


@pytest.mark.parametrize("dataset", ["libritts", "ljspeech"])
def test_prompted_features_match_jax(corpus, tmp_path, dataset):
    cuts = CutSet.from_file(corpus / "cuts_train.jsonl.gz")
    if dataset == "ljspeech":    # chapter-prefixed ids, LJ001 / LJ002
        for i, c in enumerate(cuts):
            c.id = f"LJ00{1 + i // 10}-{i:04d}"
        cuts.to_file(tmp_path / "lj.jsonl.gz")
        cuts = CutSet.from_file(tmp_path / "lj.jsonl.gz")
        jcuts = JaxCutSet.from_file(tmp_path / "lj.jsonl.gz")
    else:
        jcuts = JaxCutSet.from_file(corpus / "cuts_train.jsonl.gz")
    strat = PromptedPrecomputedFeatures(dataset, cuts, seed=5)
    jstrat = JaxPrompted(dataset, jcuts, seed=5)
    assert ({k: [n.id for n in v] for k, v in strat.utt2neighbors.items()}
            == {k: [n.id for n in v]
                for k, v in jstrat.utt2neighbors.items()})
    for lo in (0, 5, 11):                     # the draws stay in step
        (f, lens) = strat(cuts[lo:lo + 6])
        (jf, jlens) = jstrat(jcuts[lo:lo + 6])
        for a, b in zip(f.data + lens.data, jf.data + jlens.data):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_spec_augment_and_fbank_match_jax():
    rng = np.random.RandomState(3)
    feats = rng.randn(3, 260, 80).astype(np.float32)
    lens = np.array([260, 201, 190])
    got = augment.SpecAugment(seed=9)(feats, lens)
    want = jax_augment.SpecAugment(seed=9)(feats, lens)
    assert not np.array_equal(got, feats)
    np.testing.assert_array_equal(got, want)
    codes = rng.randint(0, 1024, (2, 40, 8))
    np.testing.assert_array_equal(augment.SpecAugment()(codes), codes)

    np.testing.assert_array_equal(
        fbank.mel_filterbank(24000, 1024, 100, 0.0, 12000.0),
        jax_fbank.mel_filterbank(24000, 1024, 100, 0.0, 12000.0))
    wav = (0.3 * rng.randn(24000 + 517)).astype(np.float32)
    for sr in (24000, 16000):
        got = fbank.get_fbank_extractor().extract(wav, sr)
        want = jax_fbank.get_fbank_extractor().extract(wav, sr)
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
