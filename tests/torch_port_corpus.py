"""A seeded pre-tokenized corpus for the port's trainer and data tests:
``cuts_{train,dev}.jsonl.gz`` manifests whose cuts hold (T, 8) int16 codec
codes (or, for the Transformer TTS, (T, 100) float32 fbank features) in an
HDF5 store, char tokens, and ``unique_text_tokens.k2symbols``.
Written with the port's own manifest layer; the JAX package reads the same
files. Imports no JAX (the card tests use it too)."""

from pathlib import Path

import numpy as np

from valle_tpu_torch.data.manifests import (Cut, CutSet, FeatureRef,
                                            Hdf5FeatureStore)
from valle_tpu_torch.utils.symbol_table import SymbolTable

FRAME_SHIFT = 320.0 / 24000
FBANK_SHIFT = 256.0 / 24000
NUM_MEL_BINS = 100
LETTERS = list("abcdefghijklmnop_")


class MemoryStore(dict):
    """A test double of ``Hdf5FeatureStore`` for hosts without h5py: key
    -> array in memory, read the same way."""

    def read(self, key):
        return np.asarray(self[key])


def write_corpus(root, *, n_train=16, n_dev=3, train_frames=(40, 160),
                 dev_frames=64, text_len=(5, 20), seed=0, prefix="",
                 store=None, features="codes"):
    """Writes the corpus under ``root``; returns ``root``. Train cuts take
    a random length in ``train_frames``; every dev cut has
    ``dev_frames`` frames (one validation batch shape). Cut ids are
    ``{prefix}{split}_{i:03d}``; speakers alternate over two. With a
    ``store`` (a ``MemoryStore``) the codes go there instead of HDF5, and
    the caller points ``manifests._cached_store`` at it. ``features``
    "fbank" writes seeded log-mel-like features instead of codes."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    for split, n in (("train", n_train), ("dev", n_dev)):
        h5 = root / f"feats_{split}.h5"
        cuts, arrays = [], {}
        for i in range(n):
            T = (int(rng.randint(*train_frames)) if split == "train"
                 else dev_frames)
            key = f"{prefix}{split}_{i:03d}"
            if features == "fbank":
                arrays[key] = rng.normal(-4.0, 2.0, (T, NUM_MEL_BINS)
                                         ).astype(np.float32)
                shift = FBANK_SHIFT
            else:
                arrays[key] = rng.randint(0, 1024, (T, 8)).astype(np.int16)
                shift = FRAME_SHIFT
            text = "".join(rng.choice(LETTERS, rng.randint(*text_len)))
            cuts.append(Cut(
                id=key, duration=T * shift, text=text,
                tokens=list(text), speaker=f"spk{i % 2}",
                features=FeatureRef(str(h5), key, T,
                                    arrays[key].shape[1], shift)))
        if store is None:
            with Hdf5FeatureStore(h5).writer() as w:
                for key, a in arrays.items():
                    w.write(key, a)
        else:
            store.update(arrays)
        CutSet(cuts).to_file(root / f"cuts_{split}.jsonl.gz")
    table = SymbolTable()
    for s in ["<pad>", "<bos>", "<eos>"] + sorted(LETTERS):
        table.add(s)
    table.to_file(root / "unique_text_tokens.k2symbols")
    return root
