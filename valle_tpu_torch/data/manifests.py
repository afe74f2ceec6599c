"""Self-contained cut manifests + array storage (the lhotse-lite layer).

A host-side copy of ``valle_tpu/data/manifests.py`` (the JAX package's
``data`` package reaches ``jax`` through ``valle_tpu.utils``); audio is
read through the port's own ``native`` library. The reference delegates manifests/features to lhotse (CutSet jsonl.gz
manifests referencing HDF5 feature storage — reference
``valle/bin/tokenizer.py:198-245``, ``valle/data/datamodule.py:425-440``).
This module provides the same capabilities without the dependency:

- ``Cut``: one utterance with duration, supervision (text/tokens/speaker),
  a recording reference and/or a feature reference;
- ``CutSet``: jsonl(.gz) load/save, filtering, sorting, describe();
- ``Hdf5FeatureStore``: (T, num_quantizers) code arrays (or mel features)
  keyed by cut id, via h5py.

The jsonl schema intentionally mirrors lhotse's key names where practical
so existing lhotse manifests can be converted with a small script.
"""

from __future__ import annotations

import gzip
import json
import random
from dataclasses import asdict, dataclass, field
from pathlib import Path
from functools import lru_cache
from typing import Callable, Dict, Iterable, Iterator, List, Optional

import numpy as np


@dataclass
class FeatureRef:
    storage_path: str
    storage_key: str
    num_frames: int
    num_features: int
    frame_shift: float

    def load(self) -> np.ndarray:
        return _cached_store(self.storage_path).read(self.storage_key)


@dataclass
class RecordingRef:
    path: str
    sample_rate: int
    num_samples: int


@dataclass
class Cut:
    id: str
    duration: float
    text: Optional[str] = None
    tokens: Optional[List[str]] = None
    speaker: Optional[str] = None
    features: Optional[FeatureRef] = None
    recording: Optional[RecordingRef] = None
    custom: Dict = field(default_factory=dict)

    def load_features(self) -> np.ndarray:
        assert self.features is not None, f"cut {self.id} has no features"
        return self.features.load()

    def load_audio(self) -> np.ndarray:
        from .. import native

        assert self.recording is not None
        wav, sr = native.read_wav(self.recording.path)
        assert sr == self.recording.sample_rate
        return native.to_mono(wav)

    def to_dict(self) -> Dict:
        d = {"id": self.id, "duration": self.duration}
        for k in ("text", "tokens", "speaker"):
            v = getattr(self, k)
            if v is not None:
                d[k] = v
        if self.features is not None:
            d["features"] = asdict(self.features)
        if self.recording is not None:
            d["recording"] = asdict(self.recording)
        if self.custom:
            d["custom"] = self.custom
        return d

    @staticmethod
    def from_dict(d: Dict) -> "Cut":
        return Cut(
            id=d["id"],
            duration=d["duration"],
            text=d.get("text"),
            tokens=d.get("tokens"),
            speaker=d.get("speaker"),
            features=(FeatureRef(**d["features"])
                      if d.get("features") else None),
            recording=(RecordingRef(**d["recording"])
                       if d.get("recording") else None),
            custom=d.get("custom", {}),
        )


class CutSet:
    def __init__(self, cuts: Iterable[Cut]):
        self.cuts: List[Cut] = list(cuts)
        self._by_id = {c.id: c for c in self.cuts}

    # -- io -----------------------------------------------------------------
    @staticmethod
    def from_file(path) -> "CutSet":
        path = Path(path)
        opener = gzip.open if path.suffix == ".gz" else open
        with opener(path, "rt", encoding="utf-8") as f:
            return CutSet(Cut.from_dict(json.loads(line)) for line in f
                          if line.strip())

    def to_file(self, path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        opener = gzip.open if path.suffix == ".gz" else open
        with opener(path, "wt", encoding="utf-8") as f:
            for c in self.cuts:
                f.write(json.dumps(c.to_dict(), ensure_ascii=False) + "\n")

    # -- access / transform ---------------------------------------------------
    def __len__(self) -> int:
        return len(self.cuts)

    def __iter__(self) -> Iterator[Cut]:
        return iter(self.cuts)

    def __getitem__(self, key):
        if isinstance(key, str):
            return self._by_id[key]
        return self.cuts[key]

    def filter(self, fn: Callable[[Cut], bool]) -> "CutSet":
        return CutSet(c for c in self.cuts if fn(c))

    def map(self, fn: Callable[[Cut], Cut]) -> "CutSet":
        return CutSet(fn(c) for c in self.cuts)

    def subset(self, first: Optional[int] = None,
               last: Optional[int] = None) -> "CutSet":
        if first is not None:
            return CutSet(self.cuts[:first])
        assert last is not None
        return CutSet(self.cuts[-last:])

    def shuffle(self, rng: Optional[random.Random] = None) -> "CutSet":
        rng = rng or random.Random(42)
        cuts = list(self.cuts)
        rng.shuffle(cuts)
        return CutSet(cuts)

    def sort_by_duration(self, ascending: bool = False) -> "CutSet":
        return CutSet(sorted(self.cuts, key=lambda c: c.duration,
                             reverse=not ascending))

    def __add__(self, other: "CutSet") -> "CutSet":
        return CutSet(list(self.cuts) + list(other.cuts))

    def describe(self) -> str:
        """Duration statistics (reference bin/display_manifest_statistics)."""
        durs = np.array([c.duration for c in self.cuts])
        if len(durs) == 0:
            return "Empty CutSet"
        total = durs.sum()
        lines = [
            f"Cuts count: {len(durs)}",
            f"Total duration (hh:mm:ss): "
            f"{int(total // 3600):02d}:{int(total % 3600 // 60):02d}:"
            f"{int(total % 60):02d}",
            f"mean\t{durs.mean():.1f}",
            f"std\t{durs.std():.1f}",
            f"min\t{durs.min():.1f}",
            f"25%\t{np.percentile(durs, 25):.1f}",
            f"50%\t{np.percentile(durs, 50):.1f}",
            f"75%\t{np.percentile(durs, 75):.1f}",
            f"99%\t{np.percentile(durs, 99):.1f}",
            f"99.5%\t{np.percentile(durs, 99.5):.1f}",
            f"99.9%\t{np.percentile(durs, 99.9):.1f}",
            f"max\t{durs.max():.1f}",
        ]
        return "\n".join(lines)


@lru_cache(maxsize=64)
def _cached_store(path: str) -> "Hdf5FeatureStore":
    """One open reader per storage path: FeatureRef.load runs in the
    data-loading hot path (2B reads/batch for the prompted strategy) and
    re-opening the HDF5 superblock per cut is pure overhead. h5py
    serializes concurrent access internally, so sharing the handle across
    loader threads is safe."""
    return Hdf5FeatureStore(path)


class Hdf5FeatureStore:
    """(key -> 2D int/float array) storage on HDF5, append-friendly."""

    def __init__(self, path):
        self.path = str(path)
        self._handle = None

    def _reader(self):
        import h5py

        if self._handle is None:
            self._handle = h5py.File(self.path, "r")
        return self._handle

    def read(self, key: str) -> np.ndarray:
        return np.asarray(self._reader()[key])

    def close(self):
        if self._handle is not None:
            self._handle.close()
            self._handle = None

    class Writer:
        def __init__(self, path, mode: str = "a"):
            import h5py

            Path(path).parent.mkdir(parents=True, exist_ok=True)
            self.path = str(path)
            # "a" honors the class's append-friendly contract (a resumed
            # extraction run must not truncate earlier partitions);
            # existing keys are replaced on write
            self.f = h5py.File(self.path, mode)

        def write(self, key: str, array: np.ndarray) -> None:
            if key in self.f:
                del self.f[key]
            self.f.create_dataset(key, data=array)

        def close(self):
            self.f.close()

        def __enter__(self):
            return self

        def __exit__(self, *a):
            self.close()

    def writer(self) -> "Hdf5FeatureStore.Writer":
        return Hdf5FeatureStore.Writer(self.path)
