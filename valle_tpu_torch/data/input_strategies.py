"""Input strategies: plain precomputed features and prompted features
(prefix-mode 4 neighbor-utterance acoustic prompts).

A host-side copy of ``valle_tpu/data/input_strategies.py`` (numpy).

Parity with reference ``valle/data/input_strategies.py``:
- ``PromptedFeatures`` (:16): a (prompts, features) pair;
- ``PromptedPrecomputedFeatures`` (:38): builds utt->neighbor maps from the
  id structure (libritts ``speaker_book_x_y`` sorted-neighbors per speaker;
  ljspeech ``LJ001-0010`` chapter prefix), samples one neighbor per cut and
  truncates it to <= 3 s at a random offset (:131-148).
"""

from __future__ import annotations

import random
from collections import defaultdict
from typing import List, Tuple

import numpy as np

from .manifests import Cut, CutSet


def _pad_feature_list(feats, pad_value: float = 0.0,
                      pad_to: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    lens = np.array([f.shape[0] for f in feats], dtype=np.int32)
    T = max(int(lens.max()), pad_to)
    F = feats[0].shape[1]
    out = np.full((len(feats), T, F), pad_value, dtype=feats[0].dtype)
    for i, f in enumerate(feats):
        out[i, : f.shape[0]] = f
    return out, lens


def collate_features(cuts, pad_value: float = 0.0,
                     pad_to: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Load + pad features of a batch of cuts -> ((B, T, F), lens)."""
    return _pad_feature_list([c.load_features() for c in cuts],
                             pad_value, pad_to)


class PrecomputedFeatures:
    """Read precomputed features from storage, padded to the batch max."""

    def __call__(self, cuts) -> Tuple[np.ndarray, np.ndarray]:
        return collate_features(cuts)


class OnTheFlyFeatures:
    """Compute features from each cut's recording during loading
    (reference datamodule.py:295-311 wraps lhotse OnTheFlyFeatures around
    the BigVGAN fbank extractor when --on-the-fly-feats is set)."""

    def __init__(self, extractor):
        self.extractor = extractor

    def __call__(self, cuts) -> Tuple[np.ndarray, np.ndarray]:
        # the extractor resamples internally when the recording's native
        # rate differs from its target
        feats = [np.asarray(self.extractor.extract(
            c.load_audio(), c.recording.sample_rate)) for c in cuts]
        return _pad_feature_list(feats)


class PromptedFeatures:
    def __init__(self, prompts, features):
        self.prompts = prompts
        self.features = features

    def to(self, device):  # device-movement no-op (numpy host arrays)
        return self

    def sum(self):
        return self.features.sum()

    @property
    def ndim(self):
        return self.features.ndim

    @property
    def data(self):
        return (self.prompts, self.features)


class PromptedPrecomputedFeatures(PrecomputedFeatures):
    """Neighbor-utterance acoustic prompts for NAR prefix-mode 4."""

    def __init__(self, dataset: str, cuts: CutSet, seed: int = 0) -> None:
        self.rng = random.Random(seed)
        self.utt2neighbors = defaultdict(list)

        if dataset.lower() == "libritts":
            speaker2utts = defaultdict(list)
            utt2cut = {}
            for cut in cuts:
                speaker2utts[cut.speaker].append(cut.id)
                utt2cut[cut.id] = cut
            for spk in speaker2utts:
                uttids = sorted(speaker2utts[spk])
                if len(uttids) == 1:
                    self.utt2neighbors[uttids[0]].append(utt2cut[uttids[0]])
                    continue
                utt2prevutt = dict(zip(uttids, [uttids[1]] + uttids[:-1]))
                utt2postutt = dict(zip(uttids[:-1], uttids[1:]))
                for utt in utt2prevutt:
                    self.utt2neighbors[utt].append(utt2cut[utt2prevutt[utt]])
                for utt in utt2postutt:
                    self.utt2neighbors[utt].append(utt2cut[utt2postutt[utt]])
        elif dataset.lower() == "ljspeech":
            utt2cut = {}
            uttids = []
            for cut in cuts:
                uttids.append(cut.id)
                utt2cut[cut.id] = cut
            if len(uttids) == 1:
                self.utt2neighbors[uttids[0]].append(utt2cut[uttids[0]])
            else:
                utt2prevutt = dict(zip(uttids, [uttids[1]] + uttids[:-1]))
                utt2postutt = dict(zip(uttids[:-1], uttids[1:]))
                for utt in utt2postutt:
                    postutt = utt2postutt[utt]
                    if utt[:5] == postutt[:5]:
                        self.utt2neighbors[utt].append(utt2cut[postutt])
                for utt in utt2prevutt:
                    prevutt = utt2prevutt[utt]
                    if utt[:5] == prevutt[:5] or not self.utt2neighbors[utt]:
                        self.utt2neighbors[utt].append(utt2cut[prevutt])
        else:
            raise ValueError(dataset)

    def __call__(self, cuts) -> Tuple[PromptedFeatures, PromptedFeatures]:
        features, features_lens = collate_features(cuts)

        # sample one neighbor per cut, truncate all to a COMMON <= 3 s
        # length at a random offset (reference :131-148; equal prompt
        # lengths are asserted by the model, valle.py:429)
        neighbors = [self.rng.choice(self.utt2neighbors[c.id]) for c in cuts]
        frame_shift = neighbors[0].features.frame_shift
        mini_frames = min(
            [n.features.num_frames for n in neighbors]
            + [int(3.0 / frame_shift)])
        prompts = np.zeros(
            (len(neighbors), mini_frames, features.shape[-1]),
            dtype=features.dtype)
        for i, n in enumerate(neighbors):
            f = n.load_features()
            off_max = f.shape[0] - mini_frames
            off = self.rng.randint(0, max(off_max, 0))
            prompts[i] = f[off: off + mini_frames]
        prompts_lens = np.full((len(neighbors),), mini_frames, np.int32)

        return (PromptedFeatures(prompts, features),
                PromptedFeatures(prompts_lens, features_lens))
