"""Feature-space augmentation: SpecAugment (host-side numpy).

A copy of ``valle_tpu/data/augment.py``: the same draws from the same
seed.

Parity with the reference's lhotse SpecAugment wiring
(``valle/data/datamodule.py:265-291``: time_warp_factor=80,
num_frame_masks=10, features_mask_size=27, num_feature_masks=2,
frames_mask_size=100), applied to float features (the mel model path).
Integer codec-token features pass through untouched.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np


class SpecAugment:
    """SpecAugment on a (B, T, F) float batch: one time warp + frequency
    masks + time masks per utterance, bounded to each utterance's valid
    frames. Masked regions are zeroed (lhotse semantics)."""

    def __init__(
        self,
        time_warp_factor: Optional[int] = 80,
        num_feature_masks: int = 2,
        features_mask_size: int = 27,
        num_frame_masks: int = 10,
        frames_mask_size: int = 100,
        max_frames_mask_fraction: float = 0.15,
        p: float = 0.9,
        seed: int = 42,
    ) -> None:
        self.time_warp_factor = time_warp_factor
        self.num_feature_masks = num_feature_masks
        self.features_mask_size = features_mask_size
        self.num_frame_masks = num_frame_masks
        self.frames_mask_size = frames_mask_size
        self.max_frames_mask_fraction = max_frames_mask_fraction
        self.p = p
        self.rng = np.random.RandomState(seed)

    def _time_warp(self, x: np.ndarray) -> np.ndarray:
        """Linear time warp of one (T, F) utterance around a random pivot."""
        f = self.time_warp_factor
        T = x.shape[0]
        if f is None or f < 1 or T <= 2 * f + 2:
            return x
        pivot = self.rng.randint(f + 1, T - f)
        shift = self.rng.randint(-f, f + 1)
        if shift == 0:
            return x
        warped = pivot + shift
        src = np.concatenate([
            np.linspace(0, pivot, warped, endpoint=False),
            np.linspace(pivot, T - 1, T - warped),
        ])
        idx = np.arange(T)
        out = np.empty_like(x)
        for j in range(x.shape[1]):
            out[:, j] = np.interp(src, idx, x[:, j])
        return out

    def __call__(self, features: np.ndarray,
                 lens: Optional[np.ndarray] = None) -> np.ndarray:
        if not np.issubdtype(np.asarray(features).dtype, np.floating):
            logging.warning("SpecAugment skipped: integer (codec) features")
            return features
        out = np.array(features, copy=True)
        B, T, F = out.shape
        for b in range(B):
            t_valid = int(lens[b]) if lens is not None else T
            if self.rng.uniform() > self.p:
                continue
            out[b, :t_valid] = self._time_warp(out[b, :t_valid])
            for _ in range(self.num_feature_masks):
                w = self.rng.randint(0, self.features_mask_size + 1)
                if w == 0 or w >= F:
                    continue
                f0 = self.rng.randint(0, F - w + 1)
                out[b, :, f0:f0 + w] = 0.0
            max_total = int(self.max_frames_mask_fraction * t_valid)
            masked = 0
            for _ in range(self.num_frame_masks):
                w = self.rng.randint(0, self.frames_mask_size + 1)
                w = min(w, max(max_total - masked, 0), max(t_valid - 1, 0))
                if w == 0:
                    continue
                t0 = self.rng.randint(0, t_valid - w + 1)
                out[b, t0:t0 + w, :] = 0.0
                masked += w
        return out
