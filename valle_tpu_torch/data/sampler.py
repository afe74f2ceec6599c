"""Batch samplers: duration-budget bucketing with bounded batch shapes.

A copy of ``valle_tpu/data/sampler.py``: the port and the JAX package
draw the same batches from the same cuts and seed.

Parity with the reference's lhotse samplers (``DynamicBucketingSampler``
with ``quadratic_duration=10`` and ``SimpleCutSampler``, reference
``valle/data/datamodule.py:324-343``): batches are packed under a
``max_duration`` seconds budget with a quadratic length penalty, from
duration-sorted buckets, reshuffled each epoch.

Every batch is padded to its bucket's quantized (text_len, audio_len)
shape, so the set of shapes is bounded by num_buckets instead of being
arbitrary per batch (the JAX package bounds its compiles this way; the
port keeps the rule so its batches are the JAX package's). Text pads to
a multiple of 64.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np

from .manifests import Cut, CutSet


def _quadratic_cost(duration: float, quadratic_duration: float) -> float:
    """lhotse's quadratic_duration penalty: d + d^2/q."""
    if quadratic_duration is None:
        return duration
    return duration + duration ** 2 / quadratic_duration


@dataclass
class Batch:
    cuts: List[Cut]
    pad_audio_to: int   # frames
    pad_text_to: int    # tokens


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# allowed batch sizes (ratio <= 1.34 so at most ~25% of a batch is deferred
# back to the bucket, never dropped)
_BATCH_GRID = (1, 2, 3, 4, 6, 8, 10, 12, 16, 20, 24, 32, 40, 48, 64, 96,
               128, 192, 256)


def _grid_down(b: int) -> int:
    for g in reversed(_BATCH_GRID):
        if g <= b:
            return g
    return 1


class DynamicBucketingSampler:
    def __init__(
        self,
        cuts: CutSet,
        *,
        max_duration: float,
        num_buckets: int = 6,
        shuffle: bool = True,
        drop_last: bool = False,
        quadratic_duration: Optional[float] = 10.0,
        frame_shift: float = 320.0 / 24000,
        tokens_per_second: float = 20.0,   # text-pad heuristic
        audio_multiple: int = 32,
        text_multiple: int = 64,
        seed: int = 0,
        world_size: int = 1,
        rank: int = 0,
    ) -> None:
        self.cuts = list(cuts)
        self.max_duration = max_duration
        self.num_buckets = num_buckets
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.quadratic_duration = quadratic_duration
        self.frame_shift = frame_shift
        self.audio_multiple = audio_multiple
        self.text_multiple = text_multiple
        self.seed = seed
        self.epoch = 0
        self.world_size = world_size
        self.rank = rank
        # intra-epoch resume (reference trainer.py:346-364 restores lhotse
        # sampler state so the dataloader fast-forwards): batches yielded
        # this epoch so far / batches to skip on the next iteration
        self._consumed = 0
        self._resume_consumed = 0

        durs = sorted(c.duration for c in self.cuts)
        if not durs:
            raise ValueError(
                "DynamicBucketingSampler got an empty CutSet — check the "
                "manifest path and the duration filters "
                "(--filter-min/max-duration)")
        qs = np.linspace(0, 1, num_buckets + 1)[1:-1]
        self.boundaries = [durs[int(q * (len(durs) - 1))] for q in qs]

    def set_epoch(self, epoch: int) -> None:
        if epoch != self.epoch:
            self._resume_consumed = 0  # fast-forward applies only to the
            self.epoch = epoch         # epoch the state was saved in

    def _bucket_of(self, duration: float) -> int:
        for i, b in enumerate(self.boundaries):
            if duration <= b:
                return i
        return len(self.boundaries)

    def state_dict(self) -> dict:
        return {"epoch": self.epoch, "seed": self.seed,
                "consumed": self._consumed}

    def load_state_dict(self, sd: dict) -> None:
        self.epoch = sd.get("epoch", 0)
        self.seed = sd.get("seed", self.seed)
        self._resume_consumed = sd.get("consumed", 0)

    def __iter__(self) -> Iterator[Batch]:
        rng = random.Random(self.seed + self.epoch)
        order = list(self.cuts)
        if self.shuffle:
            rng.shuffle(order)

        buckets: List[List[Cut]] = [[] for _ in range(self.num_buckets)]
        for c in order:
            buckets[self._bucket_of(c.duration)].append(c)

        batches: List[Batch] = []
        for bi, bucket in enumerate(buckets):
            cur: List[Cut] = []
            cost = 0.0
            pending = list(bucket)
            i = 0
            while i < len(pending):
                c = pending[i]
                i += 1
                cc = _quadratic_cost(c.duration, self.quadratic_duration)
                if cur and cost + cc > self.max_duration:
                    # quantize the batch size to the grid (a bounded set
                    # of (B, text, audio) shapes); overflow cuts go back
                    # into the bucket
                    keep = _grid_down(len(cur))
                    pending[i:i] = cur[keep:]
                    batches.append(self._finalize(bi, cur[:keep]))
                    cur, cost = [], 0.0
                cur.append(c)
                cost += cc
            while cur and not self.drop_last:
                keep = _grid_down(len(cur))  # tails are grid-sized too
                batches.append(self._finalize(bi, cur[:keep]))
                cur = cur[keep:]
        if self.shuffle:
            rng.shuffle(batches)
        # data-parallel sharding across processes (lhotse-style modulo),
        # truncated to a common per-rank count: a rank with one extra
        # batch would enter a collective once more than its peers and
        # deadlock the job.
        if self.world_size > 1:
            n = (len(batches) // self.world_size) * self.world_size
            batches = batches[:n]
        # skip already-consumed batches after a mid-epoch resume
        skip, self._resume_consumed = self._resume_consumed, 0
        self._consumed = 0
        for i, b in enumerate(batches):
            if i % self.world_size == self.rank:
                self._consumed += 1
                if self._consumed <= skip:
                    continue
                yield b

    def _finalize(self, bucket_idx: int, cuts: List[Cut]) -> Batch:
        max_dur = max(c.duration for c in cuts)
        # quantize to the bucket's upper boundary => bounded shape set
        top = bucket_idx >= len(self.boundaries)
        ub = max_dur if top else self.boundaries[bucket_idx]
        pad_dur = max(max_dur, ub)
        frames = int(round(pad_dur / self.frame_shift)) + 1
        # the unbounded top bucket would otherwise produce one shape per
        # batch: snap it to a coarse 4x grid; non-top buckets always pad
        # to their boundary so the fine grid suffices
        mult = (self.audio_multiple if not top
                else 4 * self.audio_multiple)
        frames = _round_up(frames, mult)
        toks = max((len(c.tokens) if c.tokens else 0) + 2 for c in cuts)
        toks = _round_up(toks, self.text_multiple)
        return Batch(cuts=cuts, pad_audio_to=frames, pad_text_to=toks)


class SimpleCutSampler:
    """Duration-sorted packing (reference datamodule.py:336-343)."""

    def __init__(self, cuts: CutSet, *, max_duration: float,
                 shuffle: bool = False, frame_shift: float = 320.0 / 24000,
                 audio_multiple: int = 32, text_multiple: int = 16,
                 world_size: int = 1, rank: int = 0, seed: int = 0):
        self.inner = DynamicBucketingSampler(
            cuts, max_duration=max_duration, num_buckets=1, shuffle=shuffle,
            quadratic_duration=None, frame_shift=frame_shift,
            audio_multiple=audio_multiple, text_multiple=text_multiple,
            world_size=world_size, rank=rank, seed=seed)

    def set_epoch(self, epoch: int) -> None:
        self.inner.set_epoch(epoch)

    def state_dict(self):
        return self.inner.state_dict()

    def load_state_dict(self, sd):
        self.inner.load_state_dict(sd)

    def __iter__(self):
        return iter(self.inner)
