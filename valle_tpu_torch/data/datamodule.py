"""TtsDataModule: CLI flags + train/valid/test dataloaders.

A host-side copy of ``valle_tpu/data/datamodule.py``, with the same flags
and batches. Sequence packing (``--ar-pack`` / ``--nar-pack``) is not
ported yet (ROADMAP A10) and raises. Parity with reference ``valle/data/datamodule.py`` (:62-440): the same flag
set (manifest dir, max-duration budget, bucketing, on-the-fly features,
input strategy, text-tokens path, ...), lazy ``cuts_{train,dev,test}``
manifests, per-epoch sampler reshuffle, worker prefetch.

The torch DataLoader worker processes are replaced by a thread-pool
prefetcher (``__getitem__`` is numpy + h5py, which release the GIL); the
batches stay numpy and become tensors in the consumer's thread.
"""

from __future__ import annotations

import argparse
import logging
import queue
import threading
from functools import lru_cache
from pathlib import Path
from typing import Iterator, Optional

from ..utils import str2bool
from .collation import get_text_token_collater
from .dataset import SpeechSynthesisDataset
from .input_strategies import PrecomputedFeatures, PromptedPrecomputedFeatures
from .manifests import CutSet
from .sampler import DynamicBucketingSampler, SimpleCutSampler


class DataLoader:
    """Sampler + dataset -> iterator of model batches with prefetching.

    ``num_workers`` loader threads run ``dataset.__getitem__`` (numpy +
    h5py, which release the GIL) over a bounded in-flight window; batches
    are handed to the consumer IN ORDER. ``state_dict()`` reports the
    number of batches actually DELIVERED to the consumer (not prefetched)
    so mid-epoch checkpoints resume exactly where training stopped.
    Tear-down is leak-free: abandoning the iterator (break / exception)
    stops the feeder and workers via a shared event and joins them.
    """

    def __init__(self, dataset: SpeechSynthesisDataset, sampler,
                 num_workers: int = 2, prefetch: int = 4):
        self.dataset = dataset
        self.sampler = sampler
        self.num_workers = max(num_workers, 0)
        self.prefetch = prefetch
        self._delivered = 0          # consumer-side count, this epoch
        self._resume_skip = 0        # sampler skip offset at epoch start

    def state_dict(self) -> dict:
        """Sampler state with 'consumed' corrected to DELIVERED batches
        (the prefetch pipeline advances the sampler ahead of training)."""
        sd = dict(self.sampler.state_dict())
        sd["consumed"] = self._resume_skip + self._delivered
        return sd

    def _load(self, b):
        return self.dataset.__getitem__(
            b.cuts, pad_audio_to=b.pad_audio_to, pad_text_to=b.pad_text_to)

    def __iter__(self) -> Iterator[dict]:
        self._delivered = 0
        self._resume_skip = getattr(self.sampler, "_resume_consumed", 0)
        if self.num_workers == 0:
            for b in self.sampler:
                out = self._load(b)
                self._delivered += 1
                yield out
            return

        stop = threading.Event()
        tasks: "queue.Queue" = queue.Queue(
            maxsize=self.prefetch + self.num_workers)
        done: dict = {}
        state = {"total": None, "error": None}
        cv = threading.Condition()
        sentinel = object()

        def _put(item):
            while not stop.is_set():
                try:
                    tasks.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def feeder():
            i = -1
            try:
                for i, b in enumerate(self.sampler):
                    if not _put((i, b)):
                        return
            except BaseException as e:
                with cv:
                    state["error"] = e
                    cv.notify_all()
            finally:
                with cv:
                    if state["total"] is None:
                        state["total"] = i + 1
                    cv.notify_all()
                for _ in range(self.num_workers):
                    _put(sentinel)

        def worker():
            while not stop.is_set():
                try:
                    item = tasks.get(timeout=0.1)
                except queue.Empty:
                    continue
                if item is sentinel:
                    return
                i, b = item
                try:
                    out = self._load(b)
                except BaseException as e:
                    with cv:
                        state["error"] = e
                        cv.notify_all()
                    return
                with cv:
                    done[i] = out
                    cv.notify_all()

        threads = [threading.Thread(target=feeder, daemon=True)]
        threads += [threading.Thread(target=worker, daemon=True)
                    for _ in range(self.num_workers)]
        for t in threads:
            t.start()

        nxt = 0
        try:
            while True:
                with cv:
                    while (state["error"] is None and nxt not in done
                           and (state["total"] is None
                                or nxt < state["total"])):
                        cv.wait()
                    if state["error"] is not None:
                        raise state["error"]
                    if state["total"] is not None and nxt >= state["total"]:
                        return
                    out = done.pop(nxt)
                nxt += 1
                self._delivered += 1
                yield out
        finally:
            # every thread ends before the iterator does: a reader left
            # running past its consumer can outlive the interpreter
            stop.set()
            for t in threads:
                t.join()


class TtsDataModule:
    """Train/valid/test dataloader factory driven by argparse flags."""

    def __init__(self, args: argparse.Namespace):
        self.args = args

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> None:
        group = parser.add_argument_group(
            title="TTS data related options",
            description="Options for data, features and dataloaders.")
        group.add_argument("--manifest-dir", type=Path,
                           default=Path("data/tokenized"))
        group.add_argument("--max-duration", type=float, default=40.0,
                           help="Maximum pooled recordings duration (s) in "
                                "a single batch.")
        group.add_argument("--buffer-size", type=int, default=40000)
        group.add_argument("--shuffle-buffer-size", type=int, default=100000)
        group.add_argument("--bucketing-sampler", type=str2bool, default=True)
        group.add_argument("--num-buckets", type=int, default=10)
        group.add_argument("--concatenate-cuts", type=str2bool, default=False)
        group.add_argument("--duration-factor", type=float, default=1.0)
        group.add_argument("--gap", type=float, default=0.1)
        group.add_argument("--on-the-fly-feats", type=str2bool, default=False)
        group.add_argument("--shuffle", type=str2bool, default=True)
        group.add_argument("--drop-last", type=str2bool, default=False)
        group.add_argument("--return-cuts", type=str2bool, default=True)
        group.add_argument("--num-workers", type=int, default=2)
        group.add_argument("--enable-spec-aug", type=str2bool, default=False)
        group.add_argument("--spec-aug-time-warp-factor", type=int,
                           default=80)
        group.add_argument("--input-strategy", type=str,
                           default="PrecomputedFeatures",
                           help="PrecomputedFeatures or "
                                "PromptedPrecomputedFeatures.")
        group.add_argument("--dataset", type=str, default="libritts",
                           help="For PromptedPrecomputedFeatures: "
                                "libritts or ljspeech.")
        group.add_argument("--text-tokens", type=str,
                           default="data/tokenized/unique_text_tokens."
                                   "k2symbols")
        group.add_argument("--sampling-rate", type=int, default=24000)
        group.add_argument("--world-size-data", type=int, default=1,
                           help="Data-parallel shard count for the sampler.")
        group.add_argument("--rank-data", type=int, default=0)
        group.add_argument("--ar-pack", type=str2bool, default=False,
                           help="AR stage: pack several utterances per "
                                "fixed-shape row (not ported yet, ROADMAP "
                                "A10).")
        group.add_argument("--nar-pack", type=str2bool, default=False,
                           help="NAR stage: pack several utterances per "
                                "fixed-shape bidirectional row (not ported "
                                "yet, ROADMAP A10).")
        group.add_argument("--pack-max-frames", type=int, default=1024,
                           help="Packed row audio capacity in codec frames "
                                "(1024 = 13.6 s at 75 Hz).")
        group.add_argument("--pack-max-text", type=int, default=256,
                           help="Packed row text-token capacity.")
        group.add_argument("--pack-rows", type=int, default=8,
                           help="Rows per packed batch.")

    # -- strategies -----------------------------------------------------------
    def _input_strategy(self, cuts: CutSet):
        if self.args.input_strategy == "PromptedPrecomputedFeatures":
            return PromptedPrecomputedFeatures(self.args.dataset, cuts)
        return PrecomputedFeatures()

    # -- loaders --------------------------------------------------------------
    def train_dataloaders(self, cuts_train: CutSet,
                          sampler_state_dict: Optional[dict] = None):
        logging.info("About to create train dataset")
        if (getattr(self.args, "ar_pack", False)
                or getattr(self.args, "nar_pack", False)):
            raise NotImplementedError(
                "sequence packing (--ar-pack / --nar-pack) is not ported "
                "yet (ROADMAP A10)")
        if getattr(self.args, "concatenate_cuts", False):
            logging.warning(
                "--concatenate-cuts is a no-op here: bucketed batching "
                "already bounds padding waste")
        input_transforms = []
        if self.args.enable_spec_aug:
            from .augment import SpecAugment

            logging.info("Enable SpecAugment (time warp factor "
                         f"{self.args.spec_aug_time_warp_factor})")
            input_transforms.append(SpecAugment(
                time_warp_factor=self.args.spec_aug_time_warp_factor,
                num_frame_masks=10, features_mask_size=27,
                num_feature_masks=2, frames_mask_size=100))
        if self.args.on_the_fly_feats:
            from .fbank import get_fbank_extractor
            from .input_strategies import OnTheFlyFeatures

            logging.info("Computing fbank features on the fly")
            strategy = OnTheFlyFeatures(get_fbank_extractor())
        else:
            strategy = self._input_strategy(cuts_train)
        dataset = SpeechSynthesisDataset(
            get_text_token_collater(self.args.text_tokens),
            feature_input_strategy=strategy,
            feature_transforms=input_transforms)
        if self.args.bucketing_sampler:
            sampler = DynamicBucketingSampler(
                cuts_train, max_duration=self.args.max_duration,
                num_buckets=self.args.num_buckets,
                shuffle=self.args.shuffle, drop_last=self.args.drop_last,
                quadratic_duration=10.0,
                world_size=self.args.world_size_data,
                rank=self.args.rank_data)
        else:
            sampler = SimpleCutSampler(
                cuts_train, max_duration=self.args.max_duration,
                shuffle=self.args.shuffle,
                world_size=self.args.world_size_data,
                rank=self.args.rank_data)
        if sampler_state_dict is not None:
            sampler.load_state_dict(sampler_state_dict)
        return DataLoader(dataset, sampler,
                          num_workers=self.args.num_workers)

    def valid_dataloaders(self, cuts_valid: CutSet):
        dataset = SpeechSynthesisDataset(
            get_text_token_collater(self.args.text_tokens),
            feature_input_strategy=self._input_strategy(cuts_valid))
        sampler = DynamicBucketingSampler(
            cuts_valid, max_duration=self.args.max_duration,
            num_buckets=max(2, self.args.num_buckets // 2), shuffle=False)
        return DataLoader(dataset, sampler,
                          num_workers=self.args.num_workers)

    def test_dataloaders(self, cuts_test: CutSet):
        dataset = SpeechSynthesisDataset(
            get_text_token_collater(self.args.text_tokens),
            feature_input_strategy=PrecomputedFeatures())
        sampler = SimpleCutSampler(
            cuts_test, max_duration=self.args.max_duration)
        return DataLoader(dataset, sampler, num_workers=0)

    # -- manifests (reference datamodule.py:425-440) ---------------------------
    @lru_cache
    def train_cuts(self) -> CutSet:
        logging.info("About to get train cuts")
        return CutSet.from_file(
            self.args.manifest_dir / "cuts_train.jsonl.gz")

    @lru_cache
    def dev_cuts(self) -> CutSet:
        logging.info("About to get dev cuts")
        return CutSet.from_file(self.args.manifest_dir / "cuts_dev.jsonl.gz")

    @lru_cache
    def test_cuts(self) -> CutSet:
        logging.info("About to get test cuts")
        return CutSet.from_file(
            self.args.manifest_dir / "cuts_test.jsonl.gz")
