"""Sequence packing: several utterances in one fixed-shape row.

A copy of ``valle_tpu/data/packing.py`` on the port's own collation,
input strategies and manifests: the same rows, segment ids and arrays
from the same cuts, seed and epoch (numpy and ``random`` only).

Duration-bucketed batches pad every utterance to the bucket's shape;
packing lays several short utterances into ONE ``[text; audio]`` row of
``max_text`` + ``max_frames`` positions with per-position segment ids, and
the model masks attention so segments never see each other. Padding
shrinks to the row tails, and every batch has the same shape.

Two model-side consumers share the sampler:
- AR stage: ``PackedSpeechDataset`` ->
  ``models.valle.valle_ar_forward_packed`` (block-diagonal mask, causal
  over audio);
- NAR stage (prefix modes 0/1): ``PackedNarSpeechDataset`` ->
  ``models.valle.valle_nar_forward_packed`` (same-segment bidirectional
  mask; one shared acoustic-prompt length per step over all packed
  segments). Prefix modes 2/4 splice prompt segments and keep the
  bucketed path.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Iterator, List

import numpy as np

from .collation import TextTokenCollater
from .input_strategies import PrecomputedFeatures
from .manifests import Cut, CutSet


def _cut_num_frames(cut: Cut, frame_shift: float) -> int:
    if cut.features is not None:
        return cut.features.num_frames
    return int(round(cut.duration / frame_shift)) + 1


@dataclass
class PackedBatch:
    cuts: List[List[Cut]]           # rows of segments
    pad_audio_to: int               # T (row audio capacity)
    pad_text_to: int                # S (row text capacity)


class SequencePackingSampler:
    """Greedy first-fit packing of shuffled cuts into fixed-shape rows.

    Yields ``PackedBatch``es of ``rows_per_batch`` rows; every batch has
    the same (rows, S, T) shape. State-dict/resume semantics match
    ``DynamicBucketingSampler`` (epoch + consumed fast-forward).
    """

    def __init__(
        self,
        cuts: CutSet,
        *,
        max_frames: int = 1024,
        max_text: int = 256,
        rows_per_batch: int = 8,
        prepend_bos: bool = False,
        shuffle: bool = True,
        drop_last: bool = False,
        frame_shift: float = 320.0 / 24000,
        seed: int = 0,
        world_size: int = 1,
        rank: int = 0,
        max_segments: int = 64,
    ) -> None:
        self.cuts = list(cuts)
        self.max_frames = max_frames
        self.max_text = max_text
        # hard cap on cuts per row: the NAR packed batch materializes a
        # (rows, max_segments) seg_frames table, so the sampler must
        # guarantee the bound AT PACKING TIME (a load-time assert would
        # only fire mid-epoch in a dataloader worker)
        self.max_segments = max_segments
        self.rows_per_batch = rows_per_batch
        self.prepend_bos = prepend_bos
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.frame_shift = frame_shift
        self.seed = seed
        self.epoch = 0
        self.world_size = world_size
        self.rank = rank
        self._consumed = 0
        self._resume_consumed = 0
        bos = int(prepend_bos)
        for c in self.cuts:
            nf = _cut_num_frames(c, frame_shift) + bos
            nt = (len(c.tokens) if c.tokens else 0) + 2
            if nf > max_frames or nt > max_text:
                raise ValueError(
                    f"cut {c.id} ({nf} frames / {nt} tokens) exceeds the "
                    f"packed row capacity ({max_frames}/{max_text}); "
                    f"filter long utterances first")

    def set_epoch(self, epoch: int) -> None:
        if epoch != self.epoch:
            self._resume_consumed = 0
            self.epoch = epoch

    def state_dict(self) -> dict:
        return {"epoch": self.epoch, "seed": self.seed,
                "consumed": self._consumed}

    def load_state_dict(self, sd: dict) -> None:
        self.epoch = sd.get("epoch", 0)
        self.seed = sd.get("seed", self.seed)
        self._resume_consumed = sd.get("consumed", 0)

    def __iter__(self) -> Iterator[PackedBatch]:
        rng = random.Random(self.seed + self.epoch)
        order = list(self.cuts)
        if self.shuffle:
            rng.shuffle(order)

        bos = int(self.prepend_bos)
        rows: List[List[Cut]] = []
        # Pool-based first-fit: keep up to ``pool`` rows open and place each
        # (shuffled) cut into the first one it fits; evict the fullest row
        # when the pool overflows. Beats single-open-row greedy fill by
        # ~20 pts of padding efficiency at LibriTTS-like durations while
        # keeping row composition random across epochs.
        pool = 32
        open_rows: List[List] = []  # [frames_used, text_used, cuts]
        for c in order:
            nf = _cut_num_frames(c, self.frame_shift) + bos
            nt = (len(c.tokens) if c.tokens else 0) + 2
            placed = False
            for slot in open_rows:
                if (slot[0] + nf <= self.max_frames
                        and slot[1] + nt <= self.max_text
                        and len(slot[2]) < self.max_segments):
                    slot[0] += nf
                    slot[1] += nt
                    slot[2].append(c)
                    placed = True
                    break
            if not placed:
                open_rows.append([nf, nt, [c]])
                if len(open_rows) > pool:
                    fullest = max(range(len(open_rows)),
                                  key=lambda i: open_rows[i][0])
                    rows.append(open_rows.pop(fullest)[2])
        rows.extend(slot[2] for slot in open_rows)

        batches: List[PackedBatch] = []
        R = self.rows_per_batch
        for i in range(0, len(rows), R):
            group = rows[i:i + R]
            if len(group) < R:
                if self.drop_last:
                    break
                group = group + [[] for _ in range(R - len(group))]
            batches.append(PackedBatch(
                cuts=group, pad_audio_to=self.max_frames,
                pad_text_to=self.max_text))
        if self.shuffle:
            rng.shuffle(batches)
        # a common per-rank count (see DynamicBucketingSampler: an uneven
        # split leaves one rank waiting in a collective on the last round)
        if self.world_size > 1:
            n = (len(batches) // self.world_size) * self.world_size
            batches = batches[:n]

        skip, self._resume_consumed = self._resume_consumed, 0
        self._consumed = 0
        for i, b in enumerate(batches):
            if i % self.world_size == self.rank:
                self._consumed += 1
                if self._consumed <= skip:
                    continue
                yield b


class PackedSpeechDataset:
    """rows of cuts -> one fixed-shape packed batch dict.

    Produces the input contract of ``models.valle.valle_ar_forward_packed``:
    per-position segment ids and PE indices for text and audio regions,
    AR input/target token rows (targets -1 at padding), per-row frame
    counts. Audio token rows hold quantizer-0 codes only (the AR stage
    reads nothing else).
    """

    def __init__(self, text_token_collater: TextTokenCollater,
                 feature_input_strategy=None, eos_id: int = 1024,
                 prepend_bos: bool = False, bos_id: int = 1025) -> None:
        self.collater = text_token_collater
        self.strategy = feature_input_strategy or PrecomputedFeatures()
        self.eos_id = eos_id
        self.prepend_bos = prepend_bos
        self.bos_id = bos_id

    def __getitem__(self, rows: List[List[Cut]], pad_audio_to: int = 0,
                    pad_text_to: int = 0) -> dict:
        B, S, T = len(rows), pad_text_to, pad_audio_to
        text = np.zeros((B, S), np.int32)
        text_seg = np.full((B, S), -1, np.int32)
        text_pos = np.zeros((B, S), np.int32)
        ar_inputs = np.zeros((B, T), np.int32)
        ar_targets = np.full((B, T), -1, np.int32)
        audio_seg = np.full((B, T), -1, np.int32)
        audio_pos = np.zeros((B, T), np.int32)
        row_frames = np.zeros((B,), np.int32)

        flat = [c for row in rows for c in row]
        for cut in flat:
            assert cut.tokens is not None, (
                f"cut {cut.id} has no text tokens; run the offline "
                f"tokenizer first")
        if flat:
            feats, f_lens = self.strategy(flat)
            feats = np.asarray(feats)
            f_lens = np.asarray(f_lens)
            tok_ids, tok_lens = self.collater.index(
                [c.tokens for c in flat])
        n = 0
        for r, row in enumerate(rows):
            s_off = t_off = 0
            for si, cut in enumerate(row):
                L = int(tok_lens[n])
                text[r, s_off:s_off + L] = tok_ids[n, :L]
                text_seg[r, s_off:s_off + L] = si
                text_pos[r, s_off:s_off + L] = np.arange(L)
                s_off += L

                Lf = int(f_lens[n])
                q0 = feats[n, :Lf, 0].astype(np.int32)
                if self.prepend_bos:
                    inputs = np.concatenate([[self.bos_id], q0])
                    targets = np.concatenate([q0, [self.eos_id]])
                else:
                    inputs = q0
                    targets = np.concatenate([q0[1:], [self.eos_id]])
                Li = len(inputs)
                ar_inputs[r, t_off:t_off + Li] = inputs
                ar_targets[r, t_off:t_off + Li] = targets
                audio_seg[r, t_off:t_off + Li] = si
                audio_pos[r, t_off:t_off + Li] = np.arange(Li)
                t_off += Li
                row_frames[r] += Lf
                n += 1

        return {
            "utt_id": [c.id for c in flat],
            "text": text,
            "text_seg": text_seg,
            "text_pos": text_pos,
            "ar_inputs": ar_inputs,
            "ar_targets": ar_targets,
            "audio_seg": audio_seg,
            "audio_pos": audio_pos,
            "row_frames": row_frames,
        }


class PackedNarSpeechDataset:
    """rows of cuts -> one fixed-shape packed NAR batch dict.

    Produces the input contract of
    ``models.valle.valle_nar_forward_packed``: per-position segment ids
    and PE indices for text and audio regions, ALL-quantizer code rows
    (the NAR stage embeds every quantizer), and per-row segment lengths
    (``seg_frames`` (B, max_segments), 0-padded) from which the model
    draws the shared acoustic-prompt prefix length.
    """

    def __init__(self, text_token_collater: TextTokenCollater,
                 feature_input_strategy=None,
                 max_segments: int = 64,
                 num_quantizers: int = 8) -> None:
        self.collater = text_token_collater
        self.strategy = feature_input_strategy or PrecomputedFeatures()
        self.max_segments = max_segments
        self.num_quantizers = num_quantizers

    def __getitem__(self, rows: List[List[Cut]], pad_audio_to: int = 0,
                    pad_text_to: int = 0) -> dict:
        B, S, T = len(rows), pad_text_to, pad_audio_to
        text = np.zeros((B, S), np.int32)
        text_seg = np.full((B, S), -1, np.int32)
        text_pos = np.zeros((B, S), np.int32)
        audio_seg = np.full((B, T), -1, np.int32)
        audio_pos = np.zeros((B, T), np.int32)
        seg_frames = np.zeros((B, self.max_segments), np.int32)
        row_frames = np.zeros((B,), np.int32)

        flat = [c for row in rows for c in row]
        for cut in flat:
            assert cut.tokens is not None, (
                f"cut {cut.id} has no text tokens; run the offline "
                f"tokenizer first")
        nar_codes = None
        if flat:
            feats, f_lens = self.strategy(flat)
            feats = np.asarray(feats)
            f_lens = np.asarray(f_lens)
            tok_ids, tok_lens = self.collater.index(
                [c.tokens for c in flat])
            Qn = feats.shape[-1]
            nar_codes = np.zeros((B, T, Qn), np.int32)
        n = 0
        for r, row in enumerate(rows):
            if len(row) > self.max_segments:
                raise ValueError(
                    f"row holds {len(row)} segments > max_segments="
                    f"{self.max_segments}")
            s_off = t_off = 0
            for si, cut in enumerate(row):
                L = int(tok_lens[n])
                text[r, s_off:s_off + L] = tok_ids[n, :L]
                text_seg[r, s_off:s_off + L] = si
                text_pos[r, s_off:s_off + L] = np.arange(L)
                s_off += L

                Lf = int(f_lens[n])
                nar_codes[r, t_off:t_off + Lf] = feats[n, :Lf].astype(
                    np.int32)
                audio_seg[r, t_off:t_off + Lf] = si
                audio_pos[r, t_off:t_off + Lf] = np.arange(Lf)
                seg_frames[r, si] = Lf
                t_off += Lf
                row_frames[r] += Lf
                n += 1
        if nar_codes is None:  # all rows empty: keep the configured width
            nar_codes = np.zeros((B, T, self.num_quantizers), np.int32)

        return {
            "utt_id": [c.id for c in flat],
            "text": text,
            "text_seg": text_seg,
            "text_pos": text_pos,
            "nar_codes": nar_codes,
            "audio_seg": audio_seg,
            "audio_pos": audio_pos,
            "seg_frames": seg_frames,
            "row_frames": row_frames,
        }
