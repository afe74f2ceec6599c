#!/usr/bin/env python3
"""Build raw cut manifests from standard corpus layouts (the port's
mirror of ``valle_tpu/bin/prepare_manifests.py``, the recipes' ``lhotse
prepare`` stage).

Scans the corpus directory and writes ``cuts_{train,dev,test}.jsonl.gz``
with recording references (rate and length read by the port's
``native`` audio library) and raw text, ready for
``valle_tpu_torch.bin.tokenizer``. Runs on the host; no device.

Supported layouts:
- ljspeech:  <corpus>/metadata.csv + <corpus>/wavs/*.wav
             split 12500/200/400 (reference egs/ljspeech/prepare.sh:76-90)
- libritts:  <corpus>/<part>/<speaker>/<book>/*.wav with *.normalized.txt
- aishell1:  <corpus>/wav/{train,dev,test}/S*/*.wav +
             <corpus>/transcript/aishell_transcript_v0.8.txt
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

from ..utils import setup_logger


def _wav_meta(path):
    from .. import native

    wav, sr = native.read_wav(path)
    return sr, wav.shape[0]


def prepare_ljspeech(corpus: Path, out: Path) -> None:
    from ..data.manifests import Cut, CutSet, RecordingRef

    meta = corpus / "metadata.csv"
    cuts = []
    with open(meta, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split("|")
            if len(parts) < 3:
                continue
            utt_id, _, text = parts[0], parts[1], parts[2]
            wav = corpus / "wavs" / f"{utt_id}.wav"
            if not wav.exists():
                continue
            sr, n = _wav_meta(wav)
            cuts.append(Cut(id=utt_id, duration=n / sr, text=text,
                            speaker="ljspeech",
                            recording=RecordingRef(str(wav), sr, n)))
    assert cuts, f"no utterances found under {corpus}"
    # reference split: first 12500 train, next 200 dev, last 400 test
    CutSet(cuts[:12500]).to_file(out / "cuts_train.jsonl.gz")
    CutSet(cuts[12500:12700]).to_file(out / "cuts_dev.jsonl.gz")
    CutSet(cuts[12700:13100]).to_file(out / "cuts_test.jsonl.gz")
    logging.info(f"ljspeech: {len(cuts)} cuts")


def prepare_libritts(corpus: Path, out: Path, train_parts: str) -> None:
    from ..data.manifests import Cut, CutSet, RecordingRef

    def scan(parts):
        cuts = []
        for part in parts:
            for wav in sorted((corpus / part).rglob("*.wav")):
                txt = wav.with_suffix(".normalized.txt")
                if not txt.exists():
                    txt = wav.with_suffix(".original.txt")
                if not txt.exists():
                    continue
                text = txt.read_text(encoding="utf-8").strip()
                sr, n = _wav_meta(wav)
                speaker = wav.stem.split("_")[0]
                cuts.append(Cut(id=wav.stem, duration=n / sr, text=text,
                                speaker=speaker,
                                recording=RecordingRef(str(wav), sr, n)))
        return cuts

    train = scan([p.strip() for p in train_parts.split(",")])
    dev = scan(["dev-clean"])
    test = scan(["test-clean"])
    CutSet(train).to_file(out / "cuts_train.jsonl.gz")
    CutSet(dev).to_file(out / "cuts_dev.jsonl.gz")
    CutSet(test).to_file(out / "cuts_test.jsonl.gz")
    logging.info(f"libritts: {len(train)}/{len(dev)}/{len(test)} cuts")


def prepare_aishell1(corpus: Path, out: Path) -> None:
    from ..data.manifests import Cut, CutSet, RecordingRef

    transcript = {}
    tpath = corpus / "transcript" / "aishell_transcript_v0.8.txt"
    with open(tpath, encoding="utf-8") as f:
        for line in f:
            fields = line.strip().split(maxsplit=1)
            if len(fields) == 2:
                transcript[fields[0]] = fields[1].replace(" ", "")

    for split in ("train", "dev", "test"):
        cuts = []
        for wav in sorted((corpus / "wav" / split).rglob("*.wav")):
            utt_id = wav.stem
            if utt_id not in transcript:
                continue
            sr, n = _wav_meta(wav)
            cuts.append(Cut(id=utt_id, duration=n / sr,
                            text=transcript[utt_id],
                            speaker=wav.parent.name,
                            recording=RecordingRef(str(wav), sr, n)))
        CutSet(cuts).to_file(out / f"cuts_{split}.jsonl.gz")
        logging.info(f"aishell1 {split}: {len(cuts)} cuts")


def main(argv=None):
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--dataset", type=str, required=True,
                        help="ljspeech | libritts | aishell1")
    parser.add_argument("--corpus-dir", type=Path, required=True)
    parser.add_argument("--output-dir", type=Path,
                        default=Path("data/manifests"))
    parser.add_argument("--libritts-train-parts", type=str,
                        default="train-clean-100,train-clean-360,"
                                "train-other-500")
    args = parser.parse_args(argv)
    setup_logger()
    args.output_dir.mkdir(parents=True, exist_ok=True)

    if args.dataset == "ljspeech":
        prepare_ljspeech(args.corpus_dir, args.output_dir)
    elif args.dataset == "libritts":
        prepare_libritts(args.corpus_dir, args.output_dir,
                         args.libritts_train_parts)
    elif args.dataset == "aishell1":
        prepare_aishell1(args.corpus_dir, args.output_dir)
    else:
        raise ValueError(args.dataset)


if __name__ == "__main__":
    main()
