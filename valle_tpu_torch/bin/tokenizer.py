#!/usr/bin/env python3
"""The offline tokenizer CLI of the port (mirror of
``valle_tpu/bin/tokenizer.py``): text to symbols, audio to EnCodec codes
or fbank features.

Per partition it reads the raw ``cuts_{partition}.jsonl.gz`` (recordings
and text, from ``bin/prepare_manifests.py``), extracts the audio
features in batches of ``--batch-duration`` seconds on ``--device``
(``--audio-extractor Encodec``: the port's EnCodec encode, codes (T, 8)
int16; ``Fbank``: the BigVGAN log-mel features (T, 100) float32 of
``data/fbank.py``), stores them in ``{encodec,fbank}_{partition}.h5``,
tokenizes every text (``--text-extractor char``: the port has only the
grapheme backend; espeak and pypinyin raise) and writes
``cuts_{partition}.jsonl.gz`` with the tokens and feature references.
``unique_text_tokens.k2symbols`` collects the symbols of every partition.
The tokens of ``char`` are made on the host, serially (JAX's
``--text-workers`` fan-out is for espeak and pypinyin, as there).

``encode_cuts`` is the extraction without the HDF5 store (it returns the
arrays), so a caller without h5py can run it.

Example:
  python -m valle_tpu_torch.bin.tokenizer --src-dir data/manifests \\
      --output-dir data/tokenized --text-extractor char \\
      --audio-extractor Encodec --encodec-weights encodec_24khz.th
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path
from typing import Callable, List

import numpy as np

from ..utils import setup_logger
from ..utils.symbol_table import SymbolTable


def get_parser():
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--src-dir", type=Path, default=Path("data/manifests"),
                        help="Dir with raw cuts_{partition}.jsonl.gz "
                             "(recordings + text, no features yet).")
    parser.add_argument("--output-dir", type=Path,
                        default=Path("data/tokenized"))
    parser.add_argument("--partitions", type=str, default="train,dev,test",
                        help="Comma-separated partition names.")
    parser.add_argument("--audio-extractor", type=str, default="Encodec",
                        help="Encodec or Fbank.")
    parser.add_argument("--text-extractor", type=str, default="espeak",
                        help="espeak | pypinyin | pypinyin_initials_finals "
                             "| char (the port has char only)")
    parser.add_argument("--language", type=str, default="en-us")
    parser.add_argument("--encodec-weights", type=str, default=None)
    parser.add_argument("--batch-duration", type=float, default=120.0,
                        help="Seconds of audio per encode batch.")
    parser.add_argument("--text-workers", type=int, default=0,
                        help="Parallel phonemizer processes; char tokens "
                             "are made serially whatever the value.")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda | cpu: where the audio is encoded.")
    return parser


def make_extractor(name: str, *, weights_path=None, device="cuda"):
    """(extractor, storage suffix): the EnCodec code extractor on
    ``device`` or the fbank extractor (computed on ``device`` in
    ``encode_cuts``)."""
    if name == "Encodec":
        from ..data.tokenizer import AudioTokenExtractor

        return AudioTokenExtractor(weights_path=weights_path,
                                   device=device), "encodec"
    if name == "Fbank":
        from ..data.fbank import get_fbank_extractor

        return get_fbank_extractor(), "fbank"
    raise ValueError(f"unknown --audio-extractor {name!r}: Encodec or Fbank")


def read_waves(cuts):
    """The cuts' recordings as mono float32 waves at the first one's rate
    (a mixed-rate batch is resampled to it, as JAX's tokenizer does);
    returns (waves, rate)."""
    from .. import native

    waves, sr = [], None
    for c in cuts:
        wav, wsr = native.read_wav(c.recording.path)
        mono = native.to_mono(wav)
        if sr is None:
            sr = wsr
        elif wsr != sr:
            mono = native.resample(mono, wsr, sr)
        waves.append(mono)
    return waves, sr


def encode_cuts(extractor, cuts, *, device="cuda") -> List[np.ndarray]:
    """One batch: the cuts' audio features, each trimmed to its
    lhotse-compatible frame count (codes (T, 8) int16, or fbank (T, 100)
    float32), computed as one batch on ``device`` (the EnCodec extractor
    already lives on its own)."""
    waves, sr = read_waves(cuts)
    from ..data.fbank import BigVGANFbank

    if isinstance(extractor, BigVGANFbank):
        return extractor.extract_batch(waves, sr, device=device)
    return extractor.extract_batch(waves, sr)


def extract_partition(extractor, cuts, write: Callable, storage_path: str,
                      batch_duration: float, *, device="cuda"):
    """Extract every cut's features in batches of ``batch_duration``
    seconds; ``write(cut_id, array)`` stores each. Returns the cuts with
    their feature references set."""
    from ..data.manifests import FeatureRef

    done, batch, dur = [], [], 0.0

    def flush():
        for c, f in zip(batch, encode_cuts(extractor, batch,
                                           device=device)):
            write(c.id, f)
            c.features = FeatureRef(str(storage_path), c.id,
                                    int(f.shape[0]), int(f.shape[1]),
                                    float(extractor.frame_shift))
            done.append(c)

    for cut in cuts:
        batch.append(cut)
        dur += cut.duration
        if dur >= batch_duration:
            flush()
            batch, dur = [], 0.0
    if batch:
        flush()
    return done


def main(argv=None):
    args = get_parser().parse_args(argv)
    setup_logger()
    from ..data.manifests import CutSet, Hdf5FeatureStore
    from ..data.tokenizer import TextTokenizer, tokenize_text

    args.output_dir.mkdir(parents=True, exist_ok=True)
    text_tokenizer = TextTokenizer(language=args.language,
                                   backend=args.text_extractor)
    extractor, suffix = make_extractor(
        args.audio_extractor, weights_path=args.encodec_weights,
        device=args.device)
    unique_symbols = set()
    for part in args.partitions.split(","):
        part = part.strip()
        src = args.src_dir / f"cuts_{part}.jsonl.gz"
        if not src.exists():
            logging.warning(f"missing {src}; skipping partition {part}")
            continue
        cuts = CutSet.from_file(src)
        logging.info(f"partition {part}: {len(cuts)} cuts")
        storage_path = args.output_dir / f"{suffix}_{part}.h5"
        with Hdf5FeatureStore(storage_path).writer() as writer:
            new_cuts = extract_partition(
                extractor, cuts, writer.write, storage_path,
                args.batch_duration, device=args.device)
        for c in new_cuts:
            assert c.text is not None, f"cut {c.id} has no text"
            c.tokens = tokenize_text(text_tokenizer, c.text)
            unique_symbols.update(c.tokens)
        out = args.output_dir / f"cuts_{part}.jsonl.gz"
        CutSet(new_cuts).to_file(out)
        logging.info(f"wrote {out}")

    table = SymbolTable()
    for s in sorted(unique_symbols):
        table.add(s)
    table.to_file(args.output_dir / "unique_text_tokens.k2symbols")
    logging.info(
        f"wrote symbol table with {len(unique_symbols)} symbols to "
        f"{args.output_dir}/unique_text_tokens.k2symbols")


if __name__ == "__main__":
    main()
