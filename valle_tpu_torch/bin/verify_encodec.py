#!/usr/bin/env python3
"""Check an EnCodec 24 kHz checkpoint in the port's codec (the port's
mirror of ``valle_tpu/bin/verify_encodec.py``).

    python -m valle_tpu_torch.bin.verify_encodec --weights encodec_24khz.th

The weights are an ``encodec``-package state dict, loaded by
``codec/convert.py`` into ``data/tokenizer.py AudioTokenizer`` on
``--device``. Five checks, each printing its result:
1) the import of the state dict; 2) the encode of a deterministic fixture
waveform; 3) its codes against the pinned goldens (``--write-golden``
pins them on a first run with verified real weights; until then they are
reported); 4) the reconstruction SNR of decode(codes) against the input
(pretrained EnCodec at 6 kbps reaches >= ~3 dB on the fixture, random
weights a large negative SNR, so the check separates the two); 5) the
share of codes that encode(decode(codes)) keeps. Exit code 0 when every
check passes, else 1.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

SAMPLE_RATE = 24000
GOLDEN = Path(__file__).resolve().parent.parent.parent / (
    "tests/data/encodec_golden_codes.npz")


def fixture_wav(seconds: float = 1.5) -> np.ndarray:
    """Deterministic speech-band fixture: a gliding tone with harmonics and
    a seeded noise floor, amplitude-enveloped."""
    t = np.arange(int(seconds * SAMPLE_RATE)) / SAMPLE_RATE
    f0 = 110 * 2 ** (t / seconds)              # one octave glide
    phase = 2 * np.pi * np.cumsum(f0) / SAMPLE_RATE
    wav = (0.5 * np.sin(phase) + 0.25 * np.sin(2 * phase)
           + 0.125 * np.sin(3 * phase))
    env = 0.5 * (1 - np.cos(2 * np.pi * np.minimum(t / 0.05, 1.0)))
    rng = np.random.RandomState(1234)
    wav = wav * env + 0.003 * rng.randn(len(t))
    return (0.6 * wav / np.abs(wav).max()).astype(np.float32)


def snr_db(ref: np.ndarray, est: np.ndarray) -> float:
    n = min(len(ref), len(est))
    ref, est = ref[:n], est[:n]
    err = ref - est
    return float(10 * np.log10(
        (np.sum(ref ** 2) + 1e-12) / (np.sum(err ** 2) + 1e-12)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--weights", type=str, required=True,
                    help="Path to an encodec-package EnCodec 24 kHz state "
                         "dict (.th/.pt).")
    ap.add_argument("--golden", type=str, default=str(GOLDEN))
    ap.add_argument("--write-golden", action="store_true",
                    help="Pin this run's code indices as the golden "
                         "(once, on verified real weights).")
    ap.add_argument("--min-snr-db", type=float, default=3.0)
    ap.add_argument("--device", type=str, default="cuda", help="cuda | cpu")
    args = ap.parse_args(argv)

    from ..data.tokenizer import AudioTokenizer

    tok = AudioTokenizer(weights_path=args.weights, device=args.device)
    print(f"imported {args.weights} into the port's codec on "
          f"{tok.device}")
    wav = fixture_wav()
    codes = tok.encode(wav[None])[0]   # (F, 8)
    print(f"encoded fixture: codes shape {codes.shape}, "
          f"first frame {codes[0].tolist()}")

    ok = True
    golden = Path(args.golden)
    if args.write_golden:
        golden.parent.mkdir(parents=True, exist_ok=True)
        np.savez(golden, codes=codes.astype(np.int32))
        print(f"wrote golden -> {golden}")
    elif golden.exists():
        want = np.load(golden)["codes"]
        if want.shape != codes.shape or not np.array_equal(want, codes):
            frac = (float((want == codes).mean())
                    if want.shape == codes.shape else 0.0)
            print(f"FAIL: codes differ from golden (match {frac:.4f})")
            ok = False
        else:
            print("golden code indices: EXACT match")
    else:
        print(f"no golden at {golden} yet: run --write-golden on "
              f"verified real weights to pin these codes")

    wav_hat = tok.decode(codes[None]).reshape(-1)
    snr = snr_db(wav, wav_hat)
    print(f"reconstruction SNR {snr:.2f} dB (min {args.min_snr_db})")
    if snr < args.min_snr_db:
        print("FAIL: SNR below threshold: the weights are not a "
              "functioning EnCodec (random or corrupt import?)")
        ok = False

    codes2 = tok.encode(wav_hat[None, : len(wav)])[0]
    stable = float((codes2 == codes).mean())
    print(f"encode(decode(codes)) self-consistency: {stable:.3f} "
          f"of codes stable")

    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
