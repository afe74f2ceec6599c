#!/usr/bin/env python3
"""Print duration statistics of cut manifests, for choosing duration
filters (the port's mirror of ``valle_tpu/bin/display_manifest_statistics
.py``; ``CutSet.describe`` of each partition). Runs on the host.
"""

import argparse
from pathlib import Path


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--manifest-dir", type=Path,
                        default=Path("data/tokenized"))
    parser.add_argument("--partitions", type=str, default="train,dev,test")
    args = parser.parse_args(argv)

    from ..data.manifests import CutSet

    for part in args.partitions.split(","):
        path = args.manifest_dir / f"cuts_{part.strip()}.jsonl.gz"
        if not path.exists():
            print(f"(missing {path})")
            continue
        cuts = CutSet.from_file(path)
        print(f"== {part} ==")
        print(cuts.describe())
        print()


if __name__ == "__main__":
    main()
