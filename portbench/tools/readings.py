"""The readings that a serving cell's limits are set from: the
program's on many seeds and the control's on some, in one process.

    python3 portbench/tools/readings.py --workload valle.serve.poisson \\
        --seeds 101-112 --control 101,102,103 --requests 96 \\
        --out chiprun_out/readings.json

For each seed the driver runs the cell's server over that seed's
weights and sends ``--requests`` requests of the seed's window at once,
with no lead-in, so that one engine call serves as many rows as a call
of the cell does (the longest request among them), and the comparison
judges the cell's sample of them. For the seeds of ``--control`` it
also reads the control, the reference one precision lower in the
program's place.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def seeds_of(text: str):
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", default="")
    ap.add_argument("--requests", type=int, default=96)
    ap.add_argument("--out", default="chiprun_out/readings.json")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import importlib

    import torch

    from portbench import check
    from portbench import run as bench_run

    bench, cell, cfg, traffic = bench_run.cell_spec(args.workload)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    driver = importlib.import_module(f"portbench.drivers.{traffic['kind']}")
    controls = set(seeds_of(args.control)) if args.control else set()
    once = dict(traffic, lead_in=dict(burst=0, burst_at_s=0.0, max_s=0.0),
                drain_s=0.0)
    orig = check.judge
    rows = []
    for seed in seeds_of(args.seeds):
        check.judge = (lambda *a, _o=orig, _c=seed in controls, **kw:
                       _o(*a, **dict(kw, control=_c)))
        t = time.monotonic()
        out = driver.run(cell, cfg, once, seed, 0.1, False,
                         torch.device("cuda:0"), t,
                         rate=args.requests / 0.1)
        row = dict(seed=seed, seconds=time.monotonic() - t,
                   calls=[(len(c["ids"]), c["ar"]["mode"], c["ar"]["steps"])
                          for c in out["data"]["calls"]],
                   **out["readings"])
        rows.append(row)
        print(json.dumps(row), flush=True)
    check.judge = orig
    names = check.NUMBERS
    summary = {n: max(r[n] for r in rows) for n in names}
    summary.update({"control_" + n: min(r["control_" + n] for r in rows
                                        if "control_" + n in r)
                    for n in names if any("control_" + n in r
                                          for r in rows)})
    print(json.dumps({"lower (largest program reading)": {
        n: summary[n] for n in names}, "upper (smallest control)": {
        k: v for k, v in summary.items() if k not in names}}), flush=True)
    path = Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({"rows": rows, "summary": summary}, indent=1))


if __name__ == "__main__":
    main()
