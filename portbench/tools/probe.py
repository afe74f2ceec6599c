"""Runs of one serving cell at given arrival rates, each in a process of
its own, with a summary of every engine call: the sweep that finds the
highest rate the server sustains (the knee), and a look inside a run.

    python3 portbench/tools/probe.py --workload valle.serve.poisson \\
        --seed 11 --seconds 30 --rates 3,5,7 --out chiprun_out/sweep

Each rate writes ``<out>/rate<r>.json``: the end-to-end readings, the
comparison's readings and, per engine call, its start and end (seconds
from the window's start), requests, padded rows, AR steps and seconds,
decode mode, prompt-encode and codec-decode seconds. A rate the server
sustains shows engine calls that keep their size and latencies that do
not grow over the window.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

T_PROCESS = time.monotonic()
ROOT = Path(__file__).resolve().parents[2]


def one(args) -> None:
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import run as bench_run

    bench, cell, cfg, traffic = bench_run.cell_spec(args.workload)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    import importlib

    driver = importlib.import_module(f"portbench.drivers.{traffic['kind']}")
    rate = float(args.rates)
    out = driver.run(cell, cfg, traffic, args.seed, args.seconds,
                     bool(args.trace), torch.device("cuda:0"), T_PROCESS,
                     rate=rate)
    data = out["data"]
    t0 = data["window"][0]
    calls = []
    for c in data["calls"]:
        ar = c.get("ar", {})
        calls.append(dict(
            start=round(c["start"] - t0, 3), end=round(c["end"] - t0, 3),
            requests=len(c["ids"]), rows=ar.get("B"),
            steps=ar.get("steps"), ar_s=round(ar.get("ar_s", 0.0), 3),
            mode=ar.get("mode"), encode_s=round(c["encode_s"], 3),
            decode_s=round(c.get("codec_decode_s", 0.0), 3)))
    lat = sorted((rec["done"] - (t0 + r["due"]))
                 for r in data["requests"] if r["stretch"] == "window"
                 for rec in [data["records"].get(r["id"])]
                 if rec and rec["status"] == 200 and rec["done"])
    summary = dict(rate=rate, seed=args.seed, seconds=args.seconds,
                   end_to_end=out["end_to_end"], readings=out["readings"],
                   attempted=out["attempted"], failed=out["failed"],
                   late_s=out["late_s"], build_s=out["build_s"],
                   memory_peak_bytes=out["memory_peak_bytes"],
                   latency_quartiles=[lat[len(lat) * q // 4]
                                      for q in range(4)] if lat else [],
                   calls=calls)
    if args.trace and data["trace"]:
        summary["trace"] = {k: data["trace"][k] for k in
                            ("window_s", "busy_s", "device_ops",
                             "idle_gaps")}
        for name in sorted((ROOT / "portbench" / "metrics").glob("*.py")):
            if not name.stem.startswith("_"):
                summary.setdefault("per_layer", {})[name.stem] = \
                    bench_run.read_metric(name.stem, data)
    path = Path(args.out) / f"rate{rate:g}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(summary, indent=1))
    print(json.dumps({k: summary[k] for k in
                      ("rate", "end_to_end", "readings", "failed",
                       "latency_quartiles", "memory_peak_bytes")}))
    print("calls (start, end, requests, rows, steps, ar_s, mode): "
          + "; ".join(
        f"{c['start']:.1f} {c['end']:.1f} {c['requests']} {c['rows']} "
        f"{c['steps']} {c['ar_s']:.2f} {c['mode']}" for c in calls))
    if "per_layer" in summary:
        print(json.dumps(summary["per_layer"]))
        print(json.dumps(summary["trace"])[:3000])
    sys.stdout.flush()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True,
                    help="comma-separated arrivals per second")
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", default="chiprun_out/probe")
    args = ap.parse_args()
    rates = args.rates.split(",")
    if len(rates) == 1:
        one(args)
        return
    for r in rates:
        cmd = [sys.executable, __file__, "--workload", args.workload,
               "--seed", str(args.seed), "--seconds", str(args.seconds),
               "--rates", r, "--trace", str(args.trace), "--out", args.out]
        subprocess.run(cmd, check=False)


if __name__ == "__main__":
    main()
