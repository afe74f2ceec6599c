"""Run one cell of the port's benchmark and print its result line.

    python3 -m portbench.run --workload valle.serve.poisson --seed 7 \\
        --seconds 51 --trace 0

The cell comes from ``BENCHMARK.json`` at the root of the checkout; its
configuration from ``portbench/configs/<config>.json`` and its traffic
mix from ``portbench/traffic/<traffic>.json``, whose ``kind`` names the
driver (``portbench/drivers/<kind>.py``). ``--trace 0`` prints the
cell's end-to-end metrics; ``--trace 1`` its per-layer metrics, each
read by ``portbench/metrics/<metric>.py``, with the device's busy time
and the trace's breakdown. The last line of standard output is one JSON
object; the comparison's numbers, each beside its limit, are the last
lines of standard error and the line's last key.

The run needs as many CUDA devices as the cell asks for and fails
without them; it fails too if JAX or the JAX package is loaded once the
window has closed.
"""

from __future__ import annotations

import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# run as a script, this folder would come first on the path and its
# modules (``trace``, ``check``) would shadow others: only the root
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != BENCH]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# modules that must not be loaded in the process that prints a result
FORBIDDEN = ("jax", "jaxlib", "flax", "valle_tpu")


def load_json(path: Path):
    return json.loads(path.read_text())


def cell_spec(name: str):
    """(benchmark, cell, configuration, traffic) by the cell's name."""
    bench = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    cell = cells[name]
    cfg = load_json(BENCH / "configs" / f"{cell['config']}.json")
    traffic = load_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    return bench, cell, cfg, traffic


def metrics_of(bench, cell, kind: str):
    """The cell's ``kind`` ("end_to_end" or "per_layer") metrics: those
    that list it, or that list no cells and move one of its end-to-end
    metrics (per-layer) or list no cells (end-to-end)."""
    e2e = [m for m in bench["end_to_end"]
           if cell["name"] in m.get("workloads", [cell["name"]])]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell["name"] in m["workloads"]] + [
        m for m in bench["per_layer"]
        if "workloads" not in m and m["moves"] in names]


def read_metric(name: str, data):
    """``portbench/metrics/<name>.py``'s ``read(data)``: a number or
    None where it finds nothing to read."""
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}",
        BENCH / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(data)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def finite(x: float) -> float:
    return x if math.isfinite(x) else 1e30


def verdict(readings, cfg, traffic):
    """(correct, checks): each number compared beside its limit, and
    whether every one is within it and everything due to be judged (the
    sampled answers, the followed steps) was."""
    limits = cfg["limits"]
    checks = {k: {"value": finite(readings[k]), "limit": limits[k]}
              for k in limits}
    want = readings["expected"]
    checks["checked"] = {"value": readings["checked"], "limit": want}
    correct = (all(checks[k]["value"] <= limits[k] for k in limits)
               and readings["checked"] == want)
    return correct, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench, cell, cfg, traffic = cell_spec(args.workload)
    import torch

    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell["chips"]:
        print(f"the cell needs {cell['chips']} CUDA device(s); found "
              f"{found}", file=sys.stderr)
        return 2
    driver = importlib.import_module(f"portbench.drivers.{traffic['kind']}")
    out = driver.run(cell, cfg, traffic, args.seed, args.seconds,
                     bool(args.trace), torch.device("cuda:0"), T_PROCESS)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in the measuring process: {bad}", file=sys.stderr)
        return 3
    print(json.dumps({"build_s": out["build_s"],
                      "setup_s": out["end_to_end"]["setup_s"],
                      "late_s": out["late_s"], "calls": out["calls"]}),
          flush=True)

    metrics = {}
    if args.trace:
        for m in metrics_of(bench, cell, "per_layer"):
            value = read_metric(m["name"], out["data"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in metrics_of(bench, cell, "end_to_end"):
            metrics[m["name"]] = {"value": out["end_to_end"][m["name"]],
                                  "unit": m["unit"]}
    correct, checks = verdict(out["readings"], cfg, traffic)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"],
              "memory_peak_bytes": out["memory_peak_bytes"],
              "power": power_limit()}
    line = {"correct": correct, "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": device}
    sliced = out["data"]["trace"]
    if args.trace:
        if sliced is None:
            print("no engine call in the window could be traced",
                  file=sys.stderr)
            return 4
        device.update(busy_s=sliced["busy_s"], window_s=sliced["window_s"])
        line["breakdown"] = {"device_ops": sliced["device_ops"],
                             "idle_gaps": sliced["idle_gaps"]}
    line["checks"] = checks
    for k, c in checks.items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    # build caches at fixed paths inside the checkout (the port's own
    # kernels build into build/valle_tpu_torch/)
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "portbench" /
                                         "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "portbench" /
                                             "extensions")
    sys.exit(main())
