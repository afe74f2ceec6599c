"""A slice of a run traced with ``torch.profiler``, reduced to what the
metrics read: the device's busy time over the slice, the kernels by
name, the idle gaps by the host operation that ran during them.

The slice's window runs from its first event to its last. An operation
on the device is a kernel, a copy or a fill; busy time is the union of
their intervals. An idle gap is a stretch of the window in which none
ran; it is named by the innermost host operation (``cpu_op``) running
at its middle, or "no host op" where none was.
"""

from __future__ import annotations

import bisect
import json
from pathlib import Path
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def reduce_events(events: List[Dict]) -> Dict:
    """Chrome-trace events (``ts``/``dur`` in microseconds) -> seconds:
    ``window_s``, ``busy_s``, ``kernels`` (name -> [(start, dur)] in
    start order), ``device_ops`` and ``idle_gaps`` (the ten largest
    totals by name, [name, seconds])."""
    timed = [e for e in events if "ts" in e and "dur" in e
             and e.get("ph") == "X"]
    if not timed:
        return {}
    lo = min(e["ts"] for e in timed)
    hi = max(e["ts"] + e["dur"] for e in timed)
    device = [e for e in timed if e.get("cat") in DEVICE_CATS]
    busy = _union([(e["ts"], e["ts"] + e["dur"]) for e in device])
    kernels: Dict[str, List[Tuple[float, float]]] = {}
    ops: Dict[str, float] = {}
    for e in sorted(device, key=lambda e: e["ts"]):
        kernels.setdefault(e["name"], []).append((e["ts"] / 1e6,
                                                  e["dur"] / 1e6))
        ops[e["name"]] = ops.get(e["name"], 0.0) + e["dur"] / 1e6
    host = sorted((e for e in timed if e.get("cat") == "cpu_op"),
                  key=lambda e: e["ts"])
    starts = [e["ts"] for e in host]
    gaps: Dict[str, float] = {}
    edges = [lo] + [x for span in busy for x in span] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        name, width = "no host op", None
        for e in host[:bisect.bisect_right(starts, mid)][-64:]:
            if e["ts"] + e["dur"] >= mid and (width is None
                                              or e["dur"] < width):
                name, width = e["name"], e["dur"]
        gaps[name] = gaps.get(name, 0.0) + (b - a) / 1e6

    def top(d):
        return [[k, v] for k, v in sorted(d.items(),
                                          key=lambda kv: -kv[1])[:10]]

    return {"window_s": (hi - lo) / 1e6,
            "busy_s": sum(b - a for a, b in busy) / 1e6,
            "kernels": kernels, "device_ops": top(ops),
            "idle_gaps": top(gaps)}


def read_trace(path: Path) -> Dict:
    """``reduce_events`` of an exported trace, which is then deleted."""
    try:
        events = json.loads(Path(path).read_text()).get("traceEvents", [])
    finally:
        Path(path).unlink(missing_ok=True)
    return reduce_events(events)
