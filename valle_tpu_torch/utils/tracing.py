"""Spans and counters of the port: where a served request's time goes,
layer by layer.

    from valle_tpu_torch.utils import tracing

    tracing.enable()                      # off by default
    with tracing.span("ar.step"):
        ...
    tracing.count("ar.frames", 120)
    tracing.spans(), tracing.counters()   # snapshots
    tracing.export_chrome("serve.trace.json")

A span records its name, its start and end on ``time.monotonic_ns()``,
the thread it ran on, its parent (the innermost span open on that thread
when it opened) and its attributes. A span whose unit is a request
carries the request's id as the attribute ``rid``; the engine call's
span lists the ids it serves as ``rids``. Spans go to a buffer of
``capacity`` records: once it is full, later spans are dropped and
counted under the counter ``tracing.dropped``, so a long-lived server
does not grow without limit.

Off, the default, ``span`` tests one module flag and returns a shared
no-op object: no clock read, no allocation. On, while a
``torch.profiler`` session is active on the span's thread, the span also
opens ``torch.profiler.record_function(name)``, so that it lands in the
profiler's trace as a ``user_annotation`` on the kernels' clock; outside
a session it never does (a ``record_function`` costs ~15 us even with no
profiler). A phase span given a CUDA ``device`` also times itself with a
pair of CUDA events on that device's current stream; they are read
(``device_ms``) when the spans are, after the caller's own
synchronisation, never on the hot path.

The names are the contract with whatever reads them; ``PERF.md`` lists
them by layer.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from typing import Dict, List, Optional

import torch

_profiling = torch._C._autograd._profiler_enabled

# one record a span: [id, name, start_ns, end_ns, tid, parent id, attrs,
# device time: None, (start event, end event) or ms]
_ID, _NAME, _START, _END, _TID, _PARENT, _ATTRS, _DEV = range(8)


class _Recorder:
    """What one ``enable`` records: the spans, the counters and the ids
    of spans dropped with ``drop`` (mapped to their parents)."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.records: List[list] = []
        self.counters: Dict[str, int] = {}
        self.reparent: Dict[int, Optional[int]] = {}
        self.ids = itertools.count(1)
        self.lock = threading.Lock()
        self.local = threading.local()

    def thread(self):
        """(the calling thread's stack of open spans, its native id)."""
        try:
            return self.local.thread
        except AttributeError:
            self.local.thread = ([], threading.get_native_id())
            return self.local.thread

    def add(self, record: list) -> None:
        with self.lock:
            if len(self.records) < self.capacity:
                self.records.append(record)
            else:
                self.counters["tracing.dropped"] = (
                    self.counters.get("tracing.dropped", 0) + 1)


_on = False
_rec = _Recorder(0)


class _NoSpan:
    """The span while the recorder is off: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass

    def drop(self) -> None:
        pass


_NO_SPAN = _NoSpan()


class _Span:
    """A span while the recorder is on."""

    __slots__ = ("rec", "name", "attrs", "device", "id", "parent", "start",
                 "rf", "events", "dropped", "stack", "tid")

    def __init__(self, rec: _Recorder, name: str, attrs: dict, device):
        self.rec, self.name, self.attrs = rec, name, attrs
        self.device = device
        self.dropped = False

    def set(self, **attrs) -> None:
        """Add attributes before the span ends."""
        self.attrs.update(attrs)

    def drop(self) -> None:
        """Record no span: its children take its parent."""
        self.dropped = True

    def __enter__(self):
        self.stack, self.tid = self.rec.thread()
        stack = self.stack
        self.parent = stack[-1].id if stack else None
        self.id = next(self.rec.ids)
        stack.append(self)
        self.rf = None
        if _profiling():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.events = None
        if self.device is not None and self.device.type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(stream)
        self.start = time.monotonic_ns()
        return self

    def __exit__(self, *exc):
        end = time.monotonic_ns()
        if self.events is not None:
            self.events[1].record(torch.cuda.current_stream(self.device))
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        self.stack.pop()
        if self.dropped:
            with self.rec.lock:
                self.rec.reparent[self.id] = self.parent
        else:
            self.rec.add([self.id, self.name, self.start, end, self.tid,
                          self.parent, self.attrs or None, self.events])
        return False


def enable(capacity: int = 1 << 18) -> None:
    """Record from now on into an empty buffer of ``capacity`` spans."""
    global _on, _rec
    _rec = _Recorder(capacity)
    _on = True


def disable() -> None:
    """Stop recording; what was recorded stays readable."""
    global _on
    _on = False


def span(name: str, *, device=None, **attrs):
    """A context manager that records the time it is open as span
    ``name`` with ``attrs``; given a CUDA ``torch.device`` it also
    records the device time between its ends. Off, a shared no-op."""
    if not _on:
        return _NO_SPAN
    return _Span(_rec, name, attrs, device)


def stamp() -> Optional[int]:
    """Now on the spans' clock while recording, else None: the start of
    a span that ``add`` closes later, on any thread."""
    return time.monotonic_ns() if _on else None


def add(name: str, start_ns: Optional[int], **attrs) -> None:
    """Record span ``name`` from ``start_ns`` (a ``stamp``) to now, on
    the calling thread under its innermost open span. Nothing while off
    or for a start of None."""
    if not _on or start_ns is None:
        return
    rec = _rec
    stack, tid = rec.thread()
    rec.add([next(rec.ids), name, start_ns, time.monotonic_ns(), tid,
             stack[-1].id if stack else None, attrs or None, None])


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while recording."""
    if not _on:
        return
    rec = _rec
    with rec.lock:
        rec.counters[name] = rec.counters.get(name, 0) + n


def _device_ms(record: list) -> Optional[float]:
    """A span's device time; its events are read once, waiting for the
    end event where the device has not reached it yet."""
    dev = record[_DEV]
    if isinstance(dev, tuple):
        dev[1].synchronize()
        dev = record[_DEV] = dev[0].elapsed_time(dev[1])
    return dev


def spans() -> List[dict]:
    """A snapshot of the recorded spans in the order they ended: ``id``,
    ``name``, ``start`` and ``end`` (seconds of ``time.monotonic()``),
    ``tid`` (the native thread id), ``parent`` (a span's id or None),
    ``attrs`` and ``device_ms`` (None without events)."""
    rec = _rec
    with rec.lock:
        records = list(rec.records)
        reparent = dict(rec.reparent)
    out = []
    for r in records:
        parent = r[_PARENT]
        while parent in reparent:
            parent = reparent[parent]
        out.append({"id": r[_ID], "name": r[_NAME], "start": r[_START] / 1e9,
                    "end": r[_END] / 1e9, "tid": r[_TID], "parent": parent,
                    "attrs": dict(r[_ATTRS] or {}),
                    "device_ms": _device_ms(r)})
    return out


def counters() -> Dict[str, int]:
    """A snapshot of the counters."""
    with _rec.lock:
        return dict(_rec.counters)


def export_chrome(path) -> None:
    """Write the spans (complete events, ``ts``/``dur`` in microseconds
    of ``time.monotonic_ns()``) and the counters (one counter event each,
    at the last span's end) as Chrome-trace JSON, which Perfetto and
    ``chrome://tracing`` open."""
    pid = os.getpid()
    events = []
    last = 0.0
    for s in spans():
        args = dict(s["attrs"], id=s["id"], parent=s["parent"])
        if s["device_ms"] is not None:
            args["device_ms"] = s["device_ms"]
        events.append({"name": s["name"], "cat": "span", "ph": "X",
                       "ts": s["start"] * 1e6,
                       "dur": (s["end"] - s["start"]) * 1e6,
                       "pid": pid, "tid": s["tid"], "args": args})
        last = max(last, s["end"] * 1e6)
    for name, value in sorted(counters().items()):
        events.append({"name": name, "cat": "counter", "ph": "C",
                       "ts": last, "pid": pid, "args": {"value": value}})
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
