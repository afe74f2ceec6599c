"""The port's span recorder (``valle_tpu_torch/utils/tracing.py``) and
the spans of its serving path, on a tiny VALL-E on the CPU: nothing
recorded while off, the span tree of one server call over three
requests, greedy codes unchanged by recording, the spans as the
profiler's user annotations, the Chrome-trace export, the bounded
buffer, and ``bin/serve.py --trace-out``."""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from valle_tpu_torch.bin import serve
from valle_tpu_torch.bin.serve import ServingWorker
from valle_tpu_torch.data.collation import TextTokenCollater
from valle_tpu_torch.data.tokenizer import AudioTokenizer, TextTokenizer
from valle_tpu_torch.models.valle import VALLE, ValleConfig
from valle_tpu_torch.serving import SynthesisRequest, Synthesizer
from valle_tpu_torch.utils import tracing

from torch_port_helpers import one_thread  # noqa: F401  (autouse)

SYMBOLS = sorted(set("abcdefghijklmnopqrstuvwxyz_"))
TINY = dict(d_model=32, nhead=2, num_layers=1, prefix_mode=1, max_len=512,
            max_prefix_len=8)
STEP_CHILDREN = ["ar.sync", "ar.sample", "ar.embed", "ar.stack", "ar.head"]


@pytest.fixture(autouse=True)
def recorder_off():
    """Each test starts and ends with an empty recorder, off."""
    tracing.enable()
    tracing.disable()
    yield
    tracing.enable()
    tracing.disable()


def _tiny_model():
    """A seeded tiny VALL-E: N(0, 1/fan-in) matrices, unit gains, zero
    biases (the module init leaves some matrices unset)."""
    torch.manual_seed(0)
    model = VALLE(ValleConfig(**TINY))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.ndim > 1:
                p.normal_(0.0, p.shape[-1] ** -0.5)
            elif name.endswith(("weight", "alpha")):
                p.fill_(1.0)
            else:
                p.zero_()
    return model.eval()


@pytest.fixture(scope="module")
def engine():
    return Synthesizer(_tiny_model(), TextTokenizer(backend="char"),
                       TextTokenCollater(SYMBOLS),
                       AudioTokenizer(device="cpu"), top_k=1,
                       compute_dtype=torch.float32, codec_dtype="float32",
                       wav_transfer="float32", device="cpu")


def _requests():
    rng = np.random.RandomState(0)
    return [SynthesisRequest(text=t, prompt_codes=rng.randint(0, 1024, (5, 8)))
            for t in ("hi", "abc", "de")]


def _serve(engine, reqs):
    """One ServingWorker call over ``reqs``: all are queued before the
    worker starts, so its first drain takes them into one engine call."""
    worker = ServingWorker(engine.synthesize, prepare_fn=engine.prepare,
                           batch_window_ms=50, max_batch=8)
    out = {}

    def submit(i, r):
        out[i] = worker.submit(r)

    threads = [threading.Thread(target=submit, args=(i, r))
               for i, r in enumerate(reqs)]
    for th in threads:
        th.start()
    deadline = time.monotonic() + 30
    while worker.inbox.qsize() < len(reqs) and time.monotonic() < deadline:
        time.sleep(0.005)
    worker.start()
    for th in threads:
        th.join(timeout=120)
    worker.stop()
    worker.join(timeout=30)
    assert not worker.is_alive() and sorted(out) == list(range(len(reqs)))
    assert all(err is None for _, err in out.values())
    return [out[i][0] for i in range(len(reqs))]


def test_off_records_nothing(engine, monkeypatch):
    """Off, a span is the shared no-op: no clock read, no profiler range,
    and a served call leaves no span and no counter."""
    def fail(*a, **k):
        raise AssertionError("called while the recorder is off")

    assert tracing.span("ar.step") is tracing.span("nar", device=torch.device("cpu"))
    monkeypatch.setattr(tracing.time, "monotonic_ns", fail)
    monkeypatch.setattr(tracing.torch.profiler, "record_function", fail)
    with tracing.span("ar.step") as s:
        s.set(rows=1)
        s.drop()
    tracing.count("ar.frames", 3)
    assert tracing.stamp() is None
    tracing.add("serve.wait", None, rid=0)
    monkeypatch.undo()
    _serve(engine, _requests())
    assert tracing.spans() == [] and tracing.counters() == {}


def _children(spans, parent):
    return [s for s in spans if s["parent"] == parent["id"]]


def test_server_call_span_tree(engine):
    tracing.enable()
    results = _serve(engine, _requests())
    tracing.disable()
    spans = tracing.spans()
    by = {}
    for s in spans:
        by.setdefault(s["name"], []).append(s)

    (drain,) = by["serve.drain"]
    assert drain["attrs"] == {"rows": 3, "queued_after": 0}
    (call,) = by["serve.call"]
    rids = call["attrs"]["rids"]
    assert sorted(rids) == [0, 1, 2] and call["parent"] is None
    for name in ("serve.prepare", "serve.wait"):
        assert sorted(s["attrs"]["rid"] for s in by[name]) == [0, 1, 2]
        assert all(s["parent"] is None for s in by[name])
    assert all(w["end"] <= call["start"] for w in by["serve.wait"])
    assert drain["end"] <= min(s["start"] for s in by["serve.prepare"])

    # the engine call's children, in order; each within its parent
    kids = _children(spans, call)
    names = [s["name"] for s in sorted(kids, key=lambda s: s["start"])]
    steps = len(by["ar.step"])
    budget = 128     # 16 x the longest text (5 tokens) + 2, to 64
    frames = [r.frames for r in results]
    assert steps == min(budget, max(frames) + 1)
    ended = steps < budget    # the check that ends the loop, outside a step
    assert names == (["synth.collate", "ar.prefill"] + ["ar.step"] * steps
                     + ["ar.sync"] * ended + ["nar", "synth.results"])
    for s in spans:
        parent = next((p for p in spans if p["id"] == s["parent"]), None)
        if parent is not None:
            assert parent["start"] <= s["start"] <= s["end"] <= parent["end"]
            assert parent["tid"] == s["tid"]
    (collate,) = by["synth.collate"]
    assert collate["attrs"] == {"rows": 3, "grid_rows": 4}
    for step in by["ar.step"]:
        assert [s["name"] for s in _children(spans, step)] == STEP_CHILDREN
    assert len(by["ar.sync"]) == steps + ended
    (res,) = by["synth.results"]
    assert res["attrs"] == {"frames": sum(frames)}
    (dec,) = by["codec.decode"]
    assert dec["parent"] == res["id"]
    assert dec["attrs"] == {"frames": 4 * budget}
    assert by["nar"][0]["device_ms"] is None          # no events on a CPU
    assert tracing.counters() == {"ar.row_steps": 4 * steps,
                                  "ar.graph_steps": 0,
                                  "ar.frames": sum(frames)}


def test_greedy_codes_equal_on_and_off(engine):
    off = engine.synthesize(_requests())
    tracing.enable()
    on = engine.synthesize(_requests())
    tracing.disable()
    assert len(tracing.spans()) > 0
    for a, b in zip(off, on):
        assert a.frames == b.frames
        np.testing.assert_array_equal(a.codes, b.codes)


def test_spans_are_profiler_annotations(engine, tmp_path, monkeypatch):
    """Under ``torch.profiler`` each span is a user annotation of the same
    name; outside a session no ``record_function`` is opened."""
    from torch.profiler import ProfilerActivity, profile

    tracing.enable()
    with monkeypatch.context() as m:
        m.setattr(tracing.torch.profiler, "record_function", None)
        engine.synthesize(_requests()[:1])        # would raise if opened
    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        engine.synthesize(_requests()[:1])
    tracing.disable()
    path = tmp_path / "prof.json"
    prof.export_chrome_trace(str(path))
    marks = [e["name"] for e in json.loads(path.read_text())["traceEvents"]
             if e.get("cat") == "user_annotation"]
    names = [s["name"] for s in tracing.spans()]
    # the check that ends the loop opened an ar.step, then dropped it
    names.append("ar.step")
    for name in set(names):
        assert marks.count(name) == names.count(name), name


def test_export_chrome_loads_and_drop_reparents(tmp_path):
    tracing.enable()
    with tracing.span("outer", rows=2):
        with tracing.span("mid") as mid:
            with tracing.span("inner"):
                pass
            mid.drop()
        tracing.add("wait", tracing.stamp(), rid=7)
    tracing.count("serve.refused.503")
    tracing.count("ar.frames", 40)
    tracing.disable()
    spans = {s["name"]: s for s in tracing.spans()}
    assert sorted(spans) == ["inner", "outer", "wait"]
    assert spans["inner"]["parent"] == spans["outer"]["id"]
    assert spans["wait"]["parent"] == spans["outer"]["id"]
    path = tmp_path / "t.json"
    tracing.export_chrome(path)
    events = json.loads(path.read_text())["traceEvents"]
    xs = {e["name"]: e for e in events if e["ph"] == "X"}
    assert sorted(xs) == ["inner", "outer", "wait"]
    assert xs["outer"]["args"]["rows"] == 2 and xs["wait"]["args"]["rid"] == 7
    assert xs["outer"]["ts"] <= xs["inner"]["ts"]
    assert xs["inner"]["ts"] + xs["inner"]["dur"] <= (
        xs["outer"]["ts"] + xs["outer"]["dur"])
    assert {e["name"]: e["args"]["value"] for e in events
            if e["ph"] == "C"} == {"serve.refused.503": 1, "ar.frames": 40}


def test_buffer_stops_at_capacity():
    tracing.enable(capacity=5)
    for i in range(8):
        with tracing.span("s", i=i):
            pass
    tracing.disable()
    assert [s["attrs"]["i"] for s in tracing.spans()] == [0, 1, 2, 3, 4]
    assert tracing.counters() == {"tracing.dropped": 3}


def test_threads_lose_no_count_and_keep_their_parents():
    """16 threads count and nest spans at once, the interpreter switching
    threads every microsecond: no count is lost, and each span's parent
    is its own thread's."""
    import sys

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    tracing.enable()
    try:
        def work():
            for _ in range(500):
                with tracing.span("outer"):
                    tracing.count("n")
                    with tracing.span("inner"):
                        tracing.count("n")

        threads = [threading.Thread(target=work) for _ in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(interval)
        tracing.disable()
    spans = tracing.spans()
    assert tracing.counters() == {"n": 16 * 1000} and len(spans) == 16000
    by_id = {s["id"]: s for s in spans}
    inner = [s for s in spans if s["name"] == "inner"]
    assert all(by_id[s["parent"]]["name"] == "outer"
               and by_id[s["parent"]]["tid"] == s["tid"] for s in inner)


def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/synthesize", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=120)


def test_serve_main_trace_out(tmp_path, monkeypatch):
    """``bin/serve.py --trace-out`` on a tiny checkpoint on the CPU: one
    answered request and one refused (413), then the server stops and the
    trace it writes loads as JSON with the server's spans and counters."""
    ckpt = tmp_path / "tiny.pt"
    torch.save({"model": _tiny_model().state_dict(), "decoder_dim": 32, "nhead": 2,
                "num_decoder_layers": 1, "prefix_mode": 1}, ckpt)
    tokens = tmp_path / "tokens.txt"
    tokens.write_text("".join(f"{s} {i}\n" for i, s in enumerate(SYMBOLS)))
    made = []
    make_server = serve.make_server
    monkeypatch.setattr(serve, "make_server",
                        lambda *a, **k: made.append(make_server(*a, **k))
                        or made[-1])
    out = tmp_path / "serve.trace.json"
    main = threading.Thread(target=serve.main, args=([
        "--checkpoint", str(ckpt), "--text-tokens", str(tokens),
        "--text-backend", "char", "--device", "cpu", "--port", "0",
        "--host", "127.0.0.1", "--decode-mode", "exact", "--top-k", "1",
        "--max-gen-len", "16", "--max-text-len", "8",
        "--codec-dtype", "float32", "--trace-out", str(out)],))
    main.start()
    deadline = time.monotonic() + 60
    while not made and time.monotonic() < deadline:
        time.sleep(0.01)
    server, _ = made[0]
    try:
        with _post(server.server_address[1], {
                "text": "hi", "prompt_codes": np.random.RandomState(0)
                .randint(0, 1024, (5, 8)).tolist(),
                "codes_only": True}) as r:
            assert r.status == 200
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(server.server_address[1], {"text": "x" * 9})
        assert ei.value.code == 413
        ei.value.close()
    finally:
        server.shutdown()
        main.join(timeout=60)
    assert not main.is_alive()
    events = json.loads(out.read_text())["traceEvents"]
    names = {e["name"] for e in events if e["ph"] == "X"}
    assert {"serve.wait", "serve.drain", "serve.prepare", "serve.call",
            "synth.collate", "ar.prefill", "ar.step", "nar",
            "synth.results", "codec.decode"} <= names
    counts = {e["name"]: e["args"]["value"] for e in events if e["ph"] == "C"}
    assert counts["serve.refused.413"] == 1 and counts["ar.frames"] > 0
