"""Open-loop TTS serving over HTTP (traffic kind ``open_loop_http``).

The program under test is the port's HTTP server (``valle_tpu_torch.bin
.serve.make_server``: its ``ServingWorker`` drains the queue every batch
window and runs the ``Synthesizer`` on what it drained), built as
``bin/serve.py build_engine`` builds it, over a model and a codec whose
weights the benchmark makes from the seed. The load generator
(``portbench/loadgen.py``) runs in a process of its own and sends the
traffic's requests at their due times, each with a prompt wav from a
pool written under ``TMPDIR``.

The configuration states the model (``model``, whose ``model_name``
picks the AR decode entry ``models.inference.<model_name>_ar_decode``)
and the precisions it is served in (``dtype`` for the weights and the
compute, ``codec_dtype`` for the codec's decoder). The traffic's
``server`` holds the server's flags; its ``mode`` has to be "static",
the one mode this driver serves (continuous batching answers through
another engine and needs a driver of its own).

Set-up runs from the process's start to the window's start: imports,
weights, one small engine call that loads the kernels and the audio
library, and the lead-in of arrivals, which ends just after the engine
call that served its burst ends (``traffic.py``), so that every run's
window starts at the same phase of the server's cycle and queue. The
device's peak memory is counted from the window's start. In the window
every request is timed from its due time to its whole WAV answer;
arrivals go on after it until every request due in the window has been
taken into an engine call, and the run waits for their answers.

Spans and counters come from the benchmark's own wrappers around calls
into the program: the server's ``prepare`` and engine call, the AR
decode (synchronized at its end) and the codec's encode and decode. With
``--trace 1`` a ``torch.profiler`` trace covers a fixed slice of one
engine call in the window: AR steps ``start_step`` .. ``start_step +
steps`` of the first call that decodes that far over a batch of 8 rows
or more with a decode-attention kernel, started and stopped on the
engine's thread at those steps (``models.inference.ar_stop_step``).
"""

from __future__ import annotations

import base64
import contextlib
import gc
import json
import queue
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from .. import check, traffic as gen, weights
from ..roofline import DECODE_ATTN_KERNELS
from ..trace import read_trace

ROOT = Path(__file__).resolve().parents[2]
# the window's start after the end of the engine call that took the
# lead-in's burst
ANCHOR_S = 0.25


class Recorder:
    """Spans and counters of a run, recorded around calls into the
    program on the engine's thread."""

    def __init__(self, ids_by_text: Dict[str, int], keep: List[int],
                 burst: List[int]):
        self.ids_by_text = ids_by_text
        self.burst = set(burst)
        self.anchored = threading.Event()   # the burst's calls have ended
        self.anchor_end = None
        self.worker = None
        self.keep = set(keep)
        self.prepared = {}      # id(prepared request) -> (it, request id)
        self.calls: List[Dict] = []
        self.current = None     # the engine call under way
        self.encodes: List[float] = []
        self.served = {}        # kept id -> the codes served
        self.prompt_codes = {}  # kept id -> the program's prompt codes
        self.taken = set()      # request ids taken into engine calls
        self.refused = set()    # request ids answered with an error

    def watch(self, worker) -> None:
        """Note the requests that the server answers with an error
        (a full queue, a deadline) without an engine call."""
        submit = worker.submit
        self.worker = worker

        def watched(req):
            result, err = submit(req)
            if err is not None:
                self.refused.add(self.ids_by_text.get(req.text))
            return result, err

        worker.submit = watched

    def hold_for_burst(self, limit_s: float = 60.0) -> None:
        """At the end of the lead-in's first call, which serves its short
        first request: wait until the whole burst is queued, so that the
        worker's next drain takes it into one engine call (the server's
        intake of many requests at once can outlast a short call)."""
        deadline = time.monotonic() + limit_s
        while time.monotonic() < deadline:
            queued = {self.ids_by_text.get(item[0].text)
                      for item in list(self.worker.inbox.queue) if item}
            if self.burst <= queued | self.taken:
                return
            time.sleep(0.01)

    def wrap(self, engine, audio_tok, inference, ar_entry: str, tracer):
        """Install the wrappers around the codec, ``inference.<ar_entry>``
        and the stop rule; returns (synth_fn, prepare_fn)."""
        rec = self
        orig_encode, orig_decode = audio_tok.encode, audio_tok.decode
        orig_ar = getattr(inference, ar_entry)
        orig_stop = inference.ar_stop_step

        def encode(wav):
            t0 = time.monotonic()
            out = orig_encode(wav)
            rec.encodes.append(time.monotonic() - t0)
            return out

        def decode(codes, **kw):
            t0 = time.monotonic()
            out = orig_decode(codes, **kw)
            rec.current["codec_decode_s"] = time.monotonic() - t0
            return out

        def ar_decode(model, text, text_lens, prompt_q0, prompt_lens, **kw):
            ctx = dict(B=int(text.shape[0]), S=int(text.shape[1]),
                       budget=int(kw["max_gen_len"]),
                       mode=kw.get("decode_mode", "exact"),
                       x_lens=text_lens.tolist(),
                       p_lens=prompt_lens.tolist(),
                       rows=len(rec.current["ids"]))
            tracer.arm(ctx, rec.current)
            t0 = time.monotonic()
            codes, lens = orig_ar(model, text, text_lens, prompt_q0,
                                  prompt_lens, **kw)
            if text.is_cuda:
                torch.cuda.synchronize(text.device)
            ctx["ar_s"] = time.monotonic() - t0
            ctx["gen_lens"] = lens.tolist()
            ctx["steps"] = min(ctx["budget"], max(ctx["gen_lens"]) + 1)
            tracer.disarm()
            rec.current["ar"] = ctx
            return codes, lens

        def stop_step(logits, g, *a, **kw):
            tracer.step(g)
            return orig_stop(logits, g, *a, **kw)

        def prepare(req):
            rid = rec.ids_by_text[req.text]
            p = engine.prepare(req)
            rec.prepared[id(p)] = (p, rid)
            if rid in rec.keep:
                rec.prompt_codes[rid] = np.array(p.prompt_codes)
            return p

        def synth(reqs):
            ids = [rec.prepared.pop(id(p))[1] for p in reqs]
            rec.taken.update(ids)
            call = dict(start=time.monotonic(), ids=ids,
                        encode_s=sum(rec.encodes))
            rec.encodes.clear()
            rec.current = call
            results = engine.synthesize(reqs)
            if rec.burst and not rec.calls:
                rec.hold_for_burst()
            call["end"] = time.monotonic()
            call["frames"] = [r.frames for r in results]
            for rid, r in zip(ids, results):
                if rid in rec.keep:
                    rec.served[rid] = np.array(r.codes)
            rec.calls.append(call)
            if (rec.burst and not rec.anchored.is_set()
                    and rec.burst <= rec.taken):
                rec.anchor_end = call["end"]
                rec.anchored.set()
            return results

        audio_tok.encode, audio_tok.decode = encode, decode
        setattr(inference, ar_entry, ar_decode)
        inference.ar_stop_step = stop_step
        self.unwrap = lambda: (setattr(inference, ar_entry, orig_ar),
                               setattr(inference, "ar_stop_step", orig_stop))
        return synth, prepare


class Tracer:
    """A ``torch.profiler`` trace of AR steps ``start_step`` ..
    ``start_step + steps`` of the first engine call, started at or after
    ``t_from``, that decodes that far over 8 rows or more in a mode with a
    decode-attention kernel. Runs on the engine's thread."""

    def __init__(self, spec: Dict, t_from: float, on: bool):
        self.start, self.steps = spec["start_step"], spec["steps"]
        self.t_from, self.on = t_from, on
        self.state = "idle"
        self.prof = None
        self.ctx = None

    def arm(self, ctx: Dict, call: Dict) -> None:
        if not self.on or self.state != "idle":
            return
        frames = [min(16 * x + 1, ctx["budget"]) for x in ctx["x_lens"]]
        if (call["start"] >= self.t_from and ctx["B"] >= 8
                and ctx["mode"] in DECODE_ATTN_KERNELS
                and max(frames) > self.start + self.steps):
            self.state, self.ctx = "armed", ctx

    def step(self, g: int) -> None:
        if self.state == "armed" and g == self.start:
            from torch.profiler import ProfilerActivity, profile

            torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.start()
            self.state = "tracing"
        elif self.state == "tracing" and g == self.start + self.steps:
            torch.cuda.synchronize()
            self.prof.stop()
            self.state = "done"

    def disarm(self) -> None:
        if self.state == "tracing":      # the call ended inside the slice
            self.prof.stop()
            self.state, self.prof = "idle", None
        elif self.state == "armed":
            self.state = "idle"

    def reduce(self, tmp: Path):
        """The slice's ``trace.reduce_events`` with its context, or None
        when no call was traced."""
        if self.state != "done":
            return None
        path = tmp / "slice.trace.json"
        self.prof.export_chrome_trace(str(path))
        self.prof = None
        out = read_trace(path)
        out["ctx"] = dict(self.ctx, g0=self.start, n=self.steps)
        return out


@contextlib.contextmanager
def _first_trace(on: bool):
    """A process's first profiler session can lose records; a traced run
    spends it on set-up."""
    if not on:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        yield


def _build_program(cfg: Dict, srv: Dict, seed: int, device):
    """The engine as ``bin/serve.py build_engine`` builds it in static
    mode, over the seed's weights, in the configuration's precisions."""
    from valle_tpu_torch.data.collation import TextTokenCollater
    from valle_tpu_torch.data.tokenizer import AudioTokenizer, TextTokenizer
    from valle_tpu_torch.models.valle import VALLE, ValleConfig
    from valle_tpu_torch.serving import Synthesizer

    if srv["mode"] != "static":
        raise ValueError(f"server mode {srv['mode']!r}: this driver serves "
                         "the static mode alone")
    dtype = getattr(torch, cfg["dtype"])
    with torch.device(device):
        model = VALLE(ValleConfig(**cfg["model"]))
    model.load_state_dict(weights.model_state(cfg, seed, device))
    model = model.to(dtype)
    audio_tok = AudioTokenizer(device=device)
    audio_tok.codec.load_state_dict(weights.codec_state(cfg, seed, device))
    engine = Synthesizer(
        model, TextTokenizer(backend="char"),
        TextTokenCollater(cfg["symbols"]), audio_tok,
        top_k=srv["top_k"], temperature=srv["temperature"],
        max_gen_len=srv["max_gen_len"], compute_dtype=dtype,
        decode_mode=srv["decode_mode"], codec_dtype=cfg["codec_dtype"],
        nar_score_bf16=srv["nar_score_bf16"],
        wav_transfer=srv["wav_transfer"], device=device, seed=seed)
    return engine, audio_tok


def _release(worker) -> None:
    """After the worker has stopped: answer what is still queued (the
    drain's requests) with an error, so that no handler thread waits on
    it, and drop the worker's hold on the engine."""
    from valle_tpu_torch.bin.serve import ServeError

    while True:
        try:
            item = worker.inbox.get_nowait()
        except queue.Empty:
            break
        if item is not None:
            item[2]["error"] = ServeError("the run is over", 503)
            item[1].set()
    worker.synth_fn = worker.prepare_fn = None


def _quantile(values: List[float], q: float) -> float:
    """The nearest-rank quantile (``values`` may hold +inf)."""
    vs = sorted(values)
    return vs[max(0, int(np.ceil(q * len(vs))) - 1)]


def run(cell: Dict, cfg: Dict, traffic: Dict, seed: int, seconds: float,
        trace: bool, device, t_process: float, rate: float = None) -> Dict:
    """One run of the cell. Returns the end-to-end readings, the data the
    per-layer readers take, the comparison's readings and the device's
    numbers."""
    from valle_tpu_torch.bin.serve import make_server
    from valle_tpu_torch.models import inference
    from valle_tpu_torch.ops import cuda_build
    from valle_tpu_torch.serving import SynthesisRequest

    srv = traffic["server"]
    reqs = gen.schedule(traffic, seed, seconds, rate)
    keep = gen.check_sample(reqs, seed, traffic["check"]["requests"])
    window = [r for r in reqs if r["stretch"] == "window"]
    tmp = Path(tempfile.mkdtemp(prefix="portbench-"))
    loadgen = server = worker = restore = None
    try:
        sr = traffic["prompts"]["sample_rate"]
        paths = []
        for i, wav in enumerate(gen.prompt_waves(traffic, seed)):
            paths.append(tmp / f"prompt{i:03d}.wav")
            gen.write_wav(paths[-1], wav, sr)
        for r in reqs:
            r["prompt_wav"] = str(paths[r["prompt"]])
        engine, audio_tok = _build_program(cfg, srv, seed, device)
        # load the kernels and the audio library, once, before arrivals;
        # in a traced run, under a first trace that CUPTI may clip
        with _first_trace(trace):
            engine.synthesize([SynthesisRequest(text=window[0]["text"][:3],
                                                prompt_wav=str(paths[0]))])
        build_s = cuda_build.build_info["seconds"]
        lead = traffic["lead_in"]
        burst = [r["id"] for r in reqs[1: 1 + lead["burst"]]]
        rec = Recorder({r["text"]: r["id"] for r in reqs}, keep, burst)
        tracer = Tracer(traffic["trace"], float("inf"), trace)
        synth_fn, prepare_fn = rec.wrap(
            engine, audio_tok, inference,
            f"{cfg['model']['model_name']}_ar_decode", tracer)
        restore = rec.unwrap
        server, worker = make_server(
            synth_fn, prepare_fn=prepare_fn, host="127.0.0.1", port=0,
            batch_window_ms=srv["batch_window_ms"],
            max_batch=srv["max_batch"], max_queue=srv["max_queue"],
            request_timeout_s=srv["request_timeout_s"])
        rec.watch(worker)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        loadgen = subprocess.Popen(
            [sys.executable, "-m", "portbench.loadgen"], cwd=ROOT,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        t_lead = time.monotonic() + 1.0
        loadgen.stdin.write(json.dumps({
            "port": server.server_address[1], "t_lead": t_lead,
            "timeout": srv["request_timeout_s"] + 10,
            "keep": keep, "wait_for": [r["id"] for r in window],
            "requests": [{k: r[k] for k in ("id", "stretch", "due", "text",
                                            "prompt_wav")} for r in reqs]})
            + "\n")
        loadgen.stdin.flush()
        # the window starts ANCHOR_S after the engine call that took the
        # burst's last request ends: the worker has drained its queue by
        # then
        if burst:
            if not rec.anchored.wait(max(t_lead + lead["max_s"]
                                         - time.monotonic(), 0.0)):
                raise RuntimeError(
                    "the lead-in's burst was not served within "
                    f"lead_in.max_s = {lead['max_s']} s")
            t0 = rec.anchor_end + ANCHOR_S
        else:
            t0 = t_lead
        loadgen.stdin.write(f"t0 {t0!r}\n")
        loadgen.stdin.flush()
        tracer.t_from = t0
        if torch.device(device).type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        # the window closes; arrivals go on until the last request due in
        # it is taken into an engine call (or refused), which then runs
        # to its end
        want = {r["id"] for r in window}
        limit = (t0 + seconds + traffic["drain_s"]
                 + srv["request_timeout_s"])
        while (not want <= rec.taken | rec.refused
               and time.monotonic() < limit):
            time.sleep(0.05)
        worker.stop()
        loadgen.stdin.write("stop\n")
        loadgen.stdin.close()
        worker.join(srv["request_timeout_s"] + 60)
        _release(worker)
        out = json.loads(loadgen.stdout.readline() or "{}")
        loadgen.wait(30)
        peak = (torch.cuda.max_memory_allocated(device)
                if torch.device(device).type == "cuda" else 0)
        sliced = tracer.reduce(tmp) if trace else None
        server.shutdown()
        server.server_close()

        records = {r["id"]: r for r in out.get("records", [])}
        bodies = out.get("bodies", {})
        latencies, failed, wrong_frames, sample = [], 0, 0, []
        for r in window:
            got = records.get(r["id"])
            if got is None or got["status"] != 200 or got["done"] is None:
                failed += 1
                latencies.append(float("inf"))
                continue
            latencies.append(got["done"] - (t0 + r["due"]))
            if got["nbytes"] != 44 + 2 * 320 * r["frames"]:
                wrong_frames += 1
        for rid in keep:
            r = reqs[rid]
            if str(rid) not in bodies or rid not in rec.served:
                continue
            codes = rec.served[rid]
            if codes.shape[0] != r["frames"]:
                wrong_frames += 1
            sample.append(dict(
                text=r["text"], prompt_wav=r["prompt_wav"], codes=codes,
                prompt_codes=rec.prompt_codes[rid],
                wav=check.pcm16_body(base64.b64decode(bodies[str(rid)]))))
        p95 = _quantile(latencies, 0.95)
        result = {
            "end_to_end": {
                "setup_s": t0 - t_process,
                "latency_p95_s": (p95 if np.isfinite(p95)
                                  else float(srv["request_timeout_s"]))},
            "attempted": len(window), "failed": failed,
            "build_s": build_s, "memory_peak_bytes": int(peak),
            "data": dict(requests=reqs, records=records, calls=rec.calls,
                         window=(t0, t0 + seconds), trace=sliced, cfg=cfg,
                         traffic=traffic),
            "late_s": max((records[r["id"]]["sent"] - (t0 + r["due"])
                           for r in reqs if r["stretch"] != "lead_in"
                           and r["id"] in records), default=0.0),
            # each engine call from the window's start: start, end (s),
            # requests, AR steps
            "calls": [[round(c["start"] - t0, 3), round(c["end"] - t0, 3),
                       len(c["ids"]), c.get("ar", {}).get("steps")]
                      for c in rec.calls],
        }
        # the program's state goes before the reference runs
        restore()
        restore = None
        del engine, audio_tok, rec, synth_fn, prepare_fn
        server = worker = None
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        readings = check.judge(cfg, seed, sample, device)
        readings["frames"] = float(wrong_frames)
        readings["checked"] = len(sample)
        readings["expected"] = len(keep)
        result["readings"] = readings
        return result
    finally:
        if restore is not None:
            restore()
        if loadgen is not None and loadgen.poll() is None:
            loadgen.kill()
            loadgen.wait()
        if server is not None:
            server.shutdown()
            server.server_close()
        shutil.rmtree(tmp, ignore_errors=True)
