"""The port's HTTP server (``valle_tpu_torch/bin/serve.py``): the wav
container byte for byte against the JAX package's, the worker's contracts
with stub engines (coalescing, group order, queue cap, deadlines, engine
errors), the admission guards, one request end to end through a tiny port
ContinuousBatcher on the CPU, and ``main`` refusing a missing card."""

import io
import json
import threading
import time
import urllib.error
import urllib.request
import wave

import numpy as np
import pytest
import torch

from valle_tpu.bin.serve import wav_bytes as jax_wav_bytes
from valle_tpu_torch.bin import serve
from valle_tpu_torch.bin.serve import ServingWorker, make_server, wav_bytes
from valle_tpu_torch.data.collation import TextTokenCollater
from valle_tpu_torch.data.tokenizer import AudioTokenizer, TextTokenizer
from valle_tpu_torch.serving import ContinuousBatcher, SynthesisRequest

from torch_port_helpers import make_pair


def test_wav_bytes_equal_jax():
    rng = np.random.RandomState(0)
    k = np.arange(-4, 5, dtype=np.float32)
    for audio in (np.sin(np.linspace(0, 100, 2400)).astype(np.float32) * 0.5,
                  rng.uniform(-1.5, 1.5, 999).astype(np.float32),
                  (k + 0.5) / 32767.0,        # halves: round half to even
                  np.zeros(0, np.float32)):
        assert wav_bytes(audio) == jax_wav_bytes(audio)
        assert wav_bytes(audio, 16000) == jax_wav_bytes(audio, 16000)
    with wave.open(io.BytesIO(wav_bytes(k / 8))) as w:
        assert (w.getframerate(), w.getnchannels(), w.getsampwidth(),
                w.getnframes()) == (24000, 1, 2, 9)


def _post(port, body, timeout=120):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/synthesize", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=timeout)


def _post_expect(port, body, code):
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(port, body)
    assert ei.value.code == code
    return ei.value


class _Served:
    """A server on a free port, driven from a thread, closed on exit."""

    def __init__(self, synth_fn, **kw):
        self.server, self.worker = make_server(synth_fn, port=0, **kw)
        self.port = self.server.server_address[1]
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.server.shutdown()
        self.worker.stop()
        self.server.server_close()


def test_worker_group_size_splits_and_reorders():
    seen = []

    def synth_fn(reqs):
        seen.append([len(r.text) for r in reqs])
        return [f"res{len(r.text)}" for r in reqs]

    worker = ServingWorker(synth_fn, batch_window_ms=300, max_batch=8,
                           group_size=2)
    worker.start()
    try:
        outs = {}

        def post(n):
            outs[n] = worker.submit(SynthesisRequest(text="x" * n))

        threads = [threading.Thread(target=post, args=(n,))
                   for n in (3, 30, 7, 18, 11)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        for n in (3, 30, 7, 18, 11):      # each caller gets its own result
            assert outs[n] == (f"res{n}", None)
        flat = [n for g in seen for n in g]
        assert sorted(flat) == [3, 7, 11, 18, 30]
        assert max(len(g) for g in seen) <= 2
        assert all(g == sorted(g, reverse=True) for g in seen)
    finally:
        worker.stop()


def test_bounded_queue_sheds_load_and_recovers():
    def slow(reqs):
        time.sleep(0.25)
        return [f"ok:{r.text}" for r in reqs]

    worker = ServingWorker(slow, batch_window_ms=50, max_batch=1,
                           max_queue=2)
    worker.start()
    try:
        results = {}

        def post(i):
            results[i] = worker.submit(SynthesisRequest(text=f"t{i}"))

        threads = [threading.Thread(target=post, args=(i,))
                   for i in range(8)]
        t0 = time.monotonic()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
        elapsed = time.monotonic() - t0
        shed = [i for i, (_, err) in results.items()
                if getattr(err, "code", 0) == 503]
        served = [i for i, (_, err) in results.items() if err is None]
        assert len(results) == 8 and shed and served
        assert all(results[i][0] == f"ok:t{i}" for i in served)
        assert elapsed < 8 * 0.25      # shed at once, not after the engine
        assert worker.submit(SynthesisRequest(text="after")) == (
            "ok:after", None)
    finally:
        worker.stop()


def test_request_deadline_504_and_queued_drop():
    calls = []

    def slow(reqs):
        calls.append([r.text for r in reqs])
        time.sleep(0.5)
        return [f"ok:{r.text}" for r in reqs]

    worker = ServingWorker(slow, batch_window_ms=10, max_batch=1,
                           request_timeout_s=0.3)
    worker.start()
    try:
        results = {}

        def post(i):
            results[i] = worker.submit(SynthesisRequest(text=f"t{i}"))

        threads = [threading.Thread(target=post, args=(i,))
                   for i in range(3)]
        for th in threads:
            th.start()
            time.sleep(0.02)
        for th in threads:
            th.join(timeout=30)
        assert all(getattr(err, "code", 0) == 504
                   for _, err in results.values()), results
        time.sleep(1.2)                # let the worker drain
        flat = [s for call in calls for s in call]
        assert "t0" in flat and len(flat) <= 2   # t2 expired while queued
    finally:
        worker.stop()


def test_http_guards_and_engine_errors():
    """400 on a malformed request, 413 on oversized text or prompt codes
    before the engine sees them, 500 with the engine's message, 404
    elsewhere, 200 on health."""
    calls = []

    def synth_fn(reqs):
        calls.append(len(reqs))
        if any(r.text == "boom" for r in reqs):
            raise RuntimeError("engine exploded")
        return ["x"] * len(reqs)

    with _Served(synth_fn, batch_window_ms=5, max_text_len=50,
                 max_prompt_frames=10, info={"mode": "stub"}) as s:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{s.port}/healthz") as r:
            assert json.loads(r.read()) == {"status": "ok", "mode": "stub"}
        assert "too large" in json.loads(
            _post_expect(s.port, {"text": "x" * 100}, 413).read())["error"]
        _post_expect(s.port, {"text": "hi", "prompt_codes": [[0] * 8] * 11},
                     413)
        _post_expect(s.port, {"nope": 1}, 400)
        _post_expect(s.port, {"text": 7}, 400)
        assert calls == []
        err = _post_expect(s.port, {"text": "boom"}, 500)
        assert "engine exploded" in json.loads(err.read())["error"]
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"http://127.0.0.1:{s.port}/nothing")
        assert ei.value.code == 404
    worker = ServingWorker(lambda reqs: 1 / 0, batch_window_ms=1)
    worker.start()
    try:
        res, err = worker.submit(object())
        assert res is None and err.code == 500 and "division" in err
    finally:
        worker.stop()


def test_worker_prepares_each_request_alone():
    """With ``prepare_fn``, each drained request is prepared alone: one it
    refuses gets its own status (``http_status``, else 500) and the
    engine runs the others, prepared, in one call."""
    calls = []

    class Refused(ValueError):
        http_status = 413

    def prepare(req):
        if req.text == "long":
            raise Refused("too many tokens")
        if req.text == "odd":
            raise KeyError("odd")
        return ("prepared", req.text)

    def synth_fn(reqs):
        calls.append(list(reqs))
        return [f"ok:{r[1]}" for r in reqs]

    # a window wide enough for the five threads to submit in it on a
    # loaded host (300 ms split the drain once beside the other workers)
    worker = ServingWorker(synth_fn, batch_window_ms=2000, max_batch=8,
                           prepare_fn=prepare)
    worker.start()
    try:
        outs = {}

        def post(text):
            outs[text] = worker.submit(SynthesisRequest(text=text))

        texts = ("a", "long", "b", "odd", "c")
        threads = [threading.Thread(target=post, args=(x,)) for x in texts]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert outs["long"][1].code == 413 and "tokens" in outs["long"][1]
        assert outs["odd"][1].code == 500
        for x in ("a", "b", "c"):
            assert outs[x] == (f"ok:{x}", None)
        assert calls == [[("prepared", x) for x in ("a", "b", "c")]]
    finally:
        worker.stop()


def test_http_end_to_end_continuous_batcher_cpu():
    """Three concurrent requests and one codes_only request through a tiny
    port ContinuousBatcher (2 slots) behind the server, on the CPU: 24 kHz
    mono wavs of frames x 320 samples, codes (frames, 8) in range. Sent
    with the three, a text longer than ``text_pad`` answers 413 and a
    prompt wav that cannot be read 400, and neither fails the others."""
    _, _, model = make_pair(d_model=32, nhead=2, num_layers=2,
                            prefix_mode=1, max_prefix_len=8)
    cb = ContinuousBatcher(model, TextTokenizer(backend="char"),
                           TextTokenCollater(sorted(set(
                               "abcdefghijklmnopqrstuvwxyz_"))),
                           AudioTokenizer(device="cpu"), slots=2,
                           text_pad=32, prompt_pad=8, max_gen_len=16,
                           chunk=4, top_k=5, compute_dtype=torch.float32,
                           device="cpu")
    calls = []

    def synth_fn(reqs):
        calls.append(len(reqs))
        return cb.run(reqs)

    with _Served(synth_fn, batch_window_ms=200, prepare_fn=cb.prepare,
                 info={"mode": "continuous"}) as s:
        outs = {}

        def post(i, body):
            try:
                with _post(s.port, body) as r:
                    outs[i] = (r.status, r.headers.get("Content-Type"),
                               r.read())
            except urllib.error.HTTPError as e:
                outs[i] = (e.code, None, e.read())

        bodies = [{"text": text, "prompt_codes": np.random.RandomState(
            i).randint(0, 1024, (5, 8)).tolist()}
            for i, text in enumerate(("hello world", "second one",
                                      "a third request"))]
        bodies += [{"text": "x" * 40},
                   {"text": "hi", "prompt_wav": "/nonexistent/p.wav"}]
        threads = [threading.Thread(target=post, args=(i, b))
                   for i, b in enumerate(bodies)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert sorted(outs) == [0, 1, 2, 3, 4] and max(calls) > 1
        assert outs[3][0] == 413 and b"text_pad" in outs[3][2]
        assert outs[4][0] == 400 and b"cannot be read" in outs[4][2]
        for status, ctype, blob in (outs[i] for i in range(3)):
            assert status == 200 and ctype == "audio/wav"
            with wave.open(io.BytesIO(blob)) as w:
                assert w.getframerate() == 24000 and w.getnchannels() == 1
                n = w.getnframes()
                assert n > 0 and n % 320 == 0
        with _post(s.port, {"text": "hello", "prompt_text": None,
                            "codes_only": True}) as r:
            body = json.loads(r.read())
        codes = np.asarray(body["codes"])
        assert codes.shape == (body["frames"], 8)
        assert 0 < body["frames"] <= 16
        assert codes.min() >= 0 and codes.max() < 1024


def test_main_refuses_a_missing_card(tmp_path):
    argv = ["--checkpoint", str(tmp_path / "m.pt"), "--text-backend", "char"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.main(argv)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.main(argv + ["--device", "cuda", "--mode", "continuous"])
    with pytest.raises(SystemExit, match="divisible by --dp 2"):
        serve.main(argv + ["--device", "cpu", "--dp", "2", "--mode",
                           "continuous", "--slots", "3"])
