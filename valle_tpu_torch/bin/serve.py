#!/usr/bin/env python3
"""HTTP zero-shot TTS server of the port (mirror of
``valle_tpu/bin/serve.py``): the batched ``Synthesizer`` or the
slot-recycling ``ContinuousBatcher`` behind stdlib ``http.server``.

    python3 -m valle_tpu_torch.bin.serve \\
        --checkpoint exp/valle/epoch-100.pt \\
        --text-tokens data/tokenized/unique_text_tokens.k2symbols \\
        --port 8080 --mode continuous --slots 8

    POST /synthesize  {"text": "...", "prompt_text": "...",
                       "prompt_wav": "/path/on/server.wav"}
                      -> audio/wav bytes (24 kHz mono PCM16)
       ("prompt_codes": [[...] x Q] instead of a wav; "codes_only": true
       for a JSON {codes, frames} answer)
    GET  /healthz     -> {"status": "ok", ...}

One worker thread drains the queue every --batch-window-ms, prepares each
drained request alone (tokens, prompt codes) and runs one engine call on
the prepared ones; --mode continuous serves them through the slot table.
A full queue answers 503, a request past its deadline 504, an engine
failure 500, a malformed request or an unreadable prompt 400 and an
oversized one 413 (more characters than --max-text-len, or in continuous
mode more tokens than --text-pad holds), each to its own client only.
The model runs in bf16 on --device (default cuda; the server raises when
there is no card).
"""

from __future__ import annotations

import argparse
import json
import logging
import queue
import struct
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


class ServeError(str):
    """An error message that carries its HTTP status code (a str, so
    callers of ``ServingWorker.submit`` can test and serialize it)."""

    code = 500

    def __new__(cls, msg: str, code: int = 500):
        s = super().__new__(cls, msg)
        s.code = code
        return s


def wav_bytes(audio: np.ndarray, sample_rate: int = 24000) -> bytes:
    """A RIFF/PCM16 mono container for an HTTP answer. Samples are
    rounded half to even, so pcm16-transferred samples k/32767 map back to
    k, as the native wav writer does."""
    pcm = np.round(np.clip(audio, -1.0, 1.0) * 32767.0).astype("<i2").tobytes()
    hdr = struct.pack(
        "<4sI4s4sIHHIIHH4sI", b"RIFF", 36 + len(pcm), b"WAVE", b"fmt ",
        16, 1, 1, sample_rate, sample_rate * 2, 2, 16, b"data", len(pcm))
    return hdr + pcm


class ServingWorker(threading.Thread):
    """Coalesces queued requests into batches and runs the engine.

    With ``group_size`` set, each drained batch goes through
    ``serving.plan_groups`` (longest prompt+text first, split into engine
    calls of ``group_size``), and each group's clients are answered as it
    finishes. Leave it None for an engine that schedules itself
    (continuous mode). ``max_queue`` bounds the queue (0: unbounded);
    ``request_timeout_s`` is each request's deadline (0: none), and a
    request whose client gave up is dropped before it reaches the engine.
    ``prepare_fn`` (an engine's ``prepare``), when given, runs on each
    drained request alone before the engine call; a request it refuses
    gets its own error (the exception's ``http_status``, else 500) and
    the others go on.
    """

    def __init__(self, synth_fn, *, batch_window_ms: float = 50.0,
                 max_batch: int = 32, group_size=None,
                 max_queue: int = 0, request_timeout_s: float = 0.0,
                 prepare_fn=None):
        super().__init__(daemon=True)
        self.synth_fn = synth_fn
        self.prepare_fn = prepare_fn
        self.batch_window = batch_window_ms / 1e3
        self.max_batch = max_batch
        self.group_size = group_size
        self.inbox = queue.Queue(maxsize=max_queue)
        self.request_timeout = request_timeout_s
        # not `_stop`: threading.Thread has a method of that name
        self._halt = threading.Event()

    def submit(self, req):
        """Blocking submit: returns (result, error); error is None or a
        ``ServeError`` with code 503 (queue full), 504 (deadline), 500
        (engine) or the code ``prepare_fn`` refused the request with."""
        ev = threading.Event()
        deadline = (time.monotonic() + self.request_timeout
                    if self.request_timeout else None)
        holder = {"deadline": deadline}
        try:
            self.inbox.put_nowait((req, ev, holder))
        except queue.Full:
            return None, ServeError(
                "server overloaded: request queue is full", 503)
        if not ev.wait(timeout=self.request_timeout or None):
            # still queued: the worker drops it instead of spending a
            # decode slot on a client that is gone
            holder["abandoned"] = True
            return None, ServeError(
                f"deadline exceeded ({self.request_timeout:.0f}s)", 504)
        return holder.get("result"), holder.get("error")

    def stop(self):
        self._halt.set()
        try:
            self.inbox.put_nowait(None)   # wake the worker
        except queue.Full:
            pass                          # it is draining; _halt is set

    def run(self):
        while not self._halt.is_set():
            item = self.inbox.get()
            if item is None:
                continue
            batch = [item]
            # coalesce: wait one window, then drain up to max_batch
            wait = self.batch_window
            while len(batch) < self.max_batch:
                try:
                    nxt = self.inbox.get(timeout=wait)
                except queue.Empty:
                    break
                if nxt is None:
                    break
                batch.append(nxt)
                wait = 0.005              # whatever else is in flight
            live = []
            now = time.monotonic()
            for item in batch:
                _, ev, holder = item
                dl = holder.get("deadline")
                if holder.get("abandoned") or (dl is not None and now > dl):
                    holder["error"] = ServeError("deadline exceeded", 504)
                    ev.set()
                elif self.prepare_fn is None or self._prepare(item):
                    live.append(item)
            if live:
                self._run_and_deliver(live)

    def _prepare(self, item) -> bool:
        """Prepare one request alone; answer a refused one here. Returns
        whether it goes on to the engine."""
        req, ev, holder = item
        try:
            holder["prepared"] = self.prepare_fn(req)
            return True
        except Exception as e:
            code = getattr(e, "http_status", 500)
            if code == 500:
                logging.exception("preparing a request failed")
            holder["error"] = ServeError(str(e), code)
            ev.set()
            return False

    def _run_and_deliver(self, batch):
        """Run the batch; answer each plan_groups group's clients as it
        finishes, and fail per group."""

        def deliver(items, results, err):
            for (_, ev, holder), res in zip(items, results):
                holder["result"], holder["error"] = res, err
                ev.set()

        def run_one(items):
            reqs = [holder.get("prepared", req) for req, _, holder in items]
            try:
                results = self.synth_fn(reqs)
                if len(results) != len(reqs):    # never hang a client
                    raise RuntimeError(
                        f"engine returned {len(results)} results for "
                        f"{len(reqs)} requests")
                deliver(items, results, None)
            except Exception as e:
                logging.exception("synthesis failed")
                deliver(items, [None] * len(items), ServeError(str(e)))

        if self.group_size is None:
            run_one(batch)
            return
        from ..serving import plan_groups

        for group in plan_groups([b[0] for b in batch], self.group_size):
            run_one([batch[i] for i in group])


def make_handler(worker: ServingWorker, info: dict,
                 max_text_len: int = 2048, max_prompt_frames: int = 2048):
    from ..serving import SynthesisRequest

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            logging.info("%s " + fmt, self.client_address[0], *args)

        def _reply(self, code, body: bytes, ctype: str, extra=()):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in extra:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _error(self, code, msg, extra=()):
            self._reply(code, json.dumps({"error": msg}).encode(),
                        "application/json", extra)

        def do_GET(self):
            if self.path in ("/healthz", "/"):
                self._reply(200, json.dumps(
                    {"status": "ok", **info}).encode(), "application/json")
            else:
                self._reply(404, b"{}", "application/json")

        def do_POST(self):
            if self.path != "/synthesize":
                self._reply(404, b"{}", "application/json")
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
                text = body["text"]
                if not isinstance(text, str):
                    raise TypeError("'text' must be a string")
                # a null prompt_text becomes "" (a None would fail the
                # sort key of plan_groups, and the whole drain with it)
                req = SynthesisRequest(
                    text=text,
                    prompt_text=body.get("prompt_text") or "",
                    prompt_wav=body.get("prompt_wav"),
                    prompt_codes=(np.asarray(body["prompt_codes"], np.int32)
                                  if body.get("prompt_codes") is not None
                                  else None))
            except Exception as e:
                self._error(400, f"bad request: {e}")
                return
            # the AR budget is 16x the tokenized prompt+text: an unbounded
            # text would hold a decode slot unboundedly
            n_chars = len(req.text) + len(req.prompt_text)
            n_pframes = (0 if req.prompt_codes is None
                         else int(req.prompt_codes.shape[0]))
            if n_chars > max_text_len or n_pframes > max_prompt_frames:
                self._error(413, f"request too large: {n_chars} chars (max "
                                 f"{max_text_len}), {n_pframes} prompt "
                                 f"frames (max {max_prompt_frames})")
                return
            result, err = worker.submit(req)
            if err is not None or result is None:
                code = getattr(err, "code", 500)
                self._error(code, str(err or "internal"),
                            (("Retry-After", "1"),) if code == 503 else ())
                return
            if body.get("codes_only"):
                self._reply(200, json.dumps(
                    {"frames": result.frames,
                     "codes": result.codes.tolist()}).encode(),
                    "application/json")
            else:
                self._reply(200, wav_bytes(np.asarray(result.wav)),
                            "audio/wav")

    return Handler


def make_server(synth_fn, *, host="127.0.0.1", port=0,
                batch_window_ms=50.0, max_batch=32, group_size=None,
                info=None, max_queue=0, request_timeout_s=0.0,
                max_text_len=2048, max_prompt_frames=2048, prepare_fn=None):
    """(server, worker): the worker is started; the server serves once
    ``server.serve_forever()`` is called."""
    worker = ServingWorker(synth_fn, batch_window_ms=batch_window_ms,
                           max_batch=max_batch, group_size=group_size,
                           max_queue=max_queue,
                           request_timeout_s=request_timeout_s,
                           prepare_fn=prepare_fn)
    worker.start()
    server = ThreadingHTTPServer(
        (host, port),
        make_handler(worker, info or {}, max_text_len=max_text_len,
                     max_prompt_frames=max_prompt_frames))
    return server, worker


def get_parser():
    parser = argparse.ArgumentParser(description="HTTP TTS server")
    parser.add_argument("--checkpoint", type=str, required=True,
                        help="a reference-format .pt checkpoint")
    parser.add_argument("--text-tokens", type=str, default="")
    parser.add_argument("--text-backend", type=str, default="espeak",
                        help="espeak | pypinyin | char (only char is "
                             "ported)")
    parser.add_argument("--encodec-weights", type=str, default=None)
    parser.add_argument("--host", type=str, default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8080,
                        help="0 picks a free port (logged)")
    parser.add_argument("--mode", type=str, default="static",
                        choices=("static", "continuous"),
                        help="static (Synthesizer) | continuous "
                             "(ContinuousBatcher slot recycling)")
    parser.add_argument("--decode-mode", type=str, default="auto",
                        help="static mode only; see Synthesizer")
    parser.add_argument("--slots", type=int, default=8,
                        help="continuous mode: decode slot count")
    parser.add_argument("--text-pad", type=int, default=128,
                        help="continuous mode: static text width in "
                             "tokens (413 beyond)")
    parser.add_argument("--chunk", type=int, default=64,
                        help="continuous mode: decode steps between "
                             "refills")
    parser.add_argument("--batch-window-ms", type=float, default=50.0)
    parser.add_argument("--max-batch", type=int, default=32,
                        help="max requests drained per serving cycle")
    parser.add_argument("--max-queue", type=int, default=256,
                        help="queued requests beyond this get an immediate "
                             "503 + Retry-After (0 = unbounded)")
    parser.add_argument("--request-timeout-s", type=float, default=120.0,
                        help="per-request deadline: 504 after this long in "
                             "queue + synthesis (0 = none); expired "
                             "requests still queued are dropped")
    parser.add_argument("--max-text-len", type=int, default=2048,
                        help="cap on len(text) + len(prompt_text) in "
                             "characters (413 beyond)")
    parser.add_argument("--max-prompt-frames", type=int, default=2048,
                        help="cap on prompt_codes frames (413 beyond)")
    parser.add_argument("--group-size", type=int, default=0,
                        help="static mode: split each drained cycle into "
                             "length-sorted groups of this size (0 = one "
                             "engine call per cycle)")
    parser.add_argument("--admission", type=str, default="lpt",
                        choices=["lpt", "fifo"],
                        help="continuous mode: queue admission order")
    parser.add_argument("--dp", type=int, default=0,
                        help="serving over several cards: not ported yet "
                             "(ROADMAP A12.1); 0 = one card")
    parser.add_argument("--max-gen-len", type=int, default=1024)
    parser.add_argument("--top-k", type=int, default=-100)
    parser.add_argument("--temperature", type=float, default=1.0)
    parser.add_argument("--codec-dtype", type=str, default="bfloat16")
    parser.add_argument("--nar-score-bf16", type=str, default="auto",
                        choices=("auto", "on", "off"))
    parser.add_argument("--wav-transfer", type=str, default="pcm16",
                        choices=("pcm16", "float32"))
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda | cpu")
    return parser


def build_engine(args):
    """(synth_fn, prepare_fn, info) for the parsed flags: the engine's
    serving call and its ``prepare``, over the model from
    ``models.load_model`` on ``args.device``, cast to bf16 once (the
    engines compute in bf16)."""
    import torch

    from ..data.collation import get_text_token_collater
    from ..data.tokenizer import AudioTokenizer, TextTokenizer
    from ..models import load_model
    from ..serving import ContinuousBatcher, Synthesizer

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    if args.dp:
        raise NotImplementedError(
            "--dp: serving over several cards is not ported yet (ROADMAP "
            "A12.1)")
    model, ckpt_tokens = load_model(args.checkpoint, device=device)
    model = model.to(torch.bfloat16)
    tok = TextTokenizer(backend=args.text_backend)
    collater = get_text_token_collater(args.text_tokens or ckpt_tokens)
    audio_tok = AudioTokenizer(weights_path=args.encodec_weights,
                               device=device)
    common = dict(top_k=args.top_k, temperature=args.temperature,
                  max_gen_len=args.max_gen_len, compute_dtype=torch.bfloat16,
                  codec_dtype=args.codec_dtype,
                  nar_score_bf16=args.nar_score_bf16,
                  wav_transfer=args.wav_transfer, device=device)
    if args.mode == "continuous":
        engine = ContinuousBatcher(
            model, tok, collater, audio_tok, slots=args.slots,
            text_pad=args.text_pad, chunk=args.chunk,
            admission=args.admission, **common)
        synth_fn = engine.run
    else:
        engine = Synthesizer(model, tok, collater, audio_tok,
                             decode_mode=args.decode_mode, **common)
        synth_fn = engine.synthesize
    return synth_fn, engine.prepare, {
        "mode": args.mode, "model": model.cfg.model_name,
        "device": str(device)}


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = get_parser().parse_args(argv)
    synth_fn, prepare_fn, info = build_engine(args)
    server, worker = make_server(
        synth_fn, prepare_fn=prepare_fn, host=args.host, port=args.port,
        batch_window_ms=args.batch_window_ms, max_batch=args.max_batch,
        group_size=((args.group_size or None) if args.mode != "continuous"
                    else None),
        info=info, max_queue=args.max_queue,
        request_timeout_s=args.request_timeout_s,
        max_text_len=args.max_text_len,
        max_prompt_frames=args.max_prompt_frames)
    logging.info("serving on %s:%d (%s mode)", args.host,
                 server.server_address[1], args.mode)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        worker.stop()
        server.server_close()
        # let the engine thread leave its loop before the interpreter
        # tears down the library state it may still hold
        worker.join(timeout=60)


if __name__ == "__main__":
    main()
