"""The open-loop load generator: a process of its own, so that its
threads never hold the server's interpreter lock.

It reads one JSON line from standard input: the server's ``port``, the
lead-in's start ``t_lead`` on the shared monotonic clock, the
``requests`` (``id``, ``stretch``, ``due``, ``text``, ``prompt_wav``),
the ids whose answers it keeps (``keep``), those it waits for
(``wait_for``) and the ``timeout`` of one request. Each request is sent
on a thread of its own at its due time, late or not: a lead-in request
at ``t_lead + due``, any other at ``t0 + due``, where ``t0``, the
window's start, comes on a later line ``t0 <seconds>``. Lead-in
requests due at or after ``t0`` are not sent. A line ``stop`` ends the
sending; then it waits for the requests of ``wait_for`` that were sent,
up to the timeout, and prints one JSON line: a record a request sent
(``id``, ``sent``, ``done``, ``status``, ``nbytes``, ``error``) and the
kept answers' bodies in base64.

    python3 -m portbench.loadgen < job.json

It imports nothing but the standard library.
"""

from __future__ import annotations

import base64
import http.client
import json
import os
import sys
import threading
import time


def _post(port, req, timeout, rec, keep, bodies):
    body = json.dumps({"text": req["text"],
                       "prompt_wav": req["prompt_wav"]}).encode()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
        conn.request("POST", "/synthesize", body,
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        rec["status"], rec["nbytes"] = resp.status, len(data)
        if resp.status == 200 and req["id"] in keep:
            bodies[str(req["id"])] = base64.b64encode(data).decode()
        elif resp.status != 200:
            rec["error"] = data[:200].decode("utf-8", "replace")
        conn.close()
    except Exception as e:      # a failed request is a miss, not a crash
        rec["status"], rec["error"] = 0, f"{type(e).__name__}: {e}"
    rec["done"] = time.monotonic()


def main() -> None:
    job = json.loads(sys.stdin.readline())
    stop, anchored = threading.Event(), threading.Event()
    anchor = {}

    def listen():
        for line in sys.stdin:
            word = line.split()
            if word and word[0] == "t0":
                anchor["t0"] = float(word[1])
                anchored.set()
            elif word and word[0] == "stop":
                break
        stop.set()
        anchored.set()

    threading.Thread(target=listen, daemon=True).start()
    keep, wait_for = set(job["keep"]), set(job["wait_for"])
    records, bodies, threads = [], {}, []

    def send(req):
        rec = {"id": req["id"], "sent": time.monotonic(), "done": None,
               "status": None, "nbytes": 0, "error": None}
        records.append(rec)
        th = threading.Thread(target=_post, daemon=True,
                              args=(job["port"], req, job["timeout"], rec,
                                    keep, bodies))
        th.start()
        if req["id"] in wait_for:
            threads.append(th)

    lead = [r for r in job["requests"] if r["stretch"] == "lead_in"]
    rest = [r for r in job["requests"] if r["stretch"] != "lead_in"]
    for req in lead:
        due = job["t_lead"] + req["due"]
        while not stop.is_set() and due > time.monotonic():
            if anchor and due >= anchor["t0"]:
                break
            stop.wait(min(due - time.monotonic(), 0.05))
        if stop.is_set() or (anchor and due >= anchor["t0"]):
            break
        send(req)
    anchored.wait()
    for req in rest:
        if stop.is_set():
            break
        due = anchor["t0"] + req["due"]
        while not stop.is_set():
            left = due - time.monotonic()
            if left <= 0:
                break
            stop.wait(min(left, 0.05))
        if not stop.is_set():
            send(req)
    stop.wait()
    end = time.monotonic() + job["timeout"]
    for th in threads:
        th.join(max(end - time.monotonic(), 0.0))
    sys.stdout.write(json.dumps({"records": records, "bodies": bodies})
                     + "\n")
    sys.stdout.flush()
    # requests of the drain still open are abandoned with the process
    os._exit(0)


if __name__ == "__main__":
    main()
