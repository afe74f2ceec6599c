"""Median wait of a request due in the window, from its due time to the
start of the engine call that took it (host clock): the queue and the
batch window of ``bin/serve.py``'s ``ServingWorker``."""

import statistics

from portbench.metrics._serve import taken_at


def read(data):
    t0 = data["window"][0]
    start = taken_at(data)
    waits = [start[r["id"]] - (t0 + r["due"]) for r in data["requests"]
             if r["stretch"] == "window" and r["id"] in start]
    return statistics.median(waits) if waits else None
