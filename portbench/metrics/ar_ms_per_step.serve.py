"""Milliseconds an AR decode step of the window's engine calls took:
the wall time of each ``valle_ar_decode`` call, synchronized at its end
(prefill included), over its steps."""

from portbench.metrics._serve import window_calls


def read(data):
    calls = [c for c in window_calls(data) if "ar" in c]
    steps = sum(c["ar"]["steps"] for c in calls)
    return 1e3 * sum(c["ar"]["ar_s"] for c in calls) / steps if steps else None
