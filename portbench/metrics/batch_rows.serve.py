"""Mean number of requests an engine call of the window served (the
``Synthesizer``'s batch before its grid padding)."""

from portbench.metrics._serve import window_calls


def read(data):
    calls = window_calls(data)
    return sum(len(c["ids"]) for c in calls) / len(calls) if calls else None
