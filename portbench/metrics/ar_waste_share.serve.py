"""Share of the AR row-steps of the window's engine calls that produced
no answered frame: rows added to snap the batch to its grid, and rows
that decode on after their own length while the longest runs on.
Counted from the frames answered and each call's rows and steps."""

from portbench.metrics._serve import window_calls


def read(data):
    calls = [c for c in window_calls(data) if "ar" in c]
    done = sum(sum(c["frames"]) for c in calls)
    run = sum(c["ar"]["B"] * c["ar"]["steps"] for c in calls)
    return 100.0 * (1.0 - done / run) if run else None
