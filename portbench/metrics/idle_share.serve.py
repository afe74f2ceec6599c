"""Share of the traced slice (AR decode steps of one engine call of the
window) in which no operation ran on the device."""


def read(data):
    t = data["trace"]
    if not t or not t.get("window_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
