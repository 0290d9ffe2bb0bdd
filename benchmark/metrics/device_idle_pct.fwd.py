"""Share of the traced forward window in which the device runs nothing:
100 * (1 - union of the device's activity intervals / window)."""

UNIT, BETTER, KIND = "%", "lower", "per_layer"


def read(run):
    tr = run["trace"]
    if tr is None or run["kind"] != "fwd":
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
