"""Device kernels a forward pass in the traced window (the benchmark's
own accounting kernels left out)."""

UNIT, BETTER, KIND = "launches/pass", "lower", "per_layer"


def read(run):
    tr = run["trace"]
    if tr is None or run["kind"] != "fwd":
        return None
    return tr["kernels"] / tr["requests"]
