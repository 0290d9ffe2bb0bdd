"""Device milliseconds a pass of every kernel outside the casts: ray
generation, shading, environment, accumulation."""

UNIT, BETTER, KIND = "ms/pass", "lower", "per_layer"


def read(run):
    tr = run["trace"]
    if tr is None or run["kind"] != "fwd":
        return None
    return 1e3 * tr["shade_s"] / tr["requests"]
