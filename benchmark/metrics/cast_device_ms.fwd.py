"""Device milliseconds a pass of the kernels launched inside the casts
(ops/integrator.py's closest_hit / closest_hit_pair: K1(a), the keys'
sort, K1 and their glue)."""

UNIT, BETTER, KIND = "ms/pass", "lower", "per_layer"


def read(run):
    tr = run["trace"]
    if tr is None or run["kind"] != "fwd" or not tr["cast_kernels"]:
        return None
    return 1e3 * tr["cast_s"] / tr["requests"]
