"""K1's (csrc/sweep.cu) share of its roofline over the traced passes:
the sum of each launch's bound (arith.span_bound on the spans its inputs
need, see trace.K1Count) over the sum of K1's device time."""

UNIT, BETTER, KIND = "%", "higher", "per_layer"


def read(run):
    tr = run["trace"]
    if (tr is None or run["kind"] != "fwd" or not tr["k1_launches"]
            or tr["k1_s"] <= 0 or tr["k1_bound_s"] <= 0):
        return None
    return 100.0 * tr["k1_bound_s"] / tr["k1_s"]
