"""Device kernels a material_grad step in the traced window, forward and
backward."""

UNIT, BETTER, KIND = "launches/step", "lower", "per_layer"


def read(run):
    tr = run["trace"]
    if tr is None or run["kind"] != "grad":
        return None
    return tr["kernels"] / tr["requests"]
