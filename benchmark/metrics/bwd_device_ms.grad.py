"""Device milliseconds a step of the kernels the autograd engine's
backward launches (inside torch.Tensor.backward)."""

UNIT, BETTER, KIND = "ms/step", "lower", "per_layer"


def read(run):
    tr = run["trace"]
    if (tr is None or run["kind"] != "grad"
            or not tr["backward_kernels"]):
        return None
    return 1e3 * tr["backward_s"] / tr["requests"]
