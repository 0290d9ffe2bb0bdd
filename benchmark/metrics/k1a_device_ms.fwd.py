"""Device milliseconds a pass of K1(a), K1's preparation kernels
(csrc/sweep_prep.cu: sweep_key, then sweep_spans or, past 8,192 clusters,
sweep_runs; not the keys' torch.sort), from the traced window's
device_ops (the ten kernels of most device time); None unless sweep_key
and one of the other two are listed, so that a kernel fallen out of the
ten never leaves a partial sum."""

import re

UNIT, BETTER, KIND = "ms/pass", "lower", "per_layer"
KEY = re.compile(r"sweep_key_kernel")
SPANS = re.compile(r"sweep_spans_kernel|sweep_runs_kernel")


def read(run):
    tr = run["trace"]
    if tr is None or run["kind"] != "fwd":
        return None
    key = [s for name, s in tr["device_ops"] if KEY.search(name)]
    spans = [s for name, s in tr["device_ops"] if SPANS.search(name)]
    if not key or not spans:
        return None
    return 1e3 * (sum(key) + sum(spans)) / tr["requests"]
