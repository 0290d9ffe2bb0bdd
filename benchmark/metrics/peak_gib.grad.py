"""torch.cuda.max_memory_allocated over the traced gradient window, after
reset_peak_memory_stats at its start, in GiB."""

UNIT, BETTER, KIND = "GiB", "lower", "per_layer"


def read(run):
    if (run["trace"] is None or run["kind"] != "grad"
            or run["peak_bytes"] is None):
        return None
    return run["peak_bytes"] / 2**30
