"""Set-up seconds: from the first line of run.py to the window's start
(imports, CUDA initialisation, inputs, the port's scene build, kernel
load, one warm-up request)."""

UNIT, BETTER, KIND = "s", "lower", "end_to_end"


def read(run):
    return None if run["trace"] is not None else run["setup_s"]
