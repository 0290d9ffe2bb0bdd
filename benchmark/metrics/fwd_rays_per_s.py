"""Forward rays a second: W*H*spp*(1+2*bounces) rays a progressive pass,
times the passes of the window, over the window's wall seconds (the last
pass ends it), every pass fenced by a host copy."""

UNIT, BETTER, KIND = "rays/s", "higher", "end_to_end"


def read(run):
    if run["kind"] != "fwd" or run["trace"] is not None:
        return None
    return run["rays_per_request"] * run["requests"] / run["window_s"]
