"""Gradient rays a second: the frame's ray count times the material_grad
steps of the window, over the window's wall seconds (the last step ends
it), every step fenced by a host copy of its loss and every gradient
leaf."""

UNIT, BETTER, KIND = "rays/s", "higher", "end_to_end"


def read(run):
    if run["kind"] != "grad" or run["trace"] is not None:
        return None
    return run["rays_per_request"] * run["requests"] / run["window_s"]
