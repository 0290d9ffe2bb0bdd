"""A cell cut to a size the CPU tests can hold (the same code paths)."""


def tiny(cell):
    c = cell.config
    c["frame"].update(width=32, height=16, max_bounce=2)
    c["environment"].update(width=64, height=32)
    for o in c["objects"]:
        if o["mesh"] == "icosphere":
            o["subdiv"] = 1
    c["rays_per_tile"] = 256
    cell.traffic.update(check_pixels=64, check_passes=3, trace_requests=2)
