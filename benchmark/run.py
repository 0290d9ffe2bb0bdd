"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (timed from this file's first line to the window's start): the
raw inputs of the cell's configuration, the port's scene built through
its Scene API, the kernels loaded (built into build/torch_kernels/ in the
checkout by the first run there), the seed's draws, and one warm-up
request of the cell's own shapes. The window: the cell's traffic for
--seconds, closed loop (with --trace 1 under the profiler, for the
traffic's trace_requests requests). Then the port's state is freed and
its outputs are held against the plain reference (the `numbers` of the
traffic's kind of request, traffic/<entry>.py); the
compared numbers print on stderr, each beside its limit, and last on
stdout one JSON line: correct, attempted, failed, metrics (the cell's
end-to-end metrics, or with --trace 1 its per-layer ones), device, with
--trace 1 a breakdown, and the compared numbers under "check".

Without a CUDA card, or with fewer than the cell asks for, it exits with
code 2 and prints no result: it never falls back to the CPU.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if __name__ == "__main__":   # the checkout's root, not this folder
    sys.path[0] = str(Path(__file__).resolve().parents[1])

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import cell as cells, inputs, program, trace  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "opengl_ray_tracing_framework_tpu")


def loaded_forbidden() -> list:
    """Modules in this process whose top-level name, compared whole, is
    JAX's, jaxlib's, flax's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


@dataclasses.dataclass
class Setup:
    """A cell's raw inputs (the reference's side) and the port's scene,
    camera and settings built from them (the program's side)."""

    cell: object
    device: torch.device
    raw: object
    cam: dict
    scene: object
    camera: object
    rconf: object

    def free_program(self):
        """Drop the port's state, so the reference runs on a card that
        holds nothing of it."""
        self.scene = self.camera = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def set_up(cell, device) -> Setup:
    config = cell.config
    raw = inputs.make_raw(config)
    cam = inputs.camera(config)
    return Setup(cell, device, raw, cam,
                 scene=program.build_scene(raw, config, device),
                 camera=program.camera(cam, device),
                 rconf=program.render_config(config))


@contextlib.contextmanager
def steady_host():
    """The window's host thread kept on one core (the card's own threads
    stay free), with the collector off. The host launches every kernel;
    in runs of the same work taken in turns, a request took 4-13% less of
    the thread's CPU time so (PERF.md, Findings)."""
    cpus = sorted(os.sched_getaffinity(0))
    gc.collect()
    gc.freeze()
    gc.disable()
    os.sched_setaffinity(0, {cpus[2] if len(cpus) > 2 else cpus[0]})
    try:
        yield
    finally:
        os.sched_setaffinity(0, cpus)
        gc.enable()
        gc.unfreeze()


def run_window(requests, seconds: float, max_requests: int | None = None,
               capture=None) -> tuple[list, float]:
    """Requests back to back, closed loop, until `seconds` have passed (or
    max_requests are done); the window ends with the last request.
    Returns (each request's seconds, window seconds)."""
    times = []
    t0 = last = time.perf_counter()
    while True:
        if capture is not None:
            with capture.request():
                requests.request()
        else:
            requests.request()
        now = time.perf_counter()
        times.append(now - last)
        last = now
        if now - t0 >= seconds or (max_requests and len(times) >= max_requests):
            return times, now - t0


def execute(cell, seed: int, seconds: float, traced: bool, device,
            t0: float) -> dict:
    """Set up, run the window, check. Returns everything the line needs."""
    setup = set_up(cell, device)
    entry = cell.entry
    draws = entry.draw(cell.traffic, cell.config, seed, device)
    requests = entry.Requests(setup, draws)
    requests.warm_up()
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t0

    capture = trace.Capture() if traced else None
    with steady_host():
        if capture is not None:
            with capture:
                times, window_s = run_window(
                    requests, seconds, cell.traffic["trace_requests"],
                    capture)
        else:
            times, window_s = run_window(requests, seconds)
    n = len(times)
    print(f"window: {n} requests in {window_s:.4f} s, each "
          f"{' '.join(f'{t:.4f}' for t in times)} s", file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    outputs = requests.outputs()
    run = {"kind": entry.KIND, "requests": n, "window_s": window_s,
           "rays_per_request": requests.rays_per_request,
           "setup_s": setup_s, "peak_bytes": peak,
           "trace": capture.reduce(n) if capture is not None else None}
    del requests, capture
    setup.free_program()
    found = entry.numbers(setup, draws, outputs, seed)
    return {"run": run, "found": found,
            "memory_peak_bytes": None if peak is None
            else max(peak, setup_peak)}


def readings(cell, seconds: float, seeds, controls, device):
    """The readings a cell's limits are set from, the scene built once (a
    seed changes the draws, never the scene): for each seed of `seeds`
    the compared numbers of the program's window; for each of `controls`
    those of the reference in bfloat16 put in the program's place on the
    same window's draws. Yields one dict a reading."""
    setup = set_up(cell, device)
    entry = cell.entry
    warm = False
    for seed in dict.fromkeys(list(seeds) + list(controls)):
        draws = entry.draw(cell.traffic, cell.config, seed, device)
        requests = entry.Requests(setup, draws)
        if not warm:
            requests.warm_up()
            warm = True
        with steady_host():
            times, window_s = run_window(requests, seconds)
        outputs = requests.outputs()
        del requests
        for control in (False, True):
            if seed not in (controls if control else seeds):
                continue
            t0 = time.perf_counter()
            got = entry.control(setup, draws, outputs) if control else outputs
            yield {"workload": cell.name, "seed": seed, "control": control,
                   "requests": len(times), "window_s": window_s,
                   "found": entry.numbers(setup, draws, got, seed),
                   "check_s": time.perf_counter() - t0}
        if device.type == "cuda":
            torch.cuda.empty_cache()


def verdict(found: dict, limits: dict) -> bool:
    return all(np.isfinite(found[k]) and found[k] <= limits[k]
               for k in limits)


def result_line(cell, out: dict, traced: bool, device) -> dict:
    limits = cell.workload["limits"]
    found = out["found"]
    kind = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in cells.metrics():
        if m.kind != kind:
            continue
        value = m.read(out["run"])
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.unit}
    cuda = device.type == "cuda"
    line = {
        "correct": verdict(found, limits),
        "attempted": out["run"]["requests"],
        "failed": 0,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else device.type,
            "kind": (torch.cuda.get_device_name(device) if cuda
                     else device.type),
            "count": 1,
            "memory_peak_bytes": out["memory_peak_bytes"],
        },
    }
    tr = out["run"]["trace"]
    if tr is not None:
        line["device"]["busy_s"] = tr["busy_s"]
        line["device"]["window_s"] = tr["window_s"]
        line["breakdown"] = {"device_ops": tr["device_ops"],
                             "idle_gaps": tr["idle_gaps"]}
    line["check"] = {k: {"value": found[k] if math.isfinite(found[k])
                         else None, "limit": limits[k]} for k in limits}
    return line


def main(argv=None, device=None, overrides=None) -> int:
    """The command. `device` and `overrides` (a function that edits the
    loaded cell) exist for the CPU tests alone; the command line always
    asks for the card."""
    args = parse(argv)
    cell = cells.load(args.workload)
    if overrides is not None:
        overrides(cell)
    if device is None:
        chips = int(cell.workload["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"benchmark: {args.workload} needs {chips} CUDA card(s); "
                  f"this machine has "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    device = torch.device(device)
    torch.set_num_threads(1)   # one host thread: the load of one process
    out = execute(cell, args.seed, args.seconds, bool(args.trace), device,
                  T0)
    found = loaded_forbidden()
    if found:
        print(f"benchmark: the run loaded {found}", file=sys.stderr)
        return 3
    line = result_line(cell, out, bool(args.trace), device)
    for k, v in line["check"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
