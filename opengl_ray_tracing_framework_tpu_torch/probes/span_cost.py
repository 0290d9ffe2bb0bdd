"""What utils/timing.py's spans and counters cost: passes of the bench
frame with tracing off and on, in turns, and one span's own cost.

    python -m opengl_ray_tracing_framework_tpu_torch.probes.span_cost \\
        [--pairs N]

The bench's frame and scene (bench.WIDTH x bench.HEIGHT, bench.BOUNCES
bounces, the 81,922-triangle `stand-in` scene, 131,072 rays a batch), one
warm pass, then N pairs of passes, one with tracing off and one with it on
(no profiler: the spans' record_function ranges, host clocks and
counters), the order alternating from pair to pair, each pass fenced by
torch.cuda.synchronize. A pass's wall time drifts by tens of percent over
tens of passes with the host's speed (PERF.md), so the cost is the median
of the pairs' ratios on / off, each pair two neighbouring passes. Beside
it, an empty span's enter and exit timed in a loop with tracing off and
on, times the spans a pass opens: the cost the spans add by themselves.

It prints one JSON line: the card, whether the tree has tracing(), each
pass's wall seconds off and on, the pairs' ratios, their median and
quartiles as cost_pct, span_ns off / on, spans_a_pass, span_cost_pct and
the counters a pass. On a tree without tracing() (a parent commit, when
this file is copied there) only the "off" passes run, so the same command
on both trees, in turns, gives the cost with tracing off.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import time

import torch

from .. import Camera, bench
from ..render import init_render_state, render_pass
from ..utils import timing
from ..utils.config import RenderConfig
from . import device_line


def span_ns(n: int = 20000) -> float:
    """Host ns of one empty span's enter and exit."""
    t0 = time.perf_counter_ns()
    for _ in range(n):
        with timing.span("rt.probe"):
            pass
    return (time.perf_counter_ns() - t0) / n


def run(pairs: int = 20, device="cuda") -> dict:
    device = torch.device(device)
    scene = bench.build_scene("stand-in", device)
    camera = Camera.make(aspect=bench.WIDTH / bench.HEIGHT, device=device)
    config = RenderConfig(width=bench.WIDTH, height=bench.HEIGHT,
                          max_bounce=bench.BOUNCES)
    state = render_pass(scene, camera, init_render_state(config, device),
                        config, 131072)
    traced = hasattr(timing, "tracing")
    seconds = {"off": [], "on": []}
    spans = counters = None
    for i in range(pairs):
        modes = ("off", "on") if i % 2 == 0 else ("on", "off")
        for mode in modes if traced else ("off",):
            window = (timing.tracing(device) if mode == "on"
                      else contextlib.nullcontext())
            with window as rec:
                torch.cuda.synchronize(device)
                t0 = time.perf_counter()
                state = render_pass(scene, camera, state, config, 131072)
                torch.cuda.synchronize(device)
                seconds[mode].append(time.perf_counter() - t0)
            if mode == "on":
                counters = rec.counters
                spans = sum(calls for calls, _, _ in rec.spans.values())
    out = {"device": device_line(), "tracing": traced, "seconds": seconds}
    if traced:
        ratios = [on / off for on, off in zip(seconds["on"], seconds["off"])]
        off_ns = span_ns()
        with timing.tracing(device):
            on_ns = span_ns()
        pass_s = statistics.median(seconds["off"])
        out.update(
            ratios=ratios,
            cost_pct=100 * (statistics.median(ratios) - 1),
            cost_quartiles_pct=[100 * (q - 1) for q in
                                statistics.quantiles(ratios, n=4)],
            span_ns={"off": off_ns, "on": on_ns}, spans_a_pass=spans,
            span_cost_pct=100 * spans * (on_ns - off_ns) * 1e-9 / pass_s,
            counters_a_pass=counters)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--pairs", type=int, default=20)
    args = p.parse_args(argv)
    print(json.dumps(run(args.pairs)), flush=True)


if __name__ == "__main__":
    main()
