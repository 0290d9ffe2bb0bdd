"""The port's own spans and counters in a traced run: a reduction of the
profiler's events by the innermost rt.* range (utils/timing.py of the
port names them), and a traced run with them on.

    python3 benchmark/spans.py --workload <cell> --seed <n> --seconds <s>

runs the cell as `run.py --trace 1` does, with the port's tracing() on for
the traced window (it allocates its counter buffer before the profiler
starts and reads it after the profiler stops), prints run.py's result line
and then one more JSON line, {"spans": ...}: what reduce_spans gives. On a
port without utils/timing.py's tracing() (before the spans existed) the
second line's "spans" is null.

reduce_spans (numbers a request; a request is one pass or one grad step):
  host_by_span      {span: [host ms, self ms]}: the span's duration, and
                    that less its rt.* children's, both less the
                    benchmark's own accounting (bm.account) inside it
  launches_by_span  {span: kernels}: device kernels by the innermost rt.*
                    range open at their launch ("none" outside every one)
  idle_by_span      {span: idle s over the window}: each gap between the
                    device's busy runs, from the first request's start to
                    the last one's end, by the innermost rt.* range open
                    on the host at its midpoint (trace.py's rule)
  idle_in_requests_s, idle_explained_share: the idle whose midpoint lies
                    inside a bm.request range, and the share of it under
                    an rt.* range other than rt.pass and rt.batch
  counters          the port's counters over the window (tracing()'s)
  readings          what the layer numbers come to: cast_host_ms.fwd,
                    shade_host_ms.fwd, sync_wait_ms.fwd, cast_live_pct.fwd,
                    k1_walk_excess.fwd (fwd) or bwd_host_ms.grad (grad)
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

if __name__ == "__main__":   # the checkout's root, not this folder
    sys.path[0] = str(Path(__file__).resolve().parents[1])

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import arith, cell as cells, program, run, trace  # noqa: E402

PREFIX = "rt."
WRAPPERS = ("rt.pass", "rt.batch")   # spans that wrap a layer, not one


def _sorted(pairs):
    s = np.asarray([p[0] for p in pairs], np.float64)
    e = np.asarray([p[1] for p in pairs], np.float64)
    order = np.argsort(s, kind="stable")
    return s[order], e[order]


def _covered_before(starts, ends, t):
    """For times t, how much of the disjoint sorted intervals lies before
    each."""
    if len(starts) == 0:
        return np.zeros(len(t))
    lens = ends - starts
    cum = np.concatenate([[0.0], np.cumsum(lens)])
    k = np.searchsorted(starts, t, side="right")
    last = np.clip(k - 1, 0, None)
    part = np.where(k > 0, np.clip(t - starts[last], 0, lens[last]), 0.0)
    return cum[last] + part


def _innermost(spans: dict, t: np.ndarray) -> np.ndarray:
    """For host times t, the name of the innermost rt.* range open at each
    ("none" where none is). A name's ranges never overlap one another, and
    the innermost of the nested ranges open at t is the one that started
    last."""
    out = np.full(len(t), "none", dtype=object)
    best = np.full(len(t), -np.inf)
    for name, (starts, ends) in spans.items():
        k = np.searchsorted(starts, t, side="right") - 1
        kk = np.clip(k, 0, None)
        inside = (k >= 0) & (t < ends[kk])
        later = inside & (starts[kk] > best)
        out = np.where(later, name, out)
        best = np.where(later, starts[kk], best)
    return out


def reduce_spans(events, n_requests: int, counters: dict,
                 k1: trace.K1Count | None, kind: str) -> dict | None:
    """The window's numbers by the port's spans (see the module's
    docstring), or None where the events hold no rt.* range."""
    cuda = torch.autograd.DeviceType.CUDA
    spans: dict = {}
    bm = {"bm.account": [], "bm.request": []}
    launch_at = {}
    dev = []   # (start, end, name, correlation id)
    for e in events:
        name = e.name()
        if e.device_type() == cuda:
            if not (name.startswith(("bm.", PREFIX))
                    or e.is_user_annotation()):
                dev.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                            name, e.correlation_id()))
        elif name.startswith(PREFIX):
            spans.setdefault(name, []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
        elif name in bm:
            bm[name].append((e.start_ns(), e.start_ns() + e.duration_ns()))
        elif name.startswith("cu"):
            launch_at[e.correlation_id()] = e.start_ns()
    if not spans:
        return None
    spans = {name: _sorted(v) for name, v in spans.items()}
    acc_s, acc_e = _sorted(bm["bm.account"])
    req_s, req_e = _sorted(bm["bm.request"])

    # host time: each range's duration less the accounting inside it; self
    # time less its children's, a child's parent being the innermost other
    # range open at its start
    flat = sorted(((s, e, name) for name, (ss, ee) in spans.items()
                   for s, e in zip(ss, ee)), key=lambda x: (x[0], -x[1]))
    ends = np.array([x[1] for x in flat])
    starts = np.array([x[0] for x in flat])
    totals = (ends - starts) - (_covered_before(acc_s, acc_e, ends)
                                - _covered_before(acc_s, acc_e, starts))
    host = {name: [0.0, 0.0] for name in spans}
    stack = []   # [end, name, own time so far]
    for (s, e, name), total in zip(flat, totals.tolist()):
        while stack and stack[-1][0] <= s:
            end, parent, own = stack.pop()
            host[parent][1] += own
        if stack:
            stack[-1][2] -= total
        host[name][0] += total
        stack.append([e, name, total])
    for _, parent, own in stack:
        host[parent][1] += own
    per = 1e-6 / n_requests   # ns over the window -> ms a request
    host_by_span = {n: [v[0] * per, v[1] * per] for n, v in host.items()}

    start = np.array([d[0] for d in dev], np.float64)
    end = np.array([d[1] for d in dev], np.float64)
    names = np.array([d[2] for d in dev], object)
    launched = np.array([launch_at.get(d[3], np.nan) for d in dev])
    in_account = np.zeros(len(dev), bool)
    if len(acc_s):
        k = np.clip(np.searchsorted(acc_s, launched, side="right") - 1, 0,
                    None)
        in_account = (launched >= acc_s[k]) & (launched < acc_e[k])
    own = ~in_account
    is_kernel = np.array([not n.startswith(("Memcpy", "Memset"))
                          for n in names], bool)
    at = _innermost(spans, np.nan_to_num(launched, nan=-1.0))
    launches: dict = {}
    for n in at[is_kernel & own]:
        launches[n] = launches.get(n, 0) + 1
    launches_by_span = {n: c / n_requests for n, c in launches.items()}

    idle_by_span: dict = {}
    idle_in = explained = 0.0
    if len(dev) and len(req_s):
        runs_s, runs_e = arith.busy_runs(start[own], end[own])
        gap_s = np.concatenate([[req_s.min()], runs_e])
        gap_e = np.concatenate([runs_s, [req_e.max()]])
        keep = gap_e > gap_s
        gap_s, gap_e = gap_s[keep], gap_e[keep]
        mid = (gap_s + gap_e) / 2
        at = _innermost(spans, mid)
        k = np.clip(np.searchsorted(req_s, mid, side="right") - 1, 0, None)
        in_req = (mid >= req_s[k]) & (mid < req_e[k])
        for n, length, inside in zip(at, (gap_e - gap_s) / 1e9, in_req):
            idle_by_span[n] = idle_by_span.get(n, 0.0) + float(length)
            if inside:
                idle_in += float(length)
                if n != "none" and n not in WRAPPERS:
                    explained += float(length)

    readings = _readings(host_by_span, counters, k1, kind)
    return {
        "host_by_span": host_by_span,
        "launches_by_span": launches_by_span,
        "idle_by_span": idle_by_span,
        "idle_in_requests_s": idle_in,
        "idle_explained_share": explained / idle_in if idle_in else None,
        "counters": counters,
        "readings": readings,
    }


def _readings(host: dict, counters: dict, k1, kind: str) -> dict:
    """The layer numbers the spans and counters come to (None where the
    run has nothing to read)."""
    def total(name):
        return host[name][0] if name in host else None

    if kind == "grad":
        return {"bwd_host_ms.grad": total("rt.backward")}
    shade = [host[n][1] for n in host
             if n == "rt.bounce" or n.startswith("rt.shade.")]
    lanes = counters.get("cast_lanes")
    walked = counters.get("k1_spans_walked")
    needed = sum(int(v) for v, *_ in k1.launches) if k1 is not None else 0
    return {
        "cast_host_ms.fwd": total("rt.cast"),
        "shade_host_ms.fwd": sum(shade) if shade else None,
        "sync_wait_ms.fwd": total("rt.sync"),
        "cast_live_pct.fwd": (100.0 * counters["cast_live_rays"] / lanes
                              if lanes else None),
        "k1_walk_excess.fwd": walked / needed if walked and needed else None,
    }


class SpanCapture(trace.Capture):
    """trace.Capture with the port's tracing() on around the profiled
    window, where the port has it."""

    def __init__(self):
        super().__init__()
        self.counters = None
        self._tracing = None

    def __enter__(self):
        timing = program.port("utils.timing")
        if hasattr(timing, "tracing"):
            self._tracing = timing.tracing(
                torch.device("cuda", torch.cuda.current_device()))
            self._recording = self._tracing.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        if self._tracing is not None:
            self._tracing.__exit__(None, None, None)
            self.counters = dict(self._recording.counters)
        return False

    def reduce(self, n_requests: int) -> dict:
        out = super().reduce(n_requests)
        kind = "grad" if out["backward_kernels"] else "fwd"
        out["spans"] = (None if self.counters is None else reduce_spans(
            self.prof.profiler.kineto_results.events(), n_requests,
            self.counters, self.k1, kind))
        return out


def main(argv=None) -> int:
    """One traced run of a cell with the port's spans on."""
    args = run.parse(list(argv if argv is not None else sys.argv[1:])
                     + ["--trace", "1"])
    cell = cells.load(args.workload)
    if not torch.cuda.is_available():
        print(f"spans: {args.workload} needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.set_num_threads(1)
    real = trace.Capture
    trace.Capture = SpanCapture
    try:
        out = run.execute(cell, args.seed, args.seconds, True, device,
                          run.T0)
    finally:
        trace.Capture = real
    print(json.dumps(run.result_line(cell, out, True, device)))
    print(json.dumps({"spans": out["run"]["trace"]["spans"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
