"""The traced run: host ranges from the benchmark's own files, the
profiler's device trace, and its reduction to what the per-layer readers
read.

Ranges (torch.profiler.record_function), opened around calls into the
port, which is left as it is: the port's module attributes are replaced
for the traced window only and restored after it.
  bm.request   one pass or one grad step
  bm.cast      ops/integrator.py's calls of closest_hit / closest_hit_pair
               (every cast of the render: K1(a), the keys' sort, K1)
  bm.backward  torch.Tensor.backward (the autograd engine's backward)
  bm.account   the benchmark's own count of K1's work after each launch
               (ops/sweep.py::sweep): its kernels are left out of every
               metric and of the device's busy time, and its host time
               out of the window (its kernels are loaded before the
               window starts)
A device operation belongs to the innermost range open on the host when
its launch (the CUDA runtime call the profiler gives the same correlation
id) was made.
"""

from __future__ import annotations

import contextlib
import re
import time

import numpy as np
import torch

from . import arith, program

K1_KERNEL = re.compile(r"\bsweep_kernel\b")
INF = 114514.0
LAYERS = ("bm.account", "bm.cast", "bm.backward", "bm.request")


class K1Count:
    """Per launch of K1, the work its inputs need: the spans a walk that
    knew each ray's final hit would visit (the first span of a tile, then
    each later one whose tile entry distance lies below the tile's final
    stop threshold, the kernel's own stop test on its final records) and
    the distinct clusters among them. A lower bound of the spans the
    kernel walks, so the bound it gives is a lower bound too."""

    def __init__(self):
        self.launches = []   # (visits tensor, clusters tensor, t, rays, g)

    def add(self, nspan, spans, tile_sorted, best, trifeat):
        g, c = spans.shape
        rec = best.reshape(g, arith.TILE_R, -1)
        live_t = torch.where((rec[..., 4] > 0.5) & (rec[..., 1] >= 0.0),
                             -INF, rec[..., 0])
        thresh = torch.amax(torch.minimum(live_t, rec[..., 3]), dim=1)
        col = torch.arange(c, device=spans.device)[None, :]
        later = ((col >= 1) & (col < nspan[:, None])
                 & (tile_sorted < thresh[:, None]))
        visits = (nspan > 0).long() + later.sum(dim=1)
        walked = col < visits[:, None]
        seen = torch.zeros(trifeat.shape[0], dtype=torch.int64,
                           device=spans.device)   # no host sync: a scatter
        seen.scatter_add_(0, spans.reshape(-1).long(),
                          walked.reshape(-1).long())
        self.launches.append((visits.sum(), (seen > 0).sum(),
                              trifeat.shape[2] // 4, g * arith.TILE_R, g))

    def warm(self, device):
        """Load the count's kernels, so that their first load is not in
        the window."""
        self.add(torch.ones(1, dtype=torch.int32, device=device),
                 torch.zeros((1, 2), dtype=torch.int32, device=device),
                 torch.zeros((1, 2), device=device),
                 torch.zeros((arith.TILE_R, 8), device=device),
                 torch.zeros((2, 16, 4), device=device))
        int(self.launches.pop()[0])

    def bound_s(self) -> float:
        total = 0.0
        for visits, clusters, t_blk, n_rays, g in self.launches:
            v = int(visits)
            total += arith.span_bound(v, int(clusters), t_blk, n_rays,
                                      index_bytes=g * 4 + 2 * v * 4)[0]
        return total


@contextlib.contextmanager
def _patched(obj, name, wrap):
    real = getattr(obj, name)
    setattr(obj, name, wrap(real))
    try:
        yield real
    finally:
        setattr(obj, name, real)


def _ranged(label):
    def wrap(fn):
        def ranged(*args, **kwargs):
            with torch.profiler.record_function(label):
                return fn(*args, **kwargs)
        return ranged
    return wrap


class Capture:
    """Profile a window of requests, with the ranges above."""

    def __init__(self):
        self.k1 = K1Count()
        self.prof = None
        self.window_s = None
        self._stack = contextlib.ExitStack()

    def __enter__(self):
        integrator = program.port("ops.integrator")
        sweep = program.port("ops.sweep")
        k1 = self.k1

        def counted(real):
            def sweep_counted(nspan, spans, tile_sorted, rayfeat, best,
                              trifeat):
                out = real(nspan, spans, tile_sorted, rayfeat, best, trifeat)
                with torch.profiler.record_function("bm.account"):
                    k1.add(nspan, spans, tile_sorted, out, trifeat)
                return out
            sweep_counted.launches = 0   # the kernel's wrapper counts here
            return sweep_counted

        st = self._stack
        st.enter_context(_patched(integrator, "closest_hit",
                                  _ranged("bm.cast")))
        st.enter_context(_patched(integrator, "closest_hit_pair",
                                  _ranged("bm.cast")))
        st.enter_context(_patched(torch.Tensor, "backward",
                                  _ranged("bm.backward")))
        st.enter_context(_patched(sweep, "sweep", counted))
        k1.warm(torch.device("cuda", torch.cuda.current_device()))
        torch.cuda.synchronize()
        self.prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        self.prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def request(self):
        return torch.profiler.record_function("bm.request")

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self.prof.__exit__(*exc)
        self._stack.close()
        return False

    def reduce(self, n_requests: int) -> dict:
        return reduce_events(self.prof.profiler.kineto_results.events(),
                             n_requests, self.window_s, self.k1)


def _innermost(ranges: dict, t: np.ndarray) -> np.ndarray:
    """For host times t, the index into LAYERS of the innermost range open
    at each (len(LAYERS) where none is)."""
    out = np.full(len(t), len(LAYERS))
    for i in reversed(range(len(LAYERS))):
        starts, ends = ranges[LAYERS[i]]
        if len(starts) == 0:
            continue
        k = np.searchsorted(starts, t, side="right") - 1
        inside = (k >= 0) & (t < ends[np.clip(k, 0, None)])
        out = np.where(inside, i, out)
    return out


def reduce_events(events, n_requests: int, window_s: float,
                  k1: K1Count | None) -> dict:
    """The traced window's numbers by layer from the profiler's raw events
    (names, device or host, start and duration in ns, correlation ids)."""
    cuda = torch.autograd.DeviceType.CUDA
    launch_at = {}   # correlation id -> host start of the runtime call
    ranges = {name: ([], []) for name in LAYERS}
    dev = []   # (start_ns, end_ns, name, correlation id)
    for e in events:
        name = e.name()
        if e.device_type() == cuda:
            if name.startswith("bm.") or e.is_user_annotation():
                continue
            dev.append((e.start_ns(), e.start_ns() + e.duration_ns(), name,
                        e.correlation_id()))
        elif name in ranges:
            ranges[name][0].append(e.start_ns())
            ranges[name][1].append(e.start_ns() + e.duration_ns())
        elif name.startswith("cu"):   # cudaLaunchKernel, cudaMemcpyAsync...
            launch_at[e.correlation_id()] = e.start_ns()
    for name, (s, t) in ranges.items():
        order = np.argsort(s)
        ranges[name] = (np.asarray(s, np.float64)[order],
                        np.asarray(t, np.float64)[order])
    if not dev:
        raise RuntimeError("the profiler saw no device activity")
    start = np.array([d[0] for d in dev], np.float64)
    end = np.array([d[1] for d in dev], np.float64)
    names = np.array([d[2] for d in dev], object)
    launched = np.array([launch_at.get(d[3], np.nan) for d in dev])
    layer = _innermost(ranges, launched)
    layer[np.isnan(launched)] = len(LAYERS)
    is_kernel = np.array([not (n.startswith("Memcpy")
                               or n.startswith("Memset")) for n in names])
    own = layer != LAYERS.index("bm.account")
    dur = (end - start) / 1e9

    def device_s(mask):
        return float(dur[mask & own].sum())

    busy_s = arith.union_length(start[own], end[own]) / 1e9
    acc_s, acc_e = ranges["bm.account"]
    account_s = float(np.sum(acc_e - acc_s)) / 1e9
    req_s, req_e = ranges["bm.request"]
    lo = req_s.min() if len(req_s) else start.min()
    hi = req_e.max() if len(req_e) else end.max()
    runs_s, runs_e = arith.busy_runs(start[own], end[own])
    gap_s = np.concatenate([[lo], runs_e])
    gap_e = np.concatenate([runs_s, [hi]])
    keep = gap_e > gap_s
    gap_s, gap_e = gap_s[keep], gap_e[keep]
    ctx = _innermost(ranges, (gap_s + gap_e) / 2)
    label = {LAYERS.index("bm.cast"): "cast",
             LAYERS.index("bm.backward"): "backward",
             LAYERS.index("bm.request"): "shading and host",
             LAYERS.index("bm.account"): "benchmark accounting",
             len(LAYERS): "between requests"}
    longest = np.argsort(gap_s - gap_e)[:10]
    by_name: dict = {}
    for n, d, m in zip(names, dur, is_kernel & own):
        if m:
            by_name[n] = by_name.get(n, 0.0) + d
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    k1_mask = np.array([bool(K1_KERNEL.search(n)) for n in names]) & own
    cast = layer == LAYERS.index("bm.cast")
    backward = layer == LAYERS.index("bm.backward")
    return {
        "requests": n_requests,
        "window_s": window_s - account_s,
        "account_s": account_s,
        "busy_s": busy_s,
        "kernels": int((is_kernel & own).sum()),
        "cast_kernels": int((is_kernel & own & cast).sum()),
        "cast_s": device_s(cast),
        "shade_s": device_s(~cast & ~backward),
        "backward_s": device_s(backward),
        "backward_kernels": int((is_kernel & own & backward).sum()),
        "k1_launches": int(k1_mask.sum()),
        "k1_s": float(dur[k1_mask].sum()),
        "k1_bound_s": k1.bound_s() if k1 is not None else 0.0,
        "unattributed_kernels": int((is_kernel & (layer == len(LAYERS)))
                                    .sum()),
        "device_ops": [[str(n), float(s)] for n, s in top],
        "idle_gaps": [[label[int(ctx[i])], float((gap_e[i] - gap_s[i]) / 1e9)]
                      for i in longest],
    }
