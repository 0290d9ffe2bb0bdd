"""The port's span recorder and counters, and the `--timing` breakdown
built on them (PyTorch port of opengl_ray_tracing_framework_tpu.utils
.timing, whose stages were timed one at a time outside a pass).

The reference's only observability is the ImGui frame-time/FPS readout and
the iteration counter (src/sources/main.cpp:366-372). Here the program
marks its own layers, inside real passes:

  tracing(device)  the switch, a context manager; off by default. While it
                   is on, span(name) opens a torch.profiler.record_function
                   range (so a profiler puts every span on its clock beside
                   the device's activity) and adds the span's host time to
                   the recording; count(name, n) adds to a host counter;
                   device_counter(name, device) gives the kernels a pointer
                   into one int64 buffer that tracing() allocates on
                   `device` when it turns on. When it turns off, the buffer
                   is read once and the Recording it yielded (and
                   counters()) holds every count.
  span(name)       with tracing off: a shared no-op context after one
                   module-level boolean test; no record_function, no CUDA
                   event, no launch.

Spans (the names are read by the benchmark and PERF.md):
  rt.pass          render.py::render_pass
  rt.batch         one render.py::trace_pixels batch (the render's
                   _trace_rows and parallel/autodiff.py's _row_batches)
  rt.accumulate    the running-mean update of render_pass
  rt.cast          ops/traverse.py::closest_hit / closest_hit_pair
  rt.cast.prep     ops/sweep.py::sweep_inputs: the pad, sweep_key, the
                   keys' torch.sort, sweep_spans
  rt.cast.k1       the span-sweep kernel (ops/sweep.py::sweep)
  rt.cast.finish   the unsort, slice and slot2tri lookup of _swept
  rt.bounce        one _bounce / _bounce_brdf call of ops/integrator.py
  rt.shade.surface surface_attributes (and the BRDF's onb); on the card
                   (ops/shade.py's kernels) not opened: shade_light does it
  rt.shade.light   the NEE light sample; after the cast, its shadow-tested
                   contribution; on the card the shade_light kernel
                   (surface and light sample, before the cast) alone
  rt.shade.bsdf    disney_sample + the media + disney_eval of the sampled
                   direction, or the shade_bsdf kernel (ops/shade.py; BRDF:
                   sample_brdf + brdf_evaluate)
  rt.shade.env     after the cast, the MIS miss and the emissive pickup; on
                   the card the shade_env kernel, which adds the NEE's
                   contribution first
  rt.sync          each host <-> device sync of the render loop: the two
                   torch.nonzero calls of _bounce_loop
  rt.loss          parallel/autodiff.py::_batch_loss in _grads
  rt.backward      the batch loss's backward in _grads
  rt.build         models/scene.py::Scene.build, the host-side scene
                   build, around:
  rt.build.bvh     the SAH BVH (models/bvh.py::build_bvh)
  rt.build.clusters  the treelet clusters and their intersection features
                   (models/clusters.py::build_clusters)
  rt.build.env     the HDR tables (build_hdr_cache, build_env_fetch)
  rt.build.upload  the arrays turned into the SceneData's tensors on the
                   device (scene_from_numpy)

Counters:
  casts            rt.cast spans (one merged pair counts one)
  cast_lanes       the sweep's lanes launched: each cast's R padded to a
                   whole number of 128-ray tiles (ops/sweep.py)
  cast_pairs       the ray x cluster pairs of K1(a) a cast: its padded R
                   x the scene's C (the pairs each of sweep_key and
                   sweep_spans covers; their group boxes leave
                   k1a_pairs_tested slab tests in all)
  cast_slots       the cluster slots a cast's records can name: the
                   scene's C x T (ops/sweep.py, K1's slot lane; the
                   schedule tracer's float32 lane names up to 2^24)
  bounces          bounces run (rt.bounce spans)
  bounce_lanes     live lanes at each bounce's start, summed
  syncs            rt.sync spans
  shade_light_lanes, shade_fused_lanes, shade_env_lanes  lanes shaded by
                   csrc/shade.cu's shade_light, shade_bsdf and shade_env
                   kernels, each counted at its launch (ops/shade.py); over
                   bounce_lanes, the share of the bounces each kernel
                   shaded: 1.0 in a forward pass on the card, 0 in a
                   gradient step or on the CPU
  k1_spans_walked  (device) spans K1 walked, once per tile
                   (csrc/sweep.cu; sweep_plain on the CPU)
  cast_live_rays   (device) rays of the sweep's casts that are masked on
                   and enter at least one cluster box: those whose key is
                   not dead (csrc/sweep_prep.cu's sweep_spans;
                   sweep_spans_plain on the CPU)
  k1a_pairs_tested (device) the (ray, cluster) member slab tests that
                   K1(a)'s kernels make at every cluster count
                   (csrc/sweep_prep.cu's sweep_key and sweep_spans: a
                   warp's lanes, times its rays a lane, times the members
                   of each group box it enters; group tests are not
                   counted); over 2 x cast_pairs, the share of the
                   all-pairs slab test left. 0 on the CPU, whose plain
                   versions test every pair
  k1a_runs_tiles   (device) tiles that sweep_spans sends down its runs
                   path (the (G, C) scratch), one atomicAdd by each such
                   CTA; 0 on the CPU, whose plain version has no such path

pass_breakdown (the `--timing` flag) runs `repeats` real render_pass calls
under tracing() and reports each span's host time a pass, total and self
(its duration less its rt.* children's), with the pass's wall time and, on
a CUDA device, its device time from CUDA events recorded before and after
the passes (from the device reaching the first event to its reaching the
last, idle gaps included).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch

from .config import resolve_device

HOST_COUNTERS = ("casts", "cast_lanes", "cast_pairs", "cast_slots",
                 "bounces", "bounce_lanes", "syncs", "shade_light_lanes",
                 "shade_fused_lanes", "shade_env_lanes")
DEVICE_COUNTERS = ("k1_spans_walked", "cast_live_rays", "k1a_pairs_tested",
                   "k1a_runs_tiles")

_ON = False                           # tracing(): the one test span() makes
_NULL = contextlib.nullcontext()      # span() while tracing is off
_rec = None                           # the Recording tracing() fills
_last = None                          # the last Recording tracing() closed


@dataclasses.dataclass
class Recording:
    """What one tracing() window recorded: counters {name: int} (filled
    when the window closes) and spans {name: [calls, total_ns, self_ns]}
    of host time."""

    counters: dict = dataclasses.field(default_factory=dict)
    spans: dict = dataclasses.field(default_factory=dict)
    buffer: torch.Tensor | None = None
    stack: list = dataclasses.field(default_factory=list)


class _Span:
    """An open span: a record_function range and its host time; self time
    is its duration less that of the spans it encloses."""

    __slots__ = ("name", "rf", "t0", "inner")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.inner = 0
        _rec.stack.append(self)
        _rec.spans.setdefault(self.name, [0, 0, 0])   # rows in entry order
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter_ns() - self.t0
        rec = _rec
        rec.stack.pop()
        if rec.stack:
            rec.stack[-1].inner += dur
        row = rec.spans[self.name]
        row[0] += 1
        row[1] += dur
        row[2] += dur - self.inner
        self.rf.__exit__(*exc)
        return False


def span(name: str):
    """A span of the program's layer `name` while tracing is on, else a
    shared no-op context."""
    if not _ON:
        return _NULL
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add n to the host counter `name` while tracing is on."""
    if _ON:
        _rec.counters[name] = _rec.counters.get(name, 0) + n


def device_counter(name: str, device: torch.device):
    """The address of the device counter `name` for a kernel launched on
    `device` while tracing is on there, else None (the kernel counts
    nothing)."""
    if not _ON or _rec.buffer.device != device:
        return None
    return _rec.buffer[DEVICE_COUNTERS.index(name)].data_ptr()


def add_device(name: str, value: torch.Tensor) -> None:
    """Add a count computed on `value`'s device (a plain version's) into
    the device counter `name` while tracing is on there."""
    if _ON and _rec.buffer.device == value.device:
        _rec.buffer[DEVICE_COUNTERS.index(name)] += value


@contextlib.contextmanager
def tracing(device=None):
    """Turn the spans and counters on for the block; yields the Recording,
    whose counters are read when the block ends (one read of the device
    buffer). Not reentrant."""
    global _ON, _rec, _last
    if _ON:
        raise RuntimeError("tracing is already on")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    rec = Recording(counters=dict.fromkeys(HOST_COUNTERS, 0),
                    buffer=torch.zeros(len(DEVICE_COUNTERS),
                                       dtype=torch.int64, device=dev))
    _rec, _ON = rec, True
    try:
        yield rec
    finally:
        _ON, _rec = False, None
        rec.counters.update(zip(DEVICE_COUNTERS, rec.buffer.tolist()))
        rec.buffer = None
        rec.stack.clear()
        _last = rec


def counters() -> dict:
    """The counters of the last tracing() window ({} before the first)."""
    return dict(_last.counters) if _last is not None else {}


def _fence(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def pass_breakdown(scene, camera, config, rays_per_tile: int = 131072,
                   repeats: int = 3) -> dict:
    """Host seconds a pass of each span, from `repeats` render_pass calls
    of `config` on `scene` (after one warm pass) under tracing():
    {span: {"calls", "total", "self"} a pass, "full_pass": wall seconds a
    pass, "_device": {"full_pass": device seconds a pass} (CUDA only),
    "_counters": the recording's counters a pass, "_meta": {...}}."""
    from ..render import init_render_state, render_pass

    dev = scene.device
    camera = camera.to(dev)
    state = init_render_state(config, dev)
    state = render_pass(scene, camera, state, config, rays_per_tile)
    _fence(dev)
    events = None
    if dev.type == "cuda":
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    with tracing(dev) as rec:
        if events is not None:
            events[0].record()
        t0 = time.perf_counter()
        for _ in range(repeats):
            state = render_pass(scene, camera, state, config, rays_per_tile)
        if events is not None:
            events[1].record()
        _fence(dev)
        wall = (time.perf_counter() - t0) / repeats

    times: dict = {
        name: {"calls": calls / repeats, "total": total_ns / 1e9 / repeats,
               "self": self_ns / 1e9 / repeats}
        for name, (calls, total_ns, self_ns) in rec.spans.items()}
    times["full_pass"] = wall
    if events is not None:
        times["_device"] = {
            "full_pass": events[0].elapsed_time(events[1]) / 1e3 / repeats}
    times["_counters"] = {k: v / repeats for k, v in rec.counters.items()}
    r = min(rays_per_tile, config.n_pixels)
    b = config.max_bounce
    times["_meta"] = {
        "rays_per_tile": r, "n_tiles": max(1, config.n_pixels // r),
        "bounces": b, "pixels": config.n_pixels,
        "rays_per_pass": config.n_pixels * (1 + 2 * b),
    }
    return times


def format_breakdown(times: dict) -> str:
    """The breakdown as a table: one row a span (calls, host ms and self
    ms a pass), then the pass's wall ms (and device ms on a CUDA device),
    its rays/s and its counters."""
    lines = ["span               calls    host ms    self ms"]
    for name, row in times.items():
        if name.startswith("_") or name == "full_pass":
            continue
        lines.append(f"{name:16s} {row['calls']:7.1f} {row['total'] * 1e3:10.2f}"
                     f" {row['self'] * 1e3:10.2f}")
    full = times.get("full_pass")
    if full:
        line = f"pass wall ms     {full * 1e3:18.2f}"
        device = times.get("_device", {}).get("full_pass")
        if device is not None:
            line += f"   device ms {device * 1e3:.2f}"
        lines.append(line)
        meta = times.get("_meta")
        if meta:
            lines.append(f"pass rays/s      {meta['rays_per_pass'] / full:,.0f}")
    counts = times.get("_counters")
    if counts:
        lines.append("a pass: " + ", ".join(f"{k} {v:g}"
                                            for k, v in counts.items()))
    return "\n".join(lines)
