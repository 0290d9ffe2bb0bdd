"""Per-stage time breakdown of a progressive pass, the `--timing` flag
(PyTorch port of opengl_ray_tracing_framework_tpu.utils.timing).

The reference's only observability is the ImGui frame-time/FPS readout and
the iteration counter (src/sources/main.cpp:366-372). Here each stage of a
pass is timed on its own, at the true batch shape and with representative
ray populations, out of the port's own functions:

  raygen          camera ray generation for one batch
  sort            the sweep tracer's coherence sort per cast: the slab
                  test and key (sweep_key) and a stable argsort
  tnear_spans     per 128-ray tile of the sorted rays the span lists, the
                  per-ray caps, ray features and records (sweep_spans,
                  which gathers the rays in sorted order)
  primary_cast    coherent closest hit (camera rays)
  shadow_cast     incoherent any hit from hit points toward env samples
  bounce_cast     incoherent closest hit from hit points, hemisphere dirs
  shade           surface_attributes + disney_eval + disney_sample
  env             environment light sample + radiance/pdf row fetches
  accumulate      running-mean update of the (H, W, 3) accumulator

`estimated_pass` composes them the way a pass does (one primary cast per
batch, per bounce a shadow and a bounce cast, two shades and an env);
`full_pass` is render_pass itself. A stage's time is the JAX module's
_timeit: one warm call, `repeats` calls, then a fence, over the host
clock. On a CUDA device, CUDA events recorded before and after the same
repeats give the stream's time beside it (times["_device"]): from the
device reaching the first event to its reaching the last, idle gaps
included, so it leaves out only the host's time before the first launch
and the fence's wake-up. It is not the device's busy time (a profiler's
sum of kernel durations, `chip_smoke.py --profile`).
"""

from __future__ import annotations

import math
import time

import torch


def _fence(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timeit(fn, *args, repeats: int = 3, device=None):
    """(wall seconds, device seconds or None) per call of fn(*args): one
    warm call, `repeats` calls, a fence."""
    fn(*args)
    _fence(device)
    events = None
    if device.type == "cuda":
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        events[0].record()
    t0 = time.perf_counter()
    for _ in range(repeats):
        fn(*args)
    if events is not None:
        events[1].record()
    _fence(device)
    wall = (time.perf_counter() - t0) / repeats
    if events is None:
        return wall, None
    return wall, events[0].elapsed_time(events[1]) / 1e3 / repeats


@torch.no_grad()
def pass_breakdown(scene, camera, config, rays_per_tile: int = 131072,
                   repeats: int = 3) -> dict:
    """Seconds per stage for one spp of `config` on `scene`, on the scene's
    device: {stage: wall seconds, "_device": {stage: device seconds} (CUDA
    only), "_meta": {...}}."""
    from ..models.camera import pixel_uv
    from ..ops import disney
    from ..ops.envmap import env_radiance_pdf_nearest, env_sample_nearest
    from ..ops.intersect import surface_attributes
    from ..ops.sampling import rand01
    from ..ops.sweep import TILE_R, sweep_key, sweep_spans
    from ..ops.traverse import closest_hit
    from ..render import init_render_state, render_pass

    dev = scene.device
    camera = camera.to(dev)
    w, h = config.width, config.height
    r = min(rays_per_tile, config.n_pixels)
    u, v = pixel_uv(w, h, device=dev)
    uu, vv = u[:r], v[:r]
    o, d = camera.generate_rays(uu, vv)
    pid = torch.arange(r, dtype=torch.int64, device=dev)
    ones = torch.ones(r, dtype=torch.bool, device=dev)
    cl_min, cl_max = scene.cl_aabb_min, scene.cl_aabb_max

    times: dict = {}
    device_times: dict = {}

    def stage(name, fn, *args, n=repeats):
        times[name], dev_s = _timeit(fn, *args, repeats=n, device=dev)
        if dev_s is not None:
            device_times[name] = dev_s

    stage("raygen", camera.generate_rays, uu, vv)

    # the coherence sort and the span lists the sweep tracer pays per cast
    # (sweep_inputs), on the rays cycled up to a whole number of tiles
    pad = torch.arange(math.ceil(r / TILE_R) * TILE_R, device=dev) % r
    o_t, d_t, m_t = o[pad].contiguous(), d[pad].contiguous(), ones[pad]
    a_t = torch.zeros_like(m_t)

    def do_sort(o, d, mask):
        key = sweep_key(o, d, mask, cl_min, cl_max)
        return torch.sort(key, stable=True).indices

    stage("sort", do_sort, o_t, d_t, m_t)
    perm = do_sort(o_t, d_t, m_t)

    def do_spans(o, d, mask, anyhit, perm):
        return sweep_spans(o, d, mask, anyhit, perm, cl_min, cl_max)

    stage("tnear_spans", do_spans, o_t, d_t, m_t, a_t, perm)

    # casts
    def cast(o, d, any_hit):
        return closest_hit(scene, o, d, config, any_hit=any_hit)

    stage("primary_cast", cast, o, d, False)
    hit = cast(o, d, False)
    hp = o + d * torch.clamp(hit.t, max=100.0)[:, None]
    hh, ww = scene.hdr_map.shape[0], scene.hdr_map.shape[1]
    xl1, xl2 = rand01(pid, 1, 0), rand01(pid, 1, 1)
    l_dir, _, _ = env_sample_nearest(scene.env_fetch, hh, ww, xl1, xl2,
                                     scene.env_angle)
    stage("shadow_cast", cast, hp, l_dir, True)

    # hemisphere bounce directions (uniform: representative incoherence)
    z1 = rand01(pid, 2, 0) * 2.0 - 1.0
    z2 = rand01(pid, 2, 1) * 2.0 * math.pi
    s = torch.sqrt(torch.clamp(1.0 - z1 * z1, min=0.0))
    bd = torch.stack([s * torch.cos(z2), torch.abs(z1), s * torch.sin(z2)],
                     dim=-1)
    stage("bounce_cast", cast, hp, bd, False)

    # shading
    xi = [rand01(pid, 3, k) for k in range(3)]

    def do_shade(o, d, t, tri, inside):
        _, n, view, mat = surface_attributes(scene, o, d, t, tri, inside)
        f, pdf = disney.disney_eval(mat, view, n, l_dir)
        smp = disney.disney_sample(mat, view, n, *xi)
        return f, pdf, smp.direction, smp.pdf

    stage("shade", do_shade, o, d, hit.t, hit.tri, hit.inside)

    # environment
    def do_env(xl1, xl2, d):
        ld, lpdf, lfr = env_sample_nearest(scene.env_fetch, hh, ww, xl1, xl2,
                                           scene.env_angle)
        fr, pdf = env_radiance_pdf_nearest(scene.env_fetch, hh, ww, d,
                                           scene.env_angle)
        return ld, lpdf, lfr, fr, pdf

    stage("env", do_env, xl1, xl2, bd)

    # accumulate
    acc = torch.zeros((h, w, 3), dtype=torch.float32, device=dev)
    sample = torch.ones((h, w, 3), dtype=torch.float32, device=dev)
    stage("accumulate", lambda a, x: a + (x - a) / 7.0, acc, sample)

    n_tiles = max(1, config.n_pixels // r)
    b = config.max_bounce
    for out in (times, device_times):
        if "raygen" in out:
            out["estimated_pass"] = n_tiles * (
                out["raygen"] + out["primary_cast"]
                + b * (out["shadow_cast"] + out["bounce_cast"]
                       + 2 * out["shade"] + out["env"])) + out["accumulate"]

    state = init_render_state(config, dev)
    stage("full_pass",
          lambda st: render_pass(scene, camera, st, config,
                                 rays_per_tile=rays_per_tile),
          state, n=max(1, repeats - 1))
    if device_times:
        times["_device"] = device_times
    times["_meta"] = {
        "rays_per_tile": r, "n_tiles": n_tiles, "bounces": b,
        "pixels": config.n_pixels,
        "rays_per_pass": config.n_pixels * (1 + 2 * b),
    }
    return times


def format_breakdown(times: dict) -> str:
    """The breakdown as a table: wall ms per stage, and device ms beside it
    where the stages ran on a CUDA device."""
    meta = times.get("_meta", {})
    device = times.get("_device", {})
    lines = ["stage              wall ms" + ("  device ms" if device else "")]
    for k, val in times.items():
        if k.startswith("_"):
            continue
        line = f"{k:16s} {val * 1e3:10.2f}"
        if k in device:
            line += f" {device[k] * 1e3:10.2f}"
        lines.append(line)
    full = times.get("full_pass")
    if meta and full:
        lines.append(f"pass rays/s      {meta['rays_per_pass'] / full:,.0f}")
    return "\n".join(lines)
