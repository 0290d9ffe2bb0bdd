#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py [--png PATH] [--profile]

Run from the repository root. It fails (exit code != 0, no result line)
when torch sees no CUDA device, and when anything below fails:

 1. device: the card's name and power limit (nvidia-smi);
 2. build: nvcc compiles csrc/sweep.cu (the span-sweep kernel, K1) and
    csrc/cluster_intersect.cu (the cluster-intersect kernel, K2), both
    started together;
 3. K1 against its plain version on the card, at the main path's shapes:
    the 81,922-triangle procedural scene (loong-100k's scale), a
    65,536-ray primary cast and the first bounce's merged NEE-shadow +
    bounce cast of the same rays, each held against sweep_plain on the
    same inputs and timed with CUDA events;
 4. K2 against its plain version at the schedule path's shapes: the same
    primary batch and the first bounce's bounce cast, with spans / nspan
    from the tracer's real votes; every round's launch is compared, the
    first round and the round with the most elected spans are timed;
 5. the default render: render_progressive at 1024x512, 8 bounces, BSDF,
    HDR environment + MIS, tear-glass sphere, 1024x512 procedural HDR,
    sweep tracer; one warm-up pass and two timed passes, each fenced by a
    host copy; K1 must be launched and its plain version never called;
 6. card against CPU: render_radiance at 128x64, 2 spp, 8 bounces, on the
    card (kernel) and on the CPU (plain version), held to the hardware
    lane's image criterion (tests/test_tpu.py:57-60);
 7. the schedule render: the same frame with cast_backend="schedule", one
    warm-up and one timed pass; K2 must be launched, its plain version and
    K1 never; then the schedule image against the sweep image on the card
    at 128x64, 2 spp, by the same criterion;
 8. BRDF mode (enable_bsdf=False, sweep tracer): one full-width pass, and
    card against CPU at 128x64;
 9. cast_backend="bvh" and use_bvh=False at 128x64, 1 spp against the
    sweep image (kernel-free tracers, host loops).

Each kernel's bound is the least time the card could take for the work
this run's inputs need: the larger of its FP32 operations over the card's
CUDA-core peak and its bytes (each input read once, each output written
once) over the HBM rate (NVIDIA's H100 SXM data sheet: 67 TFLOP/s FP32,
3.35 TB/s). Neither kernel has one PyTorch call that computes the same
function, so library_ms is null.

It prints one line of numbers per phase, then a JSON line describing the
kernels, then {"ok": true, "device": {...}} as the last line. --profile
adds, before those two, a torch.profiler summary of one sweep pass and one
schedule pass (device time in kernels, the kernels that took most of it).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

WIDTH, HEIGHT, BOUNCES = 1024, 512, 8
RAYS_PER_TILE = 65536
REPEATS = 5
PEAK_FP32_FLOPS = 67e12     # H100 SXM, FP32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12    # H100 SXM, HBM3
FLOPS_PER_PAIR = 80         # 40 FMAs per ray x triangle (csrc/mt_span.cuh)
PORT = "opengl_ray_tracing_framework_tpu_torch"


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, repeats=REPEATS) -> float:
    """Mean milliseconds of fn() over `repeats` runs, by CUDA events, after
    one warm-up run."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(repeats):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / repeats


def compare_records(got, want, slot2tri, label, min_hit_agree=0.9999):
    """The sweep criterion on two (R, 8) records: hit/miss agreement, t to
    1e-4, the same triangle on >= 99.5% of common hits, inside equal where
    the triangle agrees. Returns max |t_got - t_want| over common hits."""
    import torch
    gs, ws = got[:, 1].long(), want[:, 1].long()
    gh, wh = gs >= 0, ws >= 0
    agree = (gh == wh).float().mean().item()
    if agree < min_hit_agree:
        fail(f"{label}: hit/miss agreement {agree:.6f} < {min_hit_agree}")
    both = gh & wh
    gt, wt = got[both, 0], want[both, 0]
    if not torch.allclose(gt, wt, rtol=1e-4, atol=1e-4):
        fail(f"{label}: t differs beyond 1e-4")
    same = slot2tri[gs[both]] == slot2tri[ws[both]]
    tri_agree = same.float().mean().item() if same.numel() else 1.0
    if tri_agree < 0.995:
        fail(f"{label}: triangle agreement {tri_agree:.6f} < 0.995")
    if not torch.equal(got[both, 2][same], want[both, 2][same]):
        fail(f"{label}: inside flag differs")
    err = (gt - wt).abs().max().item() if gt.numel() else 0.0
    return err, agree, tri_agree


def compare_images(label, img, ref, note=""):
    """The image criterion (tests/test_tpu.py:57-60) on two (H, W, 3)
    tensors: finite, means within 1e-4 relative, < 1e-3 of the values off
    at atol/rtol 1e-3."""
    import numpy as np
    g, c = img.cpu().numpy(), ref.cpu().numpy()
    rel_mean = abs(g.mean() - c.mean()) / max(c.mean(), 1e-6)
    mismatch = float((~np.isclose(g, c, atol=1e-3, rtol=1e-3)).mean())
    print(f"{label}: {note}mean {g.mean():.6f} vs {c.mean():.6f} (rel "
          f"{rel_mean:.2e}) | values off at 1e-3: {mismatch:.2e}")
    if not np.isfinite(g).all() or rel_mean >= 1e-4 or mismatch >= 1e-3:
        fail(f"{label}: the images disagree")


def span_bound(visits, clusters_read, t_blk, n_rays, index_bytes):
    """(bound_ms, bound_by, ops_ms, bytes_ms) of a cluster kernel call that
    walks `visits` (ray tile of 128, cluster) spans over `clusters_read`
    distinct clusters: 128 * T * 80 FP32 operations per span; bytes are
    the 41*T floats of each distinct cluster block once, the ray features
    once, the records read and written once, and the span lists."""
    ops = visits * 128 * t_blk * FLOPS_PER_PAIR
    nbytes = (clusters_read * 41 * t_blk * 4 + n_rays * (16 + 2 * 8) * 4
              + index_bytes)
    ops_ms = ops / PEAK_FP32_FLOPS * 1e3
    bytes_ms = nbytes / PEAK_HBM_BYTES * 1e3
    by = "operations" if ops_ms >= bytes_ms else "bytes"
    return max(ops_ms, bytes_ms), by, ops_ms, bytes_ms


def timed_passes(ortf, scene, camera, config, n_passes):
    """render_progressive for n_passes, each fenced by a host copy.
    Returns (display image, per-pass seconds)."""
    stamps = [time.perf_counter()]

    def fence(state, i):
        float(state.accum[0, 0, 0])   # host copy: the pass has finished
        stamps.append(time.perf_counter())

    image, _ = ortf.render_progressive(
        scene, camera, config, n_iterations=n_passes, callback=fence,
        rays_per_tile=RAYS_PER_TILE)
    return image.float(), [b - a for a, b in zip(stamps, stamps[1:])]


def profile_pass(label, ortf, scene, camera, config):
    """One warm pass under torch.profiler: its wall time, the time the
    device spent in kernels, and the kernels that took most of it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, pass_s = timed_passes(ortf, scene, camera, config, 1)
        torch.cuda.synchronize()
    # device-side events only: a host op's row repeats its kernels' time
    rows = [(e.key, e.self_device_time_total / 1e6, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not rows:
        fail(f"profile {label}: the profiler saw no device time")
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    top = "; ".join(f"{k[:48]} {t * 1e3:.1f} ms x{n}" for k, t, n in rows[:6])
    print(f"profile {label}: pass {pass_s[0]:.3f} s under the profiler | "
          f"device in kernels {busy:.3f} s ({busy / pass_s[0]:.1%} of it), "
          f"{sum(r[2] for r in rows)} device operations | top: {top}")


def check_image(label, img):
    import torch
    finite = bool(torch.isfinite(img).all())
    mean = img.mean().item()
    if not finite or not mean > 0:
        fail(f"{label}: the image is not finite with a positive mean")
    return mean


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--png", help="also save the rendered image here")
    parser.add_argument("--profile", action="store_true",
                        help="also profile one sweep pass and one schedule "
                             "pass with torch.profiler")
    args = parser.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        return 1

    import opengl_ray_tracing_framework_tpu_torch as ortf
    from opengl_ray_tracing_framework_tpu_torch.models.hdr import (
        make_gradient_hdr)
    from opengl_ray_tracing_framework_tpu_torch.models.material import (
        preset_materials)
    from opengl_ray_tracing_framework_tpu_torch.ops import (
        cluster_intersect as ci)
    from opengl_ray_tracing_framework_tpu_torch.ops import integrator
    from opengl_ray_tracing_framework_tpu_torch.ops import schedule as sched
    from opengl_ray_tracing_framework_tpu_torch.ops import sweep as sw
    from opengl_ray_tracing_framework_tpu_torch.utils import nvcc

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    print(f"device: torch {torch.__version__}, cuda {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    # 2. build: one nvcc per source, started together
    names = ("sweep", "cluster_intersect")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        built = list(pool.map(nvcc.build, names))
    for name, (path, build_s, log) in zip(names, built):
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"build: {name}.cu -> {path.name} in {build_s:.2f} s"
              + (f" | ptxas: {regs[-1]}" if regs else " (cached)"))
    print(f"build: both in {time.perf_counter() - t0:.2f} s")

    # 3. K1 vs plain at main-path shapes
    t0 = time.perf_counter()
    _, scene = ortf.build_test_scene(
        6, material=preset_materials()["tear_glass"],
        env=make_gradient_hdr(1024, 512))
    camera = ortf.Camera.make(aspect=WIDTH / HEIGHT)
    dev = scene.device
    if dev.type != "cuda":
        fail(f"the scene was built on {dev}, not on the card")
    config = ortf.RenderConfig(width=WIDTH, height=HEIGHT,
                               max_bounce=BOUNCES)
    sched_config = config.replace(cast_backend="schedule")
    n_clusters = scene.cl_trifeat.shape[0]
    t_blk = scene.cl_trifeat.shape[2] // 4
    print(f"scene: {scene.n_triangles} triangles, {n_clusters} clusters of "
          f"{t_blk}, env {tuple(scene.hdr_map.shape[:2])}, built in "
          f"{time.perf_counter() - t0:.2f} s")

    # the first ray tile of the frame, in the renderer's 32x32-block order
    n_pix = WIDTH * HEIGHT
    pixel_id = torch.arange(n_pix, device=dev).reshape(
        HEIGHT // 32, 32, WIDTH // 32, 32).permute(0, 2, 1, 3).reshape(-1)
    pixel_id = pixel_id[:RAYS_PER_TILE]
    u = ((pixel_id % WIDTH).float() + 0.5) / WIDTH
    v = ((pixel_id // WIDTH).float() + 0.5) / HEIGHT
    origin, direction = camera.generate_rays(u, v)
    ones = torch.ones(RAYS_PER_TILE, dtype=torch.bool, device=dev)

    captured = {}
    real_pair = integrator.closest_hit_pair

    def capture_pair(scene_, *rest):
        captured.setdefault("pair", rest[:6])   # the rays, not the config
        return real_pair(scene_, *rest)

    integrator.closest_hit_pair = capture_pair
    try:
        with torch.no_grad():
            integrator.trace_radiance(scene, origin, direction, pixel_id, 1,
                                      config.replace(max_bounce=1))
    finally:
        integrator.closest_hit_pair = real_pair
    o_any, d_any, m_any, o_cls, d_cls, m_cls = captured["pair"]
    w = o_any.shape[0]
    cases = {
        "primary": (origin, direction, ones, torch.zeros_like(ones)),
        "pair": (torch.cat([o_any, o_cls]), torch.cat([d_any, d_cls]),
                 torch.cat([m_any, m_cls]),
                 torch.cat([torch.ones_like(m_any), torch.zeros_like(m_cls)])),
    }
    slot2tri = scene.cl_slot2tri.long()
    k1 = {}
    for name, rays in cases.items():
        kargs, _ = sw.sweep_inputs(scene, *rays)
        nspan, spans, best0 = kargs[0], kargs[1], kargs[4]
        got = sw.sweep(*kargs[:4], best0.clone(), kargs[5])
        want = sw.sweep_plain(*kargs)
        torch.cuda.synchronize()
        err, agree, tri_agree = compare_records(got, want, slot2tri,
                                                f"K1 {name}")
        # the work these inputs need: the spans the walk visits before
        # its stop test ends it (counted by the plain version's walk)
        visited = sw.sweep_plain.visited
        walked = torch.arange(spans.shape[1], device=dev)[None, :] \
            < visited[:, None]
        bound = span_bound(
            int(visited.sum()), int(torch.unique(spans[walked]).numel()),
            t_blk, best0.shape[0],
            index_bytes=nspan.numel() * 4 + 2 * int(visited.sum()) * 4)
        ms = cuda_ms(lambda: sw.sweep(*kargs[:4], best0.clone(), kargs[5]))
        plain_ms = cuda_ms(lambda: sw.sweep_plain(*kargs), repeats=2)
        clone_ms = cuda_ms(lambda: best0.clone())
        k1[name] = dict(err=err, ms=ms, plain_ms=plain_ms, bound=bound)
        print(f"K1 sweep {name}: {best0.shape[0]} rays "
              f"({int(rays[2].sum())} live), {spans.shape[0]} tiles, "
              f"spans/tile overlapped mean {nspan.float().mean().item():.1f}"
              f" max {int(nspan.max())}, visited {int(visited.sum())} | "
              f"hit/miss agree {agree:.6f}, tri agree {tri_agree:.6f}, "
              f"max |dt| {err:.3g} | kernel {ms:.3f} ms (incl. "
              f"{clone_ms:.3f} ms record copy), plain {plain_ms:.3f} ms, "
              f"bound {bound[0]:.4f} ms by {bound[1]} (operations "
              f"{bound[2]:.4f} ms, bytes {bound[3]:.4f} ms)")
    if w != RAYS_PER_TILE:
        print(f"note: the first bounce's pair holds {w} shadow + "
              f"{o_cls.shape[0]} bounce rays")

    # 4. K2 vs plain at the schedule path's shapes: every round of the
    # primary cast and of the first bounce's bounce cast is compared; the
    # first round and the round with the most elected spans are timed
    real_ci = sched.cluster_intersect

    def all_rounds(o, d, mask):
        seen = []

        def capture(rayfeat, best, spans, nspan, trifeat):
            seen.append((rayfeat, best.clone(), spans, nspan, trifeat))
            return real_ci(rayfeat, best, spans, nspan, trifeat)

        sched.cluster_intersect = capture
        try:
            with torch.no_grad():
                sched.closest_hit_scheduled(scene, o, d, sched_config,
                                            mask=mask)
        finally:
            sched.cluster_intersect = real_ci
        return seen

    def elected_spans(spans, nspan):
        return (torch.arange(spans.shape[1], device=dev)[None, :]
                < nspan[:, None]) & (spans < n_clusters)

    k2 = {}
    for cast, rays in (("primary", (origin, direction, ones)),
                       ("bounce", (o_cls, d_cls, m_cls))):
        rounds = all_rounds(*rays)
        err = 0.0
        for i, (rayfeat, best0, spans, nspan, trifeat) in enumerate(rounds):
            got = ci.cluster_intersect(rayfeat, best0.clone(), spans, nspan,
                                       trifeat)
            want = ci.cluster_intersect_plain(rayfeat, best0, spans, nspan,
                                              trifeat)
            torch.cuda.synchronize()
            e, agree, tri_agree = compare_records(
                got, want, slot2tri, f"K2 {cast} round {i}")
            err = max(err, e)
        print(f"K2 cluster_intersect {cast}: {len(rounds)} rounds, each "
              f"held against the plain version | max |dt| {err:.3g}")
        n_elected = [int(elected_spans(r[2], r[3]).sum()) for r in rounds]
        busiest = max(range(len(rounds)), key=n_elected.__getitem__)
        for i in sorted({0, busiest}):
            rayfeat, best0, spans, nspan, trifeat = rounds[i]
            elected = elected_spans(spans, nspan)
            visits = n_elected[i] * (sched.RAY_TILE // 128)
            bound = span_bound(
                visits, int(torch.unique(spans[elected]).numel()), t_blk,
                best0.shape[0],
                index_bytes=(spans.numel() + nspan.numel()) * 4)
            ms = cuda_ms(lambda: ci.cluster_intersect(
                rayfeat, best0.clone(), spans, nspan, trifeat))
            plain_ms = cuda_ms(lambda: ci.cluster_intersect_plain(
                rayfeat, best0, spans, nspan, trifeat), repeats=2)
            name = f"{cast} round {i}"
            k2[name] = dict(err=err, ms=ms, plain_ms=plain_ms, bound=bound,
                            visits=visits)
            print(f"K2 cluster_intersect {name} of {len(rounds)}: "
                  f"{best0.shape[0]} rays ({int(rays[2].sum())} live), "
                  f"{spans.shape[0]} tiles of {sched.RAY_TILE}, K "
                  f"{spans.shape[1]}, elected spans {visits} (max "
                  f"{int(nspan.max())} per tile) | kernel {ms:.3f} ms "
                  f"(incl. record copy), plain {plain_ms:.3f} ms, bound "
                  f"{bound[0]:.4f} ms by {bound[1]} (operations "
                  f"{bound[2]:.4f} ms, bytes {bound[3]:.4f} ms)")
    # the kernels line reports the call with the most work
    k2_main = max(k2, key=lambda name: (k2[name]["visits"], k2[name]["ms"]))

    # 5. the default render (sweep tracer)
    rays = WIDTH * HEIGHT * config.spp_per_pass * (1 + 2 * BOUNCES)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sw.sweep.launches = 0
    sw.sweep_plain.calls = 0
    ci.cluster_intersect.launches = 0
    ci.cluster_intersect_plain.calls = 0
    img, pass_s = timed_passes(ortf, scene, camera, config, 3)
    k1_launches, plain_calls = sw.sweep.launches, sw.sweep_plain.calls
    timed = pass_s[1:]
    mean_s = sum(timed) / len(timed)
    peak = torch.cuda.max_memory_allocated()
    mean = check_image("render", img)
    print(f"render: sweep tracer, {WIDTH}x{HEIGHT}, {BOUNCES} bounces, 3 "
          f"passes | warm-up {pass_s[0]:.3f} s, timed "
          f"{', '.join(f'{s:.3f}' for s in timed)} s, mean {mean_s:.3f} s | "
          f"{rays / mean_s:,.0f} rays/s | peak {peak / 2**30:.2f} GiB | K1 "
          f"launches {k1_launches} ({k1_launches // 3} per pass), plain "
          f"calls {plain_calls} | image mean {mean:.4f}")
    if k1_launches <= 0:
        fail("the render launched no sweep kernel")
    if plain_calls != 0:
        fail(f"the render called the plain sweep {plain_calls} times")
    if ci.cluster_intersect.launches or ci.cluster_intersect_plain.calls:
        fail("the sweep render reached the cluster-intersect kernel")
    if args.png:
        from opengl_ray_tracing_framework_tpu_torch.utils.image import (
            save_render)
        save_render(args.png, img.cpu().numpy())

    # 6. card vs CPU, default path
    small = config.replace(width=128, height=64)
    cam_small = ortf.Camera.make(aspect=2.0)
    scene_cpu, cam_cpu = scene.to("cpu"), cam_small.to("cpu")
    t0 = time.perf_counter()
    sweep_small = ortf.render_radiance(scene, cam_small, small, spp=2)
    torch.cuda.synchronize()
    gpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_img = ortf.render_radiance(scene_cpu, cam_cpu, small, spp=2)
    cpu_s = time.perf_counter() - t0
    compare_images("parity card vs cpu", sweep_small, cpu_img,
                   f"128x64, 2 spp, {BOUNCES} bounces | card {gpu_s:.2f} s, "
                   f"cpu {cpu_s:.2f} s | ")

    # 7. the schedule render
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sw.sweep.launches = 0
    sw.sweep_plain.calls = 0
    ci.cluster_intersect.launches = 0
    ci.cluster_intersect_plain.calls = 0
    stats = sched.closest_hit_scheduled
    stats.rounds = stats.casts = stats.max_rounds = 0
    img, pass_s = timed_passes(ortf, scene, camera, sched_config, 2)
    k2_launches = ci.cluster_intersect.launches
    peak = torch.cuda.max_memory_allocated()
    mean = check_image("schedule render", img)
    print(f"schedule render: {WIDTH}x{HEIGHT}, {BOUNCES} bounces, 2 passes "
          f"| warm-up {pass_s[0]:.3f} s, timed {pass_s[1]:.3f} s | "
          f"{rays / pass_s[1]:,.0f} rays/s | peak {peak / 2**30:.2f} GiB | "
          f"K2 launches {k2_launches} ({k2_launches // 2} per pass), plain "
          f"calls {ci.cluster_intersect_plain.calls}, K1 launches "
          f"{sw.sweep.launches} | casts {stats.casts}, rounds per cast mean "
          f"{stats.rounds / max(stats.casts, 1):.2f} max {stats.max_rounds} "
          f"| image mean {mean:.4f}")
    if k2_launches <= 0:
        fail("the schedule render launched no cluster-intersect kernel")
    if k2_launches != stats.rounds:
        fail(f"{k2_launches} K2 launches in {stats.rounds} rounds")
    if ci.cluster_intersect_plain.calls != 0:
        fail("the schedule render called the plain cluster intersect")
    if sw.sweep.launches or sw.sweep_plain.calls:
        fail("the schedule render reached the sweep tracer")
    sched_small = ortf.render_radiance(
        scene, cam_small, small.replace(cast_backend="schedule"), spp=2)
    compare_images("schedule vs sweep", sched_small, sweep_small,
                   "128x64, 2 spp, on the card | ")

    # 8. BRDF mode
    brdf = config.replace(enable_bsdf=False)
    img, pass_s = timed_passes(ortf, scene, camera, brdf, 1)
    mean = check_image("BRDF render", img)
    print(f"BRDF render: sweep tracer, {WIDTH}x{HEIGHT}, {BOUNCES} bounces "
          f"| one pass (no warm-up) {pass_s[0]:.3f} s | image mean "
          f"{mean:.4f}")
    brdf_small = small.replace(enable_bsdf=False)
    compare_images(
        "BRDF card vs cpu",
        ortf.render_radiance(scene, cam_small, brdf_small, spp=2),
        ortf.render_radiance(scene_cpu, cam_cpu, brdf_small, spp=2),
        "128x64, 2 spp | ")

    # 9. the kernel-free tracers against the sweep image
    sweep_1spp = ortf.render_radiance(scene, cam_small, small, spp=1)
    for label, kw in (("bvh", dict(cast_backend="bvh")),
                      ("brute", dict(use_bvh=False))):
        t0 = time.perf_counter()
        got = ortf.render_radiance(scene, cam_small, small.replace(**kw),
                                   spp=1)
        torch.cuda.synchronize()
        compare_images(f"{label} vs sweep", got, sweep_1spp,
                       f"128x64, 1 spp, {time.perf_counter() - t0:.2f} s | ")

    if args.profile:
        profile_pass("sweep", ortf, scene, camera, config)
        profile_pass("schedule", ortf, scene, camera, sched_config)

    def entry(name, replaces, launches, cases, main_case):
        c = cases[main_case]
        return {
            "name": name, "route": "cuda",
            "source": f"{PORT}/csrc/{name}.cu", "replaces": replaces,
            "launches": launches,
            "max_abs_err": max(x["err"] for x in cases.values()),
            "ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound"][0], "bound_by": c["bound"][1],
            "library_ms": None}

    print(json.dumps({"kernels": [
        entry("sweep", "opengl_ray_tracing_framework_tpu/ops/sweep.py:104",
              k1_launches, k1, "pair"),
        entry("cluster_intersect",
              "opengl_ray_tracing_framework_tpu/ops/intersect_pallas.py:66",
              k2_launches, k2, k2_main),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
