#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py [--png PATH]

Run from the repository root. It fails (exit code != 0, no result line)
when torch sees no CUDA device, and when anything below fails:

1. device: the card's name and power limit (nvidia-smi);
2. build: nvcc compiles csrc/sweep.cu (the span-sweep kernel);
3. kernel vs plain version on the card, at the main path's shapes: the
   81,922-triangle procedural scene (loong-100k's scale), a 65,536-ray
   primary cast and the first bounce's merged NEE-shadow + bounce cast of
   the same rays, each held against sweep_plain on the same inputs and
   timed with CUDA events;
4. the render: render_progressive at 1024x512, 8 bounces, BSDF, HDR
   environment + MIS, tear-glass sphere, 1024x512 procedural HDR; one
   warm-up pass and three timed passes, each fenced by a host copy; the
   kernel must be launched and the plain version never called;
5. device vs CPU: render_radiance at 128x64, 2 spp, 8 bounces, on the card
   (kernel) and on the CPU (plain version), held to the TPU lane's image
   criterion (tests/test_tpu.py:57-60).

It prints one line of numbers per phase, then a JSON line describing the
kernel, then {"ok": true, "device": {...}} as the last line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

WIDTH, HEIGHT, BOUNCES = 1024, 512, 8
RAYS_PER_TILE = 65536
REPEATS = 5


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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--png", help="also save the rendered image here")
    args = parser.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        return 1

    import numpy as np
    import opengl_ray_tracing_framework_tpu_torch as ortf
    from opengl_ray_tracing_framework_tpu_torch.models.hdr import (
        make_gradient_hdr)
    from opengl_ray_tracing_framework_tpu_torch.models.material import (
        preset_materials)
    from opengl_ray_tracing_framework_tpu_torch.ops import integrator
    from opengl_ray_tracing_framework_tpu_torch.ops import sweep as sw
    from opengl_ray_tracing_framework_tpu_torch.utils import nvcc

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    print(f"device: torch {torch.__version__}, cuda {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    # 2. build
    path, build_s, log = nvcc.build("sweep")
    regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
    print(f"build: sweep.cu -> {path.name} in {build_s:.2f} s"
          + (f" | ptxas: {regs[-1]}" if regs else " (cached)"))

    # 3. kernel vs plain at main-path shapes
    t0 = time.perf_counter()
    _, scene = ortf.build_test_scene(
        6, material=preset_materials()["tear_glass"],
        env=make_gradient_hdr(1024, 512), device=dev)
    camera = ortf.Camera.make(aspect=WIDTH / HEIGHT, device=dev)
    config = ortf.RenderConfig(width=WIDTH, height=HEIGHT,
                               max_bounce=BOUNCES)
    print(f"scene: {scene.n_triangles} triangles, "
          f"{scene.cl_trifeat.shape[0]} clusters of "
          f"{scene.cl_trifeat.shape[2] // 4}, env "
          f"{tuple(scene.hdr_map.shape[:2])}, built in "
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

    def capture_pair(scene_, *args):
        captured.setdefault("pair", args[:6])   # the rays, not the config
        return real_pair(scene_, *args)

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
    results = {}
    for name, rays in cases.items():
        kargs, _ = sw.sweep_inputs(scene, *rays)
        best0 = kargs[4]
        got = sw.sweep(*kargs[:4], best0.clone(), kargs[5])
        want = sw.sweep_plain(*kargs)
        torch.cuda.synchronize()
        err, agree, tri_agree = compare_records(got, want, slot2tri, name)
        ms = cuda_ms(lambda: sw.sweep(*kargs[:4], best0.clone(), kargs[5]))
        plain_ms = cuda_ms(lambda: sw.sweep_plain(*kargs), repeats=2)
        clone_ms = cuda_ms(lambda: best0.clone())
        results[name] = dict(rays=best0.shape[0], err=err, ms=ms,
                             plain_ms=plain_ms)
        spans = kargs[0].float()
        print(f"kernel {name}: {best0.shape[0]} rays ({int(rays[2].sum())} "
              f"live), {spans.shape[0]} tiles, spans/tile mean "
              f"{spans.mean().item():.1f} max {int(spans.max().item())} | "
              f"hit/miss agree {agree:.6f}, tri agree {tri_agree:.6f}, "
              f"max |dt| {err:.3g} | kernel {ms:.3f} ms (incl. "
              f"{clone_ms:.3f} ms record copy), plain {plain_ms:.3f} ms")
    if w != RAYS_PER_TILE:
        print(f"note: the first bounce's pair holds {w} shadow + "
              f"{o_cls.shape[0]} bounce rays")

    # 4. the render
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sw.sweep.launches = 0
    sw.sweep_plain.calls = 0
    stamps = []

    def fence(state, i):
        float(state.accum[0, 0, 0])   # host copy: the pass has finished
        stamps.append(time.perf_counter())

    stamps.append(time.perf_counter())
    image, state = ortf.render_progressive(
        scene, camera, config, n_iterations=4, callback=fence,
        rays_per_tile=RAYS_PER_TILE)
    launches, plain_calls = sw.sweep.launches, sw.sweep_plain.calls
    pass_s = [b - a for a, b in zip(stamps, stamps[1:])]
    timed = pass_s[1:]
    mean_s = sum(timed) / len(timed)
    rays = WIDTH * HEIGHT * config.spp_per_pass * (1 + 2 * BOUNCES)
    peak = torch.cuda.max_memory_allocated()
    img = image.float()
    finite = bool(torch.isfinite(img).all())
    mean = img.mean().item()
    print(f"render: {WIDTH}x{HEIGHT}, {BOUNCES} bounces, 4 passes | warm-up "
          f"{pass_s[0]:.3f} s, timed {', '.join(f'{s:.3f}' for s in timed)} "
          f"s, mean {mean_s:.3f} s | {rays / mean_s:,.0f} rays/s | peak "
          f"{peak / 2**30:.2f} GiB | kernel launches {launches}, plain calls "
          f"{plain_calls} | image finite {finite}, mean {mean:.4f}")
    if launches <= 0:
        fail("the render launched no sweep kernel")
    if plain_calls != 0:
        fail(f"the render called the plain sweep {plain_calls} times")
    if not finite or not mean > 0:
        fail("the rendered image is not finite with a positive mean")
    if args.png:
        from opengl_ray_tracing_framework_tpu_torch.utils.image import (
            save_render)
        save_render(args.png, img.cpu().numpy())

    # 5. device vs CPU
    small = config.replace(width=128, height=64)
    cam_small = ortf.Camera.make(aspect=2.0, device=dev)
    t0 = time.perf_counter()
    gpu_img = ortf.render_radiance(scene, cam_small, small, spp=2)
    torch.cuda.synchronize()
    gpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_img = ortf.render_radiance(scene.to("cpu"), cam_small.to("cpu"),
                                   small, spp=2)
    cpu_s = time.perf_counter() - t0
    g, c = gpu_img.cpu().numpy(), cpu_img.numpy()
    rel_mean = abs(g.mean() - c.mean()) / max(c.mean(), 1e-6)
    mismatch = float((~np.isclose(g, c, atol=1e-3, rtol=1e-3)).mean())
    print(f"parity: 128x64, 2 spp, {BOUNCES} bounces | card {gpu_s:.2f} s, "
          f"cpu {cpu_s:.2f} s | mean card {g.mean():.6f} cpu {c.mean():.6f} "
          f"(rel {rel_mean:.2e}) | values off at 1e-3: {mismatch:.2e}")
    if not np.isfinite(g).all() or rel_mean >= 1e-4 or mismatch >= 1e-3:
        fail("card and CPU images disagree")

    pair = results["pair"]
    print(json.dumps({"kernels": [{
        "name": "sweep",
        "route": "cuda",
        "source": "opengl_ray_tracing_framework_tpu_torch/csrc/sweep.cu",
        "replaces": "opengl_ray_tracing_framework_tpu/ops/sweep.py:104",
        "launches": launches,
        "max_abs_err": max(r["err"] for r in results.values()),
        "ms": pair["ms"],
        "plain_ms": pair["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
