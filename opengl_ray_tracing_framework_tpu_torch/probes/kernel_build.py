"""What the kernels cost to build, load and launch, beside the host
preparation around them: the card's counterpart of exp/compile_bisect.py.

    python -m opengl_ray_tracing_framework_tpu_torch.probes.kernel_build

The TPU file bisects a compile time: it times the span-sweep kernel alone
on precomputed host preparation, apart from the preparation, one cast, one
trace_radiance tile and the whole pass. Here compiling is nvcc's work, so
`run_builds` times, per source of csrc/, a cold nvcc build into a temporary
directory (never the build cache), the load of that fresh library and its
first launch (the CUDA module load), and the steady launch. `run_ladder`
then times the TPU file's ladder on the card: sweep_inputs alone, the
sweep kernel alone on its saved inputs (no new kernel: it is
csrc/sweep.cu, at 131,072 primary rays 1,024 tiles of one CTA and about
one span each) beside its plain version on the same inputs and the bound
of the spans its walk visits, one closest cast, one any-hit cast, one
trace_radiance batch and one render_pass.
"""

from __future__ import annotations

import re
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from ..ops import cluster_intersect  # noqa: F401, registers its kernel
from ..ops import sweep as sw
from ..ops.integrator import trace_radiance
from ..render import init_render_state, pixel_order, render_pass
from ..utils import nvcc
from . import card_perf  # noqa: F401, registers its kernels
from . import gather  # noqa: F401, registers its kernel
from . import launch_overhead  # noqa: F401, registers its kernel
from . import cuda_ms, device_line, span_bound

LADDER_RAYS = 131072   # the TPU file's tile of rays


def _ptxas_summary(log: str) -> str:
    """Registers and shared memory of every kernel in an `-Xptxas -v` log."""
    used = re.findall(r"Used (\d+) registers(?:[^\n]*?(\d+) bytes smem)?",
                      log)
    return ", ".join(f"{regs} regs" + (f" {smem} B smem" if smem else "")
                     for regs, smem in used) or "no ptxas line"


def run_builds(device="cuda", steady_launches=200):
    """Per registered kernel source (utils/nvcc.py::KERNELS): cold nvcc
    seconds (all sources started together, as the smoke test builds them),
    registers and static shared memory by ptxas, milliseconds to load the
    fresh library and to make its first launch through the kernel's
    wrapper, and microseconds per steady launch by the host clock. Returns
    dict rows."""
    device = torch.device(device)
    names = sorted(nvcc.KERNELS)
    rows = []
    with tempfile.TemporaryDirectory(prefix="kernel_build_") as tmp:
        paths = {n: Path(tmp) / f"{n}.so" for n in names}
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(names)) as pool:
            built = dict(zip(names, pool.map(
                lambda n: nvcc.compile_source(n, paths[n]), names)))
        wall = time.perf_counter() - t0
        for name in names:
            fn = nvcc.KERNELS[name][1](device)
            t0 = time.perf_counter()
            with nvcc.loaded_from(name, paths[name]):
                load_ms = (time.perf_counter() - t0) * 1e3
                torch.cuda.synchronize(device)
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize(device)
                first_ms = (time.perf_counter() - t0) * 1e3
                for _ in range(20):   # warm: clocks, allocator, caches
                    fn()
                torch.cuda.synchronize(device)
                t0 = time.perf_counter()
                for _ in range(steady_launches):
                    fn()
                torch.cuda.synchronize(device)
                steady_us = (time.perf_counter() - t0) * 1e6 / steady_launches
            seconds, log = built[name]
            rows.append(dict(name=name, build_s=seconds,
                             ptxas=_ptxas_summary(log), load_ms=load_ms,
                             first_launch_ms=first_ms, steady_us=steady_us))
            print(f"kernel_build: {name}.cu cold nvcc {seconds:.2f} s | "
                  f"{_ptxas_summary(log)} | load {load_ms:.2f} ms, first "
                  f"launch {first_ms:.2f} ms, steady {steady_us:.1f} us per "
                  f"launch (wrapper included)")
        print(f"kernel_build: {len(names)} cold builds together in "
              f"{wall:.2f} s")
    return rows


def _host_s(fn, device, repeats):
    """Mean seconds of fn() by the host clock, fenced, after a warm-up."""
    fn()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(repeats):
        fn()
    torch.cuda.synchronize(device)
    return (time.perf_counter() - t0) / repeats


def run_ladder(scene, camera, config, rays=LADDER_RAYS, repeats=2):
    """The TPU file's ladder on the card, for the first `rays` primary rays
    of the frame: {step: milliseconds}."""
    device = scene.device
    with torch.no_grad():
        camera = camera.to(device)
        pixel_id = pixel_order(config, 0, config.height, device)[:rays]
        u = ((pixel_id % config.width).float() + 0.5) / config.width
        v = ((pixel_id // config.width).float() + 0.5) / config.height
        origin, direction = camera.generate_rays(u, v)
        origin = origin.contiguous()
        n = origin.shape[0]
        ones = torch.ones(n, dtype=torch.bool, device=device)
        prep = lambda: sw.sweep_inputs(scene, origin, direction, ones,
                                       torch.zeros_like(ones))
        kargs, _ = prep()
        state = init_render_state(config, device)
        plain_ms = cuda_ms(lambda: sw.sweep_plain(*kargs), repeats=2)
        # the least time of the kernel's work: the spans its walk visits
        visited = sw.sweep_plain.visited
        spans = kargs[1]
        walked = torch.arange(spans.shape[1], device=device)[None, :] \
            < visited[:, None]
        bound_ms = span_bound(
            int(visited.sum()), int(torch.unique(spans[walked]).numel()),
            kargs[5].shape[2] // 4, n,
            index_bytes=kargs[0].numel() * 4 + 2 * int(visited.sum()) * 4)[0]
        ladder = {
            "host prep only (sweep_inputs)":
                _host_s(prep, device, repeats) * 1e3,
            "sweep kernel only (saved inputs)": cuda_ms(
                lambda: sw.sweep(*kargs[:4], kargs[4].clone(), kargs[5]),
                repeats=5),
            "plain sweep only (saved inputs)": plain_ms,
            "bound of the sweep kernel's work": bound_ms,
            "swept closest (1 cast)": _host_s(
                lambda: sw.closest_hit_swept(scene, origin, direction),
                device, repeats) * 1e3,
            "swept any-hit (1 cast)": _host_s(
                lambda: sw.closest_hit_swept(scene, origin, direction,
                                             any_hit=True),
                device, repeats) * 1e3,
            "trace_radiance (1 batch)": _host_s(
                lambda: trace_radiance(scene, origin, direction, pixel_id, 1,
                                       config), device, 1) * 1e3,
            "render_pass (full frame)": _host_s(
                lambda: render_pass(scene, camera, state, config,
                                    rays_per_tile=rays), device, 1) * 1e3,
        }
    for step, ms in ladder.items():
        print(f"kernel_build: {n} rays, {step:34s} {ms:10.3f} ms")
    return ladder


if __name__ == "__main__":
    from .. import Camera, RenderConfig, build_test_scene
    from ..models.hdr import make_gradient_hdr
    from ..models.material import preset_materials

    print(device_line())
    run_builds()
    _, smoke_scene = build_test_scene(
        6, material=preset_materials()["tear_glass"],
        env=make_gradient_hdr(1024, 512))
    run_ladder(smoke_scene, Camera.make(aspect=2.0),
               RenderConfig(width=1024, height=512, max_bounce=8))
