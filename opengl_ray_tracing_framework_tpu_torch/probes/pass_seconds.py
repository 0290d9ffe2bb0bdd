"""Seconds of the three timed paths of the smoke frame, and nothing else:
a render pass with the sweep tracer, one with the schedule tracer, and one
material_grad step, at 1024x512, 8 bounces, 65,536 rays per batch.

    python -m opengl_ray_tracing_framework_tpu_torch.probes.pass_seconds

The passes are host-bound, so their seconds follow the machine more than
the code: two trees of the repository are compared only inside one call on
one card, in turns (parent, change, change, parent), each run from its own
tree's root. This module uses only entry points every tree of the port
has, so a copy of it runs in an older tree too.
"""

from __future__ import annotations

import time

import torch

from .. import Camera, RenderConfig, build_test_scene, render_progressive
from ..models.hdr import make_gradient_hdr
from ..models.material import preset_materials
from ..parallel import autodiff
from . import device_line

WIDTH, HEIGHT, BOUNCES, RAYS_PER_TILE = 1024, 512, 8, 65536


def _passes(scene, camera, config, n_passes):
    """Seconds of each of n_passes progressive passes, each fenced by a
    host copy, and the peak bytes allocated over them."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stamps = [time.perf_counter()]

    def fence(state, i):
        float(state.accum[0, 0, 0])
        stamps.append(time.perf_counter())

    render_progressive(scene, camera, config, n_iterations=n_passes,
                       callback=fence, rays_per_tile=RAYS_PER_TILE)
    return ([b - a for a, b in zip(stamps, stamps[1:])],
            torch.cuda.max_memory_allocated())


def run(label="", passes=3):
    """Print and return {path: (seconds of the timed runs, peak GiB)}; the
    first run of each path is a warm-up and is left out."""
    _, scene = build_test_scene(
        6, material=preset_materials()["tear_glass"],
        env=make_gradient_hdr(1024, 512))
    camera = Camera.make(aspect=WIDTH / HEIGHT)
    config = RenderConfig(width=WIDTH, height=HEIGHT, max_bounce=BOUNCES)
    out = {}
    for path, cfg in (("sweep pass", config),
                      ("schedule pass",
                       config.replace(cast_backend="schedule"))):
        seconds, peak = _passes(scene, camera, cfg, passes)
        out[path] = (seconds[1:], peak / 2**30)
    target = torch.zeros((HEIGHT, WIDTH, 3), device=scene.device)
    seconds = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(passes):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, grads = autodiff.material_grad(scene, camera, target, config, spp=1,
                                          rays_per_tile=RAYS_PER_TILE)
        [g.cpu() for g in grads.mat if g is not None]   # the fence
        seconds.append(time.perf_counter() - t0)
    out["material_grad step"] = (seconds[1:],
                                 torch.cuda.max_memory_allocated() / 2**30)
    for path, (secs, peak) in out.items():
        print(f"pass_seconds{label}: {path}: "
              f"{', '.join(f'{s:.3f}' for s in secs)} s | peak {peak:.2f} GiB")
    return out


if __name__ == "__main__":
    import sys
    print(device_line())
    run(label=f" [{sys.argv[1]}]" if len(sys.argv) > 1 else "")
