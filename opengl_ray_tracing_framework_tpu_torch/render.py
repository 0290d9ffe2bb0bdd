"""Render API: progressive accumulation and finalize (PyTorch port of
opengl_ray_tracing_framework_tpu.render).

Replaces the reference's frame loop + FBO ping-pong
(src/sources/main.cpp:165-253, src/core/Screen.h:110-155):

- `render_pass`    spp_per_pass progressive samples for every pixel,
                   traced in batches of rays_per_tile rays to bound memory,
- `RenderState`    the accumulator: running mean + sample count; the
                   reference's `(1/n) sample + ((n-1)/n) hist` (glsl:1552)
                   as `acc + (sample - acc)/n`,
- `render_progressive`  the loop with the maxIterations cap
                   (RenderSettings.h:90); an edit starts a fresh state,
- `finalize`       tone map + gamma (PASS 3, main.cpp:215-227).

Everything runs on the scene's device. render_pass and finalize are forward
only (torch.no_grad); trace_pixels is the differentiable per-batch trace
that parallel/autodiff.py builds its losses on. Under utils/timing.py's
tracing(): spans rt.pass, rt.batch (one trace_pixels batch) and
rt.accumulate.
"""

from __future__ import annotations

import dataclasses

import torch

from .models.camera import Camera
from .models.scene import SceneData
from .ops import tonemap
from .ops.integrator import trace_radiance
from .ops.sampling import rand01
from .utils import timing
from .utils.config import RenderConfig, resolve_device

BLOCK = 32  # pixel-block side: rays are traced in 32x32-block order


@dataclasses.dataclass
class RenderState:
    """Progressive accumulator."""

    accum: torch.Tensor   # (H, W, 3) float32 running mean of radiance
    n_samples: int        # the reference's camera.LoopNum


def init_render_state(config: RenderConfig, device=None) -> RenderState:
    """An empty accumulator, on the card unless a device is named."""
    device = resolve_device(device)
    return RenderState(
        accum=torch.zeros((config.height, config.width, 3),
                          dtype=torch.float32, device=device),
        n_samples=0)


def pixel_order(config: RenderConfig, row0: int, n_rows: int,
                device) -> torch.Tensor:
    """Pixel ids (int64) of rows [row0, row0 + n_rows) in traced order:
    32x32-block order when the rows tile into blocks, so each kernel tile
    of rays covers a compact image square (the GPU rasterizer's 2D order,
    which the reference gets for free), row order otherwise."""
    w = config.width
    local = torch.arange(n_rows * w, dtype=torch.int64, device=device)
    if n_rows % BLOCK == 0 and w % BLOCK == 0:
        local = local.reshape(
            n_rows // BLOCK, BLOCK, w // BLOCK, BLOCK).permute(0, 2, 1, 3) \
            .reshape(-1)
    return local + w * row0


def trace_pixels(scene: SceneData, camera: Camera, pixel_id: torch.Tensor,
                 frame: int, config: RenderConfig) -> torch.Tensor:
    """One sample of the given pixels -> (R, 3) radiance. frame is the
    1-based progressive index (camera.loopNum + 1, glsl:1325/1409).

    Differentiable: the rays are generated here, per batch, so a camera
    that requires grad sits inside the batch's own graph. The forward
    render calls it under no_grad."""
    with timing.span("rt.batch"):
        w, h = config.width, config.height
        px = (pixel_id % w).to(torch.float32)
        py = (pixel_id // w).to(torch.float32)
        if config.pixel_jitter:
            ju = rand01(pixel_id, frame, 1001)
            jv = rand01(pixel_id, frame, 1002)
        else:
            ju = jv = 0.5
        origin, direction = camera.generate_rays((px + ju) / w,
                                                 (py + jv) / h)
        return trace_radiance(scene, origin, direction, pixel_id, frame,
                              config)


def _trace_rows(scene: SceneData, camera: Camera, frame: int,
                config: RenderConfig, row0: int, n_rows: int,
                rays_per_tile: int) -> torch.Tensor:
    """One sample per pixel of rows [row0, row0 + n_rows) -> (n_rows, W, 3)
    radiance, traced in batches of rays_per_tile pixels in pixel_order.
    The RNG streams are keyed by global pixel ids, so a row's radiance is
    the same whichever block it is traced in."""
    dev = scene.device
    camera = camera.to(dev)
    pixel_id = pixel_order(config, row0, n_rows, dev)
    radiance = torch.empty((n_rows * config.width, 3), dtype=torch.float32,
                           device=dev)
    for batch in pixel_id.split(rays_per_tile):
        radiance[batch - config.width * row0] = trace_pixels(
            scene, camera, batch, frame, config)
    return radiance.reshape(n_rows, config.width, 3)


@torch.no_grad()
def render_pass(scene: SceneData, camera: Camera, state: RenderState,
                config: RenderConfig, rays_per_tile: int = 65536
                ) -> RenderState:
    """Advance the progressive render by spp_per_pass samples/pixel."""
    accum, n = state.accum, state.n_samples
    with timing.span("rt.pass"):
        for s in range(config.spp_per_pass):
            sample = _trace_rows(scene, camera, n + s + 1, config, 0,
                                 config.height, rays_per_tile)
            with timing.span("rt.accumulate"):
                accum = accum + (sample - accum) / float(n + s + 1)
    return RenderState(accum=accum, n_samples=n + config.spp_per_pass)


def render_passes(scene: SceneData, camera: Camera, state: RenderState,
                  config: RenderConfig, n_passes: int,
                  rays_per_tile: int = 65536) -> RenderState:
    """n_passes progressive passes."""
    for _ in range(n_passes):
        state = render_pass(scene, camera, state, config, rays_per_tile)
    return state


@torch.no_grad()
def finalize(state: RenderState, config: RenderConfig) -> torch.Tensor:
    """Display transform: simpleACES + gamma (tone-mapping pass)."""
    return tonemap.post_process(
        state.accum,
        enable_tone_mapping=config.enable_tone_mapping,
        enable_gamma=config.enable_gamma_correction)


def render_progressive(scene: SceneData, camera: Camera,
                       config: RenderConfig, n_iterations: int | None = None,
                       state: RenderState | None = None, callback=None,
                       rays_per_tile: int = 65536):
    """Run progressive passes up to n_iterations (default: the config's
    maxIterations cap, or 1 when it is unlimited). Returns
    (display_image, state); `callback(state, i)` runs after each pass."""
    config = config.validate()
    if state is None:
        state = init_render_state(config, scene.device)
    if n_iterations is None:
        n_iterations = config.max_iterations if config.max_iterations > 0 else 1
    for i in range(-(-n_iterations // config.spp_per_pass)):
        state = render_pass(scene, camera, state, config, rays_per_tile)
        if callback is not None:
            callback(state, i)
    return finalize(state, config), state


def render(scene: SceneData, camera: Camera, config: RenderConfig,
           spp: int = 64, rays_per_tile: int = 65536) -> torch.Tensor:
    """Convenience: render `spp` samples/pixel, return the display image."""
    image, _ = render_progressive(scene, camera, config, n_iterations=spp,
                                  rays_per_tile=rays_per_tile)
    return image


def render_radiance(scene: SceneData, camera: Camera, config: RenderConfig,
                    spp: int = 16, rays_per_tile: int = 65536
                    ) -> torch.Tensor:
    """Linear-radiance render (no tone map): `spp` samples/pixel in one
    pass — the quantity compared against oracles."""
    state = init_render_state(config, scene.device)
    return render_pass(scene, camera, state,
                       config.replace(spp_per_pass=spp), rays_per_tile).accum
