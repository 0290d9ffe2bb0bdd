"""Render configuration of the PyTorch port.

The semantic fields of opengl_ray_tracing_framework_tpu.utils.config
.RenderConfig (the reference's RenderSettings.h:8-90 surface). The JAX
package's TPU knobs (Pallas backend and interpret switches, sweep tile /
supertile / prefetch depth, MXU precision, compaction buckets, gradient
remat) have no meaning here and are not carried: the traversal kernels
fix their own tile, and compaction uses dynamic shapes. The JAX pair
use_pallas / pallas_backend is one field here, cast_backend.
"""

from __future__ import annotations

import dataclasses

import torch

CAST_BACKENDS = ("sweep", "schedule", "bvh")


def default_device() -> torch.device:
    """The device every constructor and entry point of the port uses when
    the caller names none: the card. A machine without one gets torch's own
    error; callers that want the CPU (the tests) say device="cpu"."""
    return torch.device("cuda")


def resolve_device(device) -> torch.device:
    return default_device() if device is None else torch.device(device)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render settings. Defaults mirror the reference
    (RenderSettings.h:8-12, 81-90)."""

    width: int = 1024
    height: int = 512
    # RENDER_SCALE (RenderSettings.h:11): applied once at construction,
    # width/height are rewritten to the scaled values.
    render_scale: float = 1.0
    max_bounce: int = 8
    # Progressive-iteration cap; -1 means unlimited (RenderSettings.h:90).
    max_iterations: int = 3000

    enable_env_map: bool = True
    enable_mis: bool = True
    # False selects the legacy 3-lobe BRDF integrator.
    enable_bsdf: bool = True
    enable_tone_mapping: bool = True
    enable_gamma_correction: bool = True

    # GL-faithful bilinear filtering of the in-loop environment fetches
    # (the default fetches nearest texels from the fused env_fetch table).
    env_bilinear: bool = False

    spp_per_pass: int = 1
    pixel_jitter: bool = False

    # False selects the brute-force oracle tracer (every ray against every
    # triangle), whatever cast_backend says.
    use_bvh: bool = True
    # The tracer of every cast when use_bvh is on: "sweep" (cluster span
    # sweep, ops/sweep.py), "schedule" (per-tile cluster vote + dense
    # cluster intersect, ops/schedule.py) or "bvh" (batched stack
    # traversal of the BVH, ops/traverse.py; the JAX package's
    # use_pallas=False).
    cast_backend: str = "sweep"
    # schedule backend: clusters a ray tile elects per round.
    sched_topk: int = 8
    # bvh backend: per-ray stack entries, and the leaf width the BVH was
    # built with (models/bvh.py).
    traversal_stack_depth: int = 64
    bvh_leaf_size: int = 8

    def __post_init__(self):
        if self.render_scale != 1.0:
            if self.render_scale <= 0:
                raise ValueError(
                    f"render_scale must be > 0, got {self.render_scale}")
            object.__setattr__(
                self, "width", max(1, int(round(self.width
                                                * self.render_scale))))
            object.__setattr__(
                self, "height", max(1, int(round(self.height
                                                 * self.render_scale))))
            object.__setattr__(self, "render_scale", 1.0)

    def validate(self) -> "RenderConfig":
        if self.width <= 0 or self.height <= 0:
            raise ValueError(f"bad image size {self.width}x{self.height}")
        if self.max_bounce < 1:
            raise ValueError("max_bounce must be >= 1")
        if self.spp_per_pass < 1:
            raise ValueError("spp_per_pass must be >= 1")
        if self.cast_backend not in CAST_BACKENDS:
            raise ValueError(
                f"cast_backend must be one of {CAST_BACKENDS}, got "
                f"{self.cast_backend!r}")
        if self.sched_topk < 1:
            raise ValueError("sched_topk must be >= 1")
        return self

    @property
    def n_pixels(self) -> int:
        return self.width * self.height

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)
