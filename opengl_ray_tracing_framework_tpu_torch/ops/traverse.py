"""Cast dispatch (PyTorch port of the dispatch half of
opengl_ray_tracing_framework_tpu.ops.traverse).

The port traces every cast with the cluster span sweep (ops/sweep.py).
The while-loop BVH tracer (bvh_closest_hit) and the brute-force backend
are not ported yet (ROADMAP Queue 1): RenderConfig(use_bvh=False) raises.

Traversal is detached: the discrete winner (tri, inside) has no useful
derivative, so inputs and the returned t carry no autograd history, and
shading recomputes the hit distance from the winning triangle
(intersect.surface_attributes) for the continuous quantities.
"""

from __future__ import annotations

import torch

from .intersect import Hit
from .sweep import closest_hit_swept, closest_hit_swept_pair


def _check(config):
    if not config.use_bvh:
        raise NotImplementedError(
            "RenderConfig(use_bvh=False) selects the brute-force / while-loop "
            "BVH tracers, not ported yet (ROADMAP Queue 1: bvh_closest_hit)")


def closest_hit(scene, origin, direction, config, mask=None,
                any_hit: bool = False) -> Hit:
    """Closest (or any) hit of each ray; mask=False lanes return a miss."""
    _check(config)
    with torch.no_grad():
        return closest_hit_swept(scene, origin.detach(), direction.detach(),
                                 mask=mask, any_hit=any_hit)


def closest_hit_pair(scene, o_any, d_any, m_any, o_cls, d_cls, m_cls,
                     config):
    """The integrator's per-bounce cast pair — NEE shadow (any-hit) and
    bounce (closest) rays — as one sweep. Returns (hit_any, hit_cls)."""
    _check(config)
    with torch.no_grad():
        return closest_hit_swept_pair(
            scene, o_any.detach(), d_any.detach(), m_any,
            o_cls.detach(), d_cls.detach(), m_cls)
