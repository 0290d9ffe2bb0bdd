"""Cast dispatch and the batched BVH traversal (PyTorch port of
opengl_ray_tracing_framework_tpu.ops.traverse).

closest_hit sends a cast to the tracer the config names: the brute-force
oracle (use_bvh=False), the cluster span sweep (cast_backend="sweep", the
default, ops/sweep.py), the vote tracer (cast_backend="schedule",
ops/schedule.py) or bvh_closest_hit below (cast_backend="bvh"). All four
return the exact closest hit; which of two hits at exactly equal t wins
may differ between them.

bvh_closest_hit is the reference's hitBVH + hitArray (glsl:320-392) for a
whole batch of rays per step: every ray keeps its stack as a row of an
(R, D) tensor, node and triangle fetches are batched gathers, a leaf's
triangles are intersected in one ray_triangle call, and rays that finish
idle until the batch drains. The JAX module's lax.while_loop is a Python
loop with one host read per step.

Traversal is detached: the discrete winner (tri, inside) has no useful
derivative, so inputs and the returned t carry no autograd history, and
shading recomputes the hit distance from the winning triangle
(intersect.surface_attributes) for the continuous quantities.
"""

from __future__ import annotations

import torch

from ..utils import timing
from .intersect import (
    INF,
    Hit,
    closest_hit_brute,
    ray_aabb_visit,
    ray_triangle,
)
from .schedule import closest_hit_scheduled
from .sweep import closest_hit_swept, closest_hit_swept_pair


def bvh_closest_hit(scene, origin, direction, stack_depth: int = 64,
                    leaf_size: int = 8) -> Hit:
    """Closest hit of each ray against the scene BVH: ordered descent into
    the nearer child, a child visited iff its slab interval overlaps
    [0, inf) and its entry distance is below the ray's best t."""
    r = origin.shape[0]
    dev = origin.device
    small = torch.abs(direction) < 1e-12
    signed_eps = torch.where(direction < 0, -1e-12, 1e-12).to(direction.dtype)
    inv_dir = 1.0 / torch.where(small, signed_eps, direction)

    left, right = scene.bvh_left.long(), scene.bvh_right.long()
    count, first = scene.bvh_count.long(), scene.bvh_first.long()
    bmin, bmax = scene.bvh_min, scene.bvh_max
    n_nodes = left.shape[0]

    stack = torch.zeros((r, stack_depth), dtype=torch.int64, device=dev)
    stack[:, 0] = 1   # the root is node 1 (Scene.h:189-196)
    sp = torch.ones(r, dtype=torch.int64, device=dev)
    best_t = torch.full((r,), INF, dtype=torch.float32, device=dev)
    best_tri = torch.full((r,), -1, dtype=torch.int64, device=dev)
    best_in = torch.zeros(r, dtype=torch.bool, device=dev)

    rows = torch.arange(r, device=dev)
    lane = torch.arange(leaf_size, device=dev)[None, :]
    o, d = origin[:, None, :], direction[:, None, :]

    # a correct traversal visits each node at most once
    max_steps = 4 * n_nodes + 64
    steps = 0
    while steps < max_steps and bool((sp > 0).any()):
        active = sp > 0
        # a pop above the stack (its push was dropped) visits the dummy
        # node 0, a no-op, as the JAX module's out-of-range read does
        node = stack[rows, torch.clamp(sp - 1, 0, stack_depth - 1)]
        node = torch.where(active & (sp <= stack_depth), node, 0)
        n_count, n_first = count[node], first[node]
        n_left, n_right = left[node], right[node]
        is_leaf = active & (n_count > 0)
        is_internal = active & (n_count <= 0)

        # leaf: intersect up to leaf_size triangles
        tri_valid = is_leaf[:, None] & (lane < n_count[:, None])
        safe_ids = torch.clamp(n_first[:, None] + lane, 0,
                               scene.n_triangles - 1)
        hit, t, inside = ray_triangle(o, d, scene.p1[safe_ids],
                                      scene.p2[safe_ids], scene.p3[safe_ids])
        t = torch.where(hit & tri_valid, t, INF)
        t_leaf, k = torch.min(t, dim=1)   # the first minimum wins a tie
        closer = is_leaf & (t_leaf < best_t)
        best_t = torch.where(closer, t_leaf, best_t)
        best_tri = torch.where(closer, safe_ids[rows, k], best_tri)
        best_in = torch.where(closer, inside[rows, k], best_in)

        # internal: slab-test both children, push the far one first so the
        # near one pops first; a box whose conservative entry distance is
        # beyond the best hit cannot improve it
        v1, d1 = ray_aabb_visit(origin, inv_dir, bmin[n_left], bmax[n_left])
        v2, d2 = ray_aabb_visit(origin, inv_dir, bmin[n_right], bmax[n_right])
        hit1 = is_internal & (n_left > 0) & v1 & (d1 < best_t)
        hit2 = is_internal & (n_right > 0) & v2 & (d2 < best_t)
        both = hit1 & hit2
        near_is_left = d1 < d2
        far_node = torch.where(near_is_left, n_right, n_left)
        near_node = torch.where(near_is_left, n_left, n_right)
        only = torch.where(hit1, n_left, n_right)

        sp = torch.where(active, sp - 1, sp)   # pop the current node
        # a push beyond stack_depth is dropped, as in the JAX module
        push1 = both | (hit1 ^ hit2)
        at = torch.clamp(sp, max=stack_depth - 1)
        stack[rows, at] = torch.where(
            push1 & (sp < stack_depth),
            torch.where(both, far_node, only), stack[rows, at])
        sp = sp + push1.to(torch.int64)
        at = torch.clamp(sp, max=stack_depth - 1)
        stack[rows, at] = torch.where(both & (sp < stack_depth), near_node,
                                      stack[rows, at])
        sp = sp + both.to(torch.int64)
        steps += 1
    return Hit(t=best_t, tri=best_tri.to(torch.int32), inside=best_in)


def _cast(scene, origin, direction, config, mask, any_hit) -> Hit:
    if not config.use_bvh:
        return closest_hit_brute(origin, direction, scene.p1, scene.p2,
                                 scene.p3)
    if config.cast_backend == "sweep":
        return closest_hit_swept(scene, origin, direction, mask=mask,
                                 any_hit=any_hit)
    if config.cast_backend == "schedule":
        return closest_hit_scheduled(scene, origin, direction, config,
                                     mask=mask, any_hit=any_hit)
    if config.cast_backend == "bvh":
        return bvh_closest_hit(scene, origin, direction,
                               stack_depth=config.traversal_stack_depth,
                               leaf_size=config.bvh_leaf_size)
    raise ValueError(f"unknown cast_backend {config.cast_backend!r}")


def closest_hit(scene, origin, direction, config, mask=None,
                any_hit: bool = False) -> Hit:
    """Closest (or any) hit of each ray with the configured tracer.

    mask: optional (R,) bool; the cluster tracers return a miss for
    mask=False lanes, the BVH and brute-force tracers trace every lane
    (callers gate on their own mask). any_hit: occlusion semantics, a
    tracer may stop at the first hit (is_hit is then the meaningful
    field). A span rt.cast under utils/timing.py's tracing()."""
    with timing.span("rt.cast"), torch.no_grad():
        timing.count("casts")
        return _cast(scene, origin.detach(), direction.detach(), config,
                     mask, any_hit)


def closest_hit_pair(scene, o_any, d_any, m_any, o_cls, d_cls, m_cls,
                     config):
    """The integrator's per-bounce cast pair, NEE shadow (any-hit) and
    bounce (closest) rays: one merged sweep on the sweep backend, two plain
    casts on every other. Returns (hit_any, hit_cls). One span rt.cast
    either way."""
    with timing.span("rt.cast"), torch.no_grad():
        timing.count("casts")
        if config.use_bvh and config.cast_backend == "sweep":
            return closest_hit_swept_pair(
                scene, o_any.detach(), d_any.detach(), m_any,
                o_cls.detach(), d_cls.detach(), m_cls)
        return (_cast(scene, o_any.detach(), d_any.detach(), config, m_any,
                      True),
                _cast(scene, o_cls.detach(), d_cls.detach(), config, m_cls,
                      False))
