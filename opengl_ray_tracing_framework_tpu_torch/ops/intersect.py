"""Ray-primitive intersection (PyTorch port of
opengl_ray_tracing_framework_tpu.ops.intersect).

- ray/triangle plane + inside test via cross products   (hitTriangle, glsl:241-299)
- ray/AABB slab test                                    (hitAABB,     glsl:303-316)
- brute-force closest hit over the whole soup           (hitArray,    glsl:320-334)

Traversal returns only (t, triangle index, inside flag); shading
attributes are recomputed from the winning triangle id
(surface_attributes), which separates the discrete winner from the
continuous, differentiable quantities. closest_hit_brute is the oracle the
other tracers are tested against, and the tracer of use_bvh=False.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .sampling import _cross, _dot

INF = 114514.0          # the reference's sentinel "infinite" distance (glsl:10)
T_MIN = 0.0005          # minimum hit distance (glsl:268)
PARALLEL_EPS = 1e-5     # ray-parallel-to-plane epsilon (glsl:262)


class Hit(NamedTuple):
    """Per-ray closest-hit record (all tensors share the ray batch shape)."""

    t: torch.Tensor       # distance to hit (INF when miss)
    tri: torch.Tensor     # int32 winning triangle index (-1 when miss)
    inside: torch.Tensor  # bool, ray hit the backface (glsl:256-259)

    @property
    def is_hit(self):
        return self.tri >= 0


def ray_triangle(origin, direction, p1, p2, p3):
    """Intersect rays with triangles, broadcasting over leading dims.

    Returns (hit_mask, t, inside): t is the plane distance minus the
    reference's 1e-5 pullback (glsl:284), INF where missed; inside means
    the geometric normal faced away from the ray (glsl:256-259).
    """
    e1 = p2 - p1
    e2 = p3 - p1
    n = _cross(e1, e2)

    ndotd = _dot(n, direction)
    inside = ndotd > 0.0
    n_f = torch.where(inside[..., None], -n, n)
    ndotd_f = _dot(n_f, direction)

    n_len = torch.sqrt(torch.clamp(_dot(n, n), min=1e-30))
    parallel = torch.abs(ndotd_f) < PARALLEL_EPS * n_len

    t = _dot(n_f, p1 - origin) / torch.where(parallel, 1.0, ndotd_f)

    p = origin + direction * t[..., None]
    c1 = _cross(p2 - p1, p - p1)
    c2 = _cross(p3 - p2, p - p2)
    c3 = _cross(p1 - p3, p - p3)
    d1 = _dot(c1, n_f)
    d2 = _dot(c2, n_f)
    d3 = _dot(c3, n_f)
    in_tri = (((d1 > 0) & (d2 > 0) & (d3 > 0))
              | ((d1 < 0) & (d2 < 0) & (d3 < 0)))

    hit = in_tri & ~parallel & (t >= T_MIN)
    t_out = torch.where(hit, t - 1e-5, INF)
    return hit, t_out, inside


def ray_aabb(origin, inv_direction, aa, bb):
    """Slab test in the reference's convention (glsl:303-316): the entry
    distance t0 when the box is ahead, the exit distance t1 when the origin
    is inside, -1 on a miss; traversal reads it as "visit if > 0"."""
    f = (bb - origin) * inv_direction
    n = (aa - origin) * inv_direction
    t1 = torch.amin(torch.maximum(f, n), dim=-1)
    t0 = torch.amax(torch.minimum(f, n), dim=-1)
    return torch.where(t1 >= t0, torch.where(t0 > 0.0, t0, t1), -1.0)


def ray_aabb_visit(origin, inv_direction, aa, bb):
    """(visit, t_enter): visit iff the slab interval overlaps [0, inf) (the
    reference's "d > 0" rule), t_enter = max(t0, 0) a conservative entry
    distance valid for the `t_enter > best_t` prune."""
    f = (bb - origin) * inv_direction
    n = (aa - origin) * inv_direction
    t1 = torch.amin(torch.maximum(f, n), dim=-1)
    t0 = torch.amax(torch.minimum(f, n), dim=-1)
    visit = (t1 >= t0) & (t1 > 0.0)
    return visit, torch.clamp(t0, min=0.0)


def closest_hit_brute(origin, direction, p1s, p2s, p3s, chunk=1024) -> Hit:
    """Oracle: closest hit over every triangle (hitArray over [0, N)).

    origin/direction: (R, 3); p1s/p2s/p3s: (N, 3). Scans triangle chunks
    so peak memory is O(R * chunk); the lowest index wins a tie.
    """
    r = origin.shape[0]
    best_t = torch.full((r,), INF, dtype=torch.float32, device=origin.device)
    best_tri = torch.full((r,), -1, dtype=torch.int32, device=origin.device)
    best_in = torch.zeros((r,), dtype=torch.bool, device=origin.device)
    o = origin[:, None, :]
    d = direction[:, None, :]
    for lo in range(0, p1s.shape[0], chunk):
        hi = min(lo + chunk, p1s.shape[0])
        hit, t, inside = ray_triangle(o, d, p1s[None, lo:hi],
                                      p2s[None, lo:hi], p3s[None, lo:hi])
        t = torch.where(hit, t, INF)
        t_c, k = torch.min(t, dim=1)
        closer = t_c < best_t
        best_t = torch.where(closer, t_c, best_t)
        best_tri = torch.where(closer, (k + lo).to(torch.int32), best_tri)
        best_in = torch.where(
            closer, torch.gather(inside, 1, k[:, None])[:, 0], best_in)
    return Hit(t=best_t, tri=best_tri, inside=best_in)


def shading_normal(p, p1, p2, p3, n1, n2, n3, inside):
    """Interpolated shading normal at p on the winning triangle, with areal
    (3D) barycentrics; flipped by `inside` like glsl:295."""
    n_geo = _cross(p2 - p1, p3 - p1)
    denom = torch.clamp(_dot(n_geo, n_geo), min=1e-30)
    w1 = _dot(_cross(p3 - p2, p - p2), n_geo) / denom
    w2 = _dot(_cross(p1 - p3, p - p3), n_geo) / denom
    w3 = 1.0 - w1 - w2
    ns = w1[..., None] * n1 + w2[..., None] * n2 + w3[..., None] * n3
    ns = ns / torch.sqrt(torch.clamp(_dot(ns, ns), min=1e-30))[..., None]
    return torch.where(inside[..., None], -ns, ns)


def surface_attributes(scene, origin, direction, t, tri, inside):
    """Hit point, shading normal, view vector V = -d and the material of a
    (origin, direction, t, tri, inside) record.

    The hit distance is recomputed from the winning triangle's plane and
    applied straight-through: the forward value is the traversal t, the
    derivative the plane t's, so gradients reach ray and vertex tensors
    while traversal stays detached."""
    safe = torch.clamp(tri, 0, scene.n_triangles - 1).long()
    g = scene.tri_attr[:, safe]                       # (20, R)
    ax = lambda rows: torch.movedim(rows, 0, -1)
    p1, p2, p3 = ax(g[0:3]), ax(g[3:6]), ax(g[6:9])
    n1, n2, n3 = ax(g[9:12]), ax(g[12:15]), ax(g[15:18])
    n_geo = _cross(p2 - p1, p3 - p1)
    denom = _dot(n_geo, direction)
    denom = torch.where(torch.abs(denom) < 1e-12,
                        torch.where(denom < 0, -1e-12, 1e-12), denom)
    t_diff = _dot(n_geo, p1 - origin) / denom - 1e-5
    t = t + (t_diff - t_diff.detach())
    hit_point = origin + direction * t[..., None]
    n = shading_normal(hit_point, p1, p2, p3, n1, n2, n3, inside)
    mat = scene.materials.gather(g[18].long())
    return hit_point, n, -direction, mat
