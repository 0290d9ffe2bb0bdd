"""The plain reference's closest hit, worked out from the raw triangles.

Triangles are grouped by the Morton order of their centroids into blocks
of BLOCK, each with its own bounding box. Per chunk of rays, every ray
tests every box (a slab test), sorts the boxes by entry distance and
visits them nearest first, testing all of a box's triangles with the
same ray/triangle arithmetic as the program's brute-force oracle
(hitTriangle, glsl:241-299: plane distance, three edge tests, T_MIN, the
1e-5 pullback). A ray stops once the next box's entry lies beyond its
best hit, so the answer is the brute-force closest hit. None of it is the
program's: not its BVH, its clusters or its kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from .sampling import _cross, _dot

INF = 114514.0          # the reference's "infinite" distance (glsl:10)
T_MIN = 0.0005          # minimum hit distance (glsl:268)
PARALLEL_EPS = 1e-5     # ray-parallel-to-plane epsilon (glsl:262)
BLOCK = 128             # triangles a box
RAY_CHUNK = 32768       # rays a slab-test chunk
PRUNE_SLACK = 2e-5      # a box is skipped once its entry passes best + this


def ray_triangle(origin, direction, p1, p2, p3):
    """(hit, t, inside) of rays against triangles, broadcasting; t is the
    plane distance less the 1e-5 pullback, INF on a miss; inside: the
    geometric normal faced away from the ray."""
    n = _cross(p2 - p1, p3 - p1)
    ndotd = _dot(n, direction)
    inside = ndotd > 0.0
    n_f = torch.where(inside[..., None], -n, n)
    ndotd_f = _dot(n_f, direction)
    n_len = torch.sqrt(torch.clamp(_dot(n, n), min=1e-30))
    parallel = torch.abs(ndotd_f) < PARALLEL_EPS * n_len
    t = _dot(n_f, p1 - origin) / torch.where(parallel, 1.0, ndotd_f)
    p = origin + direction * t[..., None]
    d1 = _dot(_cross(p2 - p1, p - p1), n_f)
    d2 = _dot(_cross(p3 - p2, p - p2), n_f)
    d3 = _dot(_cross(p1 - p3, p - p3), n_f)
    in_tri = (((d1 > 0) & (d2 > 0) & (d3 > 0))
              | ((d1 < 0) & (d2 < 0) & (d3 < 0)))
    hit = in_tri & ~parallel & (t >= T_MIN)
    return hit, torch.where(hit, t - 1e-5, INF), inside


def _morton(points: np.ndarray) -> np.ndarray:
    """30-bit Morton codes of points in their bounding box."""
    lo, hi = points.min(axis=0), points.max(axis=0)
    q = ((points - lo) / np.maximum(hi - lo, 1e-12) * 1023).astype(np.int64)
    code = np.zeros(points.shape[0], np.int64)
    for bit in range(10):
        for axis in range(3):
            code |= ((q[:, axis] >> bit) & 1) << (3 * bit + axis)
    return code


class Caster:
    """Closest-hit queries against one triangle soup (p1, p2, p3: (N, 3)
    float32 tensors, original ids 0..N-1)."""

    def __init__(self, p1, p2, p3):
        n = p1.shape[0]
        cent = ((p1 + p2 + p3) / 3.0).double().cpu().numpy()
        order = np.argsort(_morton(cent), kind="stable")
        n_blocks = -(-n // BLOCK)
        # pad the last box with copies of its last triangle
        slots = np.minimum(np.arange(n_blocks * BLOCK), n - 1)
        ids = torch.as_tensor(order[slots].reshape(n_blocks, BLOCK),
                              device=p1.device)
        self.tri_id = ids
        self.p = torch.stack([p1[ids], p2[ids], p3[ids]])   # (3, C, B, 3)
        lo = self.p.amin(dim=(0, 2))
        hi = self.p.amax(dim=(0, 2))
        pad = 1e-5 * (hi - lo).amax(dim=1, keepdim=True) + 1e-6
        self.box_lo, self.box_hi = lo - pad, hi + pad

    def _entry(self, origin, direction):
        """(R, C) conservative entry distance of each ray into each box,
        INF where the slab test misses."""
        small = torch.abs(direction) < 1e-12
        inv = 1.0 / torch.where(small, torch.where(direction < 0, -1e-12,
                                                   1e-12), direction)
        near = (self.box_lo[None] - origin[:, None]) * inv[:, None]
        far = (self.box_hi[None] - origin[:, None]) * inv[:, None]
        t0 = torch.minimum(near, far).amax(dim=2)
        t1 = torch.maximum(near, far).amin(dim=2)
        visit = (t1 >= t0) & (t1 > 0.0)
        return torch.where(visit, torch.clamp(t0, min=0.0), INF)

    def closest_hit(self, origin, direction, mask=None, any_hit=False):
        """(t, tri, inside) per ray: t INF, tri -1 on a miss or where mask
        is False. any_hit rays may stop at their first hit (only whether
        they hit is meaningful)."""
        r = origin.shape[0]
        dev = origin.device
        if mask is None:
            mask = torch.ones(r, dtype=torch.bool, device=dev)
        t_out = torch.full((r,), INF, dtype=origin.dtype, device=dev)
        tri_out = torch.full((r,), -1, dtype=torch.int64, device=dev)
        in_out = torch.zeros(r, dtype=torch.bool, device=dev)
        for lo in range(0, r, RAY_CHUNK):
            sl = slice(lo, lo + RAY_CHUNK)
            o, d, m = origin[sl], direction[sl], mask[sl]
            entry = torch.where(m[:, None], self._entry(o, d), INF)
            entry, order = torch.sort(entry, dim=1)
            best = torch.full((o.shape[0],), INF, dtype=o.dtype, device=dev)
            tri = torch.full((o.shape[0],), -1, dtype=torch.int64, device=dev)
            inside = torch.zeros(o.shape[0], dtype=torch.bool, device=dev)
            for j in range(entry.shape[1]):
                limit = best + PRUNE_SLACK
                if any_hit:
                    limit = torch.where(tri >= 0, -INF, limit)
                act = torch.nonzero(entry[:, j] < limit).squeeze(1)
                if act.numel() == 0:
                    break
                box = order[act, j]
                p1, p2, p3 = (self.p[k, box] for k in range(3))
                hit, t, ins = ray_triangle(o[act, None], d[act, None],
                                           p1, p2, p3)
                t_min, k = torch.min(t, dim=1)
                closer = t_min < best[act]
                best[act] = torch.where(closer, t_min, best[act])
                tri[act] = torch.where(closer, self.tri_id[box, k], tri[act])
                inside[act] = torch.where(
                    closer, torch.gather(ins, 1, k[:, None])[:, 0],
                    inside[act])
            t_out[sl], tri_out[sl], in_out[sl] = best, tri, inside
        return t_out, tri_out, in_out
