"""Treelet clustering of the SAH BVH for the TPU wavefront tracer.

A numpy copy of opengl_ray_tracing_framework_tpu/models/clusters.py,
equal in what it computes (tests/test_torch_host.py checks the arrays
byte for byte): the JAX package cannot be imported without importing
jax.

The reference traverses a deep per-ray BVH with an explicit stack and
random-access node/triangle fetches (hitBVH, fragment_shader_ray_tracing
.glsl:338-392). TPUs execute that pattern at gather speed (~0.7 Gelem/s
measured on v5e) — hopeless. The TPU-native reorganization:

- cut the SAH tree into **clusters**: subtrees owning <= T contiguous,
  leaf-ordered triangles (the BVH builder already stores each subtree's
  triangles contiguously, models/bvh.py),
- store each cluster as a dense, padded block of triangle *intersection
  features* laid out for one MXU matmul per (ray tile x cluster):
  every Moller-Trumbore quantity is bilinear in per-ray features
  [o, d, o x d, 1] and per-triangle constants, so a (rays, 16) @ (16, T)
  contraction per output group computes A = d.n, TN = (p1-o).n,
  U = u*det, V = v*det and the parallel-test threshold E for a whole
  tile x cluster pair at once,
- rays are *sorted* by candidate cluster id between rounds (lax.sort is
  ~2-6 ms for 524k rays — far cheaper than per-ray gathers), so a Pallas
  kernel streams each cluster block from HBM exactly once per ray tile
  that needs it.

Derivation of the feature rows (with n = e1 x e2, e1 = p2-p1, e2 = p3-p1):
  A  = d.n                      (denominator; det = -A; inside = A > 0,
                                 matching glsl:256-259)
  TN = (p1 - o).n = c1 - o.n    with c1 = p1.n      => t = TN / A
  U  = u*det = (o x d).e2 + d.(p1 x e2)
  V  = v*det = -(o x d).e1 - d.(p1 x e1)
  E  = PARALLEL_EPS * |n|       (glsl:262's threshold, scaled like
                                 ops.intersect.ray_triangle)
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .bvh import FlatBVH

PARALLEL_EPS = 1e-5   # matches ops.intersect.PARALLEL_EPS

# Feature-column layout of the (16, 4*T) per-cluster matrix: four T-column
# groups [A | TN | U | V] side by side, so ONE MXU contraction
# rayfeat (rays, 16) @ trifeat (16, 4T) produces every ray-dependent
# Moller-Trumbore quantity for a tile x cluster pair (separate 16-row dots
# cost ~3x more in kernel launches, measured on v5e). The parallel-test
# threshold E is *ray-independent*, so it does not ride the matmul: it is
# packed into the unused feature row 10 of the A group (rayfeat row 10 is
# always 0, so it never leaks into A) and read directly by the kernels —
# 20% less MXU work and DMA than a fifth column group. Ray feature vector
# is [ox oy oz dx dy dz (oxd)x (oxd)y (oxd)z 1 0 0 0 0 0 0].
N_RAY_FEAT = 16
N_GROUPS = 4
EPS_ROW = 10          # trifeat row carrying E in the A-group columns


class ClusterSet(NamedTuple):
    """Host-side cluster arrays (numpy; Scene.build turns them into jnp)."""

    aabb_min: np.ndarray   # (C, 3) f32
    aabb_max: np.ndarray   # (C, 3) f32
    trifeat: np.ndarray    # (C, 16, N_GROUPS*T) f32 — matmul constants
    slot2tri: np.ndarray   # (C*T,) i32 — padded slot -> global tri id (-1 pad)
    first: np.ndarray      # (C,) i32 — first (unpadded) triangle
    count: np.ndarray      # (C,) i32 — real triangles in cluster

    @property
    def n_clusters(self) -> int:
        return self.aabb_min.shape[0]

    @property
    def block_tris(self) -> int:
        return self.trifeat.shape[2] // N_GROUPS


def cut_clusters(bvh: FlatBVH, max_tris: int) -> list[tuple[int, int, int]]:
    """Cut the tree into subtrees of <= max_tris triangles.

    Returns [(node, first, count)] in triangle order. Every subtree of the
    in-order SAH build owns the contiguous range [first, first+count).
    """
    # subtree triangle range = union of leaf ranges; compute by walking
    n = bvh.n_nodes
    lo = np.full(n, np.iinfo(np.int32).max, np.int64)
    hi = np.full(n, -1, np.int64)
    # children come after parents in allocation order, so reverse sweep
    # propagates leaf ranges upward in one pass
    for node in range(n - 1, 0, -1):
        if bvh.count[node] > 0:
            lo[node] = bvh.first[node]
            hi[node] = bvh.first[node] + bvh.count[node]
        else:
            l, r = bvh.left[node], bvh.right[node]
            lo[node] = min(lo[l], lo[r])
            hi[node] = max(hi[l], hi[r])

    out: list[tuple[int, int, int]] = []
    stack = [1]
    while stack:
        node = stack.pop()
        cnt = int(hi[node] - lo[node])
        if cnt <= max_tris or bvh.count[node] > 0:
            out.append((node, int(lo[node]), cnt))
        else:
            # right first so the popped order is left-to-right
            stack.append(int(bvh.right[node]))
            stack.append(int(bvh.left[node]))
    out.sort(key=lambda t: t[1])
    return out


def build_clusters(bvh: FlatBVH, p1: np.ndarray, p2: np.ndarray,
                   p3: np.ndarray, max_tris: int = 256) -> ClusterSet:
    """p1/p2/p3: (N, 3) float32 triangles ALREADY permuted to leaf order."""
    cuts = cut_clusters(bvh, max_tris)
    c = len(cuts)
    t_blk = max(8, int(max_tris))

    aabb_min = np.zeros((c, 3), np.float32)
    aabb_max = np.zeros((c, 3), np.float32)
    trifeat = np.zeros((c, N_RAY_FEAT, N_GROUPS * t_blk), np.float32)
    slot2tri = np.full(c * t_blk, -1, np.int32)
    firsts = np.zeros(c, np.int32)
    counts = np.zeros(c, np.int32)

    e1_all = p2 - p1
    e2_all = p3 - p1
    n_all = np.cross(e1_all, e2_all)

    for ci, (node, first, cnt) in enumerate(cuts):
        assert cnt <= t_blk, (cnt, t_blk)
        sl = slice(first, first + cnt)
        aabb_min[ci] = bvh.aabb_min[node]
        aabb_max[ci] = bvh.aabb_max[node]
        firsts[ci] = first
        counts[ci] = cnt
        slot2tri[ci * t_blk: ci * t_blk + cnt] = np.arange(
            first, first + cnt, dtype=np.int32)

        q1 = p1[sl]
        e1 = e1_all[sl]
        e2 = e2_all[sl]
        n = n_all[sl]
        c1 = np.einsum("ij,ij->i", q1, n)
        p1xe2 = np.cross(q1, e2)
        p1xe1 = np.cross(q1, e1)
        nlen = np.sqrt(np.maximum((n * n).sum(-1), 1e-30))

        f = trifeat[ci]
        g = t_blk
        # group A (cols 0..T-1): A = d.n  -> d rows get n
        f[3:6, 0:cnt] = n.T
        # group TN (cols T..2T-1): TN = c1 - o.n
        f[0:3, g:g + cnt] = -n.T                # o rows: -n
        f[9, g:g + cnt] = c1
        # group U (cols 2T..3T-1): U = (oxd).e2 + d.(p1 x e2)
        f[3:6, 2 * g:2 * g + cnt] = p1xe2.T
        f[6:9, 2 * g:2 * g + cnt] = e2.T
        # group V (cols 3T..4T-1): V = -(oxd).e1 - d.(p1 x e1)
        f[3:6, 3 * g:3 * g + cnt] = -p1xe1.T
        f[6:9, 3 * g:3 * g + cnt] = -e1.T
        # parallel threshold E (ray-independent): row EPS_ROW of group A,
        # read directly by the kernels (rayfeat row 10 is 0, so the A
        # matmul output is unaffected)
        f[EPS_ROW, 0:cnt] = PARALLEL_EPS * nlen
        # padded slots: everything 0 => A=0, E=0 -> |A| <= E -> miss

    return ClusterSet(aabb_min=aabb_min, aabb_max=aabb_max, trifeat=trifeat,
                      slot2tri=slot2tri, first=firsts, count=counts)
