"""Treelet clustering of the SAH BVH for the TPU wavefront tracer.

A numpy port of opengl_ray_tracing_framework_tpu/models/clusters.py,
equal in what it computes (tests/test_torch_host.py checks the arrays
byte for byte), its features written for every triangle at once rather
than a cluster at a time: the JAX package cannot be imported without
importing jax.

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

    node, firsts, counts = np.asarray(cuts, np.int64).reshape(-1, 3).T
    assert (counts <= t_blk).all(), (counts.max(), t_blk)
    aabb_min = bvh.aabb_min[node]
    aabb_max = bvh.aabb_max[node]
    firsts, counts = firsts.astype(np.int32), counts.astype(np.int32)
    trifeat = np.zeros((c, N_RAY_FEAT, N_GROUPS * t_blk), np.float32)
    slot2tri = np.full(c * t_blk, -1, np.int32)

    e1 = p2 - p1
    e2 = p3 - p1
    n = np.cross(e1, e2)
    c1 = np.einsum("ij,ij->i", p1, n)
    p1xe2 = np.cross(p1, e2)
    p1xe1 = np.cross(p1, e1)
    nlen = np.sqrt(np.maximum((n * n).sum(-1), 1e-30))

    # every triangle's cluster and lane (slot = cluster * T + lane)
    cl = np.repeat(np.arange(c), counts)
    lane = np.arange(cl.size) - np.repeat(np.cumsum(counts) - counts, counts)
    tri = np.repeat(firsts, counts) + lane
    slot2tri.reshape(c, t_blk)[cl, lane] = tri
    f = trifeat.transpose(0, 2, 1)   # (C, 4T, 16): a slot's rows
    g = t_blk
    # group A (cols 0..T-1): A = d.n  -> d rows get n
    f[cl, lane, 3:6] = n[tri]
    # group TN (cols T..2T-1): TN = c1 - o.n
    f[cl, g + lane, 0:3] = -n[tri]            # o rows: -n
    f[cl, g + lane, 9] = c1[tri]
    # group U (cols 2T..3T-1): U = (oxd).e2 + d.(p1 x e2)
    f[cl, 2 * g + lane, 3:6] = p1xe2[tri]
    f[cl, 2 * g + lane, 6:9] = e2[tri]
    # group V (cols 3T..4T-1): V = -(oxd).e1 - d.(p1 x e1)
    f[cl, 3 * g + lane, 3:6] = -p1xe1[tri]
    f[cl, 3 * g + lane, 6:9] = -e1[tri]
    # parallel threshold E (ray-independent): row EPS_ROW of group A,
    # read directly by the kernels (rayfeat row 10 is 0, so the A
    # matmul output is unaffected)
    f[cl, lane, EPS_ROW] = PARALLEL_EPS * nlen[tri]
    # padded slots: everything 0 => A=0, E=0 -> |A| <= E -> miss

    return ClusterSet(aabb_min=aabb_min, aabb_max=aabb_max, trifeat=trifeat,
                      slot2tri=slot2tri, first=firsts, count=counts)
