"""SAH bounding-volume-hierarchy construction + flattened encoding.

A numpy copy of opengl_ray_tracing_framework_tpu/models/bvh.py, equal in
what it computes (tests/test_torch_host.py checks the arrays byte for
byte): the JAX package cannot be imported without importing jax.

Host-side rebuild of the reference's builder (src/core/BVH.h):

- exact-sweep SAH over all three axes with prefix/suffix AABBs
  (buildBVHwithSAH, BVH.h:110-241),
- median split fallback (buildBVH, BVH.h:46-106),
- node record {left, right, n, index, AA, BB} (BVH.h:11-15) with the
  reference's flattened conventions: node 0 is a dummy sentinel, the root is
  node 1, children are "valid if index > 0", leaves hold a [first, first+n)
  range into the *reordered* triangle array (Scene.h:186-257).

Numpy-vectorized sweeps instead of per-element C++ loops; the tree is
returned as flat int32/float32 arrays sized for the vectorized traversal in
ops.traverse (and, later, a Pallas kernel). The builder returns the
triangle permutation instead of sorting caller arrays in place.
"""

from __future__ import annotations

import sys
from typing import NamedTuple

import numpy as np

_BIG = np.float32(1145141919.0)  # the reference's AABB init sentinel (BVH.h:55)


class FlatBVH(NamedTuple):
    """Flattened tree. All arrays have length n_nodes.

    left/right: child node indices (0 = none); count/first: leaf triangle
    range [first, first+count) (count 0 for internal nodes); aabb_min/max:
    (B, 3) float32. perm: (N,) int32 triangle permutation — triangle arrays
    must be gathered with it before traversal (leaf order == array order).
    """

    left: np.ndarray
    right: np.ndarray
    count: np.ndarray
    first: np.ndarray
    aabb_min: np.ndarray
    aabb_max: np.ndarray
    perm: np.ndarray

    @property
    def n_nodes(self) -> int:
        return self.left.shape[0]


def _surface(ext: np.ndarray) -> np.ndarray:
    """2(xy + xz + yz) for extents (..., 3)."""
    return 2.0 * (ext[..., 0] * ext[..., 1] + ext[..., 0] * ext[..., 2]
                  + ext[..., 1] * ext[..., 2])


def build_bvh(p1: np.ndarray, p2: np.ndarray, p3: np.ndarray,
              leaf_size: int = 8, method: str = "sah") -> FlatBVH:
    """Build the flattened BVH. p1/p2/p3: (N, 3) float32 world triangles.

    method: "sah" (BVH.h:110-241) or "median" (BVH.h:46-106).
    """
    n = p1.shape[0]
    if n == 0:
        raise ValueError("empty scene")

    tri_min = np.minimum(np.minimum(p1, p2), p3).astype(np.float32)
    tri_max = np.maximum(np.maximum(p1, p2), p3).astype(np.float32)
    centroid = ((p1 + p2 + p3) / 3.0).astype(np.float32)

    order = np.arange(n, dtype=np.int32)

    left: list = []
    right: list = []
    count: list = []
    first: list = []
    aabb_min: list = []
    aabb_max: list = []

    def alloc() -> int:
        left.append(0)
        right.append(0)
        count.append(0)
        first.append(0)
        aabb_min.append(np.full(3, _BIG, np.float32))
        aabb_max.append(np.full(3, -_BIG, np.float32))
        return len(left) - 1

    # Dummy sentinel node 0 (Scene.h:189-196 seeds the array with a junk
    # node so that "child == 0" means "no child" and the root lands at 1).
    alloc()

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000 + 64 * int(np.log2(n + 2))))

    def build_range(lo: int, hi: int) -> int:
        """Build over order[lo:hi] (half-open), return node id."""
        node = alloc()
        idx = order[lo:hi]
        lo_box = tri_min[idx].min(axis=0)
        hi_box = tri_max[idx].max(axis=0)
        aabb_min[node] = lo_box
        aabb_max[node] = hi_box

        m = hi - lo
        if m <= leaf_size:
            count[node] = m
            first[node] = lo
            return node

        if method == "median":
            ext = hi_box - lo_box
            axis = int(np.argmax(ext))
            sort_idx = idx[np.argsort(centroid[idx, axis], kind="stable")]
            order[lo:hi] = sort_idx
            split = (m + 1) // 2  # matches mid=(l+r)/2 inclusive convention
        else:
            best_cost = np.inf
            best_axis = 0
            best_split = m // 2
            best_order = None
            for axis in range(3):
                sort_idx = idx[np.argsort(centroid[idx, axis], kind="stable")]
                smin = tri_min[sort_idx]
                smax = tri_max[sort_idx]
                # prefix AABB of [0..i], suffix AABB of [i..m-1]
                pre_min = np.minimum.accumulate(smin, axis=0)
                pre_max = np.maximum.accumulate(smax, axis=0)
                suf_min = np.minimum.accumulate(smin[::-1], axis=0)[::-1]
                suf_max = np.maximum.accumulate(smax[::-1], axis=0)[::-1]
                counts = np.arange(1, m, dtype=np.float32)
                cost = (_surface(pre_max[:-1] - pre_min[:-1]) * counts
                        + _surface(suf_max[1:] - suf_min[1:]) * counts[::-1])
                k = int(np.argmin(cost))
                if cost[k] < best_cost:
                    best_cost = float(cost[k])
                    best_axis = axis
                    best_split = k + 1  # left = [0, k], size k+1
                    best_order = sort_idx
            order[lo:hi] = best_order
            split = best_split

        lchild = build_range(lo, lo + split)
        rchild = build_range(lo + split, hi)
        left[node] = lchild
        right[node] = rchild
        return node

    root = build_range(0, n)
    sys.setrecursionlimit(old_limit)
    assert root == 1, f"root must be node 1, got {root}"

    return FlatBVH(
        left=np.asarray(left, np.int32),
        right=np.asarray(right, np.int32),
        count=np.asarray(count, np.int32),
        first=np.asarray(first, np.int32),
        aabb_min=np.stack(aabb_min).astype(np.float32),
        aabb_max=np.stack(aabb_max).astype(np.float32),
        perm=order,
    )


def validate_bvh(bvh: FlatBVH, n_triangles: int) -> None:
    """Structural invariants: every triangle in exactly one leaf, children
    boxes inside parents, leaf counts within leaf_size."""
    seen = np.zeros(n_triangles, bool)
    stack = [1]
    while stack:
        node = stack.pop()
        c = int(bvh.count[node])
        if c > 0:
            f = int(bvh.first[node])
            assert not seen[f:f + c].any(), "triangle in two leaves"
            seen[f:f + c] = True
        else:
            l, r = int(bvh.left[node]), int(bvh.right[node])
            assert l > 0 and r > 0, "internal node missing child"
            for ch in (l, r):
                assert (bvh.aabb_min[ch] >= bvh.aabb_min[node] - 1e-4).all()
                assert (bvh.aabb_max[ch] <= bvh.aabb_max[node] + 1e-4).all()
                stack.append(ch)
    assert seen.all(), "triangle not covered by any leaf"
    assert np.unique(bvh.perm).size == n_triangles, "perm is not a permutation"
