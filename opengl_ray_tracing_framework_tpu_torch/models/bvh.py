"""SAH bounding-volume-hierarchy construction + flattened encoding.

The JAX package's models/bvh.py builds the same tree with a Python call a
node; this build works a depth of the tree at a time on arrays, and gives
its arrays byte for byte (tests/test_torch_bvh.py, tests/test_torch_host
.py): the JAX package cannot be imported without importing jax.

Host-side rebuild of the reference's builder (src/core/BVH.h):

- exact-sweep SAH over all three axes with prefix/suffix AABBs
  (buildBVHwithSAH, BVH.h:110-241),
- median split fallback (buildBVH, BVH.h:46-106),
- "sah_binned", which the JAX package does not have: the SAH over
  _BINS bins of each node's centroid extent on all three axes (pbrt's and
  Embree's builders for large meshes), a depth at a time in torch on the
  scene's device, for scenes of tens of millions of triangles, whose
  exact sweep takes minutes (_build_binned),
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

import math
import os
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
import torch

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


# Nodes of up to _POW2_ROWS triangles share rows padded to the next power
# of two; larger ones rows padded to the next multiple of an eighth of
# their power of two.
_POW2_ROWS = 4096
_ROW_ELEMS = 1 << 20   # padded elements a batch of rows holds at most
_SCAN_WIDTH = 4096     # elements an elementwise step of a scan takes
_POOL_TRIS = 1 << 17   # scenes of this many triangles build on threads
_THREADS = 8
_BINS = 32             # bins a node's centroid extent is cut into, an axis
                       # ("sah_binned")
METHODS = ("sah", "median", "sah_binned")


def _bucket_rows(m: np.ndarray) -> np.ndarray:
    """Padded row length of each node of m triangles."""
    pow2 = np.left_shift(1, np.ceil(np.log2(np.maximum(m, 1)))
                         .astype(np.int64))
    step = np.maximum(pow2 // 8, 1)
    return np.where(m > _POW2_ROWS, -(-m // step) * step, pow2)


def _scan_min(x: np.ndarray) -> np.ndarray:
    """Inclusive running minimum down axis 0 of x (L, W), as a new array.
    Minima are exact in any grouping: a narrow x is cut into K chunks
    scanned side by side (each step one elementwise minimum about
    _SCAN_WIDTH wide), then joined by the chunks' own running minimum;
    only the sign of a zero can differ from a sequential scan."""
    length, width = x.shape
    k = max(1, min(length, _SCAN_WIDTH // max(width, 1)))
    if k == 1:
        y = np.empty_like(x)
        y[0] = x[0]
        for i in range(1, length):
            np.minimum(y[i - 1], x[i], out=y[i])
        return y
    c = -(-length // k)
    y = np.full((k * c, width), np.inf, x.dtype)
    y[:length] = x
    y = np.ascontiguousarray(y.reshape(k, c, width).transpose(1, 0, 2))
    for i in range(1, c):
        np.minimum(y[i - 1], y[i], out=y[i])
    carry = np.minimum.accumulate(y[c - 1], axis=0)
    np.minimum(y[:, 1:], carry[None, :-1], out=y[:, 1:])
    return y.transpose(1, 0, 2).reshape(k * c, width)[:length]


def _surface3(ex, ey, ez):
    """2(xy + xz + yz) of extents given as three arrays."""
    return 2.0 * (ex * ey + ex * ez + ey * ez)


def _axis_split(pos, m, boxes, cents, ax, sah):
    """One axis of the splits of a batch of nodes, each a row of pos (S,
    L): the positions in the level's arrays of its triangles in their
    entry order, padded with the sentinel position n, whose box is empty
    and whose centroid is NaN, so it sorts last and leaves every scan
    unchanged. boxes (6, N+1) hold each position's [min, -max] by
    component, cents (3, N+1) its centroid. Returns, per row, the best
    split's cost (SAH; else 0) and its last left index k, the row's
    positions sorted along `ax`, and the boxes (S, 6) of [0, k] and of
    [k+1, m). The arithmetic is the recursive build's (BVH.h:110-241 /
    46-106): a stable sort of the centroids, float32 prefix and suffix
    boxes, the first argmin."""
    s, width = pos.shape
    rows = np.arange(s)
    srt = np.take_along_axis(pos, np.argsort(cents[ax][pos], axis=1,
                                             kind="stable"), 1)
    flat = np.empty((width, 6, s), np.float32)
    at = np.ascontiguousarray(srt.T)
    for c in range(6):
        np.take(boxes[c], at, out=flat[:, c])
    flat = flat.reshape(width, 6 * s)
    pre = _scan_min(flat).reshape(width, 6, s)
    suf = _scan_min(flat[::-1])[::-1].reshape(width, 6, s)
    if sah:
        left_n = np.arange(1, width, dtype=np.float32)[:, None]
        right_n = (m[None, :] - left_n).astype(np.float32)
        pl, sr = pre[:-1], suf[1:]
        with np.errstate(invalid="ignore", over="ignore"):
            cost = (_surface3(-pl[:, 3] - pl[:, 0], -pl[:, 4] - pl[:, 1],
                              -pl[:, 5] - pl[:, 2]) * left_n
                    + _surface3(-sr[:, 3] - sr[:, 0], -sr[:, 4] - sr[:, 1],
                                -sr[:, 5] - sr[:, 2]) * right_n)
        cost[left_n >= m[None, :]] = np.inf   # split points past m
        k = np.argmin(cost, axis=0)
        best = cost[k, rows]
    else:
        k = (m + 1) // 2 - 1
        best = np.zeros(s, np.float32)
    return (best, k, srt, pre[k, :, rows],
            suf[np.minimum(k + 1, width - 1), :, rows])


def _split_rows(tasks, m, method):
    """The splits of a batch of nodes from its axes' _axis_split results
    (tasks: ax -> its result, or None for an axis no row takes): per row
    the axes in order, a later one taken only at a strictly lower cost
    (SAH), or the row's own axis (median). Returns (left sizes, each
    row's positions in its new order, the children's boxes (2, S, 6))."""
    s = m.size
    best_cost = np.full(s, np.inf, np.float32)
    best_split = m // 2 if method == "sah" else (m + 1) // 2
    best_pos = None
    kids = np.zeros((2, s, 6), np.float32)
    chosen = np.zeros(s, bool)
    for ax, task in tasks.items():
        if task is None:
            continue
        cost, k, srt, left, right, rows = task
        better = np.zeros(s, bool)
        if method == "sah":
            better[rows] = cost < best_cost[rows]
        else:
            better[rows] = True
        at = better[rows]
        if best_pos is None:
            best_pos = np.full((s, srt.shape[1]), -1, srt.dtype)
        best_cost[better] = cost[at]
        best_split[better] = k[at] + 1
        best_pos[better] = srt[at]
        kids[0, better] = left[at]
        kids[1, better] = right[at]
        chosen |= better
    if not chosen.all():
        raise ValueError("SAH split: no finite cost on any axis")
    return best_split, best_pos, kids


def _reorder(tasks, m, method, pos, real, arrays):
    """_split_rows of a batch, then its rows of each of `arrays` (order,
    boxes, cents: indexed by position on their last axis) put in their
    new order. Returns (left sizes, the children's boxes)."""
    left_n, new, kids = _split_rows(tasks, m, method)
    at, src = pos[real], new[real]
    for a in arrays:
        a[..., at] = a[..., src]
    return left_n, kids


def _submit_axes(run, pos, m, boxes, cents, method):
    """_axis_split of each axis of a batch through run(fn, *args), a
    pool's submit: every
    row's axes (SAH), or each axis on the rows whose longest extent it is
    (median). Returns ax -> (cost, k, srt, left box, right box, rows)."""
    s = m.size
    if method == "sah":
        rows = {ax: np.arange(s) for ax in range(3)}
    else:
        full = boxes[:, pos].min(axis=2)
        axis = np.argmax(-full[3:] - full[:3], axis=0)
        rows = {ax: np.nonzero(axis == ax)[0] for ax in range(3)}

    def one(ax):
        r = rows[ax]
        return (*_axis_split(pos[r], m[r], boxes, cents, ax,
                             method == "sah"), r)
    return {ax: run(one, ax) if rows[ax].size else None for ax in range(3)}


def _exact_boxes(lo, m, boxes, n):
    """Boxes (S, 6) of nodes over their triangles in entry order: the
    recursive build's tri_min[idx].min(axis=0), whose zeros keep the
    sign of the last zero met."""
    col = np.arange(int(m.max()))
    pos = np.where(col[None] < m[:, None], lo[:, None] + col[None], n)
    got = boxes[:, pos]
    return np.concatenate([got[:3].min(axis=2),
                           -(-got[3:]).max(axis=2)]).T


def _segment_reduce(values, seg, k, reduce):
    """(k, D) elementwise amin or amax of the rows of values (P, D) by
    their segment seg (P,); rows of an empty segment hold +inf / -inf."""
    fill = math.inf if reduce == "amin" else -math.inf
    return values.new_full((k, values.shape[1]), fill).scatter_reduce_(
        0, seg[:, None].expand_as(values), values, reduce)


def _half_area(lo, hi):
    """(xy + xz + yz) of boxes (..., 3): the SAH's area up to a factor."""
    e = hi - lo
    return e[..., 0] * e[..., 1] + e[..., 0] * e[..., 2] + e[..., 1] * e[..., 2]


def _binned_costs(seg, k, m, bins, t_lo, t_hi):
    """SAH costs (k, 3 (_BINS - 1)) of the binned splits of k nodes, axis
    by axis: cut c puts bins [0, c] left. m (k,) the nodes' sizes; per
    triangle seg its node, bins (P, 3) its bin on each axis, t_lo / t_hi
    (P, 3) its box. A cut that leaves a side empty costs inf."""
    costs = []
    for ax in range(3):
        key = seg * _BINS + bins[:, ax]
        count = torch.bincount(key, minlength=k * _BINS).view(k, _BINS)
        b_lo = _segment_reduce(t_lo, key, k * _BINS, "amin").view(k, _BINS, 3)
        b_hi = _segment_reduce(t_hi, key, k * _BINS, "amax").view(k, _BINS, 3)
        n_l = count.cumsum(1)[:, :-1]
        n_r = m[:, None] - n_l
        left = _half_area(b_lo.cummin(1).values[:, :-1],
                          b_hi.cummax(1).values[:, :-1])
        right = _half_area(b_lo.flip(1).cummin(1).values.flip(1)[:, 1:],
                           b_hi.flip(1).cummax(1).values.flip(1)[:, 1:])
        cost = left * n_l + right * n_r
        costs.append(torch.where((n_l > 0) & (n_r > 0), cost, math.inf))
    return torch.cat(costs, 1)


def _build_binned(p1, p2, p3, leaf_size, device):
    """The "sah_binned" tree a depth at a time in torch on `device`: each
    node over leaf_size triangles is split at the cheapest of _BINS - 1
    cuts of its centroid extent on each axis (the first least cost, axes
    in order), or, where no cut leaves both sides a triangle (centroids
    that coincide), into the halves of its entry order; a stable
    partition keeps each side's triangles in their entry order. Boxes are
    the exact min / max of a node's triangles. Returns (levels, order) as
    build_bvh's depth loop leaves them."""
    dev = torch.device("cpu" if device is None else device)

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                               device=dev)

    a, b, c = put(p1), put(p2), put(p3)
    t_lo = torch.minimum(torch.minimum(a, b), c)
    t_hi = torch.maximum(torch.maximum(a, b), c)
    cent = (a + b + c) / 3.0
    del a, b, c
    n = t_lo.shape[0]
    order = torch.arange(n, device=dev)
    lo = torch.zeros(1, dtype=torch.int64, device=dev)
    hi = torch.full((1,), n, dtype=torch.int64, device=dev)
    box_lo, box_hi = t_lo.amin(0, keepdim=True), t_hi.amax(0, keepdim=True)
    levels = []
    while True:
        m = hi - lo
        inner = m > leaf_size
        split = torch.zeros_like(m)
        k_lo, k_m = lo[inner], m[inner]
        k = k_lo.numel()
        if k:
            # the inner nodes' positions, node by node, and each one's node
            seg = torch.repeat_interleave(torch.arange(k, device=dev), k_m)
            start = torch.cumsum(k_m, 0) - k_m
            idx = torch.arange(seg.numel(), device=dev) - start[seg]
            pos = k_lo[seg] + idx
            cp, tl, th = cent[pos], t_lo[pos], t_hi[pos]
            c_lo = _segment_reduce(cp, seg, k, "amin")
            ext = _segment_reduce(cp, seg, k, "amax") - c_lo
            scale = torch.where(ext > 0, _BINS / ext, 0.0)
            bins = ((cp - c_lo[seg]) * scale[seg]).long().clamp_(0, _BINS - 1)
            best, at = _binned_costs(seg, k, k_m, bins, tl, th).min(1)
            ax, cut = at // (_BINS - 1), at % (_BINS - 1)
            right = torch.where(
                torch.isfinite(best)[seg],
                bins.gather(1, ax[seg, None])[:, 0] > cut[seg],
                idx >= k_m[seg] // 2)
            # a stable partition of each node: its left side, then its right
            lf = (~right).long()
            n_l = torch.zeros(k, dtype=torch.int64, device=dev).index_add_(
                0, seg, lf)
            before = torch.cumsum(lf, 0) - lf
            rank = before - before[start][seg]
            new = k_lo[seg] + torch.where(right, n_l[seg] + idx - rank, rank)
            for arr in (order, t_lo, t_hi, cent):
                arr[new] = arr[pos]
            split[inner] = n_l
            kid = seg * 2 + right.long()
            kid_lo = _segment_reduce(tl, kid, 2 * k, "amin")
            kid_hi = _segment_reduce(th, kid, 2 * k, "amax")
        levels.append(tuple(x.cpu().numpy() for x in (lo, hi, box_lo, box_hi,
                                                      split)))
        if not k:
            break
        mid = k_lo + n_l
        lo = torch.stack([k_lo, mid], 1).reshape(-1)
        hi = torch.stack([mid, k_lo + k_m], 1).reshape(-1)
        box_lo, box_hi = kid_lo, kid_hi
    return levels, order.cpu().numpy().astype(np.int32)


def build_bvh(p1: np.ndarray, p2: np.ndarray, p3: np.ndarray,
              leaf_size: int = 8, method: str = "sah",
              device=None) -> FlatBVH:
    """Build the flattened BVH. p1/p2/p3: (N, 3) float32 world triangles.

    method: "sah" (BVH.h:110-241), "median" (BVH.h:46-106) or
    "sah_binned" (_build_binned, on `device`, the CPU by default; the
    others build on the host).

    The tree is built a depth at a time: the nodes of a depth are split
    in batches of rows (_split_rows), each child's box taken from its
    parent's scans (a box with a zero is recomputed in entry order, which
    decides the zero's sign), then the nodes are numbered in depth-first
    pre-order (node 1 the root, a left child right after its parent, the
    right child after the left subtree), as the recursive build of the
    JAX package allocates them. The triangles' boxes and centroids move
    with the order, so a node's own lie side by side.
    """
    n = p1.shape[0]
    if n == 0:
        raise ValueError("empty scene")
    if method not in METHODS:
        raise ValueError(f"unknown BVH method {method!r}")
    if method == "sah_binned":
        return _flatten(*_build_binned(p1, p2, p3, leaf_size, device))

    tri_min = np.minimum(np.minimum(p1, p2), p3).astype(np.float32)
    tri_max = np.maximum(np.maximum(p1, p2), p3).astype(np.float32)
    centroid = ((p1 + p2 + p3) / 3.0).astype(np.float32)
    # by position in `order`: [min, -max] (one running minimum scans
    # both) and the centroid, by component; position n pads a row
    boxes = np.concatenate([np.concatenate([tri_min, -tri_max], 1),
                            np.full((1, 6), np.inf, np.float32)]).T.copy()
    cents = np.concatenate([centroid, np.full((1, 3), np.nan, np.float32)]
                           ).T.copy()

    order = np.arange(n, dtype=np.int32)
    levels = []   # per depth: lo, hi, box min, box max, split (0: leaf)
    lo = np.zeros(1, np.int64)
    hi = np.full(1, n, np.int64)
    box = _exact_boxes(lo, hi - lo, boxes, n)
    # the axes of each batch are independent tasks; numpy lets go of the
    # interpreter inside them, so large scenes take several host cores
    pool = ThreadPoolExecutor(min(_THREADS, len(os.sched_getaffinity(0)))
                              if n >= _POOL_TRIS else 1)
    run = pool.submit
    try:
        while lo.size:
            m = hi - lo
            zero = (box == 0).any(axis=1)
            if zero.any():
                box[zero] = _exact_boxes(lo[zero], m[zero], boxes, n)
            split = np.zeros(lo.size, np.int64)
            kids = np.zeros((2, lo.size, 6), np.float32)
            inner = np.nonzero(m > leaf_size)[0]
            width = _bucket_rows(m[inner])
            batches = []
            for w in np.unique(width):
                nodes = inner[width == w]
                step = max(1, _ROW_ELEMS // int(w))
                for b in range(0, nodes.size, step):
                    sel = nodes[b:b + step]
                    col = np.arange(w)
                    real = col[None] < m[sel, None]
                    pos = np.where(real, lo[sel, None] + col[None], n)
                    batches.append((sel, real, pos, _submit_axes(
                        run, pos, m[sel], boxes, cents, method)))
            # a batch's reorder is queued once its axes are done, so no
            # task waits on another; each moves only its own rows (the
            # ranges never overlap) while later batches' axes run
            done = [(sel, run(_reorder, {ax: None if t is None else t.result()
                                         for ax, t in tasks.items()},
                              m[sel], method, pos, real,
                              (order, boxes, cents)))
                    for sel, real, pos, tasks in batches]
            for sel, task in done:
                split[sel], kids[:, sel] = task.result()
            levels.append((lo, hi, box[:, :3], -box[:, 3:], split))
            inner = split > 0
            mid = lo[inner] + split[inner]
            lo = np.stack([lo[inner], mid], 1).reshape(-1)
            hi = np.stack([mid, hi[inner]], 1).reshape(-1)
            box = np.stack([kids[0, inner], kids[1, inner]], 1).reshape(-1, 6)
    finally:
        pool.shutdown()
    return _flatten(levels, order)


def _flatten(levels, order) -> FlatBVH:
    """The FlatBVH of a tree built a depth at a time: levels, per depth
    (lo, hi, box min, box max, left size; 0: a leaf) of its nodes, the
    children of a depth's inner nodes in the next depth in pairs; order,
    the triangles' leaf order. Node ids in depth-first pre-order."""
    # subtree sizes bottom-up, then pre-order ids top-down
    sizes = [None] * len(levels)
    below = np.zeros(0, np.int64)
    for d in range(len(levels) - 1, -1, -1):
        inner = levels[d][4] > 0
        size = np.ones(inner.size, np.int64)
        size[inner] += below[0::2] + below[1::2]
        sizes[d], below = size, size
    n_nodes = 1 + int(sizes[0][0])
    left = np.zeros(n_nodes, np.int32)
    right = np.zeros(n_nodes, np.int32)
    count = np.zeros(n_nodes, np.int32)
    first = np.zeros(n_nodes, np.int32)
    aabb_min = np.full((n_nodes, 3), _BIG, np.float32)
    aabb_max = np.full((n_nodes, 3), -_BIG, np.float32)
    ids = np.ones(1, np.int64)
    for d, (lo, hi, box_min, box_max, split) in enumerate(levels):
        aabb_min[ids] = box_min
        aabb_max[ids] = box_max
        inner = split > 0
        count[ids[~inner]] = (hi - lo)[~inner]
        first[ids[~inner]] = lo[~inner]
        if d + 1 == len(levels):
            break
        l_id = ids[inner] + 1
        r_id = l_id + sizes[d + 1][0::2]
        left[ids[inner]] = l_id
        right[ids[inner]] = r_id
        ids = np.stack([l_id, r_id], 1).reshape(-1)

    return FlatBVH(left=left, right=right, count=count, first=first,
                   aabb_min=aabb_min, aabb_max=aabb_max, perm=order)


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
