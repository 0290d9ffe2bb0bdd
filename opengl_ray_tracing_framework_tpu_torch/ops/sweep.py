"""Swept span-list closest hit: the port's traversal, around one kernel.

PyTorch port of opengl_ray_tracing_framework_tpu.ops.sweep. Every cast of
the forward render (the primary cast and each bounce's merged NEE-shadow
+ bounce cast) comes here.

  preparation (sweep_inputs; csrc/sweep_prep.cu on a CUDA tensor, the
  plain versions sweep_key_plain / sweep_spans_plain on a CPU tensor):
    1. slab test of every ray against every cluster AABB (cluster_tnear),
       consumed only through per-ray and per-tile reductions, so the
       (rays, clusters) matrix never exists whole (the plain versions take
       it in chunks of rays); the kernels test a cluster only for rays
       that enter its group box (group_boxes: CULL_GROUP consecutive
       clusters, a BVH neighbourhood), which gives the same values;
    2. a stable coherence sort of the rays (sweep_key, then torch.sort):
       rays that trace nothing (masked off, or overlapping no cluster) go
       last, live rays group by (nearest candidate cluster, quantized
       direction);
    3. per tile of TILE_R sorted rays, the span list (sweep_spans): cluster
       ids in stable ascending order of the tile's minimum entry distance,
       and nspan = the number the tile overlaps;
    4. per ray, the pruning cap = nextafter(its farthest finite entry
       distance): a ray never needs a span beyond its own farthest
       candidate cluster; with the ray features and the records.

  kernel (sweep: csrc/sweep.cu on a CUDA tensor, a thread-block cluster
  of 1-8 CTAs per tile by the launch's tile count; sweep_plain on a CPU
  tensor): per tile, walk the span list nearest first; per span intersect
  every ray with every triangle of the cluster through the bilinear
  feature form [A | TN | U | V] = rayfeat (R, 16) . trifeat (16, 4T)
  (models/clusters.py: four T-column groups, the parallel threshold E in
  row 10 of group A); keep each ray's minimum t; stop when the next span's
  tile entry distance is >= every live ray's min(best_t, cap).

Exactness (the JAX module's argument): spans are visited in conservative
nearest-first order and a skipped span cannot hold a closer hit for any
ray, so the result is the brute-force closest hit. The tile size, the
sort and the chunking change only which spans are visited, never the
answer; only which of two hits at exactly equal t wins can depend on them.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..utils import nvcc, timing
from .intersect import INF, T_MIN, Hit
from .sampling import _cross

TILE_R = 128          # rays per kernel tile; csrc/mt_span.cuh agrees
N_FEAT = 16           # ray feature vector [o, d, o x d, 1, 0 x 6]
BEST_W = 8            # record [t, slot, inside, cap, anyhit, 0, 0, 0]
NO_SLOT = -1.0        # a record's slot before any hit: as int32 bits, < 0
MAX_SLOTS = (1 << 31) - 1   # slots (C x T) whose ids K1's records name:
                            # the slot lane holds an int32 by its bits
MAX_KEY_CLUSTERS = 1 << 23  # clusters the coherence key names below
                            # _DEAD_KEY (nearest * 128 + 127 < 2^30)
EPS_ROW = 10          # trifeat row carrying E in the A-group columns
MAX_BLOCK_TRIS = 4096  # widest cluster block the kernels take (a 12-bit
                       # lane in their keys); csrc/mt_span.cuh agrees
CULL_GROUP = 32       # consecutive clusters a group box covers;
                      # csrc/sweep_prep.cu agrees
_DEAD_KEY = 1 << 30   # sort key for rays that trace nothing
_SLAB_CHUNK = 128 * TILE_R   # rays per slab-test chunk


def cluster_tnear(origin, direction, cl_min, cl_max):
    """Conservative AABB entry distance of each ray to each cluster.

    Returns (R, C) float32: max(t_enter, 0) where the slab test passes
    (hitAABB semantics, glsl:303-316: visit iff t1 >= t0 and t1 > 0), INF
    where it misses (schedule.py::cluster_tnear in the JAX package). An
    entry of -0.0 becomes +0.0, so a sort of these distances on the card
    (a radix sort of their bits) sees the ties that the CPU's sees.
    """
    small = torch.abs(direction) < 1e-12
    signed_eps = torch.where(direction < 0, -1e-12, 1e-12).to(direction.dtype)
    inv = 1.0 / torch.where(small, signed_eps, direction)
    r, c = origin.shape[0], cl_min.shape[0]
    t0 = torch.full((r, c), -INF, dtype=torch.float32, device=origin.device)
    t1 = torch.full((r, c), INF, dtype=torch.float32, device=origin.device)
    for ax in range(3):
        near = (cl_min[None, :, ax] - origin[:, None, ax]) * inv[:, None, ax]
        far = (cl_max[None, :, ax] - origin[:, None, ax]) * inv[:, None, ax]
        t0 = torch.maximum(t0, torch.minimum(near, far))
        t1 = torch.minimum(t1, torch.maximum(near, far))
    visit = (t1 >= t0) & (t1 > 0.0)
    return torch.where(visit & (t0 > 0.0), t0,
                       torch.where(visit, 0.0, INF))


def ray_features(origin, direction):
    """(R, 16) f32 feature vector [o, d, o x d, 1, 0...] per ray."""
    r = origin.shape[0]
    return torch.cat([
        origin, direction, _cross(origin, direction),
        torch.ones((r, 1), dtype=origin.dtype, device=origin.device),
        torch.zeros((r, N_FEAT - 10), dtype=origin.dtype,
                    device=origin.device)], dim=1)


def _sort_key(tn, direction, mask):
    """Coherence sort key (R,) int32 from the slab test: major the ray's
    nearest candidate cluster, minor a 7-bit quantized direction;
    _DEAD_KEY for rays with no candidate or masked off."""
    ncand = torch.sum(tn < INF, dim=1)
    nearest = torch.argmin(tn, dim=1).to(torch.int32)
    phi = torch.atan2(direction[:, 2], direction[:, 0])
    kphi = torch.clamp(((phi * (0.5 / math.pi) + 0.5) * 16).to(torch.int32),
                       0, 15)
    kct = torch.clamp(((direction[:, 1] * 0.5 + 0.5) * 8).to(torch.int32),
                      0, 7)
    key = nearest * 128 + kphi * 8 + kct
    return torch.where(mask & (ncand > 0), key, _DEAD_KEY)


def _chunked_tnear(origin, direction, mask, cl_min, cl_max):
    """Yield (slice, masked tn chunk) over _SLAB_CHUNK-ray chunks."""
    for lo in range(0, origin.shape[0], _SLAB_CHUNK):
        sl = slice(lo, lo + _SLAB_CHUNK)
        tn = cluster_tnear(origin[sl], direction[sl], cl_min, cl_max)
        yield sl, torch.where(mask[sl, None], tn, INF)


def _span_lists(origin, direction, mask, cl_min, cl_max):
    """Per-tile min entry distance (G, C) and per-ray cap (R,) of rays in
    their sorted order; R is a multiple of TILE_R."""
    tile_tn, cap = [], []
    for _, tn in _chunked_tnear(origin, direction, mask, cl_min, cl_max):
        tile_tn.append(tn.reshape(-1, TILE_R, tn.shape[1]).amin(dim=1))
        far = torch.amax(torch.where(tn < INF, tn, -INF), dim=1)
        cap.append(torch.nextafter(far, torch.full_like(far, INF)))
    return torch.cat(tile_tn), torch.cat(cap)


# ---------------------------------------------------------------------------
# The kernel: hand-written CUDA on the card, plain torch on the CPU
# ---------------------------------------------------------------------------


def check_slots(fn, c, t_blk, limit=MAX_SLOTS, beyond=""):
    """Raise ValueError when c clusters of t_blk slots are more than
    `limit` slots, the most a kernel's records can name (`beyond`: what
    the message adds)."""
    if c * t_blk > limit:
        raise ValueError(
            f"{fn}: {c} clusters of {t_blk} slots ({c * t_blk}) exceed the "
            f"{limit} slots its records can name{beyond}")


def record_slots(best):
    """The slot lane of K1's records best (..., 8) f32 as an int32 view
    (writes go through): a hit's slot c * T + k by its bits, exact up to
    MAX_SLOTS; before any hit the bits of NO_SLOT, a negative int32."""
    return best.view(torch.int32)[..., 1]


def intersect_span_plain(rf, trifeat, cid, rec, slot_bits=False):
    """One span of the cluster kernels in plain torch (csrc/mt_span.cuh):
    ray tiles rf (n, TR, 16) against the cluster blocks trifeat[cid] (cid
    (n,) int64), folded into the tiles' records rec (n, TR, 8) in place:
    [t, slot, inside] are lowered where the span holds a strictly closer
    hit; the lowest lane wins inside a span. The slot goes in as its int32
    bits (slot_bits: K1's records, record_slots) or as its float32 value
    (K2's, exact up to 2^24 slots)."""
    t_blk = trifeat.shape[2] // 4
    lane = torch.arange(t_blk, device=rf.device)
    tf = trifeat[cid]                                   # (n, 16, 4T)
    ft = torch.bmm(rf, tf)                              # (n, TR, 4T)
    a, tn, u, v = ft.split(t_blk, dim=2)
    eps = tf[:, EPS_ROW, None, :t_blk]                  # (n, 1, T)
    not_par = torch.abs(a) > eps
    s = torch.where(a > 0.0, -1.0, 1.0).to(a.dtype)
    us = u * s
    vs = v * s
    in_tri = (us > 0.0) & (vs > 0.0) & (us + vs < torch.abs(a))
    t = tn / torch.where(not_par, a, 1.0)
    valid = not_par & in_tri & (t >= T_MIN)
    tmat = torch.where(valid, t - 1e-5, INF)            # (n, TR, T)
    tmin = torch.amin(tmat, dim=2)
    k = torch.amin(torch.where(tmat <= tmin[..., None], lane, t_blk), dim=2)
    a_win = torch.gather(a, 2, torch.clamp(k, max=t_blk - 1)[..., None])
    better = (tmin < INF) & (tmin < rec[..., 0])
    slot = cid[:, None] * t_blk + k
    rec[..., 0] = torch.where(better, tmin, rec[..., 0])
    if slot_bits:
        held = record_slots(rec)
        held.copy_(torch.where(better, slot.to(torch.int32), held))
    else:
        rec[..., 1] = torch.where(better, slot.to(torch.float32),
                                  rec[..., 1])
    rec[..., 2] = torch.where(better, (a_win[..., 0] > 0.0).float(),
                              rec[..., 2])
    return rec


def sweep_plain(nspan, spans, tile_sorted, rayfeat, best, trifeat):
    """Plain PyTorch version of csrc/sweep.cu, same inputs and output.

    nspan (G,) i32; spans (G, C) i32 cluster ids, nearest first;
    tile_sorted (G, C) f32 their tile entry distances; rayfeat (G*TILE_R,
    16) f32; best (G*TILE_R, 8) f32 records [t, slot, inside, cap, anyhit,
    ...]; trifeat (C, 16, 4T) f32. Returns the updated records (a new
    tensor). Vectorised over tiles: span j of every tile still sweeping
    is one batched matmul, then the kernel's epilogue and stop test.
    `sweep_plain.visited` keeps the last call's (G,) count of spans each
    tile walked before its stop test ended the walk: the work the kernel
    does on the same inputs. Their sum goes to utils/timing.py's device
    counter k1_spans_walked while tracing is on.
    """
    sweep_plain.calls += 1
    g, c = spans.shape
    rf = rayfeat.reshape(g, TILE_R, N_FEAT)
    best = best.clone().reshape(g, TILE_R, BEST_W)
    active = torch.nonzero(nspan > 0).squeeze(1)
    visited = torch.zeros(g, dtype=torch.int64, device=spans.device)
    sweep_plain.visited = visited
    j = 0
    while active.numel():
        visited[active] += 1
        rec = intersect_span_plain(rf[active], trifeat,
                                   spans[active, j].long(), best[active],
                                   slot_bits=True)
        best[active] = rec
        # stop test (csrc/sweep.cu): occluded any-hit rays are not live
        live_t = torch.where((rec[..., 4] > 0.5) & (record_slots(rec) >= 0),
                             -INF, rec[..., 0])
        thresh = torch.amax(torch.minimum(live_t, rec[..., 3]), dim=1)
        if j + 1 >= c:
            break
        more = (j + 1 < nspan[active]) & (tile_sorted[active, j + 1] < thresh)
        active = active[more]
        j += 1
    timing.add_device("k1_spans_walked", visited.sum())
    return best.reshape(-1, BEST_W)


sweep_plain.calls = 0
sweep_plain.visited = None


def _declare(lib):
    """Declare the C signatures of a loaded csrc/sweep.cu."""
    lib.sweep_tile_rays.argtypes = []
    lib.sweep_tile_rays.restype = ctypes.c_int
    lib.sweep_launch.argtypes = ([ctypes.c_void_p] * 6
                                 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2)
    lib.sweep_launch.restype = ctypes.c_int
    lib.sweep_cluster_size.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.sweep_cluster_size.restype = ctypes.c_int
    lib.sweep_max_block_tris.argtypes = []
    lib.sweep_max_block_tris.restype = ctypes.c_int
    if lib.sweep_tile_rays() != TILE_R:
        raise RuntimeError(
            "csrc/mt_span.cuh TILE_R differs from ops/sweep.py")
    if lib.sweep_max_block_tris() != MAX_BLOCK_TRIS:
        raise RuntimeError(
            "csrc/mt_span.cuh MAX_BLOCK_TRIS differs from ops/sweep.py")
    return lib


def sweep(nspan, spans, tile_sorted, rayfeat, best, trifeat):
    """The span-sweep kernel: csrc/sweep.cu for CUDA tensors (best is
    updated in place and returned), sweep_plain for CPU tensors. Same
    contract as sweep_plain; the kernel takes cluster blocks of up to
    MAX_BLOCK_TRIS triangles, and both versions at most MAX_SLOTS slots:
    beyond, ValueError. `sweep.launches` counts kernel launches. While
    utils/timing.py's tracing is on the kernel adds the spans it walks
    (once per tile) to the device counter k1_spans_walked."""
    dev = rayfeat.device
    g, c = spans.shape
    t_blk = trifeat.shape[2] // 4
    check_slots("sweep", trifeat.shape[0], t_blk)
    if dev.type == "cpu":
        return sweep_plain(nspan, spans, tile_sorted, rayfeat, best, trifeat)
    if dev.type != "cuda":
        raise NotImplementedError(f"the sweep kernel has no {dev} version")
    want = {
        "nspan": (nspan, torch.int32, (g,)),
        "spans": (spans, torch.int32, (g, c)),
        "tile_sorted": (tile_sorted, torch.float32, (g, c)),
        "rayfeat": (rayfeat, torch.float32, (g * TILE_R, N_FEAT)),
        "best": (best, torch.float32, (g * TILE_R, BEST_W)),
        "trifeat": (trifeat, torch.float32, (c, N_FEAT, 4 * t_blk)),
    }
    for name, (x, dtype, shape) in want.items():
        if (x.device != dev or x.dtype != dtype or tuple(x.shape) != shape
                or not x.is_contiguous() or x.data_ptr() % 16):
            raise ValueError(
                f"sweep: {name} must be a contiguous, 16-byte aligned "
                f"{dtype} tensor of shape {shape} on {dev}; got "
                f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if not 1 <= t_blk <= MAX_BLOCK_TRIS:
        raise ValueError(f"sweep: cluster block of {t_blk} triangles; the "
                         f"kernel takes at most {MAX_BLOCK_TRIS}")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = nvcc.load("sweep").sweep_launch(
            nspan.data_ptr(), spans.data_ptr(), tile_sorted.data_ptr(),
            rayfeat.data_ptr(), best.data_ptr(), trifeat.data_ptr(),
            g, c, t_blk, timing.device_counter("k1_spans_walked", dev),
            stream)
    if rc != 0:
        raise RuntimeError(f"sweep kernel launch failed: cudaError {rc}")
    sweep.launches += 1
    return best


sweep.launches = 0


def _smoke(device):
    """One tile of rays against one cluster of 8 triangles."""
    gen = torch.Generator(device="cpu").manual_seed(0)
    rayfeat = torch.rand((TILE_R, N_FEAT), generator=gen).to(device)
    trifeat = torch.rand((1, N_FEAT, 32), generator=gen).to(device)
    best = torch.zeros((TILE_R, BEST_W), device=device)
    best[:, 0], best[:, 1], best[:, 3] = INF, NO_SLOT, INF
    nspan = torch.ones(1, dtype=torch.int32, device=device)
    spans = torch.zeros((1, 1), dtype=torch.int32, device=device)
    tile_sorted = torch.zeros((1, 1), device=device)
    return lambda: sweep(nspan, spans, tile_sorted, rayfeat, best.clone(),
                         trifeat)


nvcc.register("sweep", _declare, _smoke)


# ---------------------------------------------------------------------------
# The preparation: hand-written CUDA on the card, plain torch on the CPU
# ---------------------------------------------------------------------------


def sweep_key_plain(origin, direction, mask, cl_min, cl_max):
    """Plain PyTorch version of csrc/sweep_prep.cu's sweep_key: the
    coherence key (R,) int32 of each ray (_sort_key) from the slab test,
    in chunks of _SLAB_CHUNK rays."""
    sweep_key_plain.calls += 1
    return torch.cat([
        _sort_key(tn, direction[sl], mask[sl])
        for sl, tn in _chunked_tnear(origin, direction, mask, cl_min,
                                     cl_max)])


sweep_key_plain.calls = 0


def sweep_spans_plain(origin, direction, mask, anyhit, perm, cl_min,
                      cl_max):
    """Plain PyTorch version of csrc/sweep_prep.cu's sweep_spans.

    origin, direction (R, 3) f32, mask, anyhit (R,) bool, R a multiple of
    TILE_R; perm (R,) int64, the kernel order of the rays (None: their
    order); cl_min, cl_max (C, 3) f32. Returns the sweep kernel's arguments
    but trifeat: nspan (G,) i32, spans (G, C) i32 cluster ids nearest
    first (a stable sort of the tile minima), tile_sorted (G, C) f32 their
    tile entry distances, rayfeat (R, 16) f32 and best (R, 8) f32 records
    [INF or -INF (masked), NO_SLOT, 0, cap, anyhit, 0, 0, 0], all in
    kernel order. The rays that are masked on and enter some cluster (a cap of at
    least 0) go to utils/timing.py's device counter cast_live_rays while
    tracing is on."""
    sweep_spans_plain.calls += 1
    if perm is not None:
        origin, direction = origin[perm], direction[perm]
        mask, anyhit = mask[perm], anyhit[perm]
    tile_tn, cap = _span_lists(origin, direction, mask, cl_min, cl_max)
    # a ray that enters no cluster has the cap nextafter(-INF) < 0
    timing.add_device("cast_live_rays", torch.sum(cap >= 0.0))
    tile_sorted, order = torch.sort(tile_tn, dim=1, stable=True)
    nspan = torch.sum(tile_sorted < INF, dim=1, dtype=torch.int32)
    best = torch.zeros((origin.shape[0], BEST_W), dtype=torch.float32,
                       device=origin.device)
    best[:, 0] = torch.where(mask, INF, -INF)   # masked rays never update
    best[:, 1] = NO_SLOT
    best[:, 3] = cap
    best[:, 4] = anyhit.float()
    return (nspan, order.to(torch.int32), tile_sorted.contiguous(),
            ray_features(origin, direction), best)


sweep_spans_plain.calls = 0


def group_boxes_plain(cl_min, cl_max):
    """Plain PyTorch version of csrc/sweep_prep.cu's sweep_groups: (2, G,
    3) f32, G = ceil(C / CULL_GROUP), the elementwise min of cl_min and max
    of cl_max over each run of CULL_GROUP consecutive clusters (the last
    run may be shorter)."""
    pad = (-cl_min.shape[0]) % CULL_GROUP
    lo = torch.cat([cl_min, cl_min.new_full((pad, 3), math.inf)])
    hi = torch.cat([cl_max, cl_max.new_full((pad, 3), -math.inf)])
    return torch.stack([lo.reshape(-1, CULL_GROUP, 3).amin(dim=1),
                        hi.reshape(-1, CULL_GROUP, 3).amax(dim=1)])


def _declare_prep(lib):
    """Declare the C signatures of a loaded csrc/sweep_prep.cu."""
    for name in ("sweep_prep_tile_rays", "sweep_prep_group"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    lib.sweep_groups_launch.argtypes = ([ctypes.c_void_p] * 3
                                        + [ctypes.c_int, ctypes.c_void_p])
    lib.sweep_groups_launch.restype = ctypes.c_int
    lib.sweep_key_launch.argtypes = ([ctypes.c_void_p] * 7
                                     + [ctypes.c_int] * 2
                                     + [ctypes.c_void_p] * 2)
    lib.sweep_key_launch.restype = ctypes.c_int
    lib.sweep_spans_launch.argtypes = ([ctypes.c_void_p] * 14
                                       + [ctypes.c_int] * 2
                                       + [ctypes.c_void_p] * 4)
    lib.sweep_spans_launch.restype = ctypes.c_int
    for name, want in (("tile_rays", TILE_R), ("group", CULL_GROUP)):
        if getattr(lib, f"sweep_prep_{name}")() != want:
            raise RuntimeError(f"csrc/sweep_prep.cu {name.upper()} differs "
                               "from ops/sweep.py")
    return lib


def _check_prep(fn, dev, tensors):
    """Raise ValueError unless every (name, tensor, dtype, shape) is a
    contiguous tensor of that type and shape on dev."""
    for name, x, dtype, shape in tensors:
        if not isinstance(x, torch.Tensor):
            raise ValueError(f"{fn}: {name} must be a tensor; got {x!r}")
        if (x.device != dev or x.dtype != dtype
                or tuple(x.shape) != tuple(shape) or not x.is_contiguous()):
            raise ValueError(
                f"{fn}: {name} must be a contiguous {dtype} tensor of shape "
                f"{tuple(shape)} on {dev}; got {x.dtype} {tuple(x.shape)} "
                f"on {x.device}")


def _launch_prep(fn, dev, call):
    with torch.cuda.device(dev):
        rc = call(torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn} kernel launch failed: cudaError {rc}")


def _prep_device(fn, origin, cl_min):
    """The device of a preparation call: 'cpu' (the plain version) or a
    CUDA device (the kernel, which takes any cluster count C >= 1)."""
    dev = origin.device
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise NotImplementedError(f"the {fn} kernel has no {dev} version")
    if cl_min.shape[0] < 1:
        raise ValueError(f"{fn}: no clusters; the kernel takes C >= 1")
    return dev


def group_boxes(cl_min, cl_max):
    """The group boxes of the clusters (group_boxes_plain's (2, G, 3)
    values): csrc/sweep_prep.cu's sweep_groups on a CUDA tensor,
    group_boxes_plain on a CPU tensor. `group_boxes.launches` counts kernel
    launches."""
    dev = _prep_device("group_boxes", cl_min, cl_min)
    if dev.type == "cpu":
        return group_boxes_plain(cl_min, cl_max)
    c = cl_min.shape[0]
    _check_prep("group_boxes", dev, (
        ("cl_min", cl_min, torch.float32, (c, 3)),
        ("cl_max", cl_max, torch.float32, (c, 3))))
    out = torch.empty((2, -(-c // CULL_GROUP), 3), dtype=torch.float32,
                      device=dev)
    lib = nvcc.load("sweep_prep")
    _launch_prep("group_boxes", dev, lambda stream: lib.sweep_groups_launch(
        cl_min.data_ptr(), cl_max.data_ptr(), out.data_ptr(), c, stream))
    group_boxes.launches += 1
    return out


group_boxes.launches = 0


def sweep_key(origin, direction, mask, cl_min, cl_max, groups):
    """The coherence key of each ray: csrc/sweep_prep.cu's sweep_key on a
    CUDA tensor (any cluster count: it stages the group boxes in chunks),
    sweep_key_plain on a CPU tensor; the same (R,) int32 values, as JAX's
    _sort_key: nearest * 128 + 127 stays below _DEAD_KEY for up to
    MAX_KEY_CLUSTERS clusters, and both versions raise ValueError beyond.
    `groups`: group_boxes(cl_min, cl_max), which the kernel culls its slab
    tests with (one cast's two kernels share them; the plain version does
    not read them). `sweep_key.launches` counts kernel launches. While
    utils/timing.py's tracing is on, the kernel adds its member slab tests
    to the device counter k1a_pairs_tested."""
    dev = _prep_device("sweep_key", origin, cl_min)
    if cl_min.shape[0] > MAX_KEY_CLUSTERS:
        raise ValueError(f"sweep_key: {cl_min.shape[0]} clusters; the key "
                         f"names at most {MAX_KEY_CLUSTERS}")
    if dev.type == "cpu":
        return sweep_key_plain(origin, direction, mask, cl_min, cl_max)
    r, c = origin.shape[0], cl_min.shape[0]
    _check_prep("sweep_key", dev, (
        ("origin", origin, torch.float32, (r, 3)),
        ("direction", direction, torch.float32, (r, 3)),
        ("mask", mask, torch.bool, (r,)),
        ("cl_min", cl_min, torch.float32, (c, 3)),
        ("cl_max", cl_max, torch.float32, (c, 3)),
        ("groups", groups, torch.float32, (2, -(-c // CULL_GROUP), 3))))
    key = torch.empty(r, dtype=torch.int32, device=dev)
    lib = nvcc.load("sweep_prep")
    _launch_prep("sweep_key", dev, lambda stream: lib.sweep_key_launch(
        origin.data_ptr(), direction.data_ptr(), mask.data_ptr(),
        cl_min.data_ptr(), cl_max.data_ptr(), groups.data_ptr(),
        key.data_ptr(), r, c,
        timing.device_counter("k1a_pairs_tested", dev), stream))
    sweep_key.launches += 1
    return key


sweep_key.launches = 0


def sweep_spans(origin, direction, mask, anyhit, perm, cl_min, cl_max,
                groups):
    """Span lists, ray features and records of rays in kernel order:
    csrc/sweep_prep.cu's sweep_spans on a CUDA tensor (the members of the
    group boxes `groups` that a tile's rays enter, as sweep_key takes
    them; a tile whose finite minima or entered groups outgrow shared
    memory through sorted runs in a (G, C) 64-bit scratch allocated here
    for every cast), sweep_spans_plain on a CPU tensor; same contract and
    values. `sweep_spans.launches` counts kernel launches. While
    utils/timing.py's tracing is on, the kernel adds the rays that are
    masked on and enter some cluster to the device counter cast_live_rays,
    its member slab tests to k1a_pairs_tested and the tiles that take the
    runs path to k1a_runs_tiles."""
    dev = _prep_device("sweep_spans", origin, cl_min)
    if dev.type == "cpu":
        return sweep_spans_plain(origin, direction, mask, anyhit, perm,
                                 cl_min, cl_max)
    r, c = origin.shape[0], cl_min.shape[0]
    if r % TILE_R:
        raise ValueError(f"sweep_spans: {r} rays, not a multiple of "
                         f"{TILE_R}")
    g = r // TILE_R
    _check_prep("sweep_spans", dev, (
        ("origin", origin, torch.float32, (r, 3)),
        ("direction", direction, torch.float32, (r, 3)),
        ("mask", mask, torch.bool, (r,)),
        ("anyhit", anyhit, torch.bool, (r,)),
        *((("perm", perm, torch.int64, (r,)),) if perm is not None else ()),
        ("cl_min", cl_min, torch.float32, (c, 3)),
        ("cl_max", cl_max, torch.float32, (c, 3)),
        ("groups", groups, torch.float32, (2, -(-c // CULL_GROUP), 3))))
    nspan = torch.empty(g, dtype=torch.int32, device=dev)
    spans = torch.empty((g, c), dtype=torch.int32, device=dev)
    tile_sorted = torch.empty((g, c), dtype=torch.float32, device=dev)
    rayfeat = torch.empty((r, N_FEAT), dtype=torch.float32, device=dev)
    best = torch.empty((r, BEST_W), dtype=torch.float32, device=dev)
    # the sorted runs of the runs path, uint64 keys held as int64
    runs = torch.empty((g, c), dtype=torch.int64, device=dev)
    lib = nvcc.load("sweep_prep")
    _launch_prep("sweep_spans", dev, lambda stream: lib.sweep_spans_launch(
        origin.data_ptr(), direction.data_ptr(), mask.data_ptr(),
        anyhit.data_ptr(), None if perm is None else perm.data_ptr(),
        cl_min.data_ptr(), cl_max.data_ptr(), groups.data_ptr(),
        nspan.data_ptr(), spans.data_ptr(), tile_sorted.data_ptr(),
        rayfeat.data_ptr(), best.data_ptr(), runs.data_ptr(), g, c,
        timing.device_counter("cast_live_rays", dev),
        timing.device_counter("k1a_pairs_tested", dev),
        timing.device_counter("k1a_runs_tiles", dev), stream))
    sweep_spans.launches += 1
    return nspan, spans, tile_sorted, rayfeat, best


sweep_spans.launches = 0


def _smoke_prep(device):
    """Two tiles of rays against three clusters: the key, its sort and
    the span lists, as one flat float tensor."""
    gen = torch.Generator(device="cpu").manual_seed(0)
    r = 2 * TILE_R
    origin = (torch.rand((r, 3), generator=gen) * 4 - 2).to(device)
    direction = torch.nn.functional.normalize(
        torch.rand((r, 3), generator=gen) - 0.5, dim=1).to(device)
    mask = (torch.rand(r, generator=gen) < 0.9).to(device)
    anyhit = torch.zeros(r, dtype=torch.bool, device=device)
    cl_min = torch.tensor([[-1.0, -1.0, -1.0], [0.0, 0.0, 0.0],
                           [-3.0, 1.0, -3.0]], device=device)
    cl_max = cl_min + 1.5

    def launch():
        groups = group_boxes(cl_min, cl_max)
        key = sweep_key(origin, direction, mask, cl_min, cl_max, groups)
        perm = torch.sort(key, stable=True).indices
        out = sweep_spans(origin, direction, mask, anyhit, perm, cl_min,
                          cl_max, groups)
        return torch.cat([key.float(), *(x.float().reshape(-1)
                                         for x in out)])

    return launch


nvcc.register("sweep_prep", _declare_prep, _smoke_prep)


# ---------------------------------------------------------------------------
# Casts
# ---------------------------------------------------------------------------


def pad_cast(origin, direction, mask, anyhit):
    """A cast's rays padded to a multiple of TILE_R with masked rays
    (origin 0, direction +z), as contiguous tensors."""
    pad = (-origin.shape[0]) % TILE_R
    if pad:
        origin = torch.cat([origin, origin.new_zeros((pad, 3))])
        direction = torch.cat([direction, torch.tensor(
            [[0.0, 0.0, 1.0]], device=direction.device).expand(pad, 3)])
        mask = torch.cat([mask, mask.new_zeros(pad)])
        anyhit = torch.cat([anyhit, anyhit.new_zeros(pad)])
    return (origin.contiguous(), direction.contiguous(), mask.contiguous(),
            anyhit.contiguous())


def sweep_inputs(scene, origin, direction, mask, anyhit):
    """Preparation of one cast: the sweep kernel's arguments (nspan,
    spans, tile_sorted, rayfeat, best, trifeat) for rays padded to a
    multiple of TILE_R, and the sort permutation (None when the rays fit
    one tile) that put them in kernel order. On a CUDA tensor group_boxes,
    then sweep_key, one torch.sort and sweep_spans, whatever the cluster
    count; on a CPU tensor their plain versions. A span rt.cast.prep; the
    padded R goes to the counter cast_lanes, R x C (the ray x cluster
    pairs each preparation kernel covers) to cast_pairs and C x T (the
    slots K1's records name) to cast_slots."""
    with timing.span("rt.cast.prep"):
        origin, direction, mask, anyhit = pad_cast(origin, direction, mask,
                                                   anyhit)
        r = origin.shape[0]
        cl_min, cl_max = scene.cl_aabb_min, scene.cl_aabb_max
        c = cl_min.shape[0]
        timing.count("cast_lanes", r)
        timing.count("cast_pairs", r * c)
        timing.count("cast_slots", c * scene.cl_trifeat.shape[2] // 4)

        groups = group_boxes(cl_min, cl_max)   # both kernels take them
        perm = None
        if r > TILE_R:
            key = sweep_key(origin, direction, mask, cl_min, cl_max, groups)
            perm = torch.sort(key, stable=True).indices
        args = sweep_spans(origin, direction, mask, anyhit, perm, cl_min,
                           cl_max, groups)
        return (*args, scene.cl_trifeat.contiguous()), perm


def _swept(scene, origin, direction, mask, anyhit) -> Hit:
    args, perm = sweep_inputs(scene, origin, direction, mask, anyhit)
    with timing.span("rt.cast.k1"):
        best = sweep(*args)
    with timing.span("rt.cast.finish"):
        if perm is not None:   # back to the callers' order
            best = torch.empty_like(best).index_copy_(0, perm, best)
        r_in = origin.shape[0]
        best = best[:r_in]
        t = torch.where(mask, best[:, 0], INF)
        slot = torch.where(mask, record_slots(best), -1)
        slot2tri = scene.cl_slot2tri
        tri = torch.where(
            slot >= 0,
            slot2tri[torch.clamp(slot, 0, slot2tri.shape[0] - 1).long()], -1)
        return Hit(t=t, tri=tri.to(torch.int32),
                   inside=mask & (best[:, 2] > 0.5))


def closest_hit_swept(scene, origin, direction, mask=None,
                      any_hit: bool = False) -> Hit:
    """Swept closest (or any) hit against the scene clusters; masked-off
    rays return Hit(INF, -1, False). any_hit: occlusion semantics, the
    sweep may stop at any hit (is_hit is the meaningful field)."""
    r = origin.shape[0]
    if mask is None:
        mask = torch.ones(r, dtype=torch.bool, device=origin.device)
    anyhit = torch.full((r,), any_hit, dtype=torch.bool, device=origin.device)
    return _swept(scene, origin, direction, mask, anyhit)


def closest_hit_swept_pair(scene, o_any, d_any, m_any, o_cls, d_cls, m_cls):
    """NEE shadow (any-hit) + bounce (closest-hit) rays in one sweep: the
    kernel reads the per-ray any-hit flag, so both populations share one
    sort, one slab pass and one launch. Returns (hit_any, hit_cls)."""
    w = o_any.shape[0]
    anyhit = torch.cat([
        torch.ones(w, dtype=torch.bool, device=o_any.device),
        torch.zeros(o_cls.shape[0], dtype=torch.bool, device=o_any.device)])
    hit = _swept(scene, torch.cat([o_any, o_cls]), torch.cat([d_any, d_cls]),
                 torch.cat([m_any, m_cls]), anyhit)
    return (Hit(hit.t[:w], hit.tri[:w], hit.inside[:w]),
            Hit(hit.t[w:], hit.tri[w:], hit.inside[w:]))
