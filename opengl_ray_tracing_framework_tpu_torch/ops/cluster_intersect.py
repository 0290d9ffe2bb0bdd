"""Dense ray-tile x elected-cluster intersection: the schedule tracer's
kernel (PyTorch counterpart of
opengl_ray_tracing_framework_tpu.ops.intersect_pallas).

Rays arrive in tiles (rows [g * R/G, (g + 1) * R/G) of rayfeat belong to
tile g). Each tile names up to K clusters, spans[g, :nspan[g]]; every ray
of the tile is intersected with every triangle of every named cluster
through the bilinear feature form [A | TN | U | V] = rayfeat (R, 16) .
trifeat (16, 4T) (models/clusters.py), and the ray's record [t, slot,
inside, ...] keeps the minimum t. Entries of spans outside [0, C) and
those at j >= nspan[g] are skipped. There is no stop test: the caller
(ops/schedule.py) elected the clusters.

cluster_intersect runs csrc/cluster_intersect.cu on CUDA tensors and
cluster_intersect_plain on CPU tensors. Epsilons and conventions are
ops.intersect.ray_triangle's: t >= T_MIN before the 1e-5 pullback,
parallel iff |A| <= E, strict interior test, inside = (d.n > 0).
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import nvcc
from .intersect import INF
from .sweep import (BEST_W, MAX_BLOCK_TRIS, N_FEAT, NO_SLOT, TILE_R,
                    check_slots, intersect_span_plain)

MAX_SLOTS = 1 << 24   # slot = c*T + k is kept as a float32's value: exact
                      # up to 2^24 (the sweep tracer keeps its bits)
MAX_SPANS = 1 << 19   # span positions the kernel's (t, j, k) key can name


def init_best(n_rays: int, device) -> torch.Tensor:
    """Fresh best-hit records: t = INF, slot = NO_SLOT, inside = 0."""
    best = torch.zeros((n_rays, BEST_W), dtype=torch.float32, device=device)
    best[:, 0] = INF
    best[:, 1] = NO_SLOT
    return best


def _check_shapes(rayfeat, best, spans, nspan, trifeat):
    """(G, K, rays per tile, C, T) of one call, or ValueError."""
    r = rayfeat.shape[0]
    g, k = spans.shape
    c, rows, cols = trifeat.shape
    t_blk = cols // 4
    if g < 1 or r % g or (r // g) % TILE_R:
        raise ValueError(
            f"cluster_intersect: {r} rays in {g} tiles; the rays per tile "
            f"must be a multiple of {TILE_R}")
    if (tuple(rayfeat.shape) != (r, N_FEAT) or tuple(best.shape) != (r, BEST_W)
            or tuple(nspan.shape) != (g,) or rows != N_FEAT
            or cols != 4 * t_blk):
        raise ValueError(
            f"cluster_intersect: shapes rayfeat {tuple(rayfeat.shape)}, best "
            f"{tuple(best.shape)}, spans {tuple(spans.shape)}, nspan "
            f"{tuple(nspan.shape)}, trifeat {tuple(trifeat.shape)} do not "
            "fit together")
    check_slots("cluster_intersect", c, t_blk, MAX_SLOTS,
                "; the sweep tracer (cast_backend 'sweep') names up to "
                "2^31 - 1")
    return g, k, r // g, c, t_blk


def cluster_intersect_plain(rayfeat, best, spans, nspan, trifeat):
    """Plain PyTorch version of csrc/cluster_intersect.cu, same inputs.

    rayfeat (R, 16) f32; best (R, 8) f32 records [t, slot, inside, ...];
    spans (G, K) i32 cluster ids; nspan (G,) i32; trifeat (C, 16, 4T) f32.
    Returns the updated records as a new tensor. Entry j of every tile that
    has one is a single batched matmul plus the kernel's epilogue.
    """
    cluster_intersect_plain.calls += 1
    g, k, tile, c, _ = _check_shapes(rayfeat, best, spans, nspan, trifeat)
    rf = rayfeat.reshape(g, tile, N_FEAT)
    best = best.clone().reshape(g, tile, BEST_W)
    for j in range(k):
        cid = spans[:, j].long()
        active = torch.nonzero((j < nspan) & (cid >= 0) & (cid < c)) \
            .squeeze(1)
        if active.numel():
            best[active] = intersect_span_plain(
                rf[active], trifeat, cid[active], best[active])
    return best.reshape(-1, BEST_W)


cluster_intersect_plain.calls = 0


def _declare(lib):
    """Declare the C signatures of a loaded csrc/cluster_intersect.cu."""
    lib.cluster_intersect_block_rays.argtypes = []
    lib.cluster_intersect_block_rays.restype = ctypes.c_int
    lib.cluster_intersect_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.cluster_intersect_launch.restype = ctypes.c_int
    lib.cluster_intersect_max_spans.argtypes = []
    lib.cluster_intersect_max_spans.restype = ctypes.c_int
    lib.cluster_intersect_max_block_tris.argtypes = []
    lib.cluster_intersect_max_block_tris.restype = ctypes.c_int
    if lib.cluster_intersect_block_rays() != TILE_R:
        raise RuntimeError(
            "csrc/mt_span.cuh TILE_R differs from ops/sweep.py")
    if lib.cluster_intersect_max_spans() != MAX_SPANS:
        raise RuntimeError(
            "csrc/mt_span.cuh KEY_LANE_BITS differs from MAX_SPANS")
    if lib.cluster_intersect_max_block_tris() != MAX_BLOCK_TRIS:
        raise RuntimeError(
            "csrc/mt_span.cuh MAX_BLOCK_TRIS differs from ops/sweep.py")
    return lib


def cluster_intersect(rayfeat, best, spans, nspan, trifeat):
    """The cluster-intersect kernel: csrc/cluster_intersect.cu for CUDA
    tensors (best is updated in place and returned), the plain version for
    CPU tensors (a new tensor). Same contract as cluster_intersect_plain.
    `cluster_intersect.launches` counts kernel launches."""
    dev = rayfeat.device
    if dev.type == "cpu":
        return cluster_intersect_plain(rayfeat, best, spans, nspan, trifeat)
    if dev.type != "cuda":
        raise NotImplementedError(
            f"the cluster-intersect kernel has no {dev} version")
    g, k, tile, c, t_blk = _check_shapes(rayfeat, best, spans, nspan, trifeat)
    want = {"rayfeat": (rayfeat, torch.float32), "best": (best, torch.float32),
            "spans": (spans, torch.int32), "nspan": (nspan, torch.int32),
            "trifeat": (trifeat, torch.float32)}
    for name, (x, dtype) in want.items():
        if (x.device != dev or x.dtype != dtype or not x.is_contiguous()
                or x.data_ptr() % 16):
            raise ValueError(
                f"cluster_intersect: {name} must be a contiguous, 16-byte "
                f"aligned {dtype} tensor on {dev}; got {x.dtype} on "
                f"{x.device}")
    if not 1 <= t_blk <= MAX_BLOCK_TRIS:
        raise ValueError(
            f"cluster_intersect: cluster block of {t_blk} triangles; the "
            f"kernel takes at most {MAX_BLOCK_TRIS}")
    if k > MAX_SPANS:
        raise ValueError(
            f"cluster_intersect: {k} spans per tile; the kernel takes at "
            f"most {MAX_SPANS}")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = nvcc.load("cluster_intersect").cluster_intersect_launch(
            rayfeat.data_ptr(), best.data_ptr(), spans.data_ptr(),
            nspan.data_ptr(), trifeat.data_ptr(), g * tile, tile, k, c,
            t_blk, stream)
    if rc != 0:
        raise RuntimeError(
            f"cluster_intersect kernel launch failed: cudaError {rc}")
    cluster_intersect.launches += 1
    return best


cluster_intersect.launches = 0


def _smoke(device):
    """One tile of rays against one elected cluster of 8 triangles."""
    gen = torch.Generator(device="cpu").manual_seed(0)
    rayfeat = torch.rand((TILE_R, N_FEAT), generator=gen).to(device)
    trifeat = torch.rand((1, N_FEAT, 32), generator=gen).to(device)
    best = init_best(TILE_R, device)
    spans = torch.zeros((1, 1), dtype=torch.int32, device=device)
    nspan = torch.ones(1, dtype=torch.int32, device=device)
    return lambda: cluster_intersect(rayfeat, best.clone(), spans, nspan,
                                     trifeat)


nvcc.register("cluster_intersect", _declare, _smoke)
