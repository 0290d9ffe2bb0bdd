"""PyTorch port, kernels on the card against their plain versions on the
same inputs: the cluster kernels at every width of cluster block, K1
(csrc/sweep.cu) and K2 (csrc/cluster_intersect.cu) against sweep_plain and
cluster_intersect_plain for blocks of T = 256 (one bulk copy of the whole
block), 512, 1,024 and 4,096 (chunks of a CTA's columns by tensor-map
copies) and 302 (no multiple of 4: hand-copied chunks), and the refusal of
a block wider than the kernels' 4,096; K1's preparation kernels
(csrc/sweep_prep.cu: sweep_key, sweep_spans, both culled by the group
boxes of sweep_groups) against sweep_key_plain and sweep_spans_plain on
every output, on the 81,922-triangle scene in blocks of 256, 512, 1,024,
128 and 8 (C = 484, 243, 121, one over a chunk of 512 boxes, and
14,172), on the 5,122-triangle scene in blocks of 256 (33), on its
sphere at 7 subdivisions in blocks of 16 (29,442: group boxes in two
chunks of 512), at C = 1, 45, 8,192 and one more, every tile minimum
finite (sorted runs in global scratch, merged by rank), and at 3 x 8,192
+ 5, the cases aimed at the group-box cull (_prep_culled), with the tiles
that take the runs path counted (k1a_runs_tiles), and the whole merged
cast on the 14,172 clusters against the plain versions; the group
boxes (sweep_groups) against group_boxes_plain; a cast on the normal
path over 65,600 clusters of 256 (slots past 2^24) against the plain
reference's triangle ids;
the chained lookups (K4c-2,
csrc/probe_gather.cu) on tables whose columns differ and the block sums
(K4c-3, csrc/probe_stream.cu) for one and many rows of starts, and the
refusal of a table column over the shared-memory limit; the per-CTA copy
(K4a, csrc/probe_copy.cu) at every tile of launch_overhead.TILES on row
counts that are no multiple of the tile, with and without span rows, and
with whole rayfeat rows read; the empty launch-floor kernel and the
shared-memory probe (K4c-1) at 227 KB (csrc/probe_smem.cu); and the
bench's correctness check (bench.parity: a render through K1 or K2 against
the CPU's plain render), which holds and which fails on a moved image.

Every test here is marked `cuda` and skips without a card: the kernels
are CUDA C++ and have no interpreted mode. This file imports nothing of
the JAX package, so it also runs where JAX is not installed, without the
repository's conftest (which imports jax):

    python -m pytest --noconftest -m cuda tests/test_torch_card.py
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from opengl_ray_tracing_framework_tpu_torch import Camera, bench
from opengl_ray_tracing_framework_tpu_torch.models.scene import (
    build_test_scene)
from opengl_ray_tracing_framework_tpu_torch.ops import (
    cluster_intersect as tci)
from opengl_ray_tracing_framework_tpu_torch.ops import sweep as tsweep
from opengl_ray_tracing_framework_tpu_torch.probes import (
    card_perf, gather, launch_overhead, prep_kernels, row_balance)
from opengl_ray_tracing_framework_tpu_torch.render import _trace_rows
from opengl_ray_tracing_framework_tpu_torch.utils import timing
from opengl_ray_tracing_framework_tpu_torch.utils.config import RenderConfig

WIDTHS = [256, 512, 1024, 302, 4096]


def _sizes(t_blk):
    """(rays, any-hit share) of the K1 cases and (tiles, rays per tile) of
    the K2 cases: one tile (8 CTAs on it), 64 and 512 tiles (8 and 2), and
    1,024 tiles (1 CTA, whose columns of a 512- or 1,024-wide block are 2
    or 4 chunks); 4,096-wide blocks stop at 64 tiles, where the plain
    version's (tiles, 128, 4T) products still fit the card."""
    if t_blk > 1024:
        return ((128, 0.0), (8192, 0.3)), ((1, 128), (8, 1024))
    return (((128, 0.0), (8192, 0.0), (65536, 0.3), (131072, 0.3)),
            ((1, 128), (64, 1024), (1024, 128)))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the cluster kernels are CUDA C++ "
                    "and have no interpreted mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rays(n, seed, device):
    """Rays from around the scene towards the sphere at (0, 0, 3), so most
    of them hit and their tiles overlap several clusters."""
    rng = np.random.default_rng(seed)
    o = rng.normal(0, 2.0, (n, 3)).astype(np.float32)
    o[:, 2] -= 1.0
    d = np.array([0.0, 0.0, 3.0], np.float32) - o \
        + rng.normal(0, 0.6, o.shape).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return torch.tensor(o, device=device), torch.tensor(d, device=device)


def _scene(t_blk, device):
    # subdiv 5 (20,482 triangles) gives 4,096-triangle blocks more than one
    # cluster; subdiv 3 (1,282) is enough for the narrower ones
    host_scene, _ = build_test_scene(5 if t_blk > 1024 else 3, device="cpu")
    scene = host_scene.build(cluster_size=t_blk, device=device)
    assert scene.cl_trifeat.shape[2] == 4 * t_blk
    return scene


def _assert_same_records(got, want, label, min_hits=0.3):
    """Kernel and plain version give the same hit or miss, slot (so the
    same triangle) and inside flag on every ray, and the same t to 1e-6
    relative: the kernel sums each of A, TN, U, V as one chain of fmaf,
    while the plain version's batched product goes through cuBLAS, whose
    order of summation depends on the shape (single-tile products at
    4T = 1,024 and 1,208 round t 1 ulp apart; the others agree bit for
    bit)."""
    torch.cuda.synchronize()
    g, w = got[:, :3], want[:, :3]
    diff = (g[:, 1:] != w[:, 1:]).any(dim=1) | ~torch.isclose(
        g[:, 0], w[:, 0], rtol=1e-6, atol=0.0)
    if diff.any():
        g, w = g[diff], w[diff]
        pytest.fail(
            f"{label}: {int(diff.sum())} records differ: hit/miss "
            f"{int(((g[:, 1] >= 0) != (w[:, 1] >= 0)).sum())}, slot "
            f"{int((g[:, 1] != w[:, 1]).sum())}, inside "
            f"{int((g[:, 2] != w[:, 2]).sum())}, max |dt| "
            f"{(g[:, 0] - w[:, 0]).abs().max().item():.3g}; first rows "
            f"kernel {g[:4].tolist()} plain {w[:4].tolist()}")
    assert (want[:, 1] >= 0).float().mean() > min_hits


@pytest.mark.cuda
@pytest.mark.parametrize("t_blk", WIDTHS)
def test_sweep_kernel_equals_plain_at_every_width(t_blk):
    dev = _card()
    scene = _scene(t_blk, dev)
    for n_rays, anyhit_share in _sizes(t_blk)[0]:
        o, d = _rays(n_rays, t_blk + n_rays, dev)
        mask = torch.ones(n_rays, dtype=torch.bool, device=dev)
        anyhit = torch.rand(n_rays, device=dev) < anyhit_share
        kargs, _ = tsweep.sweep_inputs(scene, o, d, mask, anyhit)
        launches, calls = tsweep.sweep.launches, tsweep.sweep_plain.calls
        got = tsweep.sweep(*kargs[:4], kargs[4].clone(), kargs[5])
        assert tsweep.sweep.launches == launches + 1
        assert tsweep.sweep_plain.calls == calls
        _assert_same_records(got, tsweep.sweep_plain(*kargs),
                             f"T {t_blk}, {n_rays} rays")


@pytest.mark.cuda
@pytest.mark.parametrize("t_blk", WIDTHS)
def test_cluster_intersect_kernel_equals_plain_at_every_width(t_blk):
    dev = _card()
    scene = _scene(t_blk, dev)
    c = scene.cl_trifeat.shape[0]
    rng = np.random.default_rng(t_blk)
    for g, tile in _sizes(t_blk)[1]:
        o, d = _rays(g * tile, t_blk + g, dev)
        rayfeat = tsweep.ray_features(o, d)
        k = 8
        spans = torch.tensor(rng.integers(0, c + 1, (g, k)), dtype=torch.int32,
                             device=dev)   # id c is skipped
        nspan = torch.tensor(rng.integers(1, k + 1, g), dtype=torch.int32,
                             device=dev)
        if g > 1:
            nspan[g // 2] = 0   # a tile without spans keeps its records
        best = tci.init_best(g * tile, dev)
        launches = tci.cluster_intersect.launches
        got = tci.cluster_intersect(rayfeat, best.clone(), spans, nspan,
                                    scene.cl_trifeat)
        assert tci.cluster_intersect.launches == launches + 1
        want = tci.cluster_intersect_plain(rayfeat, best, spans, nspan,
                                           scene.cl_trifeat)
        _assert_same_records(got, want, f"T {t_blk}, {g} tiles of {tile}",
                             min_hits=0.0)


@pytest.mark.cuda
def test_blocks_beyond_the_limit_are_refused():
    dev = _card()
    t_blk = tsweep.MAX_BLOCK_TRIS + 4
    trifeat = torch.zeros((1, 16, 4 * t_blk), device=dev)
    rayfeat = torch.zeros((128, 16), device=dev)
    best = tci.init_best(128, dev)
    one = torch.ones(1, dtype=torch.int32, device=dev)
    spans = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    calls = tsweep.sweep_plain.calls, tci.cluster_intersect_plain.calls
    with pytest.raises(ValueError, match="4096"):
        tsweep.sweep(one, spans, torch.zeros((1, 1), device=dev), rayfeat,
                     best, trifeat)
    with pytest.raises(ValueError, match="4096"):
        tci.cluster_intersect(rayfeat, best, spans, one, trifeat)
    assert (tsweep.sweep_plain.calls,
            tci.cluster_intersect_plain.calls) == calls


PREP_BLOCKS = [256, 512, 1024, 128, 8]
PREP_MESH = "29,442 clusters"   # prep_kernels.mesh_scene: two chunks
PREP_JADE = "33 clusters"       # the jade5k cell's 5,122 triangles
PREP_SYNTHETIC = ["masked warps", "one live ray", "all dead", "one cluster",
                  "45 clusters", "ties", "8,192 clusters",
                  "every minimum finite", "many runs"]
PREP_CULLED = ["culled: inside a group", "culled: grazing",
               "culled: axis rays", "culled: flat boxes",
               "culled: ties across groups", "culled: some tiles fall back",
               "culled: three chunks"]
SMALL_BLOCK_CLUSTERS = 14172   # the 81,922 triangles in blocks of 8


@pytest.fixture(scope="module")
def loong_scale_scene():
    """The 81,922-triangle scene of the main path (chip_smoke.py), built
    on the host; each test cuts it into its own cluster blocks."""
    return build_test_scene(6, device="cpu")[0]


def _prep_cases(dev, seed):
    """(rays, masked share, any-hit share): a full primary batch, a
    merged-pair-sized one with masked lanes, mixed any-hit flags and a
    ragged count (padded), one tile (no sort), and a small ragged one."""
    for n, masked, anyhit_share in ((131072, 0.0, 0.0),
                                    (131072 - 37, 0.3, 0.5),
                                    (100, 0.2, 0.5), (5000, 0.5, 0.3)):
        o, d = _rays(n, seed + n, dev)
        gen = torch.Generator(device=dev).manual_seed(seed + n)
        mask = torch.rand(n, generator=gen, device=dev) >= masked
        anyhit = torch.rand(n, generator=gen, device=dev) < anyhit_share
        yield n, tsweep.pad_cast(o, d, mask, anyhit)


def _prep_synthetic(case, dev):
    """Boxes (cl_min, cl_max) and 8,192 rays (64 tiles) of a synthetic
    case of sweep_spans's tile minima: warps partly and wholly masked;
    one live ray a tile; tiles with no live ray and a tile whose live rays
    miss every box; C = 1 and C = 45 (no multiple of 32 or 4); 150 equal
    boxes among 300, so many tile minima tie (the rays inside them at
    +0.0) and the stable order decides; C = 8,192 overlapping boxes; and
    the same boxes at one more cluster, where one ray of each tile runs
    along the boxes' diagonal, so every tile minimum is finite (nf = C:
    the sorted runs of sweep_spans's runs path), beside a tile with no
    live ray and a masked warp; and the same boxes at 3 x 8,192 + 5
    (twelve runs of 2,048 and one of five)."""
    rng = np.random.default_rng(PREP_SYNTHETIC.index(case) + 11)
    c = {"one cluster": 1, "45 clusters": 45, "ties": 300,
         "8,192 clusters": 8192, "every minimum finite": 8193,
         "many runs": 3 * 8192 + 5}.get(case, 484)
    lo = rng.uniform(-3, 3, (c, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.2, 1.5, (c, 3)).astype(np.float32)
    if case == "ties":
        lo[::2], hi[::2] = lo[0], hi[0]
    if case in ("8,192 clusters", "every minimum finite", "many runs"):
        lo = (np.arange(c, dtype=np.float32)[:, None] * 1e-3
              + np.zeros((1, 3), np.float32))
        hi = lo + 1
    n = 8192
    i = np.arange(n)
    o = rng.normal(0, 2.0, (n, 3)).astype(np.float32)
    d = rng.normal(0, 1.0, (n, 3)).astype(np.float32)
    if case == "ties":   # a quarter of the rays start inside the equal boxes
        o[::4] = (lo[0] + hi[0]) / 2
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    mask = rng.random(n) >= 0.2
    if case == "masked warps":
        w = i // 32
        mask = np.where(w % 4 == 1, False,
                        np.where(w % 4 == 2, True, (i % 32) % 3 != 0))
    elif case == "one live ray":
        mask = i % tsweep.TILE_R == 77
    elif case == "all dead":
        mask = (i // tsweep.TILE_R) % 2 == 1
        miss = (i // tsweep.TILE_R) == 3   # live, and they miss every box
        o[miss] = 100.0
        d[miss] = np.float32(1 / np.sqrt(3))
    elif case == "every minimum finite":
        along = i % tsweep.TILE_R == 5   # from (-1, -1, -1) along (1, 1, 1)
        o[along] = -1.0
        d[along] = np.float32(1 / np.sqrt(3))
        tile, lane = i // tsweep.TILE_R, i % tsweep.TILE_R
        mask = along | (mask & (lane // 32 != 2))   # warp 2 all masked
        mask[tile == 3] = False
    anyhit = rng.random(n) < 0.4
    t = lambda x: torch.tensor(x, device=dev)
    return t(lo), t(hi), [(n, tsweep.pad_cast(t(o), t(d), t(mask),
                                              t(anyhit)))]


def _prep_culled(case, dev):
    """Boxes (cl_min, cl_max) and 8,192 rays (64 tiles) of a case aimed at
    the group-box cull, at C = 8,192 + 37 (no multiple of CULL_GROUP: the
    last group holds 5), or at 2 x 16,384 + 37
    (three chunks of 512 group boxes, the last of two). Group g's members are
    cubes of half-size 0.05 about points on the surface of the cube of
    half-size 0.5 about lattice point g, so the group box has an empty
    middle: rays from inside group boxes but outside all their members;
    rays on a group box's faces, edges and corners, along and across them;
    axis-parallel directions whose other components are +-0.0 or below the
    1e-12 clamp; zero-thick y slabs (members, and whole groups, flat in
    y); members copied into a group three later, so an earlier and a later
    group tie exactly (and rays start inside both copies); unit cubes
    along the diagonal (three chunks) where a tile's rays enter group
    boxes of 3,616 members (within the culled pass's KEYS_CAP = 4,096),
    of 1,024 members in the first chunk and 4,160 in the second (the runs
    path, taken after the first chunk's tests), of every cube (the runs
    path from the first chunk) or none; and tiles of rays from inside one
    group box (three chunks), in a narrow cone (a few group boxes, any
    chunk) or in any direction (more members than KEYS_CAP, few of them
    entered). Every case masks warp 2 of each tile and all of tile 3 (and
    15% of the rest)."""
    rng = np.random.default_rng(PREP_CULLED.index(case) + 29)
    group, n = tsweep.CULL_GROUP, 8192
    c = (2 * 512 * group + 37 if case in ("culled: some tiles fall back",
                                          "culled: three chunks")
         else 8192 + 37)
    k = np.arange(c)
    g = k // group
    centre = (np.stack([g % 7, (g // 7) % 7, g // 49], 1) * 2.0 - 6.0
              ).astype(np.float32)
    p = rng.uniform(-1, 1, (c, 3))
    on = rng.integers(0, 3, c)
    p[k, on] = np.where(p[k, on] < 0, -1.0, 1.0)   # on the cube's surface
    mid = (centre + 0.5 * p).astype(np.float32)
    lo, hi = mid - np.float32(0.05), mid + np.float32(0.05)
    i = np.arange(n)
    tile, lane = i // tsweep.TILE_R, i % tsweep.TILE_R
    keep_live = np.zeros(n, bool)
    o = rng.normal(0, 4.0, (n, 3)).astype(np.float32)
    d = rng.normal(0, 1.0, (n, 3)).astype(np.float32)
    pick = rng.integers(0, c // group, n)            # a group a ray
    gpick = pick[:, None] * group + np.arange(group)
    g_lo, g_hi = lo[gpick].min(axis=1), hi[gpick].max(axis=1)
    if case == "culled: inside a group":
        o[::2] = (centre[pick * group]
                  + rng.uniform(-0.3, 0.3, (n, 3)))[::2]
    elif case == "culled: grazing":
        # corners, edges and faces of group boxes, exact in float32
        side = rng.random((n, 3)) < 0.5
        o = np.where(side, g_lo, g_hi)
        free = rng.integers(0, 3, n)
        inside = rng.uniform(g_lo, g_hi).astype(np.float32)
        o[i % 3 == 1, free[i % 3 == 1]] = inside[i % 3 == 1,
                                                 free[i % 3 == 1]]
        face = i % 3 == 2
        keep = rng.integers(0, 3, n)
        o[face] = inside[face]
        o[face, keep[face]] = np.where(side, g_lo, g_hi)[face, keep[face]]
        # along the face (a zero component) or across it
        d[i % 2 == 0, keep[i % 2 == 0]] = np.where(
            rng.random((i % 2 == 0).sum()) < 0.5, 0.0, -0.0)
        corner = i % 12 == 0
        d[corner] = np.where(side[corner], 1.0, -1.0)
    elif case == "culled: axis rays":
        o = np.where(rng.random((n, 3)) < 0.5, lo[pick * group + 3],
                     rng.uniform(-7, 7, (n, 3))).astype(np.float32)
        axis = rng.integers(0, 3, n)
        special = np.float32([0.0, -0.0, 1e-13, -1e-13, 0.0, -0.0])
        d = special[rng.integers(0, len(special), (n, 3))]
        d[i, axis] = np.where(rng.random(n) < 0.5, 1.0, -1.0)
    elif case == "culled: flat boxes":
        flat = g % 2 == 0                             # whole groups flat
        lo[flat, 1] = hi[flat, 1] = centre[flat, 1]
        lo[~flat, 1] = hi[~flat, 1]                   # flat members
        o[::3, 1] = centre[pick * group, 1][::3]      # in a flat plane
        d[::3, 1] = np.where(i[::3] % 2 == 0, 0.0, -0.0)
    elif case == "culled: ties across groups":
        copy = (g % 5 == 0) & (g + 3 < c // group)
        lo[k[copy] + 3 * group], hi[k[copy] + 3 * group] = lo[copy], hi[copy]
        start = i % 4 == 0                            # inside a copied box
        src = rng.choice(k[copy], n)
        o[start] = ((lo[src] + hi[src]) / 2)[start]
    elif case == "culled: some tiles fall back":
        lo = (k.astype(np.float32)[:, None] * np.float32(1e-3)
              + np.zeros((1, 3), np.float32))
        hi = lo + 1
        o[:] = -5.0
        d[:] = -1.0                                   # away from every cube
        # rays along x at y = z = s enter the ~1,001 cubes k of s - 1 <=
        # k / 1,000 <= s: tiles 2 mod 4 the group boxes of 3,616 members,
        # 0 mod 4 1,024 in the first chunk and 4,160 in the second; tiles
        # 1 mod 4 every cube (one ray along the diagonal)
        for t_mod, s in ((2, np.float32([2.0, 4.0, 6.0, 0.5])),
                         (0, np.float32([2.0, 18.0, 20.0, 22.0, 24.0]))):
            rows = (tile % 4 == t_mod) & (lane % 8 < len(s))
            at = s[lane[rows] % 8]
            o[rows] = np.stack([np.full(rows.sum(), -1.0, np.float32), at,
                                at], 1)
            d[rows] = np.float32([1.0, 0.0, 0.0])
            keep_live |= rows
        diag = (tile % 4 == 1) & (lane == 5)
        o[diag] = -1.0
        d[diag] = np.float32(1 / np.sqrt(3))
        keep_live |= diag
    elif case == "culled: three chunks":
        near = rng.integers(0, -(-c // group), n // tsweep.TILE_R)[tile]
        o = (centre[near * group]
             + rng.uniform(-0.3, 0.3, (n, 3))).astype(np.float32)
        axis = rng.normal(0, 1.0, (n // tsweep.TILE_R, 3))[tile]
        d = np.where((tile % 2 == 0)[:, None],
                     axis + rng.normal(0, 0.1, (n, 3)),
                     rng.normal(0, 1.0, (n, 3))).astype(np.float32)
    nz = np.linalg.norm(d, axis=1, keepdims=True)
    d = np.where(nz > 0.5, d / np.maximum(nz, 1e-30), d).astype(np.float32)
    mask = (((rng.random(n) >= 0.15) | keep_live) & (lane // 32 != 2)
            & (tile != 3))
    anyhit = rng.random(n) < 0.4
    t = lambda x: torch.tensor(np.ascontiguousarray(x), device=dev)
    return t(lo), t(hi), [(n, tsweep.pad_cast(t(o), t(d), t(mask),
                                              t(anyhit)))]


@pytest.mark.cuda
@pytest.mark.parametrize("case", PREP_BLOCKS + [PREP_JADE, PREP_MESH]
                         + PREP_SYNTHETIC + PREP_CULLED)
def test_prep_kernels_equal_plain(case, loong_scale_scene):
    """sweep_key and sweep_spans, given the group boxes, equal their
    plain versions on every output (torch.equal: the same values, -0.0
    equal to +0.0; the key int32), on the main path's scene cut into
    blocks of 256, 512, 1,024, 128 and 8, on the 5,122-triangle scene (33
    clusters), on prep_kernels.mesh_scene (29,442 clusters) and on the
    synthetic cases of _prep_synthetic and _prep_culled (each also with
    the rays in their own order, so its tiles stay as built, and
    sweep_spans's member tests counted), and sweep_inputs on the card
    launches both and one sweep_groups for the two, and calls no plain
    version."""
    dev = _card()
    if isinstance(case, int):
        scene = loong_scale_scene.build(cluster_size=case, device=dev)
        lo, hi = scene.cl_aabb_min, scene.cl_aabb_max
        assert lo.shape[0] == {256: 484, 512: 243, 1024: 121,
                               8: SMALL_BLOCK_CLUSTERS}.get(
            case, lo.shape[0]) and (case != 128 or lo.shape[0] > 512)
        cases = _prep_cases(dev, case)
    elif case == PREP_JADE:
        scene = build_test_scene(4, device="cpu")[0].build(device=dev)
        lo, hi = scene.cl_aabb_min, scene.cl_aabb_max
        assert lo.shape[0] == 33
        cases = _prep_cases(dev, 33)
    elif case == PREP_MESH:
        scene = prep_kernels.mesh_scene(dev)
        lo, hi = scene.cl_aabb_min, scene.cl_aabb_max
        assert lo.shape[0] > 512 * tsweep.CULL_GROUP   # two chunks
        cases = _prep_cases(dev, prep_kernels.MESH_T)
    else:
        lo, hi, cases = (_prep_culled if case in PREP_CULLED
                         else _prep_synthetic)(case, dev)
        scene = SimpleNamespace(
            cl_aabb_min=lo, cl_aabb_max=hi,
            cl_trifeat=torch.zeros((lo.shape[0], 16, 4), device=dev))
    groups = tsweep.group_boxes(lo, hi)
    for n, (o, d, mask, anyhit) in cases:
        label = f"{case}, {lo.shape[0]} clusters, {n} rays"
        key = tsweep.sweep_key(o, d, mask, lo, hi, groups)
        want = tsweep.sweep_key_plain(o, d, mask, lo, hi)
        torch.cuda.synchronize()
        assert key.dtype == want.dtype == torch.int32
        assert torch.equal(key, want), \
            f"{label}: key differs on {int((key != want).sum())} rays"
        perms = [torch.sort(key, stable=True).indices]
        if n <= tsweep.TILE_R or case in PREP_SYNTHETIC + PREP_CULLED:
            perms.append(None)
        for perm in perms:
            got = tsweep.sweep_spans(o, d, mask, anyhit, perm, lo, hi,
                                     groups)
            want = tsweep.sweep_spans_plain(o, d, mask, anyhit, perm, lo, hi)
            torch.cuda.synchronize()
            for name, g, w in zip(("nspan", "spans", "tile_sorted",
                                   "rayfeat", "best"), got, want):
                assert g.shape == w.shape and g.dtype == w.dtype, name
                assert torch.equal(g, w), (
                    f"{label}, perm {perm is not None}: {name} differs in "
                    f"{int((g != w).sum())} entries")
            if case in PREP_SYNTHETIC + PREP_CULLED and perm is None:
                # the tiles as built take the path the rule gives them, and
                # sweep_spans counts the member tests that path makes
                with timing.tracing(dev) as rec:
                    tsweep.sweep_spans(o, d, mask, anyhit, None, lo, hi,
                                       groups)
                _, tests, fell_back = _culled_pairs(
                    o, d, mask, torch.arange(n, device=dev), lo, hi)
                assert rec.counters["k1a_pairs_tested"] == tests > 0
                assert rec.counters["k1a_runs_tiles"] == fell_back
                assert fell_back == {"culled: some tiles fall back": 32,
                                     "every minimum finite": 63}.get(
                    case, 0 if lo.shape[0] <= 4096 else fell_back)
                # the narrow tiles (even) keep their minima in the keys
                assert case != "culled: three chunks" or fell_back < 32
            if case == "every minimum finite" and perm is None:
                # every tile minimum finite but in the tile with no live ray
                assert want[0].tolist() == [0 if i == 3 else lo.shape[0]
                                            for i in range(64)]
        launched = (tsweep.sweep_key.launches, tsweep.sweep_spans.launches)
        calls = (tsweep.sweep_key_plain.calls, tsweep.sweep_spans_plain.calls)
        launched_groups = tsweep.group_boxes.launches
        tsweep.sweep_inputs(scene, o, d, mask, anyhit)
        sort = o.shape[0] > tsweep.TILE_R
        assert (tsweep.sweep_key.launches, tsweep.sweep_spans.launches) \
            == (launched[0] + sort, launched[1] + 1)
        # one cast's kernels share one launch of sweep_groups
        assert tsweep.group_boxes.launches == launched_groups + 1
        assert (tsweep.sweep_key_plain.calls,
                tsweep.sweep_spans_plain.calls) == calls


@pytest.mark.cuda
@pytest.mark.parametrize("c", [33, 484, 8192 + 37, SMALL_BLOCK_CLUSTERS])
def test_group_boxes_kernel_equals_plain(c, loong_scale_scene):
    """csrc/sweep_prep.cu's sweep_groups equals group_boxes_plain
    (torch.equal) on random boxes with zero-thick and -0.0 coordinates and
    on the main path's scene in blocks of 8; one launch, no plain call;
    and sweep_key and sweep_spans refuse group boxes of another count of
    clusters, or none."""
    dev = _card()
    if c == SMALL_BLOCK_CLUSTERS:
        scene = loong_scale_scene.build(cluster_size=8, device=dev)
        lo, hi = scene.cl_aabb_min, scene.cl_aabb_max
    else:
        rng = np.random.default_rng(c)
        lo = rng.uniform(-5, 5, (c, 3)).astype(np.float32)
        lo[rng.random((c, 3)) < 0.05] = -0.0
        hi = lo + (rng.uniform(0, 2, (c, 3))
                   * (rng.random((c, 3)) < 0.9)).astype(np.float32)
        lo, hi = torch.tensor(lo, device=dev), torch.tensor(hi, device=dev)
    launches = tsweep.group_boxes.launches
    got = tsweep.group_boxes(lo, hi)
    assert tsweep.group_boxes.launches == launches + 1
    want = tsweep.group_boxes_plain(lo, hi)
    torch.cuda.synchronize()
    assert got.shape == want.shape and torch.equal(got, want)
    o, d = _rays(256, c, dev)
    mask = torch.ones(256, dtype=torch.bool, device=dev)
    for bad in (None, tsweep.group_boxes(lo[:-32], hi[:-32])):
        with pytest.raises(ValueError, match="groups"):
            tsweep.sweep_key(o, d, mask, lo, hi, bad)
        with pytest.raises(ValueError, match="groups"):
            tsweep.sweep_spans(o, d, mask, mask, None, lo, hi, bad)


@pytest.mark.cuda
def test_swept_pair_past_the_shared_memory(loong_scale_scene):
    """One whole merged cast (closest_hit_swept_pair: NEE-shadow any-hit
    rays and closest-hit rays) on the main path's scene in blocks of 8,
    14,172 clusters: sweep_groups, sweep_key, sweep_spans and K1 launched,
    no plain version called, and its hits those of the plain versions on
    the same
    inputs (sweep_key_plain, the stable sort, sweep_spans_plain,
    sweep_plain): the same triangle and inside flag on every ray, t to
    1e-6 relative (_assert_same_records)."""
    dev = _card()
    scene = loong_scale_scene.build(cluster_size=8, device=dev)
    assert scene.cl_aabb_min.shape[0] == SMALL_BLOCK_CLUSTERS
    gen = torch.Generator(device=dev).manual_seed(5)
    o_a, d_a = _rays(24576, 3, dev)
    o_c, d_c = _rays(40960, 4, dev)
    m_a = torch.rand(24576, generator=gen, device=dev) < 0.8
    m_c = torch.rand(40960, generator=gen, device=dev) < 0.9
    launched = (tsweep.group_boxes.launches, tsweep.sweep_key.launches,
                tsweep.sweep_spans.launches, tsweep.sweep.launches)
    calls = (tsweep.sweep_key_plain.calls, tsweep.sweep_spans_plain.calls,
             tsweep.sweep_plain.calls)
    hit_a, hit_c = tsweep.closest_hit_swept_pair(scene, o_a, d_a, m_a, o_c,
                                                 d_c, m_c)
    assert (tsweep.group_boxes.launches, tsweep.sweep_key.launches,
            tsweep.sweep_spans.launches,
            tsweep.sweep.launches) == tuple(n + 1 for n in launched)
    assert (tsweep.sweep_key_plain.calls, tsweep.sweep_spans_plain.calls,
            tsweep.sweep_plain.calls) == calls

    mask = torch.cat([m_a, m_c])
    o, d, m, a = tsweep.pad_cast(
        torch.cat([o_a, o_c]), torch.cat([d_a, d_c]), mask,
        torch.cat([torch.ones_like(m_a), torch.zeros_like(m_c)]))
    lo, hi = scene.cl_aabb_min, scene.cl_aabb_max
    perm = torch.sort(tsweep.sweep_key_plain(o, d, m, lo, hi),
                      stable=True).indices
    best = tsweep.sweep_plain(
        *tsweep.sweep_spans_plain(o, d, m, a, perm, lo, hi),
        scene.cl_trifeat)
    best = torch.empty_like(best).index_copy_(0, perm, best)[:mask.shape[0]]
    slot = torch.where(mask, tsweep.record_slots(best), -1).long()
    tri = torch.where(slot >= 0, scene.cl_slot2tri[slot.clamp(min=0)], -1)
    got = torch.cat([torch.stack([h.t, h.tri.float(), h.inside.float()], 1)
                     for h in (hit_a, hit_c)])
    want = torch.stack([torch.where(mask, best[:, 0], tsweep.INF),
                        tri.float(), (mask & (best[:, 2] > 0.5)).float()], 1)
    _assert_same_records(got, want, "pair, 14,172 clusters", min_hits=0.2)


GRID_CLUSTERS = 65600   # clusters of 256: slots up to 16,793,599 > 2^24


def _grid_soup(n_clusters):
    """(p1, p2, p3) (N, 3) float32 of a flat grid in the plane z = 0: patch
    j a unit square at (j % 256, j // 256) cut into 16 x 8 quads, each two
    triangles facing +z, triangle 256 j + k lane k of patch j. Every
    coordinate is exact in float32."""
    j = np.arange(n_clusters)[:, None]
    q = np.arange(128)[None, :]
    x0 = (j % 256 + (q % 16) / 16.0).astype(np.float32)
    y0 = (j // 256 + (q // 16) / 8.0).astype(np.float32)
    z = np.zeros_like(x0)
    a, b, c, d = (np.stack([x0 + dx, y0 + dy, z], -1)
                  for dx, dy in ((0, 0), (0.0625, 0), (0, 0.125),
                                 (0.0625, 0.125)))
    return tuple(np.stack(pair, 2).reshape(-1, 3)
                 for pair in ((a, b), (b, d), (c, c)))


def _grid_clusters(p1, p2, p3):
    """The port's clusters (models/clusters.py::build_clusters) of the
    grid, one a patch: a BVH in heap order whose leaves are the patches
    (leaf C + j holds triangles [256 j, 256 j + 256))."""
    from opengl_ray_tracing_framework_tpu_torch.models.bvh import FlatBVH
    from opengl_ray_tracing_framework_tpu_torch.models.clusters import (
        build_clusters)
    c = p1.shape[0] // 256
    n = 2 * c
    inner = np.arange(1, c)
    left, right = np.zeros(n, np.int32), np.zeros(n, np.int32)
    left[inner], right[inner] = 2 * inner, 2 * inner + 1
    count, first = np.zeros(n, np.int32), np.zeros(n, np.int32)
    count[c:], first[c:] = 256, 256 * np.arange(c)
    box_lo, box_hi = np.zeros((n, 3), np.float32), np.zeros((n, 3),
                                                             np.float32)
    box_lo[c:] = np.minimum(np.minimum(p1, p2), p3).reshape(c, 256, 3).min(1)
    box_hi[c:] = np.maximum(np.maximum(p1, p2), p3).reshape(c, 256, 3).max(1)
    bvh = FlatBVH(left, right, count, first, box_lo, box_hi,
                  np.arange(p1.shape[0], dtype=np.int32))
    return build_clusters(bvh, p1, p2, p3, max_tris=256)


@pytest.mark.cuda
def test_cast_past_2_24_slots_names_every_triangle():
    """A cast on the normal path (closest_hit_swept: K1(a), the sort, K1,
    _swept's decode) over 65,600 clusters of 256 (16,793,600 triangles,
    slots past 2^24): every one of 20,480 rays, 16,384 of them down
    through a triangle of the last 64 clusters (slots 2^24 and up, half
    of them odd) and 4,096 through random triangles, gets exactly the
    triangle id of the plain reference's BlockCaster. A float32's value
    would round each odd slot past 2^24 to the next lane."""
    from benchmark.reference.cast import Caster
    from benchmark.reference.cast_blocks import BlockCaster
    dev = _card()
    p = _grid_soup(GRID_CLUSTERS)
    cl = _grid_clusters(*p)
    assert cl.n_clusters == GRID_CLUSTERS and cl.block_tris == 256
    assert np.array_equal(cl.slot2tri, np.arange(256 * GRID_CLUSTERS))
    t = lambda x: torch.as_tensor(x).to(dev)
    scene = SimpleNamespace(cl_aabb_min=t(cl.aabb_min),
                            cl_aabb_max=t(cl.aabb_max),
                            cl_trifeat=t(cl.trifeat),
                            cl_slot2tri=t(cl.slot2tri))
    del cl
    rng = np.random.default_rng(24)
    tri = np.concatenate([np.arange(256 * (GRID_CLUSTERS - 64),
                                    256 * GRID_CLUSTERS),
                          rng.integers(0, 256 * GRID_CLUSTERS, 4096)])
    cent = (p[0][tri].astype(np.float64) + p[1][tri] + p[2][tri]) / 3.0
    origin = t((cent + [0.0, 0.0, 1.0]).astype(np.float32))
    direction = t(np.tile(np.float32([[0.0, 0.0, -1.0]]), (tri.size, 1)))
    launches, calls = tsweep.sweep.launches, tsweep.sweep_plain.calls
    hit = tsweep.closest_hit_swept(scene, origin, direction)
    assert (tsweep.sweep.launches, tsweep.sweep_plain.calls) == \
        (launches + 1, calls)
    got = hit.tri.long().cpu()
    del scene
    torch.cuda.empty_cache()
    want = BlockCaster.of(Caster(*(t(x) for x in p))).closest_hit(
        origin, direction)[1].cpu()
    assert torch.equal(want, torch.as_tensor(tri))   # down through tri
    wrong = got != want
    odd_past = (want % 2 == 1) & (want >= 1 << 24)
    assert not wrong.any(), (
        f"{int(wrong.sum())} of {tri.size} triangle ids wrong, "
        f"{int((wrong & odd_past).sum())} of the {int(odd_past.sum())} "
        f"odd slots past 2^24; first: {got[wrong][:4].tolist()} for "
        f"{want[wrong][:4].tolist()}")
    assert int(odd_past.sum()) >= 8192


@pytest.mark.cuda
@pytest.mark.parametrize("t_blk,n_rays,ctas", [
    (256, 128, 8),      # one tile: a cluster of 8 CTAs walks it
    (256, 131072, 1),   # 1,024 tiles: one CTA a tile
    (8, 8192, 2),       # 14,172 clusters
])
def test_traced_counts_equal_plain(t_blk, n_rays, ctas, loong_scale_scene):
    """Under utils/timing.py's tracing(), K1 (csrc/sweep.cu) adds the spans
    each tile walked once per tile, whatever its CTAs a tile (8, 1 and 2
    here), and sweep_spans (csrc/sweep_prep.cu) the rays that are masked
    on and enter some cluster: the same counts as sweep_plain's `visited`
    and sweep_spans_plain on the same inputs, the live rays those whose
    key is not dead. k1a_pairs_tested is 0 in the plain versions and, on
    the card, the member tests _culled_pairs counts (sweep_key's only
    where the cast has more than one tile, which it sorts)."""
    dev = _card()
    scene = (_scene(t_blk, dev) if t_blk > 8 else
             loong_scale_scene.build(cluster_size=t_blk, device=dev))
    gen = torch.Generator(device=dev).manual_seed(n_rays)
    o, d = _rays(n_rays, t_blk + 7, dev)
    mask = torch.rand(n_rays, generator=gen, device=dev) < 0.9
    anyhit = torch.rand(n_rays, generator=gen, device=dev) < 0.3
    kargs, _ = tsweep.sweep_inputs(scene, o, d, mask, anyhit)
    g = kargs[0].shape[0]
    assert tsweep.nvcc.load("sweep").sweep_cluster_size(g, t_blk) == ctas
    with timing.tracing(dev) as kernel:
        tsweep.sweep_inputs(scene, o, d, mask, anyhit)
        tsweep.sweep(*kargs[:4], kargs[4].clone(), kargs[5])
    padded = tsweep.pad_cast(o, d, mask, anyhit)
    lo, hi = scene.cl_aabb_min, scene.cl_aabb_max
    with timing.tracing(dev) as plain:
        tsweep.sweep_spans_plain(*padded, None, lo, hi)
        tsweep.sweep_plain(*kargs)
    walked = int(tsweep.sweep_plain.visited.sum())
    live = int((tsweep.sweep_key_plain(*padded[:3], lo, hi)
                != tsweep._DEAD_KEY).sum())
    assert kernel.counters["k1_spans_walked"] == walked > 0
    assert plain.counters["k1_spans_walked"] == walked
    assert kernel.counters["cast_live_rays"] == live > 0
    assert plain.counters["cast_live_rays"] == live
    assert kernel.counters["cast_lanes"] == padded[0].shape[0]
    assert plain.counters["k1a_pairs_tested"] == 0
    r = padded[0].shape[0]
    sort = r > tsweep.TILE_R
    perm = (torch.sort(tsweep.sweep_key_plain(*padded[:3], lo, hi),
                       stable=True).indices if sort
            else torch.arange(r, device=dev))
    key_tests, spans_tests, _ = _culled_pairs(*padded[:3], perm, lo, hi)
    want = spans_tests + (key_tests if sort else 0)
    assert kernel.counters["k1a_pairs_tested"] == want > 0
    if t_blk == 8:
        # these rays cross the sphere from all sides, so the cull keeps a
        # quarter of the all-pairs 2 x cast_pairs tests
        assert want < kernel.counters["cast_pairs"]


def _culled_pairs(o, d, mask, perm, lo, hi):
    """The member slab tests that sweep_key and sweep_spans make on one
    cast (the counter k1a_pairs_tested), from the plain slab test: a key
    warp (lanes i and i + 128 of a 256-ray CTA, two rays a lane) tests
    group g's members if a live ray enters its box at an entry below the
    least entry of the members before g; a warp of 32 rays of a
    sweep_spans tile (in kernel order) if a live ray enters its box, in
    _runs_path's culled batches, and in every group again where the tile
    takes the runs path; 32 lanes x rays a lane x members each time.
    Returns (sweep_key's tests, sweep_spans's tests, the tiles that took
    the runs path)."""
    group = tsweep.CULL_GROUP
    groups = tsweep.group_boxes_plain(lo, hi)
    c, n_groups = lo.shape[0], groups.shape[1]
    members = torch.clamp(c - group * torch.arange(n_groups, device=o.device),
                          max=group)
    inf = tsweep.INF

    def entries(boxes_lo, boxes_hi, rays):
        return torch.where(mask[rays, None], tsweep.cluster_tnear(
            o[rays], d[rays], boxes_lo, boxes_hi), inf)

    r = o.shape[0]
    key_tests = runs_tests = fell_back = 0
    for lo_r in range(0, r, 1024):          # whole key CTAs and tiles
        rays = torch.arange(lo_r, min(lo_r + 1024, r), device=o.device)
        e = entries(lo, hi, rays)
        e_g = entries(groups[0], groups[1], rays)
        pad = n_groups * group - c
        g_min = torch.nn.functional.pad(e, (0, pad), value=inf).reshape(
            -1, n_groups, group).amin(dim=2)
        before = torch.cat([torch.full_like(g_min[:, :1], inf),
                            torch.cummin(g_min, dim=1).values[:, :-1]], 1)
        want = torch.nn.functional.pad(          # rays of whole CTAs
            e_g < before, (0, 0, 0, (-rays.shape[0]) % 256))
        want = want.reshape(-1, 2, 4, 32, n_groups)   # CTA, q, warp, lane
        key_tests += int((want.any(dim=3).any(dim=1).sum(dim=(0, 1))
                          * members).sum()) * 64
        k_rays = perm[rays]
        warp_in = (entries(groups[0], groups[1], k_rays) < inf).reshape(
            -1, 32, n_groups).any(dim=1)                     # (warps, G)
        finite = torch.nn.functional.pad(
            entries(lo, hi, k_rays).reshape(-1, 128, c).amin(dim=1) < inf,
            (0, pad)).reshape(-1, n_groups, group).sum(dim=2)  # (tiles, G)
        tile_in = warp_in.reshape(-1, 4, n_groups).any(dim=1)
        for t in range(tile_in.shape[0]):
            tested, runs = _runs_path(tile_in[t].cpu().numpy(),
                                      finite[t].cpu().numpy(),
                                      members.cpu().numpy(), c)
            w = warp_in[4 * t:4 * t + 4].cpu().numpy()
            n = (w & tested).sum(axis=0) + (w.sum(axis=0) if runs else 0)
            runs_tests += int((n * members.cpu().numpy()).sum()) * 32
            fell_back += runs
    return key_tests, runs_tests, fell_back


def _runs_path(entered, finite, members, c, keys_cap=4096, chunk=512,
               batch=16):
    """sweep_spans's culled pass on one tile, from the groups it enters and
    their members with finite tile minima: (the groups whose members it
    tested, whether the tile took the runs path). Chunk by chunk of group
    boxes, after the chunk's group tests, it leaves when the entered
    groups so far hold more than keys_cap members and at least half the
    clusters; else it tests the entered groups in batches, and leaves
    after the batch that takes the finite minima past keys_cap."""
    tested = np.zeros_like(entered)
    held = nf = 0
    for lo in range(0, len(entered), chunk):
        ids = lo + np.flatnonzero(entered[lo:lo + chunk])
        held += int(members[ids].sum())
        if held > keys_cap and 2 * held >= c:
            return tested, True
        for b in range(0, len(ids), batch):
            tested[ids[b:b + batch]] = True
            nf += int(finite[ids[b:b + batch]].sum())
            if nf > keys_cap:
                return tested, True
    return tested, False


@pytest.mark.cuda
@pytest.mark.parametrize("s,cols,integer", [
    (512, 128, True), (3000, 128, True), (4096, 128, True),
    (4096, 128, False), (2048, 6, True), (1000, 1, False)])
def test_chained_kernel_equals_plain(s, cols, integer):
    """K4c-2 on (S, C) tables whose columns differ (or random floats in
    [0, S)): every chain equal, as the lookups and the modulo are exact.
    C = 6 and C = 1 take the 4-byte staging copies; C = 1 is the 1-D
    table with indices of any shape."""
    dev = _card()
    table, idx = gather.make_chained_inputs(dev, s, cols, seed=s + cols,
                                            integer=integer)
    if cols == 1:
        table, idx = table[:, 0].contiguous(), idx.reshape(-1, 8)
    launches = gather.probe_chained.launches
    calls = gather.probe_gather_plain.calls
    got = gather.probe_chained(table, idx)
    assert gather.probe_chained.launches == launches + 1
    assert gather.probe_gather_plain.calls == calls
    torch.cuda.synchronize()
    want = gather.probe_gather_plain(table, idx, steps=8)
    assert got.shape == want.shape
    assert torch.equal(got, want), \
        f"{int((got != want).sum())} of {got.numel()} chains differ"


@pytest.mark.cuda
def test_chained_column_over_the_limit_is_refused():
    dev = _card()
    limit = card_perf.smem_optin_limit(dev)
    s = limit // 4 + 1
    table = torch.zeros((s, 4), device=dev)
    idx = torch.zeros((8, 4), dtype=torch.int32, device=dev)
    launches = gather.probe_chained.launches
    with pytest.raises(ValueError, match=str(limit)):
        gather.probe_chained(table, idx)
    assert gather.probe_chained.launches == launches


@pytest.mark.cuda
@pytest.mark.parametrize("g,n_blocks", [(1, 64), (3, 64), (132, 64),
                                         (10, 37)])
@pytest.mark.parametrize("integer", [True, False])
def test_stream_kernel_equals_plain(g, n_blocks, integer):
    """K4c-3's split reduction: integer-valued tables exactly (any order of
    sums is exact), random floats to rtol 1e-5 (another order of sums);
    repeated launches agree bit for bit (the partials are summed in a
    fixed order, and the row counters are left at zero)."""
    dev = _card()
    table, starts = card_perf.make_stream_inputs(
        dev, g, seed=g, integer=integer, n_blocks=n_blocks)
    launches = card_perf.probe_stream.launches
    calls = card_perf.probe_stream_plain.calls
    got = card_perf.probe_stream(table, starts)
    again = card_perf.probe_stream(table, starts)
    assert card_perf.probe_stream.launches == launches + 2
    assert card_perf.probe_stream_plain.calls == calls
    torch.cuda.synchronize()
    want = card_perf.probe_stream_plain(table, starts)
    assert torch.equal(got, again)
    if integer:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", launch_overhead.TILES)
@pytest.mark.parametrize("n_rows", [131072 - 37, 1000])
@pytest.mark.parametrize("span_rows", [False, True])
def test_copy_kernel_equals_plain(tile, n_rows, span_rows):
    """K4a bit for bit best + rayfeat[:, :8] (an add of the same two floats
    in any order), the ragged last tile included, with the half of each
    rayfeat row it does not use read as well (whole_rows) or not."""
    dev = _card()
    rayfeat, best = launch_overhead.make_inputs(dev, n_rows, seed=tile)
    extra = launch_overhead.make_span_rows(dev, n_rows, tile, seed=n_rows) \
        if span_rows else ()
    want = launch_overhead.probe_copy_plain(rayfeat, best, tile, *extra)
    launches = launch_overhead.probe_copy.launches
    calls = launch_overhead.probe_copy_plain.calls
    for whole in (False, True):
        got = launch_overhead.probe_copy(rayfeat, best, tile, *extra,
                                         whole_rows=whole)
        torch.cuda.synchronize()
        assert torch.equal(got, want), \
            f"{int((got != want).any(dim=1).sum())} rows differ"
    assert launch_overhead.probe_copy.launches == launches + 2
    assert launch_overhead.probe_copy_plain.calls == calls


@pytest.mark.cuda
def test_launch_floor_kernel_and_the_largest_block():
    """The empty kernel launches (one CTA, and a grid of 1,024), and the
    shared-memory probe at 227 KB still reads back its row."""
    dev = _card()
    launches = card_perf.probe_floor.launches
    assert card_perf.probe_floor(dev) is None
    card_perf.probe_floor(dev, ctas=1024)
    torch.cuda.synchronize()
    assert card_perf.probe_floor.launches == launches + 2
    assert card_perf.launch_floor_ms(dev) > 0.0
    got = card_perf.probe_smem(227 * 1024, dev)
    torch.cuda.synchronize()
    assert torch.equal(got, card_perf.probe_smem_plain(227 * 1024, dev))


@pytest.mark.cuda
@pytest.mark.parametrize("tracer", ["sweep", "schedule"])
def test_bench_parity_holds_and_fails(tracer, monkeypatch):
    """bench.parity renders its 128x64, 8-bounce frame through the tracer's
    kernel and through the plain versions on the CPU: the two hold to the
    image criterion, and a card image moved by 5e-3 does not."""
    device = _card()
    scene = build_test_scene(1, device=device)[1]
    config = RenderConfig(width=32, height=16, max_bounce=2,
                          cast_backend=tracer)
    launches = tsweep.sweep.launches + tci.cluster_intersect.launches
    assert bench.parity(scene, config, device) is True
    assert tsweep.sweep.launches + tci.cluster_intersect.launches > launches
    render = bench.render_radiance

    def moved(scene, *args, **kwargs):
        img = render(scene, *args, **kwargs)
        return img + 5e-3 if img.is_cuda else img

    monkeypatch.setattr(bench, "render_radiance", moved)
    assert bench.parity(scene, config, device) is False


@pytest.mark.cuda
@pytest.mark.parametrize("tracer", ["sweep", "schedule"])
def test_row_balance_blocks_on_the_card(tracer):
    """row_balance.block_seconds through the tracer's kernel: every block
    launches it and not the other tracer's, calls no plain version and has
    kernel time; the stacked blocks agree with one whole-frame _trace_rows
    by the image criterion (ties in a tile may fall either way)."""
    device = _card()
    scene = build_test_scene(3, device=device)[1]
    config = RenderConfig(width=128, height=64, max_bounce=2,
                          cast_backend=tracer)
    camera = Camera.make(aspect=2.0, device=device)
    res = row_balance.block_seconds(scene, camera, config, blocks=4,
                                    repeats=2, keep=True)
    own, other = (("sweep", "cluster_intersect") if tracer == "sweep"
                  else ("cluster_intersect", "sweep"))
    assert all(n > 0 for n in res["launches"][own])
    assert res["launches"][other] == [0] * 4
    assert res["plain_calls"] == [0] * 4
    assert all(ms > 0 for ms in res["kernel_ms"])
    with torch.no_grad():
        whole = _trace_rows(scene, camera, 1, config, 0, 64, 131072)
    held, rel_mean, off = bench.images_agree(res["radiance"].cpu().numpy(),
                                             whole.cpu().numpy())
    assert held, (rel_mean, off)
