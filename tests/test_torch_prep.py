"""PyTorch port, what K1's preparation kernels (csrc/sweep_prep.cu) rely on,
on the CPU: cluster_tnear never gives -0.0 or a negative distance, so the
bits of its distances order as unsigned integers do (sweep_spans takes its
tile minima as unsigned integer minima of those bits), and the port's key
(sweep_key_plain, int32) equals JAX's _sort_key (int32) on the same edge
cases: origins on box faces and inside boxes, direction components of
+-0.0 and below 1e-12, boxes behind the ray. Also the SASS reader of
probes/prep_kernels.py, on a listing in cuobjdump's form, its bytes
bound and its synthetic case of every tile minimum finite, and the group
boxes the kernels cull their slab tests with."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from opengl_ray_tracing_framework_tpu.ops import sweep as jsweep
from opengl_ray_tracing_framework_tpu.ops.schedule import (
    cluster_tnear as jax_cluster_tnear)
from opengl_ray_tracing_framework_tpu_torch.ops import sweep as tsweep
from opengl_ray_tracing_framework_tpu_torch.probes import prep_kernels

INF = 114514.0


def edge_cases(seed):
    """(origin, direction, mask, cl_min, cl_max) as float32 / bool numpy:
    24 boxes, random and unit cubes on a grid, and rays from their faces,
    edges and insides, from behind them and from far off, whose direction
    components are often +-0.0 or below 1e-12."""
    rng = np.random.default_rng(seed)
    lo = rng.uniform(-4, 4, (24, 3)).astype(np.float32)
    lo[:8] = np.float32(np.stack(np.meshgrid([-1, 0], [-1, 0], [-1, 0]),
                                 -1).reshape(8, 3))
    hi = (lo + rng.uniform(0.25, 2, (24, 3))).astype(np.float32)
    hi[:8] = lo[:8] + 1
    n = 384
    box = rng.integers(0, 24, n)
    t = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    origin = lo[box] + t * (hi[box] - lo[box])        # inside
    face = rng.integers(0, 3, n)
    side = rng.random(n) < 0.5
    on = np.arange(n) % 4 == 1                         # on a face
    plane = np.where(side[:, None], lo[box], hi[box])
    origin[on, face[on]] = plane[on, face[on]]
    edge = np.arange(n) % 8 == 3                       # on an edge / corner
    origin[edge] = plane[edge]
    far = np.arange(n) % 4 == 2                        # far off, behind
    origin[far] = rng.uniform(-12, 12, (far.sum(), 3)).astype(np.float32)
    direction = rng.normal(0, 1, (n, 3)).astype(np.float32)
    direction /= np.linalg.norm(direction, axis=1, keepdims=True)
    special = np.float32([0.0, -0.0, 1e-13, -1e-13, 5e-13, -9e-13,
                          1e-12, -1e-12])
    zap = rng.random((n, 3)) < 0.35
    direction[zap] = special[rng.integers(0, len(special), zap.sum())]
    axis = np.arange(n) % 16 == 5                      # along one axis
    direction[axis] = np.float32([[0.0, -0.0, 1.0]])
    mask = rng.random(n) >= 0.1
    return origin, direction, mask, lo, hi


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_cluster_tnear_bits_order_as_unsigned(seed):
    """Every distance is +0.0, positive or INF (never -0.0 or negative),
    equal to JAX's cluster_tnear where that gives -0.0 too, and a stable
    sort of each row's uint32 bits is the stable sort of its floats."""
    o, d, _, lo, hi = edge_cases(seed)
    tn = tsweep.cluster_tnear(*map(torch.as_tensor, (o, d, lo, hi))).numpy()
    assert tn.dtype == np.float32
    assert not np.signbit(tn).any()
    assert (tn >= 0).all() and (tn <= INF).all()
    assert (tn == 0).sum() > 50 and (tn == INF).sum() > 50
    assert ((tn > 0) & (tn < INF)).sum() > 50
    want = np.asarray(jax_cluster_tnear(*map(jnp.asarray, (o, d, lo, hi))))
    np.testing.assert_array_equal(tn, want)   # -0.0 == +0.0
    bits = tn.view(np.uint32)
    np.testing.assert_array_equal(np.argsort(bits, axis=1, kind="stable"),
                                  np.argsort(tn, axis=1, kind="stable"))
    # the tile minimum as an unsigned minimum of the bits (sweep_spans)
    tiles = tn.reshape(-1, 128, tn.shape[1])
    np.testing.assert_array_equal(
        tiles.view(np.uint32).min(axis=1).view(np.float32), tiles.min(axis=1))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_sort_key_int32_equals_jax(seed):
    """sweep_key_plain's key (int32) equals JAX's _sort_key (int32) on the
    masked slab test of the same edge cases."""
    o, d, mask, lo, hi = edge_cases(seed)
    key = tsweep.sweep_key_plain(*map(torch.as_tensor, (o, d, mask, lo, hi)))
    tn = jax_cluster_tnear(*map(jnp.asarray, (o, d, lo, hi)))
    tn = jnp.where(jnp.asarray(mask)[:, None], tn, INF)
    want = np.asarray(jsweep._sort_key(tn, jnp.asarray(d), jnp.asarray(mask)))
    assert key.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(key.numpy(), want)
    dead = want == (1 << 30)
    assert dead.sum() > 10 and (~dead).sum() > 100


SASS = """
	code for sm_90a
		Function : _ZN12_GLOBAL__N_116sweep_key_kernelEPKfS1_PKbS1_S1_S1_S1_PiiiPy
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   FMUL R9, R2, R3 ;
        /*0020*/                   LDS.128 R4, [R0+0x10] ;
        /*0030*/                   FADD R5, R4, -R6 ;
        /*0040*/                   FMUL R5, R5, R7 ;
        /*0050*/                   FMUL R6, R5, R7 ;
        /*0060*/                   FMUL R6, R5, R7 ;
        /*0070*/                   FMUL R6, R5, R7 ;
        /*0080*/                   FMUL R6, R5, R7 ;
        /*0090*/                   FMUL R6, R5, R7 ;
        /*00a0*/                   FMNMX R8, R5, R6, PT ;
        /*00b0*/                   FSETP.GE.AND P0, PT, R8, R9, PT ;
        /*00c0*/              @!P0 BRA 0x20 ;
        /*00d0*/                   EXIT ;
        /*00e0*/                   BRA 0xe0;
		Function : _ZN12_GLOBAL__N_118sweep_spans_kernelEPKfS1_PKbS3_PKxS1_S1_S1_S1_iPiS6_PfS7_S7_PyS8_S8_
        /*0000*/                   FMUL R9, R2, R3 ;
.L_x_1:
        /*0010*/                   FMUL R5, R5, R7 ;
        /*0020*/                   FMUL R6, R5, R7 ;
        /*0030*/                   FMUL R6, R5, R7 ;
        /*0040*/                   FMUL R6, R5, R7 ;
        /*0050*/                   FMUL R6, R5, R7 ;
        /*0060*/                   FMUL R6, R5, R7 ;
        /*0070*/                   FMUL R6, R5, R7 ;
        /*0080*/                   FMUL R6, R5, R7 ;
        /*0090*/                   FMUL R6, R5, R7 ;
        /*00a0*/                   FMUL R6, R5, R7 ;
        /*00b0*/                   FMUL R6, R5, R7 ;
        /*00c0*/                   FMUL R6, R5, R7 ;
        /*00d0*/                   REDUX.MIN UR4, R6 ;
        /*00e0*/                   ISETP.NE.AND P0, PT, R2, R3, PT ;
        /*00f0*/               @P0 BRA `(.L_x_1) ;
        /*0100*/                   EXIT ;
"""


def test_sass_reader_counts_per_pair():
    """parse_sass finds each kernel's backward branch (a hex address or a
    label), takes FMUL / 6 slab tests an iteration and counts each opcode
    per pair, split by pipe; the self-branch after EXIT holds no loop."""
    got = prep_kernels.parse_sass(SASS)
    (key,), (spans,) = got["sweep_key_kernel"], got["sweep_spans_kernel"]
    assert key["pairs_per_iteration"] == 1
    assert key["instructions"] == 11   # 0x20..0xc0
    assert (key["fma"], key["alu"], key["memory"]) == (7, 2, 1)
    assert key["opcodes"]["FMUL"] == 6 and key["opcodes"]["BRA"] == 1
    assert spans["pairs_per_iteration"] == 2
    assert spans["instructions"] == 15 / 2
    assert (spans["fma"], spans["alu"]) == (6, 0.5)
    assert spans["opcodes"]["REDUX"] == 0.5
    ms = prep_kernels.pipe_ms(key, 132 * 64 * 1000, 1000.0)
    assert ms["alu"] == pytest.approx(2.0 / 1000)
    assert ms["issue"] == pytest.approx(11 * 64 / 128 / 1000)


def test_sass_reader_keeps_to_the_named_kernels():
    """Another kernel of the library (sweep_groups_kernel), here with a
    loop of FMUL, holds neither kernel's name: the per-pair counts stay
    those of sweep_key_kernel and sweep_spans_kernel wherever its listing
    falls."""
    groups = """
		Function : _ZN12_GLOBAL__N_119sweep_groups_kernelEPKfS1_PfS2_ii
        /*0000*/                   FMUL R5, R5, R7 ;
        /*0010*/                   FMUL R6, R5, R7 ;
        /*0020*/                   FMUL R6, R5, R7 ;
        /*0030*/                   FMUL R6, R5, R7 ;
        /*0040*/                   FMUL R6, R5, R7 ;
        /*0050*/                   FMUL R6, R5, R7 ;
        /*0060*/                   FMNMX R8, R5, R6, PT ;
        /*0070*/               @P0 BRA 0x0 ;
        /*0080*/                   EXIT ;
"""
    want = prep_kernels.parse_sass(SASS)
    head, tail = SASS.split("\t\tFunction : _ZN12_GLOBAL__N_118sweep_spans")
    for text in (SASS + groups, head + groups + "\t\tFunction : "
                 "_ZN12_GLOBAL__N_118sweep_spans" + tail):
        assert prep_kernels.parse_sass(text) == want


@pytest.mark.parametrize("c", [8192, 8193])
def test_prep_bound_counts_the_runs_scratch(c):
    """prep_kernels.bounds: at every cluster count sweep_spans's bytes
    add its (G, C) scratch of 8-byte keys, written once and read once;
    sweep_key's bytes and the pairs count every (ray, cluster) pair."""
    r = 4 * tsweep.TILE_R
    o = torch.zeros((r, 3))
    m = torch.ones(r, dtype=torch.bool)
    lo = torch.zeros((c, 3))
    key, spans, pairs = prep_kernels.bounds((o, o, m, m, lo, lo))
    per_byte = prep_kernels.prep_bound(0, 1)[3]   # ms a byte
    assert pairs == r * c
    assert key[3] == pytest.approx((r * 29 + c * 24) * per_byte)
    g = r // tsweep.TILE_R
    plain = r * 34 + c * 24 + g * 4 + g * c * 8 + r * 96
    scratch = 2 * g * c * 8
    assert spans[3] == pytest.approx((plain + scratch) * per_byte)


def test_finite_case_enters_every_box():
    """prep_kernels.finite_case (8,193 boxes that every ray enters, so every
    tile minimum is finite): on the CPU the port's slab test and JAX's
    give a finite entry for every (ray, box) pair, and sweep_spans_plain's
    nspan is C in every tile."""
    boxes, (o, d, mask, anyhit) = prep_kernels.finite_case("cpu", 256)
    lo, hi = boxes.cl_aabb_min, boxes.cl_aabb_max
    assert lo.shape[0] == 8193
    tn = tsweep.cluster_tnear(o, d, lo, hi)
    want = np.asarray(jax_cluster_tnear(*(jnp.asarray(x.numpy())
                                          for x in (o, d, lo, hi))))
    np.testing.assert_array_equal(tn.numpy(), want)
    assert bool((tn < INF).all())
    nspan = tsweep.sweep_spans_plain(o, d, mask, anyhit, None, lo, hi)[0]
    assert nspan.tolist() == [lo.shape[0]] * 2


def test_sass_reader_tells_the_culled_kernel_apart():
    """A kernel whose name holds sweep_key_kernel's inside a longer one
    (sweep_key_kernel_culled, which an older tree's library held beside
    the all-pairs key kernel, and a copy of the probe reads there), with a
    loop with a slab test: the per-pair counts stay those of
    sweep_key_kernel wherever its listing falls."""
    culled = """
		Function : _ZN12_GLOBAL__N_123sweep_key_kernel_culledEPKfS1_PKbS1_S1_S1_S1_PiiiPy
        /*0000*/                   FMUL R5, R5, R7 ;
        /*0010*/                   FMUL R6, R5, R7 ;
        /*0020*/                   FMUL R6, R5, R7 ;
        /*0030*/                   FMUL R6, R5, R7 ;
        /*0040*/                   FMUL R6, R5, R7 ;
        /*0050*/                   FMUL R6, R5, R7 ;
        /*0060*/               @P0 BRA 0x0 ;
        /*0070*/                   EXIT ;
"""
    want = prep_kernels.parse_sass(SASS)
    head, tail = SASS.split("\t\tFunction : _ZN12_GLOBAL__N_118sweep_spans")
    for text in (SASS + culled, culled + SASS, head + culled
                 + "\t\tFunction : _ZN12_GLOBAL__N_118sweep_spans" + tail):
        assert prep_kernels.parse_sass(text) == want


@pytest.mark.parametrize("c", [1, 31, 32, 33, 484, 8229, 14172])
def test_group_boxes_equal_numpy_min_max(c):
    """group_boxes (group_boxes_plain on the CPU) is, for each run of
    CULL_GROUP consecutive clusters, the numpy min of their cl_min and max
    of their cl_max, the last run partial where C is no multiple of 32;
    with zero-thick and -0.0 coordinates among the boxes."""
    rng = np.random.default_rng(c)
    lo = rng.uniform(-5, 5, (c, 3)).astype(np.float32)
    lo[rng.random((c, 3)) < 0.05] = -0.0
    hi = (lo + rng.uniform(0, 2, (c, 3)) * (rng.random((c, 3)) < 0.9)
          ).astype(np.float32)
    got = tsweep.group_boxes(torch.tensor(lo), torch.tensor(hi))
    group = tsweep.CULL_GROUP
    n = -(-c // group)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, n, 3)
    runs = [slice(g * group, (g + 1) * group) for g in range(n)]
    want = np.stack([np.stack([lo[r].min(axis=0) for r in runs]),
                     np.stack([hi[r].max(axis=0) for r in runs])])
    np.testing.assert_array_equal(got.numpy(), want)


def _slab_interval(o, d, lo, hi):
    """csrc/sweep_prep.cu's reciprocal and slabs in float32 torch ops, one
    rounding an op: (t0, t1) (R, B) of each ray against each box, the
    three axes folded without starting values."""
    eps = torch.tensor(1e-12, dtype=torch.float32)
    inv = 1.0 / torch.where(d.abs() < eps, torch.where(d < 0, -eps, eps), d)
    t0 = t1 = None
    for ax in range(3):
        near = (lo[None, :, ax] - o[:, None, ax]) * inv[:, None, ax]
        far = (hi[None, :, ax] - o[:, None, ax]) * inv[:, None, ax]
        enter, leave = torch.minimum(near, far), torch.maximum(near, far)
        t0 = enter if t0 is None else torch.maximum(t0, enter)
        t1 = leave if t1 is None else torch.minimum(t1, leave)
    return t0, t1


def _enters(t0, t1):
    return (t1 >= t0) & (t1 > 0.0) & (t0 <= INF)


def _entry_bits(t0):
    """max(t0, +0.0)'s bits as a (non-negative) int32."""
    return torch.clamp(t0.contiguous().view(torch.int32), min=0)


def _glass5m_like_boxes(c=30741, per=16, seed=0):
    """c cluster boxes at glass5m's count: the floor quad's flat box, then
    boxes of `per` consecutive points of the unit sphere about (0, 0, 3) in
    Morton order, as clusters of BVH leaves in leaf order are."""
    rng = np.random.default_rng(seed)
    p = rng.normal(size=((c - 1) * per, 3))
    p = p / np.linalg.norm(p, axis=1, keepdims=True) + np.array([0, 0, 3.0])
    q = ((p - p.min(0)) / (p.max(0) - p.min(0)) * 1023).astype(np.int64)
    morton = np.zeros(len(p), np.int64)
    for bit in range(10):
        for ax in range(3):
            morton |= ((q[:, ax] >> bit) & 1) << (3 * bit + ax)
    p = p[np.argsort(morton, kind="stable")].astype(np.float32)
    p = p.reshape(c - 1, per, 3)
    floor = np.float32([[-10.0, -1.0, -7.0], [10.0, -1.0, 13.0]])
    lo = np.concatenate([floor[:1], p.min(axis=1)])
    hi = np.concatenate([floor[1:], p.max(axis=1)])
    return torch.tensor(lo), torch.tensor(hi)


@pytest.fixture(scope="module")
def cull_boxes():
    """{name: (cl_min, cl_max)}: glass5m-like boxes and those of the
    81,922-triangle scene in blocks of 8 (14,172 clusters)."""
    from opengl_ray_tracing_framework_tpu_torch.models.scene import (
        build_test_scene)

    scene = build_test_scene(6, device="cpu")[0].build(cluster_size=8,
                                                       device="cpu")
    return {"glass5m-like": _glass5m_like_boxes(),
            "14,172 clusters": (scene.cl_aabb_min, scene.cl_aabb_max)}


def _cull_rays(kind, g_lo, g_hi, lo, seed, n=192):
    """Rays towards the sphere from around the scene (random), or from the
    corners, edges and faces of group boxes and member boxes, exact in
    float32, whose direction components are often +-0.0, below or at the
    1e-12 clamp (edge)."""
    rng = np.random.default_rng(seed)
    o = rng.normal(0, 2.0, (n, 3)).astype(np.float32)
    o[:, 2] -= 1.0
    d = (np.float32([0.0, 0.0, 3.0]) - o
         + rng.normal(0, 0.6, (n, 3))).astype(np.float32)
    if kind == "edge":
        g = rng.integers(0, g_lo.shape[0], n)
        side = rng.random((n, 3)) < 0.5
        o = np.where(side, g_lo[g], g_hi[g])                 # corners
        inside = rng.uniform(g_lo[g], g_hi[g]).astype(np.float32)
        axis = rng.integers(0, 3, n)
        i = np.arange(n)
        o[i % 3 == 1, axis[i % 3 == 1]] = inside[i % 3 == 1,
                                                 axis[i % 3 == 1]]   # edges
        o[i % 3 == 2] = inside[i % 3 == 2]
        o[i % 3 == 2, axis[i % 3 == 2]] = np.where(
            side, g_lo[g], g_hi[g])[i % 3 == 2, axis[i % 3 == 2]]    # faces
        o[i % 5 == 4] = lo[rng.integers(0, lo.shape[0], n)][i % 5 == 4]
        special = np.float32([0.0, -0.0, 1e-13, -1e-13, 1e-12, -1e-12])
        zap = rng.random((n, 3)) < 0.4
        d[zap] = special[rng.integers(0, len(special), zap.sum())]
        d[i % 7 == 0] = np.float32([0.0, -0.0, 1.0])
    return torch.tensor(o), torch.tensor(d)


@pytest.mark.parametrize("kind", ["random", "edge"])
@pytest.mark.parametrize("boxes", ["glass5m-like", "14,172 clusters"])
def test_group_box_covers_its_members(boxes, kind, cull_boxes):
    """The cull's premise (csrc/sweep_prep.cu, group_covers) under the
    kernels' own float32 arithmetic: against every member's group box a
    ray's t0 is <= its t0 and t1 >= its t1, so a ray that enters a member
    enters the group box at entry bits <= the member's. The group boxes
    skip most members: most (ray, group) pairs enter no group, and some
    enter a group box but none of its members."""
    lo, hi = cull_boxes[boxes]
    groups = tsweep.group_boxes(lo, hi)
    o, d = _cull_rays(kind, groups[0].numpy(), groups[1].numpy(),
                      lo.numpy(), len(boxes) + len(kind))
    member_of = torch.arange(lo.shape[0]) // tsweep.CULL_GROUP
    entered = group_only = 0
    for sl in (slice(j, j + 32) for j in range(0, o.shape[0], 32)):
        t0, t1 = _slab_interval(o[sl], d[sl], lo, hi)
        gt0, gt1 = _slab_interval(o[sl], d[sl], groups[0], groups[1])
        assert not (torch.isnan(t0).any() or torch.isnan(gt0).any())
        assert bool((gt0[:, member_of] <= t0).all())
        assert bool((gt1[:, member_of] >= t1).all())
        inside = _enters(t0, t1)
        g_in = _enters(gt0, gt1)
        assert bool(g_in[:, member_of][inside].all())
        assert bool((_entry_bits(gt0)[:, member_of]
                     <= _entry_bits(t0))[inside].all())
        entered += int(inside.sum())
        pad = g_in.shape[1] * tsweep.CULL_GROUP - inside.shape[1]
        hit = torch.nn.functional.pad(inside, (0, pad)).reshape(
            inside.shape[0], -1, tsweep.CULL_GROUP).any(dim=2)
        group_only += int((g_in & ~hit).sum())
        assert float(g_in.float().mean()) < 0.5
    assert entered > 100 and group_only > 10


def test_k1a_pairs_tested_stays_zero_on_the_cpu():
    """Under tracing() on the CPU a cast (here of 8,193 clusters) runs
    the plain versions, which test every pair and count none in
    k1a_pairs_tested and have no runs path (k1a_runs_tiles 0); cast_pairs
    still counts R x C and cast_slots C x T."""
    from types import SimpleNamespace

    from opengl_ray_tracing_framework_tpu_torch.utils import timing

    boxes, (o, d, mask, anyhit) = prep_kernels.finite_case("cpu", 256)
    c = boxes.cl_aabb_min.shape[0]
    scene = SimpleNamespace(cl_aabb_min=boxes.cl_aabb_min,
                            cl_aabb_max=boxes.cl_aabb_max,
                            cl_trifeat=torch.zeros((c, 16, 4)))
    with timing.tracing("cpu") as rec:
        tsweep.sweep_inputs(scene, o, d, mask, anyhit)
    assert c == 8193
    assert rec.counters["k1a_pairs_tested"] == 0
    assert rec.counters["k1a_runs_tiles"] == 0
    assert rec.counters["cast_pairs"] == 256 * c
    assert rec.counters["cast_slots"] == c

