"""PyTorch port, what K1's preparation kernels (csrc/sweep_prep.cu) rely on,
on the CPU: cluster_tnear never gives -0.0 or a negative distance, so the
bits of its distances order as unsigned integers do (sweep_spans takes its
tile minima as unsigned integer minima of those bits), and the port's key
(sweep_key_plain, int32) equals JAX's _sort_key (int32) on the same edge
cases: origins on box faces and inside boxes, direction components of
+-0.0 and below 1e-12, boxes behind the ray. Also the SASS reader of
probes/prep_kernels.py, on a listing in cuobjdump's form, its bytes
bound and its synthetic case past the shared-memory path."""

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
		Function : _ZN12_GLOBAL__N_116sweep_key_kernelEPKfS1_PKbS1_S1_Piii
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
		Function : _ZN12_GLOBAL__N_118sweep_spans_kernelEPKfS1_PKbS3_PKxS1_S1_iiPiS6_PfS7_S7_
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
    """The kernel of the path past SMEM_CLUSTERS (sweep_runs_kernel) has a
    slab-test loop too, but its name holds neither kernel's name: the
    per-pair counts stay those of sweep_key_kernel and sweep_spans_kernel
    wherever its listing falls."""
    runs = """
		Function : _ZN12_GLOBAL__N_117sweep_runs_kernelEPKfS1_PKbS3_PKxS1_S1_iPiS6_PfS7_S7_Py
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
    for text in (SASS + runs, head + runs + "\t\tFunction : "
                 "_ZN12_GLOBAL__N_118sweep_spans" + tail):
        assert prep_kernels.parse_sass(text) == want


@pytest.mark.parametrize("c", [tsweep.SMEM_CLUSTERS,
                               tsweep.SMEM_CLUSTERS + 1])
def test_prep_bound_counts_the_runs_scratch(c):
    """prep_kernels.bounds: past SMEM_CLUSTERS clusters sweep_spans's bytes
    add its (G, C) scratch of 8-byte keys, written once and read once;
    sweep_key's bytes and the pairs do not change."""
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
    scratch = 2 * g * c * 8 if c > tsweep.SMEM_CLUSTERS else 0
    assert spans[3] == pytest.approx((plain + scratch) * per_byte)


def test_finite_case_enters_every_box():
    """prep_kernels.finite_case (8,193 boxes that every ray enters, so every
    tile minimum is finite): on the CPU the port's slab test and JAX's
    give a finite entry for every (ray, box) pair, and sweep_spans_plain's
    nspan is C in every tile."""
    boxes, (o, d, mask, anyhit) = prep_kernels.finite_case("cpu", 256)
    lo, hi = boxes.cl_aabb_min, boxes.cl_aabb_max
    assert lo.shape[0] == tsweep.SMEM_CLUSTERS + 1
    tn = tsweep.cluster_tnear(o, d, lo, hi)
    want = np.asarray(jax_cluster_tnear(*(jnp.asarray(x.numpy())
                                          for x in (o, d, lo, hi))))
    np.testing.assert_array_equal(tn.numpy(), want)
    assert bool((tn < INF).all())
    nspan = tsweep.sweep_spans_plain(o, d, mask, anyhit, None, lo, hi)[0]
    assert nspan.tolist() == [lo.shape[0]] * 2
