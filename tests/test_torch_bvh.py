"""PyTorch port, the scene build at scale on the CPU: models/bvh.py's
depth-at-a-time build gives the JAX package's recursive build_bvh byte for
byte (node ids in depth-first pre-order, stable tie orders, float32 SAH
costs and their first argmin, the signs of zero in the boxes), on
icospheres with the floor, a random soup, all-equal centroids, a coplanar
strip and a soup of signed zeros, at leaf sizes 1 and 8, SAH and median,
and on its threads as inline; the binned build ("sah_binned"), which the
JAX package lacks, is a whole tree whose clusters are as tight as the
exact build's and whose scene casts the brute-force hits."""

import numpy as np
import pytest

from opengl_ray_tracing_framework_tpu.models.bvh import (
    build_bvh as jax_build_bvh)
from opengl_ray_tracing_framework_tpu_torch.models import bvh as tbvh
from opengl_ray_tracing_framework_tpu_torch.models import mesh as tmesh


def _icosphere_on_floor(subdiv):
    sphere = tmesh.mesh_to_triangles(
        tmesh.make_icosphere(subdiv),
        tmesh.transform_matrix((0, 0, 0), (0.0, 0.0, 3.0), (1.0, 1.0, 1.0)),
        smooth_normal=True, normalize=False)
    floor = tmesh.mesh_to_triangles(
        tmesh.make_quad(),
        tmesh.transform_matrix((0, 0, 0), (0.0, -1.0, 3.0),
                               (10.0, 1.0, 10.0)), normalize=False)
    return [np.concatenate([floor[k], sphere[k]]) for k in range(3)]


def _soup(kind, n=3000):
    rng = np.random.default_rng(7)
    if kind == "random":
        p = rng.normal(size=(3, n, 3))
    elif kind == "equal_centroids":   # every centroid at the origin
        d = rng.normal(size=(2, n, 3))
        p = np.stack([d[0], d[1], -d[0] - d[1]])
    elif kind == "coplanar_strip":    # a row of triangles in z = 0
        x = np.arange(n, dtype=np.float64)
        z = np.zeros(n)
        p = np.stack([np.stack([x, z, z], 1), np.stack([x + 1, z, z], 1),
                      np.stack([x, z + 1, z], 1)])
    else:                             # signed zeros among +-1
        p = rng.choice([0.0, -0.0, 1.0, -1.0], size=(3, n, 3))
    return [a.astype(np.float32) for a in p]


SCENES = {f"icosphere{s}": (lambda s=s: _icosphere_on_floor(s))
          for s in range(2, 7)}
SCENES.update({k: (lambda k=k: _soup(k)) for k in
               ("random", "equal_centroids", "coplanar_strip",
                "signed_zeros")})


def _assert_same(got, want):
    for field in want._fields:
        a, b = getattr(got, field), np.asarray(getattr(want, field))
        assert a.dtype == b.dtype and a.shape == b.shape, field
        assert a.tobytes() == b.tobytes(), field


@pytest.mark.parametrize("method", ["sah", "median"])
@pytest.mark.parametrize("leaf_size", [1, 8])
@pytest.mark.parametrize("scene", list(SCENES))
def test_build_matches_jax(scene, leaf_size, method):
    p = SCENES[scene]()
    got = tbvh.build_bvh(*p, leaf_size=leaf_size, method=method)
    _assert_same(got, jax_build_bvh(*p, leaf_size=leaf_size, method=method))
    tbvh.validate_bvh(got, p[0].shape[0])


@pytest.mark.parametrize("method", ["sah", "median"])
def test_threaded_build_matches_inline(monkeypatch, method):
    """The thread pool that large scenes take gives the inline build."""
    p = _icosphere_on_floor(5)
    inline = tbvh.build_bvh(*p, method=method)
    monkeypatch.setattr(tbvh, "_POOL_TRIS", 1)
    monkeypatch.setattr(tbvh, "_ROW_ELEMS", 1 << 12)   # many batches
    _assert_same(tbvh.build_bvh(*p, method=method), inline)


def test_scan_min_is_a_running_minimum():
    rng = np.random.default_rng(3)
    for shape in [(1, 1), (5, 1), (1000, 6), (37, 700), (4097, 3)]:
        x = rng.normal(size=shape).astype(np.float32)
        np.testing.assert_array_equal(tbvh._scan_min(x),
                                      np.minimum.accumulate(x, axis=0))


# "sah_binned", the port's build for scenes of tens of millions of
# triangles, has no JAX counterpart: it is held to the tree's invariants,
# to the exact build's cluster boxes and, through a scene, to the
# brute-force closest hits.

def _binned(p, leaf_size=8):
    return tbvh.build_bvh(*p, leaf_size=leaf_size, method="sah_binned",
                          device="cpu")


@pytest.mark.parametrize("leaf_size", [1, 8])
@pytest.mark.parametrize("scene", ["icosphere4", "random", "equal_centroids",
                                   "coplanar_strip", "signed_zeros"])
def test_binned_build_is_a_whole_tree(scene, leaf_size):
    """Every triangle in one leaf of at most leaf_size (centroids that
    coincide split into halves), a leaf's box its triangles' exact min /
    max and an inner node's its children's, ids in depth-first pre-order
    (the left child right after its parent)."""
    p = SCENES[scene]()
    bvh = _binned(p, leaf_size)
    tbvh.validate_bvh(bvh, p[0].shape[0])
    assert 0 < bvh.count.max() <= leaf_size
    lo = np.minimum(np.minimum(p[0], p[1]), p[2])[bvh.perm]
    hi = np.maximum(np.maximum(p[0], p[1]), p[2])[bvh.perm]
    for node in range(1, bvh.n_nodes):
        c, f = int(bvh.count[node]), int(bvh.first[node])
        if c:
            want_lo, want_hi = lo[f:f + c].min(0), hi[f:f + c].max(0)
        else:
            l, r = bvh.left[node], bvh.right[node]
            assert l == node + 1
            want_lo = np.minimum(bvh.aabb_min[l], bvh.aabb_min[r])
            want_hi = np.maximum(bvh.aabb_max[l], bvh.aabb_max[r])
        np.testing.assert_array_equal(bvh.aabb_min[node], want_lo)
        np.testing.assert_array_equal(bvh.aabb_max[node], want_hi)


def test_binned_clusters_are_the_exact_builds_in_tightness():
    """On the 81,922-triangle scene the binned build's clusters of 256
    cover about the exact build's box area (within 1%), in about its
    count of clusters."""
    from opengl_ray_tracing_framework_tpu_torch.models.clusters import (
        build_clusters)
    p = _icosphere_on_floor(6)
    got = {}
    for method in ("sah", "sah_binned"):
        bvh = tbvh.build_bvh(*p, leaf_size=8, method=method, device="cpu")
        cl = build_clusters(bvh, *(x[bvh.perm] for x in p), max_tris=256)
        e = cl.aabb_max - cl.aabb_min
        got[method] = (cl.n_clusters, float((e[:, 0] * e[:, 1] + e[:, 0]
                                             * e[:, 2] + e[:, 1] * e[:, 2])
                                            .sum()))
    (c_exact, a_exact), (c_binned, a_binned) = got["sah"], got["sah_binned"]
    assert abs(c_binned - c_exact) <= 0.01 * c_exact
    assert a_binned <= 1.01 * a_exact


def test_binned_scene_casts_the_exact_scenes_hits():
    """A scene built with bvh_method="sah_binned" casts, through the sweep
    tracer and the BVH tracer, the hits of the scene built with the exact
    SAH: the same hit or miss and t bit for bit (a triangle's arithmetic
    does not depend on its cluster or leaf), the same triangle but at
    equal-t ties; and the brute-force oracle's within its rounding."""
    import torch

    from opengl_ray_tracing_framework_tpu_torch import (
        RenderConfig, build_test_scene)
    from opengl_ray_tracing_framework_tpu_torch.ops import intersect
    from opengl_ray_tracing_framework_tpu_torch.ops import traverse

    host, exact = build_test_scene(3, device="cpu")
    binned = host.build(bvh_method="sah_binned", device="cpu")
    gen = torch.Generator().manual_seed(24)
    o = torch.rand((2000, 3), generator=gen) * 6 - 3 + torch.tensor(
        [0.0, 0.0, 3.0])
    d = torch.nn.functional.normalize(torch.randn((2000, 3), generator=gen),
                                      dim=1)
    brute = intersect.closest_hit_brute(o, d, exact.p1, exact.p2, exact.p3)
    assert (brute.tri >= 0).sum() > 500
    for backend in ("sweep", "bvh"):
        config = RenderConfig(cast_backend=backend)
        got = traverse.closest_hit(binned, o, d, config)
        want = traverse.closest_hit(exact, o, d, config)
        assert torch.equal(got.t, want.t)
        hit = got.tri >= 0     # ids index each scene's own leaf order
        same = torch.ones(int(hit.sum()), dtype=torch.bool)
        for v in ("p1", "p2", "p3"):
            same &= (getattr(binned, v)[got.tri[hit]]
                     == getattr(exact, v)[want.tri[hit]]).all(1)
        assert same.float().mean() > 0.999
        assert torch.equal(got.tri >= 0, brute.tri >= 0)
        assert torch.allclose(got.t, brute.t, rtol=1e-4, atol=1e-4)


def test_unknown_method_is_refused():
    with pytest.raises(ValueError, match="unknown BVH method"):
        tbvh.build_bvh(*_soup("random", 10), method="binned")
