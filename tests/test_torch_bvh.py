"""PyTorch port, the scene build at scale on the CPU: models/bvh.py's
depth-at-a-time build gives the JAX package's recursive build_bvh byte for
byte (node ids in depth-first pre-order, stable tie orders, float32 SAH
costs and their first argmin, the signs of zero in the boxes), on
icospheres with the floor, a random soup, all-equal centroids, a coplanar
strip and a soup of signed zeros, at leaf sizes 1 and 8, SAH and median,
and on its threads as inline."""

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
