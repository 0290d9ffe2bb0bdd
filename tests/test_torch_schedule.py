"""PyTorch port, the schedule tracer: ops/cluster_intersect.py (the
kernel's plain version, which is what a CPU tensor runs) against the JAX
Pallas kernel in interpret mode, ops/schedule.py against the JAX schedule
tracer and the brute-force oracle on the cases of tests/test_schedule.py,
and the render as a whole with cast_backend="schedule".

Hit criterion (tests/test_schedule.py::assert_matches_oracle): hit/miss
exact, t within rtol/atol 1e-4, the same triangle on >= 99.5% of the hits
(exact-t ties between duplicate triangles may go either way), and the same
inside flag where the triangle agrees. The kernel's records are held
tighter, t to rtol 1e-5: both sides contract the same 10 products in
float32 and differ only in summation order."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from opengl_ray_tracing_framework_tpu.models.scene import (
    build_test_scene as jax_build_test_scene)
from opengl_ray_tracing_framework_tpu.ops import intersect_pallas as jci
from opengl_ray_tracing_framework_tpu.ops import schedule as jsched
from opengl_ray_tracing_framework_tpu.ops.intersect import closest_hit_brute
from opengl_ray_tracing_framework_tpu.render import (
    render_radiance as jax_render_radiance)
from opengl_ray_tracing_framework_tpu.utils.config import (
    RenderConfig as JConfig)
from opengl_ray_tracing_framework_tpu_torch import (
    RenderConfig, render_radiance, scene_from_numpy)
from opengl_ray_tracing_framework_tpu_torch.ops import (
    cluster_intersect as tci)
from opengl_ray_tracing_framework_tpu_torch.ops import schedule as tsched
from opengl_ray_tracing_framework_tpu_torch.ops import sweep as tsweep

from test_torch_host import jax_scene_arrays
from test_torch_render import assert_images_agree, scenes  # noqa: F401
from test_torch_sweep import (  # noqa: F401
    INF, assert_hits_agree, inside_rays, random_rays, wide_block_scenes)

T = torch.as_tensor


def _pair(jdata):
    return jdata, scene_from_numpy(jax_scene_arrays(jdata), device="cpu")


@pytest.fixture(scope="module")
def small_scenes():
    _, jdata = jax_build_test_scene(n_sphere_subdiv=2)
    return _pair(jdata)


@pytest.fixture(scope="module")
def many_cluster_scenes():
    jsc, _ = jax_build_test_scene(n_sphere_subdiv=3)
    jdata = jsc.build(cluster_size=8)
    assert jdata.cl_aabb_min.shape[0] >= 100
    return _pair(jdata)


def test_cluster_intersect_plain_matches_pallas():
    """Two tiles of the JAX kernel's 1024 rays plus an empty one, spans
    with skipped entries (>= C) inside the counted prefix, records that
    already hold hits; rays aimed at the sphere, whose ~20 clusters of 64
    each tile draws 8 from."""
    jsc, _ = jax_build_test_scene(n_sphere_subdiv=3)
    jdata, tdata = _pair(jsc.build(cluster_size=64))
    c = jdata.cl_aabb_min.shape[0]
    t_blk = jdata.cl_trifeat.shape[2] // 4
    rng = np.random.default_rng(31)
    tile, g, k = jci.RAY_TILE, 3, 8
    o, _ = random_rays(rng, tile * g, spread=2.0)
    d = np.array([0.0, 0.0, 3.0], np.float32) - o \
        + rng.normal(0, 0.5, o.shape).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rayfeat = np.asarray(jci.ray_features(jnp.asarray(o), jnp.asarray(d)))
    np.testing.assert_array_equal(
        tsweep.ray_features(T(o), T(d)).numpy(), rayfeat)
    spans = rng.integers(0, c, (g, k)).astype(np.int32)
    spans[0, 2] = c          # skipped inside the counted prefix
    spans[1, 0] = c + 5
    nspan = np.array([k, 5, 0], np.int32)   # the last tile is empty
    best = np.asarray(jci.init_best(tile * g)).copy()
    np.testing.assert_array_equal(tci.init_best(tile * g, "cpu").numpy(),
                                  best)
    seeded = rng.random(tile * g) < 0.3      # records that already hold a hit
    best[seeded, 0] = rng.uniform(0.5, 6.0, seeded.sum()).astype(np.float32)
    best[seeded, 1] = rng.integers(0, c * t_blk, seeded.sum())
    best[:, 3:] = rng.random((tile * g, 5)).astype(np.float32)

    want = np.asarray(jci.cluster_intersect(
        jnp.asarray(rayfeat), jnp.asarray(best), jnp.asarray(spans),
        jnp.asarray(nspan), jdata.cl_trifeat, interpret=True))
    calls = tci.cluster_intersect_plain.calls
    launches = tci.cluster_intersect.launches
    before = T(best.copy())
    got = tci.cluster_intersect(T(rayfeat.copy()), before, T(spans), T(nspan),
                                tdata.cl_trifeat).numpy()
    assert tci.cluster_intersect_plain.calls == calls + 1   # CPU: plain
    assert tci.cluster_intersect.launches == launches
    np.testing.assert_array_equal(before.numpy(), best)   # a new tensor

    changed = want[:, 1] != best[:, 1]
    assert 0.05 < changed.mean() < 0.95, changed.mean()
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-5)
    same = got[:, 1] == want[:, 1]
    assert same.mean() >= 0.995, same.mean()
    np.testing.assert_array_equal(got[same, 2], want[same, 2])
    # what the kernel must not touch: columns 3.., and the empty tile
    np.testing.assert_array_equal(got[:, 3:], best[:, 3:])
    np.testing.assert_array_equal(got[2 * tile:], best[2 * tile:])
    untouched = ~changed & same
    np.testing.assert_array_equal(got[untouched], best[untouched])


def test_cluster_intersect_refuses_bad_shapes(small_scenes):
    _, tdata = small_scenes
    rf = torch.zeros((200, 16))
    best = tci.init_best(200, "cpu")
    spans = torch.zeros((1, 2), dtype=torch.int32)
    nspan = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 128"):
        tci.cluster_intersect(rf, best, spans, nspan, tdata.cl_trifeat)


def test_direction_key_bit_equal():
    rng = np.random.default_rng(37)
    d = rng.normal(size=(8192, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:6] = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                      [0, 0, 1], [0, 0, -1]], np.float32)
    want = np.asarray(jsched._direction_key(jnp.asarray(d)))
    got = tsched._direction_key(T(d)).numpy()
    np.testing.assert_array_equal(got, want)


def test_vote_ties_take_the_lower_cluster():
    """argmin and the vote both resolve ties toward the lower id, as
    jnp.argmin and jax.lax.top_k do, so rounds repeat from run to run."""
    tkey = torch.tensor([[3.0, 1.0, 1.0, 5.0], [INF, INF, INF, INF]])
    _, cand = torch.min(tkey, dim=1)
    assert cand.tolist() == [1, 0]
    assert np.asarray(jnp.argmin(jnp.asarray(tkey.numpy()), axis=1)
                      ).tolist() == [1, 0]
    # tile 0: clusters 4 and 2 get two votes each, 7 one; tile 1: none
    has = torch.zeros(256, dtype=torch.bool)
    cand = torch.zeros(256, dtype=torch.int64)
    has[:5] = True
    cand[:5] = torch.tensor([4, 2, 7, 2, 4])
    spans, nspan = tsched.elect(has, cand, 2, 9, 2)
    assert spans.tolist() == [[2, 4], [9, 9]] and nspan.tolist() == [2, 0]
    assert spans.dtype == torch.int32 and nspan.dtype == torch.int32


def three_way(jdata, tdata, o, d, topk=8, **kw):
    """Port vs JAX schedule tracer vs the brute-force oracle."""
    port = tsched.closest_hit_scheduled(
        tdata, T(o), T(d), RenderConfig(sched_topk=topk), **kw)
    jkw = dict(kw)
    if "mask" in jkw:
        jkw["mask"] = jnp.asarray(jkw["mask"].numpy())
    ref = jsched.closest_hit_scheduled(
        jdata, jnp.asarray(o), jnp.asarray(d),
        JConfig(sched_topk=topk, pallas_interpret=True), interpret=True,
        **jkw)
    oracle = closest_hit_brute(jnp.asarray(o), jnp.asarray(d),
                               jdata.p1, jdata.p2, jdata.p3)
    return port, ref, oracle


@pytest.mark.parametrize("topk", [1, 2, 8])
def test_scheduled_matches_jax_and_oracle(small_scenes, topk):
    jdata, tdata = small_scenes
    o, d = random_rays(np.random.default_rng(11), 2048)
    stats = tsched.closest_hit_scheduled
    rounds, casts = stats.rounds, stats.casts
    port, ref, oracle = three_way(jdata, tdata, o, d, topk=topk)
    assert stats.casts == casts + 1 and stats.rounds > rounds
    assert_hits_agree(port, oracle)
    assert_hits_agree(port, ref)


def test_scheduled_many_clusters(many_cluster_scenes):
    jdata, tdata = many_cluster_scenes
    o, d = random_rays(np.random.default_rng(7), 2048)
    port, ref, oracle = three_way(jdata, tdata, o, d)
    assert_hits_agree(port, oracle)
    assert_hits_agree(port, ref)


def test_scheduled_wide_blocks_match_jax(wide_block_scenes):  # noqa: F811
    """Cluster blocks of 512, 1,024 and 302 triangles: the port's vote
    tracer finds the JAX tracer's hits (and the oracle's), triangle for
    triangle."""
    jdata, tdata = wide_block_scenes
    o, d = random_rays(np.random.default_rng(29), 2048)
    port, ref, oracle = three_way(jdata, tdata, o, d)
    assert (port.tri.numpy() >= 0).sum() > 100
    assert_hits_agree(port, ref, tri_agree=1.0)
    assert_hits_agree(port, oracle, tri_agree=1.0)


def test_scheduled_inside_scene_rays(small_scenes):
    jdata, tdata = small_scenes
    o, d = inside_rays(np.random.default_rng(5), 512)
    port, ref, oracle = three_way(jdata, tdata, o, d)
    assert_hits_agree(port, oracle)
    assert_hits_agree(port, ref)


def test_scheduled_any_hit(many_cluster_scenes):
    """any_hit agrees with the oracle on is_hit, its only contract."""
    jdata, tdata = many_cluster_scenes
    o, d = random_rays(np.random.default_rng(13), 1024)
    port, ref, oracle = three_way(jdata, tdata, o, d, any_hit=True)
    want = np.asarray(oracle.tri) >= 0
    assert ((port.tri.numpy() >= 0) == want).all()
    assert ((np.asarray(ref.tri) >= 0) == want).all()


def test_scheduled_mask(small_scenes):
    """Masked lanes return a miss and do not perturb live lanes; 500 rays,
    so the padding lanes run too."""
    jdata, tdata = small_scenes
    rng = np.random.default_rng(17)
    o, d = random_rays(rng, 500)
    mask = T(rng.random(500) < 0.5)
    port, ref, oracle = three_way(jdata, tdata, o, d, mask=mask)
    full = tsched.closest_hit_scheduled(tdata, T(o), T(d), RenderConfig())
    m = mask.numpy()
    assert (port.t.numpy()[~m] == INF).all()
    assert (port.tri.numpy()[~m] == -1).all()
    assert not port.inside.numpy()[~m].any()
    assert (port.tri.numpy()[m] == full.tri.numpy()[m]).all()
    assert_hits_agree(port, ref)
    pick = lambda h: tuple(np.asarray(x)[m] for x in h)
    assert_hits_agree(pick(port), pick(oracle))


@pytest.mark.parametrize("case", [
    dict(max_bounce=3), dict(max_bounce=2, enable_env_map=False)],
    ids=["env_mis", "sky"])
def test_schedule_render_matches_jax(scenes, case):  # noqa: F811
    """The slice as a whole: render_radiance with cast_backend="schedule"
    against the JAX package's schedule backend (its Pallas kernel in
    interpret mode), by tests/test_torch_render.py's image criterion."""
    jdata, jcam, tdata, tcam = scenes
    kw = dict(width=32, height=32, **case)
    ref = np.asarray(jax_render_radiance(
        jdata, jcam,
        JConfig(use_pallas=True, pallas_backend="schedule",
                pallas_interpret=True, compaction_buckets=1, **kw), spp=2))
    sweeps = tsweep.sweep_plain.calls
    calls = tci.cluster_intersect_plain.calls
    img = render_radiance(tdata, tcam,
                          RenderConfig(cast_backend="schedule", **kw), spp=2)
    assert tci.cluster_intersect_plain.calls > calls
    assert tsweep.sweep_plain.calls == sweeps   # never the sweep tracer
    assert img.shape == (32, 32, 3)
    assert_images_agree(img.numpy(), ref)
