"""PyTorch port, the module that holds the kernel: ops/sweep.py (host
preparation + the span-sweep kernel's plain version, which is what a CPU
tensor runs) against the JAX sweep (Pallas kernel in interpret mode) and
both against the brute-force oracle, on the cases of tests/test_sweep.py.

Criterion (tests/test_schedule.py::assert_matches_oracle): hit/miss
exact, t within rtol/atol 1e-4, the same triangle on >= 99.5% of the
hits (exact-t ties between duplicate triangles may go either way), and
the same inside flag where the triangle agrees."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from opengl_ray_tracing_framework_tpu.models.scene import (
    build_test_scene as jax_build_test_scene)
from opengl_ray_tracing_framework_tpu.ops import sweep as jsweep
from opengl_ray_tracing_framework_tpu.ops.intersect import closest_hit_brute
from opengl_ray_tracing_framework_tpu.ops.intersect_pallas import (
    ray_features as jax_ray_features)
from opengl_ray_tracing_framework_tpu.ops.schedule import (
    cluster_tnear as jax_cluster_tnear)
from opengl_ray_tracing_framework_tpu.utils.config import RenderConfig
from opengl_ray_tracing_framework_tpu_torch.models.scene import (
    build_test_scene as torch_build_test_scene, scene_from_numpy)
from opengl_ray_tracing_framework_tpu_torch.ops import intersect as tint
from opengl_ray_tracing_framework_tpu_torch.ops import sweep as tsweep

from test_torch_host import assert_same_scene, jax_scene_arrays

INF = 114514.0
JCFG = RenderConfig(pallas_interpret=True)


def _pair(jdata):
    return jdata, scene_from_numpy(jax_scene_arrays(jdata), device="cpu")


@pytest.fixture(scope="module")
def scenes():
    _, jdata = jax_build_test_scene(n_sphere_subdiv=2)
    return _pair(jdata)


@pytest.fixture(scope="module")
def many_cluster_scenes():
    jsc, _ = jax_build_test_scene(n_sphere_subdiv=3)
    jdata = jsc.build(cluster_size=8)
    assert jdata.cl_aabb_min.shape[0] >= 100
    return _pair(jdata)


@pytest.fixture(scope="module")
def small_block_scenes():
    """The 81,922-triangle scene of the main path in cluster blocks of 8:
    14,172 clusters, more than csrc/sweep_prep.cu's sweep_spans holds in
    its keys, so the card's tiles can take its sorted runs. Built once in
    each package; the port's build equals JAX's."""
    jsc, _ = jax_build_test_scene(n_sphere_subdiv=6)
    jdata = jsc.build(cluster_size=8)
    tdata = torch_build_test_scene(6, device="cpu")[0].build(
        cluster_size=8, device="cpu")
    assert tdata.cl_aabb_min.shape[0] == 14172 > 8192
    assert_same_scene(tdata, jax_scene_arrays(jdata))
    return jdata, tdata


@pytest.fixture(scope="module", params=[512, 1024, 302])
def wide_block_scenes(request):
    """The subdiv-3 test scene in cluster blocks wider than 256 triangles,
    as the reference's Scene.build(cluster_size=...) takes them (302: a
    width that is no multiple of 4)."""
    jsc, _ = jax_build_test_scene(n_sphere_subdiv=3)
    jdata = jsc.build(cluster_size=request.param)
    assert jdata.cl_trifeat.shape[2] == 4 * request.param
    return _pair(jdata)


def random_rays(rng, n, spread=3.0):
    origin = np.asarray(rng.normal(0, spread, (n, 3)), np.float32)
    origin[:, 2] -= 1.0
    d = np.asarray(rng.normal(0, 1, (n, 3)), np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return origin, d


def inside_rays(rng, n):
    origin = np.asarray(rng.normal(0, 0.4, (n, 3)), np.float32)
    origin[:, 2] += 3.0   # inside the sphere at z = 3
    d = np.asarray(rng.normal(0, 1, (n, 3)), np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return origin, d


def np_hit(hit):
    return tuple(np.asarray(x.cpu() if torch.is_tensor(x) else x)
                 for x in hit)


def assert_hits_agree(got, want, tri_agree=0.995):
    (gt, gtri, gin), (wt, wtri, win) = np_hit(got), np_hit(want)
    gh, wh = gtri >= 0, wtri >= 0
    assert (gh == wh).all(), f"hit/miss differs on {(gh != wh).sum()} rays"
    both = gh & wh
    np.testing.assert_allclose(gt[both], wt[both], rtol=1e-4, atol=1e-4)
    same = gtri[both] == wtri[both]
    assert same.mean() >= tri_agree, same.mean()
    assert (gin[both][same] == win[both][same]).all()


def three_way(jdata, tdata, o, d, **kw):
    """Port vs JAX sweep vs the brute-force oracle on one batch."""
    port = tsweep.closest_hit_swept(tdata, torch.as_tensor(o),
                                    torch.as_tensor(d), **kw)
    jkw = dict(kw)
    if "mask" in jkw:
        jkw["mask"] = jnp.asarray(jkw["mask"].numpy())
    ref = jsweep.closest_hit_swept(jdata, jnp.asarray(o), jnp.asarray(d),
                                   JCFG, interpret=True, **jkw)
    oracle = closest_hit_brute(jnp.asarray(o), jnp.asarray(d),
                               jdata.p1, jdata.p2, jdata.p3)
    return port, ref, oracle


def test_cluster_tnear_matches_jax(scenes):
    jdata, tdata = scenes
    o, d = random_rays(np.random.default_rng(3), 512)
    want = np.asarray(jax_cluster_tnear(jnp.asarray(o), jnp.asarray(d),
                                        jdata.cl_aabb_min, jdata.cl_aabb_max))
    got = tsweep.cluster_tnear(torch.as_tensor(o), torch.as_tensor(d),
                               tdata.cl_aabb_min, tdata.cl_aabb_max).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["random", "inside"])
def test_swept_matches_jax_and_oracle(scenes, case):
    jdata, tdata = scenes
    rng = np.random.default_rng(11 if case == "random" else 5)
    o, d = random_rays(rng, 2048) if case == "random" else \
        inside_rays(rng, 512)
    port, ref, oracle = three_way(jdata, tdata, o, d)
    assert_hits_agree(port, oracle)
    assert_hits_agree(port, ref)
    assert_hits_agree(ref, oracle)


def test_swept_many_clusters(many_cluster_scenes):
    jdata, tdata = many_cluster_scenes
    o, d = random_rays(np.random.default_rng(7), 2048)
    port, ref, oracle = three_way(jdata, tdata, o, d)
    assert_hits_agree(port, oracle)
    assert_hits_agree(port, ref)


def test_swept_wide_blocks_match_jax(wide_block_scenes):
    """Cluster blocks of 512, 1,024 and 302 triangles: the port's sweep
    finds the JAX sweep's hits (and the oracle's), triangle for
    triangle."""
    jdata, tdata = wide_block_scenes
    o, d = random_rays(np.random.default_rng(29), 2048)
    port, ref, oracle = three_way(jdata, tdata, o, d)
    assert (port.tri.numpy() >= 0).sum() > 100
    assert_hits_agree(port, ref, tri_agree=1.0)
    assert_hits_agree(port, oracle, tri_agree=1.0)


def test_swept_small_blocks_match_jax(small_block_scenes):
    """14,172 clusters of 8 triangles: the port's sweep finds the JAX
    sweep's hits and the oracle's."""
    jdata, tdata = small_block_scenes
    o, d = random_rays(np.random.default_rng(37), 256)
    port, ref, oracle = three_way(jdata, tdata, o, d)
    assert (port.tri.numpy() >= 0).sum() > 50
    assert_hits_agree(port, oracle)
    assert_hits_agree(port, ref)


def test_swept_any_hit(many_cluster_scenes):
    jdata, tdata = many_cluster_scenes
    o, d = random_rays(np.random.default_rng(13), 1024)
    port, ref, oracle = three_way(jdata, tdata, o, d, any_hit=True)
    want = np.asarray(oracle.tri) >= 0
    assert ((port.tri.numpy() >= 0) == want).all()
    assert ((np.asarray(ref.tri) >= 0) == want).all()


def test_swept_mask(scenes):
    jdata, tdata = scenes
    rng = np.random.default_rng(17)
    o, d = random_rays(rng, 512)
    mask = torch.as_tensor(rng.random(512) < 0.5)
    port, ref, _ = three_way(jdata, tdata, o, d, mask=mask)
    full = tsweep.closest_hit_swept(tdata, torch.as_tensor(o),
                                    torch.as_tensor(d))
    m = mask.numpy()
    assert (port.t.numpy()[~m] == INF).all()
    assert (port.tri.numpy()[~m] == -1).all()
    assert not port.inside.numpy()[~m].any()
    for a, b in zip(np_hit(port), np_hit(full)):
        np.testing.assert_array_equal(a[m], b[m])
    assert_hits_agree(port, ref)


def test_swept_pair_mixed(many_cluster_scenes):
    """The per-bounce merged cast: NEE shadow rays (any hit) and bounce
    rays (closest hit) in one sweep, each population with its own mask."""
    jdata, tdata = many_cluster_scenes
    rng = np.random.default_rng(19)
    oa, da = inside_rays(rng, 640)
    oc, dc = random_rays(rng, 896)
    ma, mc = rng.random(640) < 0.7, rng.random(896) < 0.8
    t = torch.as_tensor
    p_any, p_cls = tsweep.closest_hit_swept_pair(
        tdata, t(oa), t(da), t(ma), t(oc), t(dc), t(mc))
    j = jnp.asarray
    r_any, r_cls = jsweep.closest_hit_swept_pair(
        jdata, j(oa), j(da), j(ma), j(oc), j(dc), j(mc), JCFG,
        interpret=True)
    o_any = closest_hit_brute(j(oa), j(da), jdata.p1, jdata.p2, jdata.p3)
    o_cls = closest_hit_brute(j(oc), j(dc), jdata.p1, jdata.p2, jdata.p3)
    want_any = (np.asarray(o_any.tri) >= 0) & ma
    assert ((p_any.tri.numpy() >= 0) == want_any).all()
    assert ((np.asarray(r_any.tri) >= 0) == want_any).all()
    sel = np.nonzero(mc)[0]
    pick = lambda h: tuple(np.asarray(x)[sel] for x in np_hit(h))
    assert_hits_agree(pick(p_cls), pick(o_cls))
    assert_hits_agree(pick(p_cls), pick(r_cls))
    assert (p_cls.tri.numpy()[~mc] == -1).all()


def test_cpu_tensors_take_the_plain_version(scenes):
    """A CPU tensor runs sweep_plain and never counts a kernel launch; the
    records it returns are the brute-force closest hits."""
    jdata, tdata = scenes
    o, d = random_rays(np.random.default_rng(23), 1000)
    launches, calls = tsweep.sweep.launches, tsweep.sweep_plain.calls
    hit = tsweep.closest_hit_swept(tdata, torch.as_tensor(o),
                                   torch.as_tensor(d))
    assert tsweep.sweep.launches == launches
    assert tsweep.sweep_plain.calls == calls + 1
    oracle = tint.closest_hit_brute(torch.as_tensor(o), torch.as_tensor(d),
                                    tdata.p1, tdata.p2, tdata.p3)
    assert_hits_agree(hit, oracle)


def _jax_prep(jdata, o, d, mask, anyhit):
    """JAX's own steps of ops/sweep.py::_swept_impl (:286-322) on rays
    padded to a whole number of 128-ray tiles as the port pads them: the
    slab test, _sort_key and the stable lax.sort (R > 128 only), the
    second slab test on the sorted rays, the per-tile minimum and the
    stable argsort, nspan, the cap, the ray features and the records."""
    tile = tsweep.TILE_R
    pad = (-o.shape[0]) % tile
    o = np.concatenate([o, np.zeros((pad, 3), np.float32)])
    d = np.concatenate([d, np.tile(np.float32([[0, 0, 1]]), (pad, 1))])
    mask = np.concatenate([mask, np.zeros(pad, bool)])
    anyhit = np.concatenate([anyhit, np.zeros(pad, bool)])
    padded = tuple(torch.as_tensor(x) for x in (o, d, mask))
    o, d, mask, anyhit = map(jnp.asarray, (o, d, mask, anyhit))
    r, c = o.shape[0], jdata.cl_aabb_min.shape[0]

    def masked_tn(o, d, mask):
        tn = jax_cluster_tnear(o, d, jdata.cl_aabb_min, jdata.cl_aabb_max)
        return jnp.where(mask[:, None], tn, INF)

    key = perm = None
    tn = masked_tn(o, d, mask)
    if r > tile:
        key = jsweep._sort_key(tn, d, mask)
        perm = jax.lax.sort((key, jnp.arange(r, dtype=jnp.int32)),
                            num_keys=1)[1]
        o, d, mask, anyhit = o[perm], d[perm], mask[perm], anyhit[perm]
        tn = masked_tn(o, d, mask)
    tile_tn = tn.reshape(r // tile, tile, c).min(axis=1)
    order = jnp.argsort(tile_tn, axis=1)
    tile_sorted = jnp.take_along_axis(tile_tn, order, axis=1)
    nspan = jnp.sum(tile_sorted < INF, axis=1)
    cap = jnp.nextafter(jnp.max(jnp.where(tn < INF, tn, -INF), axis=1), INF)
    best = jnp.zeros((r, 8), jnp.float32)
    best = best.at[:, 0].set(jnp.where(mask, INF, -INF)).at[:, 1].set(-1.0)
    best = best.at[:, 3].set(cap).at[:, 4].set(anyhit.astype(jnp.float32))
    return key, perm, dict(
        nspan=nspan, spans=order, tile_sorted=tile_sorted,
        rayfeat=jax_ray_features(o, d), best=best), padded


@pytest.mark.parametrize("fixture", ["scenes", "many_cluster_scenes",
                                     "small_block_scenes"])
@pytest.mark.parametrize("n_rays,masked", [(1000, 0.3), (100, 0.2),
                                           (768, 0.0)])
def test_sweep_inputs_equal_jax_swept_impl_steps(fixture, n_rays, masked,
                                                 request):
    """On the CPU, sweep_inputs (the plain versions of the preparation
    kernels, csrc/sweep_prep.cu) gives exactly the values of JAX's steps of
    _swept_impl: the key, the permutation, the span lists, the caps, the
    ray features and the records; with masked lanes, R no multiple of 128
    (padded) and R <= 128 (one tile, no sort), at 161 clusters and at
    14,172 (where the card's tiles can take sorted runs). Exact: the two CPU
    libraries round the slab test and the cross product alike; their
    atan2 differs in the last bit on about a sixth of inputs, which moves
    a key only where phi lies within that bit of a bucket edge (none
    here)."""
    jdata, tdata = request.getfixturevalue(fixture)
    rng = np.random.default_rng(n_rays + 31)
    o, d = random_rays(rng, n_rays // 2)
    oi, di = inside_rays(rng, n_rays - n_rays // 2)
    o, d = np.concatenate([o, oi]), np.concatenate([d, di])
    mask = rng.random(n_rays) >= masked
    anyhit = rng.random(n_rays) < 0.4
    want_key, want_perm, want, padded = _jax_prep(jdata, o, d, mask, anyhit)

    t = torch.as_tensor
    calls = (tsweep.sweep_key_plain.calls, tsweep.sweep_spans_plain.calls)
    launches = (tsweep.sweep_key.launches, tsweep.sweep_spans.launches)
    args, perm = tsweep.sweep_inputs(tdata, t(o), t(d), t(mask), t(anyhit))
    sort = n_rays > tsweep.TILE_R
    assert (tsweep.sweep_key_plain.calls,
            tsweep.sweep_spans_plain.calls) == (calls[0] + sort, calls[1] + 1)
    assert (tsweep.sweep_key.launches,
            tsweep.sweep_spans.launches) == launches
    padded_port = tsweep.pad_cast(t(o), t(d), t(mask), t(anyhit))
    for x, y in zip(padded_port, padded):
        assert torch.equal(x, y)
    if sort:
        lo, hi = tdata.cl_aabb_min, tdata.cl_aabb_max
        key = tsweep.sweep_key(*padded, lo, hi, tsweep.group_boxes(lo, hi))
        np.testing.assert_array_equal(key.numpy(), np.asarray(want_key))
        assert (key.numpy() != (1 << 30)).sum() > 100   # live keys
        np.testing.assert_array_equal(perm.numpy(), np.asarray(want_perm))
    else:
        assert perm is None and want_perm is None
    for name, got in zip(("nspan", "spans", "tile_sorted", "rayfeat",
                          "best"), args[:5]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want[name]),
                                      err_msg=name)
    assert int(args[0].max()) > 1
    assert args[5] is tdata.cl_trifeat or torch.equal(args[5],
                                                      tdata.cl_trifeat)
