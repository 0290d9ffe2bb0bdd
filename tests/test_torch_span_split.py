"""PyTorch port: the properties of the plain cluster kernels that the
card's kernels (csrc/mt_span.cuh) lean on when they split a span's
triangles over warps and thread blocks and reduce the pieces in any order.

 (i) one span cut into 2, 4 and 8 groups of triangle columns, each group
     intersected on its own and the groups reduced by the least
     (t bits, lane k, inside) key, is the uncut span bit for bit, a tie
     between two identical triangles going to the lower lane;
 (ii) a sweep that walks past its stop test (every tile visits every span
     it overlaps) gives closest-hit rays the same hit within the 1e-5
     pullback window and any-hit rays the same hit/miss;
 (iii) the cluster intersection is invariant under a permutation of a
     tile's elected spans where no two spans tie.

Scenes are made as tests/test_torch_sweep.py makes them."""

import numpy as np
import pytest
import torch

from opengl_ray_tracing_framework_tpu.models.scene import (
    build_test_scene as jax_build_test_scene)
from opengl_ray_tracing_framework_tpu_torch.models.scene import (
    scene_from_numpy)
from opengl_ray_tracing_framework_tpu_torch.ops import (
    cluster_intersect as tci)
from opengl_ray_tracing_framework_tpu_torch.ops import sweep as tsweep

from test_torch_host import jax_scene_arrays

INF = 114514.0
TILE_R = tsweep.TILE_R
NO_HIT = np.uint64(2**64 - 1)


def _torch_scene(jdata):
    return scene_from_numpy(jax_scene_arrays(jdata), device="cpu")


@pytest.fixture(scope="module")
def scenes():
    _, jdata = jax_build_test_scene(n_sphere_subdiv=2)
    return _torch_scene(jdata)


@pytest.fixture(scope="module")
def many_cluster_scenes():
    jsc, _ = jax_build_test_scene(n_sphere_subdiv=3)
    jdata = jsc.build(cluster_size=8)
    assert jdata.cl_aabb_min.shape[0] >= 100
    return _torch_scene(jdata)


@pytest.fixture(params=["scenes", "many_cluster_scenes"])
def scene(request):
    return request.getfixturevalue(request.param)


def rays_at_sphere(rng, n):
    """Rays from around the scene aimed near the sphere at z = 3."""
    origin = np.asarray(rng.normal(0, 3.0, (n, 3)), np.float32)
    origin[:, 2] -= 1.0
    target = np.asarray(rng.normal(0, 0.7, (n, 3)), np.float32)
    target[:, 2] += 3.0
    d = target - origin
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return torch.as_tensor(origin), torch.as_tensor(d.astype(np.float32))


def fresh_records(n):
    rec = tci.init_best(n, "cpu")
    rec[:, 3] = INF
    return rec


def keys_of(rec, cid, t_blk, lane0):
    """The kernel's key of each record of a span over columns starting at
    lane0 of cluster cid: (t bits, lane k, inside bit) as one uint64, all
    ones where the span holds no hit."""
    t = rec[..., 0].numpy()
    slot = rec[..., 1].numpy().astype(np.int64)
    k = slot - cid.numpy()[:, None] * t_blk + lane0
    key = (t.view(np.uint32).astype(np.uint64) << np.uint64(32)) \
        | (k.astype(np.uint64) << np.uint64(1)) \
        | rec[..., 2].numpy().astype(np.uint64)
    return np.where(slot >= 0, key, NO_HIT)


def duplicate_lane(trifeat, cluster, src, dst):
    """Make triangle `dst` of a cluster block a copy of triangle `src`."""
    t_blk = trifeat.shape[2] // 4
    out = trifeat.clone()
    cols = out[cluster].reshape(tsweep.N_FEAT, 4, t_blk)
    cols[:, :, dst] = cols[:, :, src]
    return out


@pytest.mark.parametrize("groups", [2, 4, 8])
def test_span_cut_into_column_groups_is_the_span(scene, groups):
    """(i): also with a duplicated triangle, whose tie the lower lane wins."""
    trifeat = scene.cl_trifeat
    n_clusters, _, cols = trifeat.shape
    t_blk = cols // 4
    assert t_blk % groups == 0
    t_grp = t_blk // groups
    rng = np.random.default_rng(29 + groups)
    o, d = rays_at_sphere(rng, 4 * TILE_R)
    rf = tsweep.ray_features(o, d).reshape(4, TILE_R, tsweep.N_FEAT)

    # the cluster each tile hits most, its most-hit triangle copied into
    # the last lane of the block (another column group)
    cid = torch.zeros(4, dtype=torch.int64)
    for g in range(4):
        hits = [(tsweep.intersect_span_plain(
            rf[g:g + 1], trifeat, torch.tensor([c]),
            fresh_records(TILE_R)[None])[..., 1] >= 0).sum().item()
            for c in range(n_clusters)]
        cid[g] = int(np.argmax(hits))
    whole = tsweep.intersect_span_plain(
        rf, trifeat, cid, fresh_records(4 * TILE_R).reshape(4, TILE_R, -1))
    assert (whole[..., 1] >= 0).sum() > 40
    for g in range(4):
        lanes = (whole[g, :, 1][whole[g, :, 1] >= 0].long()
                 - cid[g] * t_blk).numpy()
        lanes = lanes[lanes < t_blk - t_grp]     # not in the last group
        src = int(np.bincount(lanes).argmax())
        trifeat = duplicate_lane(trifeat, int(cid[g]), src, t_blk - 1)
    whole = tsweep.intersect_span_plain(
        rf, trifeat, cid, fresh_records(4 * TILE_R).reshape(4, TILE_R, -1))
    want = keys_of(whole, cid, t_blk, 0)

    key = np.full((4, TILE_R), NO_HIT)
    blocks = trifeat.reshape(n_clusters, tsweep.N_FEAT, 4, t_blk)
    for s in reversed(range(groups)):          # any order of reduction
        part = blocks[..., s * t_grp:(s + 1) * t_grp].reshape(
            n_clusters, tsweep.N_FEAT, 4 * t_grp).contiguous()
        rec = tsweep.intersect_span_plain(
            rf, part, cid, fresh_records(4 * TILE_R).reshape(4, TILE_R, -1))
        key = np.minimum(key, keys_of(rec, cid, t_grp, s * t_grp))
    np.testing.assert_array_equal(key, want)
    # the duplicates tie exactly and the lower lane holds every such hit
    lane = (want >> np.uint64(1)) & np.uint64(511)
    assert not ((want != NO_HIT) & (lane == t_blk - 1)).any()


def sweep_arguments(scene, rng, n, anyhit_share):
    o, d = rays_at_sphere(rng, n)
    mask = torch.as_tensor(rng.random(n) < 0.9)
    anyhit = torch.as_tensor(rng.random(n) < anyhit_share)
    args, _ = tsweep.sweep_inputs(scene, o, d, mask, anyhit)
    return args


@pytest.mark.parametrize("anyhit_share", [0.0, 0.5])
def test_sweep_past_its_stop_test(scene, anyhit_share):
    """(ii): no span the stop test skips changes a closest hit by more
    than the pullback, or an any-hit ray's hit/miss."""
    rng = np.random.default_rng(31)
    nspan, spans, tile_sorted, rayfeat, best, trifeat = sweep_arguments(
        scene, rng, 1024, anyhit_share)
    want = tsweep.sweep_plain(nspan, spans, tile_sorted, rayfeat, best,
                              trifeat)
    stopped = tsweep.sweep_plain.visited.clone()
    # entry distances below every threshold: the stop test never fires
    # while a tile has a live ray
    got = tsweep.sweep_plain(nspan, spans,
                             torch.full_like(tile_sorted, -3 * INF), rayfeat,
                             best, trifeat)
    walked = tsweep.sweep_plain.visited
    assert torch.equal(walked, nspan.long()) and (walked >= stopped).all()
    closest = best[:, 4] < 0.5
    assert torch.equal(got[:, 1] >= 0, want[:, 1] >= 0)
    hit = closest & (want[:, 1] >= 0)
    assert hit.sum() > 100
    np.testing.assert_allclose(got[hit, 0].numpy(), want[hit, 0].numpy(),
                               rtol=0, atol=1.0001e-5)
    same_t = got[hit, 0] == want[hit, 0]
    assert same_t.float().mean() >= 0.995
    assert torch.equal(got[hit][same_t][:, 1:3], want[hit][same_t][:, 1:3])


@pytest.mark.parametrize("seed", [37, 41])
def test_cluster_intersect_under_a_permutation_of_the_spans(scene, seed):
    """(iii): the elected spans of a tile in another order give the same
    records (no two spans of these inputs tie)."""
    rng = np.random.default_rng(seed)
    n_tiles, k = 4, min(8, scene.cl_trifeat.shape[0])
    o, d = rays_at_sphere(rng, n_tiles * TILE_R)
    rayfeat = tsweep.ray_features(o, d)
    tn = tsweep.cluster_tnear(o, d, scene.cl_aabb_min, scene.cl_aabb_max)
    tile_tn = tn.reshape(n_tiles, TILE_R, -1).amin(dim=1)
    near, order = torch.sort(tile_tn, dim=1, stable=True)
    n_clusters = tile_tn.shape[1]
    spans = torch.where(near[:, :k] < INF, order[:, :k], n_clusters) \
        .to(torch.int32)                 # n_clusters: an entry to skip
    nspan = torch.full((n_tiles,), k, dtype=torch.int32)
    best = tci.init_best(n_tiles * TILE_R, "cpu")
    want = tci.cluster_intersect_plain(rayfeat, best, spans, nspan,
                                       scene.cl_trifeat)
    assert (want[:, 1] >= 0).sum() > 40
    shuffled = torch.stack([row[torch.as_tensor(rng.permutation(k))]
                            for row in spans])
    assert not torch.equal(shuffled, spans)
    got = tci.cluster_intersect_plain(rayfeat, best, shuffled, nspan,
                                      scene.cl_trifeat)
    assert torch.equal(got, want)
