"""PyTorch port, the cluster slots the tracers' records name: the sweep
tracer's record keeps a slot (cluster * T + lane) as an int32 by its bits,
exact up to 2^31 - 1, and its wrapper refuses more slots; the schedule
tracer's record keeps the slot's float32 value and its wrapper refuses
more than 2^24 slots; one check of (C, T) serves both. The sweep on the
CPU names odd slots past 2^24 exactly, where a float32's value would
round them to a neighbouring lane. The coherence key refuses more
clusters than it can name below its dead key."""

import numpy as np
import pytest
import torch

from opengl_ray_tracing_framework_tpu_torch import build_test_scene
from opengl_ray_tracing_framework_tpu_torch.ops import (
    cluster_intersect as tci)
from opengl_ray_tracing_framework_tpu_torch.ops import sweep as tsweep

TILE_R = tsweep.TILE_R

# (clusters, slots a cluster) of each slot count, as C x T
SLOT_COUNTS = {
    (1 << 24) - 1: ((1 << 24) - 1, 1),
    1 << 24: (1 << 16, 256),
    (1 << 24) + 1: ((1 << 24) + 1, 1),
    (1 << 31) - 1: ((1 << 31) - 1, 1),
    1 << 31: (1 << 23, 256),
}


def _blocks(c, t_blk):
    """A (C, 16, 4T) trifeat that holds one block, seen C times."""
    return torch.zeros((1, tsweep.N_FEAT, 4 * t_blk)).expand(
        c, tsweep.N_FEAT, 4 * t_blk)


def _sweep(trifeat):
    """sweep on zero tiles of trifeat's clusters (no work past the
    check)."""
    c = trifeat.shape[0]
    return tsweep.sweep(torch.zeros(0, dtype=torch.int32),
                        torch.zeros((0, c), dtype=torch.int32),
                        torch.zeros((0, c)), torch.zeros((0, tsweep.N_FEAT)),
                        torch.zeros((0, tsweep.BEST_W)), trifeat)


def _cluster_intersect(trifeat):
    """cluster_intersect on one tile with no spans (no work past the
    check)."""
    return tci.cluster_intersect(
        torch.zeros((TILE_R, tsweep.N_FEAT)), tci.init_best(TILE_R, "cpu"),
        torch.zeros((1, 1), dtype=torch.int32),
        torch.zeros(1, dtype=torch.int32), trifeat)


@pytest.mark.parametrize("wrapper,limit,beyond", [
    ("sweep", (1 << 31) - 1, ""),
    ("cluster_intersect", 1 << 24, "sweep tracer"),
])
@pytest.mark.parametrize("slots", sorted(SLOT_COUNTS))
def test_each_wrapper_refuses_past_its_slots(wrapper, limit, beyond, slots):
    """sweep takes up to 2^31 - 1 slots, cluster_intersect up to 2^24 (its
    message names the sweep tracer, which goes further); both through
    check_slots, before either version runs."""
    c, t_blk = SLOT_COUNTS[slots]
    call = _sweep if wrapper == "sweep" else _cluster_intersect
    trifeat = _blocks(c, t_blk)
    if slots <= limit:
        call(trifeat)
    else:
        with pytest.raises(ValueError, match=f"{limit} slots.*{beyond}"):
            call(trifeat)


@pytest.mark.parametrize("slot", [0, 1, (1 << 24) - 1, (1 << 24) + 1,
                                  (1 << 24) + 3, (1 << 25) + 5,
                                  (1 << 31) - 1])
def test_slot_lane_holds_every_slot_by_its_bits(slot):
    """A slot written into K1's record comes back exact through the copies
    a cast makes of the records (clone, gather, the unsort's
    index_copy_), beside records that hold no hit (NO_SLOT: a negative
    int32, and -1.0 as a float); a float32's value would not hold the odd
    slots past 2^24."""
    best = torch.zeros((4, tsweep.BEST_W))
    best[:, 1] = tsweep.NO_SLOT
    tsweep.record_slots(best)[2] = slot
    perm = torch.tensor([3, 0, 2, 1])
    moved = torch.empty_like(best).index_copy_(0, perm, best.clone()[perm])
    lane = tsweep.record_slots(moved)
    assert lane.dtype == torch.int32
    assert lane.tolist()[2] == slot
    assert all(v < 0 for i, v in enumerate(lane.tolist()) if i != 2)
    assert moved[[0, 1, 3], 1].tolist() == [-1.0] * 3
    exact = int(torch.tensor(slot, dtype=torch.float32).item()) == slot
    assert exact == (slot <= 1 << 24)


def test_sweep_names_odd_slots_past_2_24_exactly():
    """One tile of rays aimed at the triangles of the last of 65,600
    clusters of 256 (slots 16,793,344 and up), each cluster a view of one
    block (only the last one's box lies where the rays go): the sweep
    tracer's preparation and sweep give every ray that cluster's slot base
    plus the lane a cast of the block alone (closest_hit_swept) hits, odd
    lanes past 2^24 included, with the same t and inside flag."""
    host, _ = build_test_scene(1, device="cpu")
    small = host.build(cluster_size=256, device="cpu")
    assert small.cl_aabb_min.shape[0] == 1     # one block of 82 triangles
    c = 65600
    base = (c - 1) * 256
    assert base > 1 << 24
    lo = torch.full((c, 3), 1000.0)
    hi = lo + 1.0
    lo[-1], hi[-1] = small.cl_aabb_min[0], small.cl_aabb_max[0]
    trifeat = small.cl_trifeat.expand(c, -1, -1)

    # rays from off each triangle's centroid, back through it
    cent = (small.p1 + small.p2 + small.p3) / 3.0
    normal = torch.nn.functional.normalize(torch.linalg.cross(
        small.p2 - small.p1, small.p3 - small.p1), dim=1)
    pick = torch.arange(TILE_R) % cent.shape[0]
    origin = cent[pick] + 0.5 * normal[pick]
    direction = -normal[pick]
    want = tsweep.closest_hit_swept(small, origin, direction)
    mask = torch.ones(TILE_R, dtype=torch.bool)
    args = tsweep.sweep_spans_plain(origin, direction, mask, ~mask, None, lo,
                                    hi)
    assert args[0].tolist() == [1]              # the last cluster alone
    best = tsweep.sweep(*args, trifeat)
    slot = tsweep.record_slots(best)

    lanes = small.cl_slot2tri.tolist()
    lane = torch.tensor([lanes.index(t) if t >= 0 else -1
                         for t in want.tri.tolist()], dtype=torch.int32)
    hit = lane >= 0
    assert hit.sum() > 100
    assert torch.equal(slot[hit], base + lane[hit])
    assert (slot[~hit] < 0).all()
    assert torch.equal(best[:, 0], want.t)
    assert torch.equal(best[:, 2] > 0.5, want.inside)
    odd = slot[hit] % 2 == 1
    assert odd.sum() > 20
    # as a float32's value these slots would come back rounded
    assert (slot[hit][odd].float().long() != slot[hit][odd].long()).all()


def test_key_refuses_more_clusters_than_it_names():
    """nearest * 128 + 127 stays below the dead key up to MAX_KEY_CLUSTERS
    clusters; past them sweep_key refuses before it computes anything."""
    assert (tsweep.MAX_KEY_CLUSTERS - 1) * 128 + 127 == tsweep._DEAD_KEY - 1
    c = tsweep.MAX_KEY_CLUSTERS + 1
    lo = torch.zeros((1, 3)).expand(c, 3)
    o, d = torch.zeros((2 * TILE_R, 3)), torch.zeros((2 * TILE_R, 3))
    d[:, 2] = 1.0
    mask = torch.ones(2 * TILE_R, dtype=torch.bool)
    with pytest.raises(ValueError, match=f"{tsweep.MAX_KEY_CLUSTERS}"):
        tsweep.sweep_key(o, d, mask, lo, lo + 1, None)


def test_no_slot_reads_as_minus_one():
    """The record a preparation writes before any hit: the slot lane -1.0
    as a float (JAX's record), a negative int32 by its bits."""
    o = torch.zeros((TILE_R, 3))
    d = torch.zeros((TILE_R, 3))
    d[:, 2] = 1.0
    mask = torch.ones(TILE_R, dtype=torch.bool)
    lo = torch.tensor([[-1.0, -1.0, 2.0]])
    out = tsweep.sweep_spans_plain(o, d, mask, mask, None, lo, lo + 2)
    best = out[4]
    assert (best[:, 1] == -1.0).all()
    assert (tsweep.record_slots(best) < 0).all()
    assert np.isfinite(best.numpy()).all()
