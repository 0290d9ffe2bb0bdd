"""Scheduled-wavefront closest hit: the vote tracer, around one kernel
(PyTorch port of opengl_ray_tracing_framework_tpu.ops.schedule).

RenderConfig(cast_backend="schedule") sends every cast here.

  round loop (runs until no ray has a pending cluster):
    1. candidates: from the slab test of every ray against every cluster
       AABB (sweep.cluster_tnear, (R, C)), each ray's candidate is its
       nearest cluster that is not yet visited and not pruned by its
       current best hit (the `t_enter > best_t` cut of glsl:373-388);
    2. vote: each tile of RAY_TILE rays counts its rays' candidates and
       elects the top-K most wanted clusters;
    3. intersect: ops.cluster_intersect.cluster_intersect tests every ray
       of the tile against every elected cluster (opportunistic: all rays,
       not only the voters) and lowers the best records;
    4. mark: elected clusters become visited for all rays of the tile.

Nothing is ever dropped: a ray whose candidate loses the vote votes again
next round, and each round visits at least one new cluster per tile with
pending rays, so the loop ends within C rounds. The answer is the exact
closest hit whatever the tile size, the sort and K are; they change only
the number of rounds.

The JAX module's lax.while_loop is a Python loop here, with one host read
per round (is any ray still pending?). `closest_hit_scheduled.rounds` and
`.casts` count rounds and casts, so a run can print rounds per cast, and
`.max_rounds` keeps the most rounds one cast took.

Shadow rays pass any_hit=True: a ray stops voting once it has any hit.
"""

from __future__ import annotations

import math

import torch

from .cluster_intersect import cluster_intersect, init_best
from .intersect import INF, Hit
from .sweep import TILE_R, cluster_tnear, ray_features

RAY_TILE = TILE_R     # rays per voting tile: one CTA of the kernel
_MASKED_KEY = 1 << 12  # sort key of masked rays: after every direction key


def _direction_key(direction):
    """11-bit quantized direction (6 bits azimuth, 5 bits elevation): the
    sort key that groups rays with similar candidate clusters into the same
    tiles. The sort is stable, so equal keys keep their (pixel-block)
    order."""
    phi = torch.atan2(direction[:, 2], direction[:, 0])
    kphi = torch.clamp(((phi * (0.5 / math.pi) + 0.5) * 64).to(torch.int32),
                       0, 63)
    kct = torch.clamp(((direction[:, 1] * 0.5 + 0.5) * 32).to(torch.int32),
                      0, 31)
    return kphi * 32 + kct


def _candidates(tnear, best, visited, mask, any_hit):
    """(has, cand): whether each ray still has a pending cluster, and its
    nearest one (the first minimum, so ties take the lower cluster id)."""
    pending = ~visited & (tnear < best[:, 0:1]) & mask[:, None]
    if any_hit:
        pending &= (best[:, 1] < 0.0)[:, None]
    tkey = torch.where(pending, tnear, INF)
    cmin, cand = torch.min(tkey, dim=1)
    return cmin < INF, cand


def elect(has, cand, n_tiles: int, n_clusters: int, top_k: int):
    """The per-tile vote: (spans (G, K) i32, nspan (G,) i32).
    Among equal counts the lower cluster id wins (a stable descending
    sort), so runs repeat; entries without votes are n_clusters, which the
    kernel skips."""
    tile = has.shape[0] // n_tiles
    tile_of = torch.arange(has.shape[0], device=has.device) // tile
    votes = torch.zeros((n_tiles, n_clusters), dtype=torch.int64,
                        device=has.device)
    votes.view(-1).scatter_add_(0, tile_of * n_clusters + cand,
                                has.to(torch.int64))
    counts, ids = torch.sort(votes, dim=1, descending=True, stable=True)
    counts, ids = counts[:, :top_k], ids[:, :top_k]
    valid = counts > 0
    spans = torch.where(valid, ids, n_clusters).to(torch.int32).contiguous()
    nspan = valid.sum(dim=1, dtype=torch.int32)
    return spans, nspan


def _scheduled(origin, direction, mask, cl_min, cl_max, trifeat, slot2tri,
               top_k: int, any_hit: bool) -> Hit:
    r_in = origin.shape[0]
    dev = origin.device
    c = cl_min.shape[0]
    pad = (-r_in) % RAY_TILE
    mask_in = mask
    if pad:   # padding rays point along +z with the mask off
        origin = torch.cat([origin, origin.new_zeros((pad, 3))])
        direction = torch.cat([direction, torch.tensor(
            [[0.0, 0.0, 1.0]], dtype=direction.dtype, device=dev)
            .expand(pad, 3)])
        mask = torch.cat([mask, mask.new_zeros(pad)])
    r = origin.shape[0]
    g = r // RAY_TILE
    k = min(top_k, c)

    # Sort rays by quantized direction so a tile's rays share candidate
    # clusters (a multi-tile batch of bounce or shadow rays is otherwise
    # direction-incoherent and every tile elects every cluster).
    perm = None
    if g > 1:
        key = torch.where(mask, _direction_key(direction), _MASKED_KEY)
        perm = torch.sort(key, stable=True).indices
        origin, direction, mask = origin[perm], direction[perm], mask[perm]

    rayfeat = ray_features(origin, direction)
    tnear = cluster_tnear(origin, direction, cl_min, cl_max)
    best = init_best(r, dev)
    visited = torch.zeros((r, c), dtype=torch.bool, device=dev)
    tile_of = torch.arange(r, device=dev) // RAY_TILE

    rounds = 0
    has, cand = _candidates(tnear, best, visited, mask, any_hit)
    while bool(has.any()):
        # every round visits >= 1 new cluster of each tile with pending
        # rays, so more than C rounds means the bookkeeping is broken
        assert rounds <= c, f"schedule tracer: {rounds} rounds, {c} clusters"
        spans, nspan = elect(has, cand, g, c, k)
        best = cluster_intersect(rayfeat, best, spans, nspan, trifeat)
        sched = torch.zeros((g, c + 1), dtype=torch.bool, device=dev)
        sched.scatter_(1, spans.long(), True)   # column c takes the skipped
        visited |= sched[:, :c][tile_of]
        has, cand = _candidates(tnear, best, visited, mask, any_hit)
        rounds += 1
    stats = closest_hit_scheduled
    stats.rounds += rounds
    stats.casts += 1
    stats.max_rounds = max(stats.max_rounds, rounds)

    if perm is not None:   # back to the callers' order
        best = torch.empty_like(best).index_copy_(0, perm, best)
    best = best[:r_in]
    # masked lanes pick up opportunistic tile hits: the contract is a miss
    t = torch.where(mask_in, best[:, 0], INF)
    slot = torch.where(mask_in, best[:, 1].to(torch.int32), -1)
    tri = torch.where(
        slot >= 0,
        slot2tri[torch.clamp(slot, 0, slot2tri.shape[0] - 1).long()], -1)
    return Hit(t=t, tri=tri.to(torch.int32),
               inside=mask_in & (best[:, 2] > 0.5))


def closest_hit_scheduled(scene, origin, direction, config, mask=None,
                          any_hit: bool = False) -> Hit:
    """Scheduled-wavefront closest (or any) hit against the scene clusters.

    mask: optional (R,) bool; lanes with mask=False are not traced and
    return a miss. any_hit: occlusion semantics, rays stop once any hit is
    found (the returned t/tri are then a hit, not necessarily the
    closest)."""
    if mask is None:
        mask = torch.ones(origin.shape[0], dtype=torch.bool,
                          device=origin.device)
    return _scheduled(origin, direction, mask, scene.cl_aabb_min,
                      scene.cl_aabb_max, scene.cl_trifeat.contiguous(),
                      scene.cl_slot2tri, config.sched_topk, any_hit)


closest_hit_scheduled.rounds = 0
closest_hit_scheduled.casts = 0
closest_hit_scheduled.max_rounds = 0
