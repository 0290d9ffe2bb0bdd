"""PyTorch port, kernels on the card against their plain versions on the
same inputs: the cluster kernels at every width of cluster block, K1
(csrc/sweep.cu) and K2 (csrc/cluster_intersect.cu) against sweep_plain and
cluster_intersect_plain for blocks of T = 256 (one bulk copy of the whole
block), 512, 1,024 and 4,096 (chunks of a CTA's columns by tensor-map
copies) and 302 (no multiple of 4: hand-copied chunks), and the refusal of
a block wider than the kernels' 4,096; the chained lookups (K4c-2,
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
    card_perf, gather, launch_overhead, row_balance)
from opengl_ray_tracing_framework_tpu_torch.render import _trace_rows
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
