"""PyTorch port, scenes past 8,192 clusters on the CPU: the benchmark's
reference for such scenes (benchmark/reference/cast_blocks.py) gives its
plain Caster's closest hits; a render of 14,000-odd clusters holds
against the plain reference within glass5m.fwd's limits; the scene build's
spans and the casts' pair counter exist only inside tracing()."""

import time

import numpy as np
import pytest
import torch

from benchmark import cell as cells, run
from benchmark.reference.cast import Caster
from benchmark.reference.cast_blocks import BlockCaster
from opengl_ray_tracing_framework_tpu_torch import (
    Camera, RenderConfig, build_test_scene)
from opengl_ray_tracing_framework_tpu_torch.ops import sweep as tsweep
from opengl_ray_tracing_framework_tpu_torch.render import (
    init_render_state, render_pass)
from opengl_ray_tracing_framework_tpu_torch.utils import timing


def _rays(n, seed):
    gen = torch.Generator().manual_seed(seed)
    origin = torch.rand((n, 3), generator=gen) * 6 - 3 + torch.tensor(
        [0.0, 0.0, 3.0])
    direction = torch.nn.functional.normalize(
        torch.randn((n, 3), generator=gen), dim=1)
    return origin, direction


@pytest.mark.parametrize("any_hit", [False, True])
def test_block_caster_gives_the_casters_hits(any_hit):
    _, scene = build_test_scene(3, device="cpu")
    p = (scene.p1, scene.p2, scene.p3)
    origin, direction = _rays(3000, 11)
    mask = torch.rand(3000, generator=torch.Generator().manual_seed(5)) < 0.9
    want = Caster(*p).closest_hit(origin, direction, mask, any_hit=any_hit)
    caster = Caster(*p)
    blocks = BlockCaster.of(caster, budget=48 * 11 * 7)   # 7 rays a chunk
    assert blocks.ray_chunk == 7 and caster.box_lo.shape[0] == 11
    got = blocks.closest_hit(origin, direction, mask, any_hit=any_hit)
    assert BlockCaster.of(caster).ray_chunk > 3000
    hits = (want[1] >= 0).sum()
    assert hits > 500
    if any_hit:   # only whether a ray hits is meaningful
        assert torch.equal(got[1] >= 0, want[1] >= 0)
    else:
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def _past_smem(cell):
    """glass5m.fwd on the CPU: the sphere of 6 subdivisions in blocks of
    8 triangles (more than 8,192 clusters), a 32x16 frame."""
    c = cell.config
    c["frame"].update(width=32, height=16, max_bounce=2)
    c["environment"].update(width=64, height=32)
    for o in c["objects"]:
        if o["mesh"] == "icosphere":
            o["subdiv"] = 6
    c["scene_build"]["cluster_size"] = 8
    c["rays_per_tile"] = 512
    cell.traffic.update(check_pixels=128, check_passes=2, trace_requests=1)


def test_render_past_smem_clusters_holds(monkeypatch):
    """Every cast of the render has C > 8,192, and the passes hold
    against the plain reference within the cell's own limits."""
    scene_mod = run.program.port("models.scene")
    seen = {}
    real = scene_mod.Scene.build

    def build(self, *args, **kwargs):
        with timing.tracing("cpu") as rec:
            out = real(self, *args, **kwargs)
        seen["clusters"] = out.cl_aabb_min.shape[0]
        seen["spans"] = rec.spans
        return out
    monkeypatch.setattr(scene_mod.Scene, "build", build)
    cell = cells.load("glass5m.fwd")
    _past_smem(cell)
    # run.main's own steps (run.main refuses a process that holds jax,
    # which these tests import for their other comparisons)
    out = run.execute(cell, 3000000021, 0.1, False, torch.device("cpu"),
                      time.perf_counter())
    line = run.result_line(cell, out, False, torch.device("cpu"))
    assert line["correct"] is True, line["check"]
    assert seen["clusters"] > 8192
    assert {"rt.build", "rt.build.bvh", "rt.build.clusters",
            "rt.build.env", "rt.build.upload"} <= set(seen["spans"])
    limits = cells.load("glass5m.fwd").workload["limits"]
    assert {k: v["limit"] for k, v in line["check"].items()} == limits


def test_build_spans_and_cast_counters_only_when_tracing():
    scene_obj, scene = build_test_scene(2, device="cpu")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        scene_obj.build(device="cpu")
    assert not [e for e in prof.events() if e.name.startswith("rt.")]
    with timing.tracing("cpu") as rec:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            scene_obj.build(device="cpu")
    names = sorted((e.time_range.start, e.name) for e in prof.events()
                   if e.name.startswith("rt.build"))
    assert [n for _, n in names] == ["rt.build", "rt.build.bvh",
                                     "rt.build.clusters", "rt.build.env",
                                     "rt.build.upload"]
    assert all(rec.spans[n][0] == 1 for _, n in names)

    config = RenderConfig(width=24, height=16, max_bounce=2)
    cam = Camera.make(position=(0.0, 0.5, -2.0), yaw=90.0, pitch=-8.0,
                      zoom=30.0, aspect=1.5, device="cpu")
    state = init_render_state(config, "cpu")
    render_pass(scene, cam, state, config, 256)
    assert timing.counters() == rec.counters   # nothing counted outside
    with timing.tracing("cpu") as rec:
        render_pass(scene, cam, state, config, 256)
    c = scene.cl_aabb_min.shape[0]
    assert rec.counters["casts"] > 0
    assert rec.counters["cast_pairs"] == rec.counters["cast_lanes"] * c
    assert rec.counters["cast_slots"] == rec.counters["casts"] * c * 256


def test_cast_pairs_counts_padded_rays_times_clusters():
    """Each cast adds its rays, padded to whole 128-ray tiles, times the
    scene's clusters to cast_pairs, and the scene's slots (clusters x
    block width) to cast_slots."""
    _, scene = build_test_scene(2, device="cpu")
    c = scene.cl_aabb_min.shape[0]
    origin, direction = _rays(300, 2)
    with timing.tracing("cpu") as rec:
        tsweep.closest_hit_swept(scene, origin, direction)
        tsweep.closest_hit_swept(scene, origin[:100], direction[:100])
    assert rec.counters["cast_pairs"] == (384 + 128) * c
    assert rec.counters["cast_slots"] == 2 * c * 256
    assert np.isfinite(c)
