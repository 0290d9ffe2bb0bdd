"""PyTorch port, the span recorder and counters of utils/timing.py on the
CPU: under tracing() the spans of a render nest as the layers do (rt.pass
> rt.batch > rt.bounce > rt.shade.* and rt.cast > rt.cast.prep / .k1 /
.finish, each bounce between two rt.sync spans), a gradient step adds
rt.loss and rt.backward a batch; with tracing off a profile holds no rt.*
range and the image is bit-equal to the traced one; the counters equal
what the plain versions count on the same casts (spans walked, keys that
are not dead, the padded lanes)."""

import pytest
import torch

from opengl_ray_tracing_framework_tpu_torch import (
    Camera, RenderConfig, build_test_scene)
from opengl_ray_tracing_framework_tpu_torch.ops import sweep as tsweep
from opengl_ray_tracing_framework_tpu_torch.parallel.autodiff import (
    material_grad)
from opengl_ray_tracing_framework_tpu_torch.render import (
    init_render_state, render_pass)
from opengl_ray_tracing_framework_tpu_torch.utils import timing

SIZE, BOUNCES, TILE = 32, 3, 400   # 1,024 pixels in batches of 400, 400, 224
CONFIG = RenderConfig(width=SIZE, height=SIZE, max_bounce=BOUNCES)


@pytest.fixture(scope="module")
def scene_camera():
    _, scene = build_test_scene(device="cpu")
    cam = Camera.make(position=(0.0, 0.5, -2.0), yaw=90.0, pitch=-8.0,
                      zoom=30.0, aspect=1.0, device="cpu")
    return scene, cam


def _pass(scene, cam, config=CONFIG):
    return render_pass(scene, cam, init_render_state(config, "cpu"), config,
                       TILE).accum


def _profiled(fn):
    """fn() under a CPU-only profiler: (its result, [(name, start, end)] of
    the rt.* ranges in start order)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.name.startswith("rt."))
    return out, [(n, s, t) for s, t, n in spans]


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _parent(span, spans):
    """The innermost other span that encloses `span`."""
    around = [o for o in spans if o is not span and _inside(span, o)]
    return min(around, key=lambda o: o[2] - o[1])[0] if around else None


@pytest.fixture(scope="module")
def traced(scene_camera):
    """A render pass under tracing() and a CPU profiler: (image, spans,
    recording)."""
    scene, cam = scene_camera
    with timing.tracing("cpu") as rec:
        image, spans = _profiled(lambda: _pass(scene, cam))
    return image, spans, rec


def test_spans_nest_as_the_layers(traced):
    _, spans, rec = traced
    parents = {
        "rt.pass": {None}, "rt.batch": {"rt.pass"},
        "rt.accumulate": {"rt.pass"}, "rt.sync": {"rt.batch"},
        "rt.bounce": {"rt.batch"}, "rt.cast": {"rt.batch", "rt.bounce"},
        "rt.cast.prep": {"rt.cast"}, "rt.cast.k1": {"rt.cast"},
        "rt.cast.finish": {"rt.cast"}, "rt.shade.surface": {"rt.bounce"},
        "rt.shade.light": {"rt.bounce"}, "rt.shade.bsdf": {"rt.bounce"},
        "rt.shade.env": {"rt.bounce"}}
    names = [s[0] for s in spans]
    assert set(names) == set(parents)
    for s in spans:
        assert _parent(s, spans) in parents[s[0]], s
    batches = [s for s in spans if s[0] == "rt.batch"]
    assert len(batches) == 3 and names.count("rt.pass") == 1
    for batch in batches:
        inner = [s[0] for s in spans if s[0] in ("rt.sync", "rt.bounce")
                 and _inside(s, batch)]
        # the compaction's nonzero before the loop and after each bounce
        assert inner == ["rt.sync", "rt.bounce"] * (len(inner) // 2) \
            + ["rt.sync"]
        casts = [s for s in spans if s[0] == "rt.cast" and _inside(s, batch)]
        # the primary cast, then one merged pair a bounce
        assert len(casts) == len(inner) // 2 + 1
        assert _parent(casts[0], spans) == "rt.batch"
    for cast in (s for s in spans if s[0] == "rt.cast"):
        assert [s[0] for s in spans if _inside(s, cast) and s is not cast] \
            == ["rt.cast.prep", "rt.cast.k1", "rt.cast.finish"]
    counts = rec.counters
    assert counts["bounces"] == names.count("rt.bounce") > 3
    assert counts["syncs"] == names.count("rt.sync") \
        == counts["bounces"] + len(batches)
    assert counts["casts"] == names.count("rt.cast") \
        == counts["bounces"] + len(batches)
    assert 0 < counts["bounce_lanes"] <= counts["bounces"] * TILE
    for name, (calls, total, own) in rec.spans.items():
        assert calls == names.count(name) and 0 <= own <= total, name


def test_tracing_off_leaves_no_range_and_the_same_image(traced,
                                                        scene_camera):
    scene, cam = scene_camera
    assert timing.span("rt.pass") is timing.span("rt.cast")   # shared no-op
    assert timing.device_counter("k1_spans_walked",
                                 torch.device("cpu")) is None
    image, spans = _profiled(lambda: _pass(scene, cam))
    assert spans == []
    assert torch.equal(image, traced[0])


def test_tracing_is_not_reentrant():
    with timing.tracing("cpu"):
        with pytest.raises(RuntimeError, match="already on"):
            with timing.tracing("cpu"):
                pass
    with timing.tracing("cpu") as rec:
        timing.count("syncs", 2)
    assert rec.counters["syncs"] == 2 and timing.counters() == rec.counters


def _recorded(monkeypatch, name, note):
    """Replace ops/sweep.py's `name` by a wrapper that calls note(args,
    result) after the real one (which then finds its counting attributes,
    `calls`, `visited`, on the wrapper)."""
    real = getattr(tsweep, name)

    def wrapped(*args):
        out = real(*args)
        note(args, out)
        return out
    wrapped.__dict__.update(vars(real))
    monkeypatch.setattr(tsweep, name, wrapped)


def test_counters_equal_the_plain_counts(scene_camera, monkeypatch):
    """k1_spans_walked is the sum of sweep_plain.visited over the casts,
    cast_live_rays the count of keys that are not dead, cast_lanes each
    cast's R padded to whole tiles."""
    scene, cam = scene_camera
    seen = {"walked": 0, "live": 0, "lanes": 0, "casts": 0}
    lo, hi = scene.cl_aabb_min, scene.cl_aabb_max

    def walked(args, out):
        seen["walked"] += int(tsweep.sweep_plain.visited.sum())

    def live(args, out):
        key = tsweep.sweep_key_plain(args[0], args[1], args[2], lo, hi)
        seen["live"] += int((key != tsweep._DEAD_KEY).sum())

    def lanes(args, out):
        seen["lanes"] += -(-args[1].shape[0] // tsweep.TILE_R) * tsweep.TILE_R
        seen["casts"] += 1

    _recorded(monkeypatch, "sweep_plain", walked)
    _recorded(monkeypatch, "sweep_spans_plain", live)
    _recorded(monkeypatch, "_swept", lanes)
    with timing.tracing("cpu") as rec:
        _pass(scene, cam)
    got = rec.counters
    assert got["k1_spans_walked"] == seen["walked"] > 0
    assert got["cast_live_rays"] == seen["live"] > 0
    assert got["cast_lanes"] == seen["lanes"]
    assert got["casts"] == seen["casts"]
    assert got["cast_live_rays"] < got["cast_lanes"]


def test_gradient_step_spans(scene_camera):
    """material_grad: per batch one rt.batch, then rt.loss and rt.backward,
    the backward outside the forward's spans."""
    scene, cam = scene_camera
    config = RenderConfig(width=16, height=16, max_bounce=1)
    target = torch.zeros((16, 16, 3))
    with timing.tracing("cpu"):
        _, spans = _profiled(lambda: material_grad(
            scene, cam, target, config, rays_per_tile=160))
    top = [s[0] for s in spans if _parent(s, spans) is None]
    assert top == ["rt.batch", "rt.loss", "rt.backward"] * 2
