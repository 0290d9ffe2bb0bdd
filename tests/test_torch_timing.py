"""PyTorch port, the --timing breakdown: utils/timing.py's pass_breakdown
gives each span's host time a pass (total and self) from real render_pass
calls under tracing(), with the JAX module's `_meta`; the spans cover the
pass's wall time, and format_breakdown prints one row a span (the pass's
device ms beside its wall ms when it ran on a CUDA device, which the CPU
never fills)."""

import pytest

from opengl_ray_tracing_framework_tpu_torch import (
    Camera, RenderConfig, build_test_scene)
from opengl_ray_tracing_framework_tpu_torch import cli
from opengl_ray_tracing_framework_tpu_torch.utils.timing import (
    format_breakdown, pass_breakdown)

SIZE, BOUNCES = 32, 2
CONFIG = RenderConfig(width=SIZE, height=SIZE, max_bounce=BOUNCES)


@pytest.fixture(scope="module")
def port_times():
    _, scene = build_test_scene(device="cpu")
    cam = Camera.make(position=(0.0, 0.5, -2.0), yaw=90.0, pitch=-8.0,
                      zoom=30.0, aspect=1.0, device="cpu")
    return pass_breakdown(scene, cam, CONFIG, rays_per_tile=SIZE * SIZE,
                          repeats=2)


def _spans(times):
    return {k: v for k, v in times.items()
            if not k.startswith("_") and k != "full_pass"}


def test_spans_cover_the_pass_wall_time(port_times):
    """rt.pass's host time is the pass's wall time to within 10%, and the
    self times of every span add up to it: each span lies inside rt.pass
    and each instant of it is one span's own."""
    spans = _spans(port_times)
    assert "_device" not in port_times   # the CPU has no device column
    whole = spans["rt.pass"]
    assert whole["calls"] == 1
    assert whole["total"] == pytest.approx(port_times["full_pass"], rel=0.1)
    assert sum(v["self"] for v in spans.values()) == pytest.approx(
        whole["total"], rel=1e-9)
    for name, v in spans.items():
        assert 0 <= v["self"] <= v["total"], name


def test_breakdown_counts_a_pass(port_times):
    """One batch of 1,024 rays a pass: per pass one rt.batch, one primary
    cast and one merged cast a bounce run, and as many casts counted."""
    spans, counts = _spans(port_times), port_times["_counters"]
    assert port_times["_meta"] == {"rays_per_tile": 1024, "n_tiles": 1,
                                   "bounces": 2, "pixels": 1024,
                                   "rays_per_pass": 5120}
    assert spans["rt.batch"]["calls"] == 1
    bounces = spans["rt.bounce"]["calls"]
    assert 1 <= bounces <= BOUNCES
    assert spans["rt.cast"]["calls"] == bounces + 1
    assert spans["rt.sync"]["calls"] == bounces + 1
    assert counts["casts"] == bounces + 1
    assert counts["cast_lanes"] >= 1024 + 2 * 128
    assert 0 < counts["cast_live_rays"] < counts["cast_lanes"]


def test_several_batches_and_a_ragged_tile():
    """rays_per_tile below the pixel count: n_tiles batches, and a batch
    that is no multiple of the kernel's 128-ray tile."""
    _, scene = build_test_scene(device="cpu")
    cam = Camera.make(aspect=2.0, device="cpu")
    times = pass_breakdown(scene, cam, RenderConfig(width=24, height=12,
                                                    max_bounce=1),
                           rays_per_tile=100, repeats=1)
    assert times["_meta"] == {"rays_per_tile": 100, "n_tiles": 2,
                              "bounces": 1, "pixels": 288,
                              "rays_per_pass": 864}
    spans = _spans(times)
    assert spans["rt.batch"]["calls"] == 3   # 100 + 100 + 88 pixels
    assert all(v["total"] > 0 for v in spans.values())
    assert times["full_pass"] > 0


def test_format_breakdown_prints_one_row_a_span(port_times):
    lines = format_breakdown(port_times).splitlines()
    assert lines[0].split() == ["span", "calls", "host", "ms", "self", "ms"]
    spans = list(_spans(port_times))
    assert [ln.split()[0] for ln in lines[1:len(spans) + 1]] == spans
    assert lines[1].split()[0] == "rt.pass"
    assert lines[len(spans) + 1].startswith("pass wall ms")
    assert lines[-2].startswith("pass rays/s")
    assert lines[-1].startswith("a pass: casts ")
    assert len(lines) == len(spans) + 4


def test_format_breakdown_columns(port_times):
    lines = format_breakdown(port_times).splitlines()
    row = lines[1].split()
    whole = port_times["rt.pass"]
    assert row[1:] == [f"{whole['calls']:.1f}", f"{whole['total'] * 1e3:.2f}",
                       f"{whole['self'] * 1e3:.2f}"]
    assert "device ms" not in lines[-3]
    with_device = dict(port_times, _device={"full_pass": 2e-3})
    assert format_breakdown(with_device).splitlines()[-3].endswith(
        "device ms 2.00")


def test_cli_timing_prints_the_table_first(capsys):
    cli.main(["--device", "cpu", "--width", "16", "--height", "16",
              "--max-bounce", "1", "--spp", "1", "--timing",
              "--progress-every", "1", "--out", "/dev/null"])
    err = capsys.readouterr().err
    assert "span               calls    host ms    self ms\n" in err
    assert err.index("rt.pass") < err.index("pass wall ms") \
        < err.index("pass 1/1 (1 spp")
