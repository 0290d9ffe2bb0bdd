"""PyTorch port, the --timing breakdown: utils/timing.py's pass_breakdown
has the JAX module's stages and `_meta`, each a finite positive time, and
format_breakdown prints them (wall ms; device ms beside it when the stages
ran on a CUDA device, which the CPU never fills)."""

import math

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
                          repeats=1)


def test_stages_and_meta_match_jax(port_times):
    """The same stage keys and the same _meta as the JAX module's
    pass_breakdown on the same config (its tnear stage takes tiles of
    1024 rays, hence 32x32)."""
    from opengl_ray_tracing_framework_tpu import RenderConfig as JConfig
    from opengl_ray_tracing_framework_tpu.models.camera import (
        Camera as JCamera)
    from opengl_ray_tracing_framework_tpu.models.scene import (
        build_test_scene as jbuild)
    from opengl_ray_tracing_framework_tpu.utils.timing import (
        pass_breakdown as jbreakdown)
    _, jscene = jbuild()
    jcam = JCamera.make(position=(0.0, 0.5, -2.0), yaw=90.0, pitch=-8.0,
                        zoom=30.0, aspect=1.0)
    ref = jbreakdown(jscene, jcam, JConfig(width=SIZE, height=SIZE,
                                           max_bounce=BOUNCES),
                     rays_per_tile=SIZE * SIZE, repeats=1)
    assert "_device" not in port_times   # the CPU has no device column
    assert list(port_times) == list(ref)
    assert port_times["_meta"] == ref["_meta"]
    for k, v in port_times.items():
        if not k.startswith("_"):
            assert math.isfinite(v) and v > 0, k


def test_estimated_pass_composes_the_stages(port_times):
    t, meta = port_times, port_times["_meta"]
    b = meta["bounces"]
    want = meta["n_tiles"] * (
        t["raygen"] + t["primary_cast"]
        + b * (t["shadow_cast"] + t["bounce_cast"] + 2 * t["shade"]
               + t["env"])) + t["accumulate"]
    assert t["estimated_pass"] == pytest.approx(want, rel=1e-12)


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
    assert all(v > 0 for k, v in times.items() if not k.startswith("_"))


def test_format_breakdown_columns(port_times):
    text = format_breakdown(port_times)
    lines = text.splitlines()
    assert lines[0].split() == ["stage", "wall", "ms"]
    stages = [k for k in port_times if not k.startswith("_")]
    assert [ln.split()[0] for ln in lines[1:len(stages) + 1]] == stages
    assert lines[-1].startswith("pass rays/s")
    with_device = dict(port_times, _device={k: 2e-3 for k in stages})
    lines = format_breakdown(with_device).splitlines()
    assert lines[0].split() == ["stage", "wall", "ms", "device", "ms"]
    assert all(ln.split()[-1] == "2.00" for ln in lines[1:len(stages) + 1])


def test_cli_timing_prints_the_table_first(capsys):
    cli.main(["--device", "cpu", "--width", "16", "--height", "16",
              "--max-bounce", "1", "--spp", "1", "--timing",
              "--progress-every", "1", "--out", "/dev/null"])
    err = capsys.readouterr().err
    assert "stage              wall ms\n" in err
    assert err.index("full_pass") < err.index("pass 1/1 (1 spp")
