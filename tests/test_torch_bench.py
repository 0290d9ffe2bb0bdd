"""PyTorch port, the bench (opengl_ray_tracing_framework_tpu_torch/bench.py,
run as bench_torch.py): its JSON line on the CPU with each tracer, its
accumulator against the JAX package's render_pass on the same scene,
config and frames, the image criterion of its correctness check and the
exit code when that check fails, the baseline it may read, and its
refusal to run without a card or with JAX importable. (The check's two
renders, card against CPU, run only on the card: tests/test_torch_card.py.)

Image criterion: the hardware lane's (tests/test_tpu.py:57-60), the same
as tests/test_torch_render.py."""

import contextlib
import functools
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from opengl_ray_tracing_framework_tpu.models.camera import Camera as JCamera
from opengl_ray_tracing_framework_tpu.models.scene import (
    build_test_scene as jax_build_test_scene)
from opengl_ray_tracing_framework_tpu.render import (
    init_render_state as jax_init_render_state,
    render_pass as jax_render_pass)
from opengl_ray_tracing_framework_tpu.utils.config import (
    RenderConfig as JConfig)
from opengl_ray_tracing_framework_tpu_torch import bench, scene_from_numpy

from test_torch_host import jax_scene_arrays
from test_torch_render import assert_images_agree

ROOT = Path(__file__).resolve().parents[1]
W, H, BOUNCES, PASSES = 32, 16, 2, 1
ENV = {"BENCH_PASSES": str(PASSES)}
# bench.py:160-173
BENCH_FIELDS = ("metric", "value", "unit", "vs_baseline", "pass_seconds",
                "compile_seconds", "warm_compile_seconds", "bwd_rays_per_sec",
                "bwd_step_seconds", "bwd_compile_seconds", "device",
                "n_triangles")
PORT_FIELDS = ("tracer", "rays_per_tile", "power_limit",
               "k1_launches_per_pass", "k2_launches_per_pass", "plain_calls",
               "peak_gib_fwd", "peak_gib_bwd", "image_mean", "loss",
               "correct")


@pytest.fixture(scope="module")
def jax_scene():
    return jax_build_test_scene(1)[1]


@pytest.fixture(scope="module")
def port_scene(jax_scene):
    return scene_from_numpy(jax_scene_arrays(jax_scene), device="cpu")


def run_bench(scene, tracer="sweep", **env):
    """bench.run on the CPU at W x H -> (its stdout, its result, the
    accumulator after its timed passes)."""
    keep, out = [], io.StringIO()
    with contextlib.redirect_stdout(out):
        result = bench.run(W, H, BOUNCES, scene=scene, scene_name="test-1",
                           device="cpu", keep=keep,
                           env={**ENV, "BENCH_TRACER": tracer, **env})
    return out.getvalue(), result, keep[0]


@pytest.fixture(scope="module")
def runs(port_scene):
    return {tracer: run_bench(port_scene, tracer)
            for tracer in ("sweep", "schedule")}


@pytest.mark.parametrize("tracer", ["sweep", "schedule"])
def test_bench_line(runs, tracer):
    stdout, result, _ = runs[tracer]
    line = json.loads(stdout.strip().splitlines()[-1])
    assert line == result
    for field in BENCH_FIELDS + PORT_FIELDS:
        assert field in line, field
    rays = W * H * 1 * (1 + 2 * BOUNCES)
    assert line["value"] * line["pass_seconds"] == pytest.approx(rays,
                                                                 rel=1e-12)
    assert line["bwd_rays_per_sec"] * line["bwd_step_seconds"] == \
        pytest.approx(rays, rel=1e-12)
    assert line["unit"] == "rays/s" and line["vs_baseline"] == 1.0
    assert line["tracer"] == tracer and line["device"] == "cpu"
    assert line["n_triangles"] == 82 and "82 triangles" in line["metric"]
    assert tracer in line["metric"] and f"{W}x{H}" in line["metric"]
    # the CPU runs the plain versions: no kernel, no build, no card figure
    assert line["plain_calls"] > 0
    assert line["k1_launches_per_pass"] == 0
    assert line["k2_launches_per_pass"] == 0
    assert line["warm_compile_seconds"] is None
    assert line["power_limit"] is None and line["peak_gib_fwd"] is None
    assert np.isfinite(line["loss"]) and line["loss"] > 0
    assert line["correct"] is True


def test_bench_accumulator_matches_jax(runs, jax_scene):
    """The bench's passes (one warm-up and PASSES timed, frames 1..) equal
    the JAX package's render_pass, sweep kernel in interpret mode, on the
    same scene, config and frames; both tracers give the same image."""
    config = JConfig(width=W, height=H, max_bounce=BOUNCES, use_pallas=True,
                     pallas_backend="sweep", pallas_interpret=True,
                     compaction_buckets=1)
    camera = JCamera.make(aspect=W / H)
    state = jax_init_render_state(config)
    for _ in range(1 + PASSES):
        state = jax_render_pass(jax_scene, camera, state, config)
    ref = np.asarray(state.accum)
    for tracer in ("sweep", "schedule"):
        _, result, accum = runs[tracer]
        assert accum.shape == (H, W, 3) and accum.dtype == torch.float32
        assert_images_agree(accum.numpy(), ref)
        assert result["image_mean"] == pytest.approx(float(ref.mean()),
                                                     rel=1e-4)


def _shift(img, at, by=5e-3):
    """A copy of img moved by `by` at the flat indices `at` (5e-3: past
    atol + rtol * |value| = 2e-3 for values up to 1)."""
    out = img.copy()
    out.reshape(-1)[at] += by
    return out


@pytest.mark.parametrize("case,held", [
    ("same", True),
    ("below the share", True),      # 1 value in 1,536 off: under 1e-3
    ("every value", False),         # all off by 5e-3, mean off too
    ("past the share", False),      # 2 in 1,536 off, mean within 1e-4
    ("mean", False),                # every value 1e-4 off: mean rel > 1e-4
    ("not finite", False),
])
def test_images_agree(case, held):
    """bench.images_agree, the correctness check's criterion, holds on an
    image and on copies off by less than it allows, and fails on copies
    shifted past 1e-3 in too many values, off in the mean, or not finite."""
    ref = np.random.default_rng(0).uniform(0.2, 1.0, (H, W, 3)) \
        .astype(np.float32)
    img = {"same": ref.copy(),
           "below the share": _shift(ref, [7]),
           "every value": ref + np.float32(5e-3),
           "past the share": _shift(ref, [7, 900]),
           "mean": ref * np.float32(1 + 1.5e-4),
           "not finite": _shift(ref, [5], np.nan),
           }[case]
    assert bench.images_agree(img, ref)[0] is held


def test_failed_check_prints_the_line_then_exits_1(port_scene, monkeypatch,
                                                   capsys):
    """When the correctness check fails, main() still prints the whole
    line, with correct false, and returns 1."""
    monkeypatch.setattr(bench, "parity", lambda *a: False)
    monkeypatch.setattr(bench, "run", functools.partial(
        bench.run, W, H, BOUNCES, scene=port_scene, scene_name="test-1",
        env=ENV))
    assert bench.main(["--device", "cpu"]) == 1
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert tuple(line) == bench.FIELDS and line["correct"] is False


def test_vs_baseline_reads_only_nvidia_records(port_scene, tmp_path,
                                               monkeypatch):
    monkeypatch.chdir(tmp_path)
    record = {"n": 99, "rc": 0, "parsed": {
        "metric": "rays/sec/chip fwd", "value": 9165323.3,
        "device": "TPU v5 lite0"}}
    (tmp_path / "BENCH_r99.json").write_text(json.dumps(record))
    assert bench.nvidia_baseline() is None
    assert run_bench(port_scene)[1]["vs_baseline"] == 1.0

    record["parsed"]["device"] = "NVIDIA H100 80GB HBM3"
    record["parsed"]["value"] = 1000.0
    (tmp_path / "BENCH_r99.json").write_text(json.dumps(record))
    # an older TPU record with a value never displaces it
    (tmp_path / "BENCH_r05.json").write_text(json.dumps(
        {"parsed": {"value": 1.0, "device": "TPU v5 lite0"}}))
    assert bench.nvidia_baseline() == 1000.0
    result = run_bench(port_scene)[1]
    assert result["vs_baseline"] == pytest.approx(result["value"] / 1000.0)


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="a card is present: the default device works")
def test_no_card_raises_and_prints_nothing(capsys):
    with pytest.raises((AssertionError, RuntimeError)):
        bench.main([])
    out, _ = capsys.readouterr()
    assert out == ""


def test_bench_runs_with_jax_blocked():
    """bench_torch.py loads and runs with jax and the JAX package made
    unimportable (a None entry in sys.modules): it needs neither."""
    code = f"""
import runpy, sys
sys.modules["jax"] = None
sys.modules["opengl_ray_tracing_framework_tpu"] = None
sys.argv = ["bench_torch.py", "--device", "cpu"]
from opengl_ray_tracing_framework_tpu_torch import bench, build_test_scene
bench.run({W}, {H}, {BOUNCES}, scene=build_test_scene(1, device="cpu")[1],
          scene_name="test-1", device="cpu", env={ENV!r})
runpy.run_path("bench_torch.py", run_name="not_main")
assert not any(m == "jax" or m.startswith(("jax.", "jaxlib"))
               for m in sys.modules if sys.modules[m] is not None)
"""
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["plain_calls"] > 0
