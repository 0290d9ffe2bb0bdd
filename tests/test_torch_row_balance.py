"""PyTorch port, the row-balance probe
(opengl_ray_tracing_framework_tpu_torch/probes/row_balance.py, the `tpu`
mode of exp/scaling_probe.py): its efficiency formula against a numpy
transcription of exp/scaling_probe.py:125-127, its row blocks stacked
against one whole-frame _trace_rows (bit for bit on the CPU, both
tracers), one block against the JAX package's parallel/sharding.py::
_trace_rows (the image criterion of tests/test_torch_render.py), its JSON
line, and its refusal to run without a card or with JAX importable. (The
blocks on the card: tests/test_torch_card.py.)"""

import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opengl_ray_tracing_framework_tpu.models.camera import Camera as JCamera
from opengl_ray_tracing_framework_tpu.models.scene import (
    build_test_scene as jax_build_test_scene)
from opengl_ray_tracing_framework_tpu.parallel.sharding import (
    _trace_rows as jax_trace_rows)
from opengl_ray_tracing_framework_tpu.utils.config import (
    RenderConfig as JConfig)
from opengl_ray_tracing_framework_tpu_torch import (
    Camera, RenderConfig, build_test_scene)
from opengl_ray_tracing_framework_tpu_torch.probes import row_balance
from opengl_ray_tracing_framework_tpu_torch.render import _trace_rows

from test_torch_render import assert_images_agree

ROOT = Path(__file__).resolve().parents[1]
BOUNCES = 2
# main at a tiny frame: 8 blocks of 2 rows, the 82-triangle scene
SMALL = ["--device", "cpu", "--width", "32", "--height", "16", "--bounces",
         "1", "--subdiv", "1", "--repeats", "2"]


def jax_efficiency(times, ndev):
    """exp/scaling_probe.py:125-127, transcribed."""
    times = np.asarray(times)
    blocks = times.size
    groups = times.reshape(ndev, blocks // ndev).sum(axis=1)
    return float(groups.mean() / groups.max())


@pytest.fixture(scope="module")
def scene():
    return build_test_scene(device="cpu")[1]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_efficiency_matches_the_jax_formula(seed):
    times = np.random.default_rng(seed).uniform(0.05, 0.5, 8)
    got = row_balance.efficiency(times)
    assert list(got) == ["2", "4", "8"]
    for n in (2, 4, 8):
        assert got[str(n)] == jax_efficiency(times, n)


def test_efficiency_hand_cases():
    assert row_balance.efficiency([0.3] * 8) == {"2": 1.0, "4": 1.0,
                                                 "8": 1.0}
    # one block twice as slow: groups (5, 4), (3, 2, 2, 2), (2, 1, ... 1)
    assert row_balance.efficiency([2.0] + [1.0] * 7) == {
        "2": 4.5 / 5, "4": 2.25 / 3, "8": 9 / 8 / 2}
    assert row_balance.efficiency([1.0] * 6, ndevs=(2, 3)) == {"2": 1.0,
                                                              "3": 1.0}
    with pytest.raises(ValueError):
        row_balance.efficiency([1.0] * 6, ndevs=(4,))


@pytest.mark.parametrize("tracer", ["sweep", "schedule"])
@pytest.mark.parametrize("size,blocks", [(64, 2), (32, 4)])
def test_blocks_stack_to_the_whole_frame(scene, tracer, size, blocks):
    """Blocks of 32 rows trace in 32x32 pixel-block order, blocks of 8 in
    row order; either way the stacked blocks are the whole frame's
    _trace_rows bit for bit, since the RNG is keyed by global pixel ids."""
    config = RenderConfig(width=size, height=size, max_bounce=BOUNCES,
                          cast_backend=tracer)
    camera = Camera.make(aspect=1.0, device="cpu")
    res = row_balance.block_seconds(scene, camera, config, blocks=blocks,
                                    repeats=1, keep=True)
    with torch.no_grad():
        whole = _trace_rows(scene, camera, 1, config, 0, size, 131072)
    assert torch.equal(res["radiance"], whole)
    # the CPU runs the plain versions: no launch, plain calls in each block
    assert res["kernel_ms"] is None
    assert all(n > 0 for n in res["plain_calls"])
    assert res["launches"] == {"sweep": [0] * blocks,
                               "cluster_intersect": [0] * blocks}
    assert len(res["block_seconds"]) == len(res["block_spread"]) == blocks
    assert all(s > 0 for s in res["block_seconds"])


def test_block_matches_jax_trace_rows(scene):
    """Rows 16-31 of a 32x32 frame against the JAX package's per-device
    unit, its sweep kernel in interpret mode, on the same scene."""
    jconfig = JConfig(width=32, height=32, max_bounce=BOUNCES,
                      use_pallas=True, pallas_backend="sweep",
                      pallas_interpret=True, compaction_buckets=1)
    ref = np.asarray(jax_trace_rows(
        jax_build_test_scene()[1], JCamera.make(aspect=1.0), jnp.uint32(1),
        jconfig, jnp.int32(16), 16, 131072))
    config = RenderConfig(width=32, height=32, max_bounce=BOUNCES)
    res = row_balance.block_seconds(scene, Camera.make(aspect=1.0,
                                                       device="cpu"),
                                    config, blocks=2, repeats=1, keep=True)
    got = res["radiance"][16:].numpy()
    assert got.shape == ref.shape == (16, 32, 3)
    assert_images_agree(got, ref)


def test_blocks_must_divide_the_height(scene):
    config = RenderConfig(width=32, height=24, max_bounce=1)
    camera = Camera.make(aspect=32 / 24, device="cpu")
    with pytest.raises(ValueError):
        row_balance.block_seconds(scene, camera, config, blocks=5)
    with pytest.raises(ValueError):
        row_balance.block_seconds(scene, camera,
                                  config.replace(cast_backend="bvh"))


def test_main_line_on_the_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        line = row_balance.main(SMALL)
    lines = out.getvalue().strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == line
    assert tuple(line) == row_balance.FIELDS
    assert line["mode"] == "card" and line["device"] == "cpu"
    assert line["power_limit"] is None
    assert line["scene"] == "stand-in, subdiv 1" and line["triangles"] == 82
    assert (line["frame"], line["tracer"], line["blocks"],
            line["rays_per_tile"], line["repeats"]) == (1, "sweep", 8,
                                                        131072, 2)
    assert len(line["block_seconds"]) == 8
    assert line["efficiency"] == row_balance.efficiency(
        line["block_seconds"])
    assert all(0 < e <= 1 for e in line["efficiency"].values())
    assert all(s >= 0 for s in line["block_spread"])
    assert all(n > 0 for n in line["plain_calls"])
    assert line["launches"]["sweep"] == [0] * 8
    assert line["kernel_ms"] is None and line["kernel_efficiency"] is None


def test_no_card_raises_and_prints_nothing(capsys):
    with pytest.raises((AssertionError, RuntimeError)):
        row_balance.main([])
    out, _ = capsys.readouterr()
    assert out == ""


def test_probe_runs_with_jax_blocked():
    """The module runs as a user runs it (python -m) with jax and the JAX
    package made unimportable (a None entry in sys.modules)."""
    code = f"""
import runpy, sys
sys.modules["jax"] = None
sys.modules["opengl_ray_tracing_framework_tpu"] = None
sys.argv = ["row_balance"] + {SMALL!r} + ["--tracer", "schedule"]
runpy.run_module("opengl_ray_tracing_framework_tpu_torch.probes.row_balance",
                 run_name="__main__")
assert not any(m == "jax" or m.startswith(("jax.", "jaxlib"))
               for m in sys.modules if sys.modules[m] is not None)
"""
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["tracer"] == "schedule" and all(
        n > 0 for n in line["plain_calls"])
