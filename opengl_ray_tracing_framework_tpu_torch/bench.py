"""Headline benchmark of the port: rays/s of the reference frame, forward
and forward + backward (PyTorch port of the repository's bench.py).

    python3 bench_torch.py [--device cuda|cpu]

Renders the frame BASELINE.md names (1024x512, 8 bounces, HDR environment
with MIS, glass object, Camera.make(aspect=2)) on the card and prints ONE
JSON line, last on stdout, with bench.py's fields (unrounded) and ray
accounting: each pixel sample launches 1 primary ray plus, per bounce, 1
NEE shadow ray and 1 bounce ray, so rays = W * H * spp * (1 + 2 * bounces)
per pass. `value` is that count over the seconds of one progressive pass;
`bwd_rays_per_sec` the same count over one material_grad step (forward
and backward per ray batch, traversal detached). Every pass and step is
fenced by a host copy of a value it computed.

Environment knobs (as bench.py has them, plus the scene and tracer):

  BENCH_SCENE     stand-in (default): build_test_scene(6) with tear_glass
                  and a 1024x512 gradient HDR, 81,922 triangles, the
                  loong-100k scale; loong: the floor + loong_100000 OBJ
                  files under ORTF_ASSETS (FileNotFoundError without them;
                  the repository does not hold them, so no test runs it)
  BENCH_TRACER    sweep (default; the span-sweep kernel, csrc/sweep.cu) or
                  schedule (the cluster-intersect kernel,
                  csrc/cluster_intersect.cu)
  BENCH_SPP       samples per pixel per pass (1)
  BENCH_TILE      rays per batch of a forward pass (131072)
  BENCH_BWD_TILE  rays per batch of a grad step (131072)
  BENCH_PASSES    timed passes (3); the grad step is timed
                  max(1, BENCH_PASSES - 1) times
  BENCH_TIMING=1  also print utils/timing.py's breakdown (host ms a pass by
                  span) to stderr

`compile_seconds` is the first pass of the process: it pays the nvcc build
of whatever build/torch_kernels/ lacks, the library loads and the first
launches. `warm_compile_seconds` is a cold nvcc build of the tracer's
kernel source into a temporary directory (never the cache): what a changed
kernel costs. On the CPU, where the kernels' plain versions run, nothing
is built and `warm_compile_seconds` is null.

Beside bench.py's fields the line carries the tracer, rays_per_tile, the
card's power_limit (nvidia-smi; null on the CPU), k1_ / k2_launches_per_pass
over the timed passes, plain_calls (of the kernels' plain versions over
the timed passes and steps: 0 on the card), peak_gib_fwd / peak_gib_bwd
(torch.cuda.max_memory_allocated over the timed passes / steps; null on
the CPU), image_mean (the accumulator after the timed passes), loss (the
last grad step's) and correct: image_mean and loss let two trees be
checked to compute the same thing.

The run then renders 128x64, 2 spp, 8 bounces of the same scene on the
card and on the CPU (the plain versions) and holds the two to the image
criterion (`images_agree`); `correct` goes into the line, and a failure
exits non-zero after printing it. On the CPU the bench runs the plain
versions themselves, so there is nothing to hold them against: the render
is skipped and `correct` is true. `vs_baseline` compares `value`
with the newest BENCH_r*.json of the working directory whose device is an
NVIDIA card, and reads 1.0 when there is none.

With no card and no --device cpu the bench fails with torch's own error
before printing anything: it never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from .models.camera import Camera
from .models.hdr import make_gradient_hdr
from .models.material import preset_materials
from .models.scene import build_reference_scene, build_test_scene
from .ops import cluster_intersect as ci
from .ops import sweep as sw
from .parallel.autodiff import material_grad
from .probes import device_line
from .render import init_render_state, render_pass, render_radiance
from .utils import nvcc
from .utils.config import RenderConfig, resolve_device

WIDTH, HEIGHT, BOUNCES = 1024, 512, 8
PARITY = dict(width=128, height=64, spp=2, bounces=8)
SCENES = ("stand-in", "loong")
TRACERS = {"sweep": "sweep", "schedule": "cluster_intersect"}  # -> source
# the line's fields: bench.py:160-173's twelve, then the port's
FIELDS = ("metric", "value", "unit", "vs_baseline", "pass_seconds",
          "compile_seconds", "warm_compile_seconds", "bwd_rays_per_sec",
          "bwd_step_seconds", "bwd_compile_seconds", "device", "n_triangles",
          "tracer", "rays_per_tile", "power_limit", "k1_launches_per_pass",
          "k2_launches_per_pass", "plain_calls", "peak_gib_fwd",
          "peak_gib_bwd", "image_mean", "loss", "correct")


def images_agree(img, ref) -> tuple[bool, float, float]:
    """The image criterion (tests/test_tpu.py:57-60) on two (H, W, 3)
    arrays: finite, means within 1e-4 relative, fewer than 1e-3 of the
    values off at atol/rtol 1e-3. Returns (held, relative mean gap, share
    of values off)."""
    g, c = np.asarray(img, np.float64), np.asarray(ref, np.float64)
    rel_mean = abs(g.mean() - c.mean()) / max(c.mean(), 1e-6)
    off = float((~np.isclose(g, c, atol=1e-3, rtol=1e-3)).mean())
    held = bool(np.isfinite(g).all() and rel_mean < 1e-4 and off < 1e-3)
    return held, float(rel_mean), off


def build_scene(name: str, device, subdiv: int = 6):
    """The bench's scene by BENCH_SCENE name, on `device`; `subdiv` sets
    the stand-in's icosphere subdivisions (6: 81,922 triangles)."""
    if name == "stand-in":
        return build_test_scene(
            subdiv, material=preset_materials()["tear_glass"],
            env=make_gradient_hdr(1024, 512), device=device)[1]
    if name == "loong":
        return build_reference_scene(objects=("floor", "loong"),
                                     device=device)[1]
    raise ValueError(f"BENCH_SCENE must be one of {SCENES}, got {name!r}")


def nvidia_baseline(pattern: str = "BENCH_r*.json") -> float | None:
    """`value` of the newest BENCH_r<n>.json (the bench's line, or a record
    that wraps it under "parsed") whose device names an NVIDIA card and
    that holds a value. TPU records are never read: no TPU figure is the port's
    baseline."""
    recs = []
    for path in glob.glob(pattern):
        m = re.search(r"BENCH_r(\d+)\.json$", path)
        if not m:
            continue
        try:
            with open(path) as fh:
                recs.append((int(m.group(1)), json.load(fh)))
        except (OSError, ValueError):
            continue
    for _, rec in sorted(recs, key=lambda r: r[0], reverse=True):
        if isinstance(rec, dict) and isinstance(rec.get("parsed"), dict):
            rec = rec["parsed"]
        if (isinstance(rec, dict) and rec.get("value")
                and "nvidia" in str(rec.get("device", "")).lower()):
            return float(rec["value"])
    return None


def parity(scene, config, device) -> bool:
    """Render PARITY's frame of `scene` with `config`'s tracer on `device`
    and on the CPU, print both times and the gaps to stderr, and return
    whether the two hold to `images_agree`. On the CPU the bench already
    runs the plain versions, which are the reference: nothing is rendered
    and the check holds."""
    if device.type == "cpu":
        print("bench: correctness: the plain versions are the reference on "
              "the CPU, nothing to compare", file=sys.stderr)
        return True
    small = config.replace(width=PARITY["width"], height=PARITY["height"],
                           max_bounce=PARITY["bounces"], spp_per_pass=1)
    camera = Camera.make(aspect=small.width / small.height, device=device)
    t0 = time.perf_counter()
    img = render_radiance(scene, camera, small, spp=PARITY["spp"]).cpu()
    dev_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = render_radiance(scene.to("cpu"), camera.to("cpu"), small,
                          spp=PARITY["spp"])
    cpu_s = time.perf_counter() - t0
    held, rel_mean, off = images_agree(img.numpy(), ref.numpy())
    print(f"bench: correctness {small.width}x{small.height}, "
          f"{PARITY['spp']} spp, {small.max_bounce} bounces, "
          f"{small.cast_backend} tracer | {device.type} {dev_s:.2f} s, cpu "
          f"{cpu_s:.2f} s | mean rel {rel_mean:.2e}, values off at 1e-3 "
          f"{off:.2e} | {'held' if held else 'FAILED'}", file=sys.stderr)
    return held


def power_limit(device) -> str | None:
    """The card's power limit as nvidia-smi reports it; None on the CPU."""
    if device.type != "cuda":
        return None
    return device_line().rsplit(",", 1)[1].strip()


def counts() -> tuple[int, int, int]:
    """(K1 launches, K2 launches, calls of the plain versions of K1, K2 and
    K1's preparation kernels) so far."""
    return (sw.sweep.launches, ci.cluster_intersect.launches,
            sw.sweep_plain.calls + ci.cluster_intersect_plain.calls
            + sw.sweep_key_plain.calls + sw.sweep_spans_plain.calls)


def _peak_reset(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)


def _peak_gib(device):
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2**30


def run(width: int = WIDTH, height: int = HEIGHT, bounces: int = BOUNCES,
        scene=None, scene_name: str | None = None, device=None,
        env=None, keep: list | None = None) -> dict:
    """Run the bench, print its JSON line and return it as a dict.

    scene: a SceneData to render (default: the BENCH_SCENE build, on
    `device`); scene_name names it in `metric`. env: the knobs (default
    os.environ). keep, a list, receives the accumulator after the timed
    passes."""
    env = os.environ if env is None else env
    device = resolve_device(device)
    torch.zeros((), device=device)    # no card: torch's error, nothing else
    spp = int(env.get("BENCH_SPP", "1"))
    rays_per_tile = int(env.get("BENCH_TILE", "131072"))
    bwd_tile = int(env.get("BENCH_BWD_TILE", "131072"))
    n_timed = int(env.get("BENCH_PASSES", "3"))
    tracer = env.get("BENCH_TRACER", "sweep")
    if tracer not in TRACERS:
        raise ValueError(f"BENCH_TRACER must be one of {sorted(TRACERS)}, "
                         f"got {tracer!r}")
    if scene is None:
        scene_name = scene_name or env.get("BENCH_SCENE", "stand-in")
        scene = build_scene(scene_name, device)
    scene_name = scene_name or "custom"
    scene = scene.to(device)
    camera = Camera.make(aspect=width / height, device=device)
    config = RenderConfig(width=width, height=height, max_bounce=bounces,
                          spp_per_pass=spp, cast_backend=tracer).validate()

    def fence_pass(state):
        float(state.accum[0, 0, 0])   # host copy: the pass has finished

    # forward: the first pass pays builds and loads, then the timed passes
    state = init_render_state(config, device)
    t0 = time.perf_counter()
    state = render_pass(scene, camera, state, config, rays_per_tile)
    fence_pass(state)
    compile_s = time.perf_counter() - t0
    warm_compile_s = None
    if device.type == "cuda":
        with tempfile.TemporaryDirectory() as tmp:
            warm_compile_s = nvcc.compile_source(
                TRACERS[tracer], Path(tmp) / f"{TRACERS[tracer]}.so")[0]

    _peak_reset(device)
    before = counts()
    t0 = time.perf_counter()
    for _ in range(n_timed):
        state = render_pass(scene, camera, state, config, rays_per_tile)
        fence_pass(state)
    elapsed = (time.perf_counter() - t0) / n_timed
    after = counts()
    peak_fwd = _peak_gib(device)
    k1_per_pass = (after[0] - before[0]) / n_timed
    k2_per_pass = (after[1] - before[1]) / n_timed
    plain_calls = after[2] - before[2]
    image_mean = state.accum.mean().item()
    if keep is not None:
        keep.append(state.accum)

    rays = width * height * spp * (1 + 2 * bounces)

    # forward + backward: material_grad against a zero target
    target = torch.zeros((height, width, 3), dtype=torch.float32,
                         device=device)

    def grad_step():
        loss, grads = material_grad(scene, camera, target, config, spp=spp,
                                    rays_per_tile=bwd_tile)
        # the fence: the loss and every gradient leaf (medium_type has none)
        [g.cpu() for g in grads.mat if g is not None]
        return float(loss)

    t0 = time.perf_counter()
    grad_step()
    bwd_compile_s = time.perf_counter() - t0
    n_bwd = max(1, n_timed - 1)
    _peak_reset(device)
    before = counts()
    t0 = time.perf_counter()
    for _ in range(n_bwd):
        loss = grad_step()
    bwd_elapsed = (time.perf_counter() - t0) / n_bwd
    plain_calls += counts()[2] - before[2]
    peak_bwd = _peak_gib(device)

    if env.get("BENCH_TIMING") == "1":
        from .utils.timing import format_breakdown, pass_breakdown
        print(format_breakdown(pass_breakdown(
            scene, camera, config, rays_per_tile=rays_per_tile)),
            file=sys.stderr)

    correct = parity(scene, config, device)

    rays_per_sec = rays / elapsed
    baseline = nvidia_baseline()
    out = {
        "metric": f"rays/sec/chip fwd ({scene_name}, {scene.n_triangles} "
                  f"triangles, {width}x{height}, {bounces} bounces, "
                  f"{tracer} tracer)",
        "value": rays_per_sec,
        "unit": "rays/s",
        "vs_baseline": rays_per_sec / baseline if baseline else 1.0,
        "pass_seconds": elapsed,
        "compile_seconds": compile_s,
        "warm_compile_seconds": warm_compile_s,
        "bwd_rays_per_sec": rays / bwd_elapsed,
        "bwd_step_seconds": bwd_elapsed,
        "bwd_compile_seconds": bwd_compile_s,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else str(device)),
        "n_triangles": scene.n_triangles,
        "tracer": tracer,
        "rays_per_tile": rays_per_tile,
        "power_limit": power_limit(device),
        "k1_launches_per_pass": k1_per_pass,
        "k2_launches_per_pass": k2_per_pass,
        "plain_calls": plain_calls,
        "peak_gib_fwd": peak_fwd,
        "peak_gib_bwd": peak_bwd,
        "image_mean": image_mean,
        "loss": loss,
        "correct": correct,
    }
    assert tuple(out) == FIELDS
    print(json.dumps(out), flush=True)
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda",
                   help="torch device to bench on (cuda, cpu); the knobs "
                        "are environment variables, see the module's doc")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return 0 if run(device=args.device)["correct"] else 1
