"""Requests of render.py::render_pass on scenes of millions of triangles:
traffic/render_pass.py's draws, requests, comparison and control, with
the reference's closest hit taken by reference/cast_blocks.py (rays in
chunks sized to a memory budget), whose answers are Caster's. Traffic
mixes whose `entry` is "render_pass_dense" set render_pass's parameters.

Loading this module first checks that the port's BVH build does its
Python work a level of the tree at a time, not a call a node: a build of a
call a node takes about 270 s over 5.2M triangles, which puts a run past
its time limit, so such a port is refused at once, before its set-up.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys

import numpy as np
import torch

from benchmark import program
from benchmark.reference import cast_blocks, lowp, render
from benchmark.traffic import render_pass as base

PROBE_TRIANGLES = 1024   # the soup the build is checked on, a leaf each

KIND = base.KIND
draw = base.draw
Requests = base.Requests


def build_calls(bvh) -> int:
    """Python calls into the module bvh (its file) while its build_bvh
    builds a tree over a fixed soup of PROBE_TRIANGLES triangles."""
    c = np.random.default_rng(0).random((PROBE_TRIANGLES, 3),
                                        dtype=np.float32)
    calls = 0

    def count(frame, event, arg):
        nonlocal calls
        if event == "call" and frame.f_code.co_filename == bvh.__file__:
            calls += 1

    sys.setprofile(count)
    try:
        bvh.build_bvh(c, c + np.float32(0.01),
                      c + np.float32([0.0, 0.01, 0.02]), leaf_size=1,
                      method="sah")
    finally:
        sys.setprofile(None)
    return calls


def require_level_build(bvh) -> None:
    """SystemExit unless bvh's build makes fewer Python calls than a
    quarter of its triangles (a level-at-a-time build makes tens)."""
    calls = build_calls(bvh)
    if 4 * calls >= PROBE_TRIANGLES:
        raise SystemExit(
            f"render_pass_dense: the port's BVH build made {calls} Python "
            f"calls over {PROBE_TRIANGLES} triangles, about one a node; at "
            "millions of triangles its set-up alone outlasts a run")


require_level_build(program.port("models.bvh"))


def reference_passes(setup, draws, passes, low=False):
    """render_pass.reference_passes, the reference scene's caster a
    BlockCaster of the same boxes."""
    frame = setup.cell.config["frame"]
    spp, device = frame["spp_per_pass"], setup.device
    scene = render.build_scene(setup.raw, device)
    scene = dataclasses.replace(
        scene, caster=cast_blocks.BlockCaster.of(scene.caster))
    pixels = draws.pixels.to(device)
    jobs = [(k, f) for k in passes for f in base._frames(draws.start_index,
                                                         k, spp)]
    pid = pixels.repeat(len(jobs))
    frm = torch.tensor([f for _, f in jobs], device=device) \
        .repeat_interleave(pixels.numel())
    out = []
    with torch.no_grad(), (lowp.bfloat16() if low
                           else contextlib.nullcontext()):
        for lo in range(0, pid.numel(), base.CHUNK):
            out.append(render.trace(scene, setup.cam, frame["width"],
                                    frame["height"], frame["max_bounce"],
                                    pid[lo:lo + base.CHUNK],
                                    frm[lo:lo + base.CHUNK])
                       .double().cpu())
    s = torch.cat(out).reshape(len(passes), spp, pixels.numel(), 3)
    return s.sum(dim=1)


def numbers(setup, draws, outputs: dict, seed: int) -> dict:
    """render_pass.numbers against this reference."""
    snaps = outputs["snaps"]
    passes = base.checked_passes(snaps.shape[0] - 1,
                                 setup.cell.traffic["check_passes"], seed)
    ref = reference_passes(setup, draws, passes)
    return base.compare_passes(snaps, draws.start_index,
                               setup.cell.config["frame"]["spp_per_pass"],
                               passes, ref)


def control(setup, draws, outputs: dict) -> dict:
    """render_pass.control with this reference in bfloat16."""
    snaps = outputs["snaps"]
    sums = reference_passes(setup, draws, range(1, snaps.shape[0]), low=True)
    return {"snaps": base.accumulate(snaps[0], draws.start_index, sums,
                                     setup.cell.config["frame"]
                                     ["spp_per_pass"])}
