"""Requests of render.py::render_pass: progressive passes on a resumed
render. Traffic mixes whose `entry` is "render_pass" set:
  start_index_max  the seed draws the sample index the render resumes at
                   below this, and the image accumulated so far
  check_pixels     pixels of the frame whose samples are checked
  check_passes     passes of the window checked (all, or a sample drawn
                   from the seed)
  trace_requests   passes in the traced window

A request is one pass; its fence copies the checked pixels of the
accumulator to the host, as a viewer that shows each pass waits for it.

The comparison: each checked pass's contribution, recovered from the
accumulator's checked pixels before and after it (the running mean gives
n_k acc_k - n_(k-1) acc_(k-1) = the pass's samples), against the
reference's samples of the same pixels and frames.
  values_off  share of the checked values (pixel x pass x channel) off by
              more than 1e-3 + 1e-3 |ref| plus the float32 rounding the
              recovery itself can carry (4 n eps32 |acc|)
  mean_gap    |sum(program - ref)| / sum(|ref|) over the checked values
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from benchmark import arith, program
from benchmark.reference import lowp, render

KIND = "fwd"   # its runs report the metrics that move fwd_rays_per_s
EPS32 = 2.0 ** -23
CHUNK = 65536   # reference rays a batch


@dataclasses.dataclass
class Draws:
    start_index: int      # samples already in the accumulator
    accum: torch.Tensor   # (H, W, 3) the resumed image
    pixels: torch.Tensor  # (P,) int64 pixel ids checked


def draw(traffic: dict, config: dict, seed: int, device) -> Draws:
    w, h = config["frame"]["width"], config["frame"]["height"]
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    n_check = min(int(traffic["check_pixels"]), w * h)
    return Draws(
        start_index=int(rng.integers(0, traffic["start_index_max"])),
        accum=torch.rand((h, w, 3), generator=gen, device=device),
        pixels=torch.as_tensor(np.sort(rng.choice(w * h, n_check,
                                                  replace=False)),
                               device=device))


class Requests:
    def __init__(self, setup, draws: Draws):
        self.render = program.port("render")
        self.scene, self.camera = setup.scene, setup.camera
        self.rconf, self.tile = setup.rconf, setup.cell.config["rays_per_tile"]
        self.pixels = draws.pixels
        rc = self.rconf
        self.rays_per_request = arith.rays_per_pass(
            rc.width, rc.height, rc.spp_per_pass, rc.max_bounce)
        self.state = self.render.RenderState(accum=draws.accum,
                                             n_samples=draws.start_index)
        self.snaps = [self._fence(self.state)]

    def _fence(self, state):
        return state.accum.reshape(-1, 3)[self.pixels].cpu()

    def _pass(self, state):
        return self.render.render_pass(self.scene, self.camera, state,
                                       self.rconf, self.tile)

    def warm_up(self):
        """One pass of the same shapes on a state of its own."""
        self._fence(self._pass(self.render.RenderState(
            accum=torch.zeros_like(self.state.accum),
            n_samples=self.state.n_samples)))

    def request(self):
        self.state = self._pass(self.state)
        self.snaps.append(self._fence(self.state))

    def outputs(self) -> dict:
        return {"snaps": torch.stack(self.snaps)}


def _frames(start_index, pass_k, spp):
    """The 1-based frames of window pass k (1-based)."""
    first = start_index + (pass_k - 1) * spp + 1
    return list(range(first, first + spp))


def reference_passes(setup, draws: Draws, passes, low=False):
    """(len(passes), P, 3) float64: the sum of each pass's samples of the
    checked pixels, by the reference (in bfloat16 with low=True)."""
    frame = setup.cell.config["frame"]
    spp, device = frame["spp_per_pass"], setup.device
    scene = render.build_scene(setup.raw, device)
    pixels = draws.pixels.to(device)
    jobs = [(k, f) for k in passes for f in _frames(draws.start_index, k,
                                                    spp)]
    pid = pixels.repeat(len(jobs))
    frm = torch.tensor([f for _, f in jobs], device=device) \
        .repeat_interleave(pixels.numel())
    out = []
    with torch.no_grad(), (lowp.bfloat16() if low
                           else contextlib.nullcontext()):
        for lo in range(0, pid.numel(), CHUNK):
            out.append(render.trace(scene, setup.cam, frame["width"],
                                    frame["height"], frame["max_bounce"],
                                    pid[lo:lo + CHUNK], frm[lo:lo + CHUNK])
                       .double().cpu())
    s = torch.cat(out).reshape(len(passes), spp, pixels.numel(), 3)
    return s.sum(dim=1)


def accumulate(acc0, start_index, pass_sums, spp):
    """The program's float32 running mean fed with given per-pass sums
    spread evenly over the pass's samples: the snapshots a program that
    drew those samples would show."""
    acc = acc0.to(torch.float32)
    n = start_index
    snaps = [acc.clone()]
    for s in pass_sums:
        for _ in range(spp):
            n += 1
            acc = acc + ((s / spp).to(torch.float32) - acc) / float(n)
        snaps.append(acc.clone())
    return torch.stack(snaps)


def compare_passes(snaps, start_index, spp, passes, ref):
    """values_off and mean_gap of the checked passes."""
    acc = snaps.double()
    got, allow = [], []
    for k in passes:
        n1 = start_index + k * spp
        n0 = n1 - spp
        got.append(n1 * acc[k] - n0 * acc[k - 1])
        allow.append(4 * n1 * EPS32 * (acc[k].abs() + acc[k - 1].abs()))
    got, allow = torch.stack(got), torch.stack(allow)
    tol = 1e-3 + 1e-3 * ref.abs() + allow
    diff = (got - ref).abs()
    bad = ~(diff <= tol)   # a NaN is off
    return {"values_off": float(bad.double().mean()),
            "mean_gap": float((got - ref).sum().abs()
                              / ref.abs().sum().clamp(min=1e-30))}


def checked_passes(n_passes: int, how_many: int, seed: int) -> list:
    """The window's passes (1-based) whose pixels are checked: all, or a
    sample drawn from the seed."""
    if n_passes <= how_many:
        return list(range(1, n_passes + 1))
    rng = np.random.default_rng([seed, 1])
    return sorted(int(k) + 1 for k in rng.choice(n_passes, how_many,
                                                 replace=False))


def numbers(setup, draws: Draws, outputs: dict, seed: int) -> dict:
    """The compared numbers of one run's outputs."""
    snaps = outputs["snaps"]
    passes = checked_passes(snaps.shape[0] - 1,
                            setup.cell.traffic["check_passes"], seed)
    ref = reference_passes(setup, draws, passes)
    return compare_passes(snaps, draws.start_index,
                          setup.cell.config["frame"]["spp_per_pass"], passes,
                          ref)


def control(setup, draws: Draws, outputs: dict) -> dict:
    """The outputs of the reference computed in bfloat16 and put in the
    program's place: the same window's passes from the same resumed
    image."""
    snaps = outputs["snaps"]
    sums = reference_passes(setup, draws, range(1, snaps.shape[0]), low=True)
    return {"snaps": accumulate(snaps[0], draws.start_index, sums,
                                setup.cell.config["frame"]["spp_per_pass"])}
