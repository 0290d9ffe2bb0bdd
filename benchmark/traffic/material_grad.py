"""Requests of parallel/autodiff.py::material_grad: whole-frame gradient
steps of the material table against a target image the seed draws.
Traffic mixes whose `entry` is "material_grad" set:
  trace_requests   steps in the traced window

A request is one step; its fence copies the loss and every gradient leaf
to the host, as an optimiser that applies the step waits for it.

The comparison: every step's loss and material gradient against the
reference's, rendered from the same raw inputs and target.
  loss_gap    the largest |loss - ref| / |ref| over the steps
  grad_gap    the largest, over steps and leaves (the material table's
              float fields), of |g - ref| / max(|ref|, the median leaf's
              |ref|), Euclidean norms, over the leaves whose entries are
              all finite
  grad_nonfinite  the count of gradient entries that are NaN or infinite
              (an exact comparison: its limit is 0)
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from benchmark import arith, program
from benchmark.reference import lowp, render

KIND = "grad"   # its runs report the metrics that move grad_rays_per_s


@dataclasses.dataclass
class Draws:
    target: torch.Tensor   # (H, W, 3) the step's target image


def draw(traffic: dict, config: dict, seed: int, device) -> Draws:
    w, h = config["frame"]["width"], config["frame"]["height"]
    gen = torch.Generator(device=device).manual_seed(seed)
    return Draws(target=torch.rand((h, w, 3), generator=gen, device=device))


class Requests:
    def __init__(self, setup, draws: Draws):
        self.grad = program.port("parallel.autodiff").material_grad
        self.scene, self.camera = setup.scene, setup.camera
        self.rconf, self.tile = setup.rconf, setup.cell.config["rays_per_tile"]
        self.target = draws.target
        rc = self.rconf
        self.rays_per_request = arith.rays_per_pass(
            rc.width, rc.height, rc.spp_per_pass, rc.max_bounce)
        self.steps = []

    def _step(self):
        loss, grads = self.grad(self.scene, self.camera, self.target,
                                self.rconf, spp=self.rconf.spp_per_pass,
                                rays_per_tile=self.tile)
        return (float(loss),
                {f: (None if g is None else g.cpu())
                 for f, g in zip(grads.mat._fields, grads.mat)})

    def warm_up(self):
        self._step()

    def request(self):
        self.steps.append(self._step())

    def outputs(self) -> dict:
        return {"steps": self.steps}


def reference_grad(setup, draws: Draws, low=False):
    """(loss, {field: gradient}) of sum((render - target)^2) over the whole
    frame with respect to the material table, batch by batch (in bfloat16
    with low=True)."""
    config, device = setup.cell.config, setup.device
    frame = config["frame"]
    w, h = frame["width"], frame["height"]
    table = render.material_table(setup.raw.materials, device)
    leaves = [x.clone().requires_grad_(x.is_floating_point())
              for x in table]
    scene = render.build_scene(setup.raw, device,
                               materials=render.Material(*leaves))
    want = draws.target.to(device).reshape(-1, 3)
    loss = 0.0
    wrt = [x for x in leaves if x.requires_grad]
    with lowp.bfloat16() if low else contextlib.nullcontext():
        for pid in torch.arange(w * h, device=device).split(
                config["rays_per_tile"]):
            frames = torch.ones_like(pid)
            rad = render.trace(scene, setup.cam, w, h, frame["max_bounce"],
                               pid, frames)
            batch = torch.sum((rad - want[pid]) ** 2)
            batch.backward(inputs=wrt)
            loss += float(batch.detach())
    grads = {f: (x.grad.detach().cpu() if x.grad is not None
                 else torch.zeros_like(x).cpu()) if x.requires_grad else None
             for f, x in zip(render.FIELDS, leaves)}
    return loss, grads


def compare_grad(steps, ref):
    loss_r, grads_r = ref
    norms = {f: float(g.double().norm()) for f, g in grads_r.items()
             if g is not None}
    median = float(np.median(list(norms.values())))
    loss_gap = grad_gap = 0.0
    nonfinite = 0
    for loss, grads in steps:
        gap = abs(loss - loss_r) / max(abs(loss_r), 1e-30)
        loss_gap = max(loss_gap, gap if np.isfinite(gap) else np.inf)
        for f, n in norms.items():
            g = grads[f].double()
            bad = int((~torch.isfinite(g)).sum())
            nonfinite += bad
            if not bad:
                grad_gap = max(grad_gap, float((g - grads_r[f].double())
                                               .norm()) / max(n, median,
                                                              1e-30))
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "grad_nonfinite": nonfinite}


def numbers(setup, draws: Draws, outputs: dict, seed: int) -> dict:
    """The compared numbers of one run's outputs."""
    return compare_grad(outputs["steps"], reference_grad(setup, draws))


def control(setup, draws: Draws, outputs: dict) -> dict:
    """The outputs of the reference computed in bfloat16 and put in the
    program's place: one step."""
    return {"steps": [reference_grad(setup, draws, low=True)]}
