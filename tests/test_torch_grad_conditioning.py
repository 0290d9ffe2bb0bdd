"""PyTorch port: how well-conditioned the camera and geometry gradients
are in the camera itself, on the 81,922-triangle scene the card's smoke
test renders (128x64, 2 spp).

At 8 bounces deep paths meet the tessellated sphere at grazing angles,
where the straight-through hit distance divides by a cosine near zero, and
a few such pixels carry a large share of the gradient: moving the camera by
1e-6 moves a camera leaf by more than half of its value and the vertex
gradients by several percent of their largest entry, on one device and in
one float order. Two float orders (the card's kernel and the CPU's plain
version) therefore cannot agree there, and the smoke test holds camera and
geometry gradients card against CPU at 2 bounces, where the same shift
moves them by a few 1e-4 (measured on the CPU: camera 1.55 and 3.0e-4,
geometry 0.15 and 2.1e-4). Material gradients do not see the camera's
derivative and are held at 8 bounces.
"""

import pytest
import torch

from opengl_ray_tracing_framework_tpu_torch import (
    Camera, Material, MaterialTable, RenderConfig, build_test_scene,
    render_radiance)
from opengl_ray_tracing_framework_tpu_torch.models.hdr import (
    make_gradient_hdr)
from opengl_ray_tracing_framework_tpu_torch.models.material import (
    preset_materials)
from opengl_ray_tracing_framework_tpu_torch.parallel import autodiff as tad

SHIFT = 1e-6


@pytest.fixture(scope="module")
def world():
    presets = preset_materials()
    _, scene = build_test_scene(6, material=presets["tear_glass"],
                                env=make_gradient_hdr(256, 128), device="cpu")
    assert scene.n_triangles == 81922
    mat = Material(*(torch.stack([field[0], p]) for field, p in
                     zip(scene.materials.mat, presets["brown_glass"])))
    return scene, scene.with_materials(MaterialTable(mat=mat))


def moved_by(scene, target_scene, param, bounces):
    """Worst leaf of max |g(camera + SHIFT) - g(camera)| over max |g|."""
    cfg = RenderConfig(width=128, height=64, max_bounce=bounces)
    cam = Camera.make(aspect=2.0, device="cpu")
    target = render_radiance(target_scene, cam, cfg, spp=2)
    grads = []
    for shift in (0.0, SHIFT):
        c = cam._replace(position=cam.position
                         + torch.tensor([shift, 0.0, 0.0]))
        _, g = tad.param_grad(scene, c, target, cfg, param=param, spp=2)
        grads.append(list(g) if isinstance(g, Camera) else [g])
    return max(float((b - a).abs().max() / a.abs().max())
               for a, b in zip(*grads))


@pytest.mark.parametrize("param, deep_moves_over, shallow_moves_under",
                         [("camera", 0.5, 2e-3), ("geometry", 0.05, 2e-3)])
def test_grad_conditioning_by_depth(world, param, deep_moves_over,
                                    shallow_moves_under):
    scene, target_scene = world
    assert moved_by(scene, target_scene, param, 2) < shallow_moves_under
    assert moved_by(scene, target_scene, param, 8) > deep_moves_over
