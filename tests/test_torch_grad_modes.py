"""PyTorch port, the gradient path in use: an Adam fit of a material
colour (tests/test_inverse.py:33-68 with torch.optim.Adam), the BRDF-mode
gradients against the JAX package's, and the 256x256, 8-bounce shapes at
which the specular lobe's backward once produced NaN
(tests/test_grad_finite.py:23-41; slow in the JAX package, seconds here).

The BRDF-mode comparison uses test_torch_grad's joint JAX gradient and its
tolerances (loss rtol 1e-5, leaves 2e-4 of their largest entry; measured
2e-4 at worst, on clearcoat, whose GTR1 sampler is the ill-conditioned one
of tests/test_torch_brdf.py, so it is held to 1e-3).
"""

import numpy as np
import pytest
import torch

from opengl_ray_tracing_framework_tpu_torch import (
    Camera, Material, MaterialTable, RenderConfig, build_test_scene)
from opengl_ray_tracing_framework_tpu_torch.models.material import (
    preset_materials)
from opengl_ray_tracing_framework_tpu_torch.parallel import autodiff as tad

import test_torch_grad as tg

CAM = dict(position=(0.0, 0.5, -2.0), yaw=90.0, pitch=-8.0, zoom=30.0,
           aspect=1.0, device="cpu")


def test_fit_base_color_recovers_target():
    """Gradient descent recovers a perturbed base_color: loss below 5% of
    the start within 80 Adam steps, colour within 0.05."""
    true_color = torch.tensor([0.75, 0.25, 0.2])
    mat = Material.make(base_color=tuple(true_color.tolist()), roughness=0.6)
    _, scene = build_test_scene(material=mat, device="cpu")
    cam = Camera.make(**CAM)
    cfg = RenderConfig(width=16, height=16, max_bounce=2)
    with torch.no_grad():
        target = tad.render_rows_radiance(scene, cam, cfg, 0, 16, 2, 256)

    # start from a wrong colour on the sphere's material slot (slot 1)
    bc = scene.materials.mat.base_color.clone()
    bc[1] = torch.tensor([0.4, 0.55, 0.6])
    bc.requires_grad_(True)
    opt = torch.optim.Adam([bc], lr=2e-2)
    losses = []
    for _ in range(80):
        opt.zero_grad()
        table = MaterialTable(mat=scene.materials.mat._replace(base_color=bc))
        loss = tad.material_loss(table, scene, cam, target, cfg, 0, 16, 2,
                                 256)
        loss.backward()
        opt.step()
        with torch.no_grad():
            bc.clamp_(0.0, 1.0)
        losses.append(float(loss.detach()))
    assert losses[-1] < 0.05 * losses[0], losses[::16]
    np.testing.assert_allclose(bc[1].detach().numpy(), true_color.numpy(),
                               atol=0.05)


@pytest.fixture(scope="module")
def brdf_world():
    return tg.make_world()


@pytest.mark.parametrize("group", tg.GROUPS)
def test_brdf_mode_grad_matches_jax(brdf_world, brdf_ref, group):
    world = brdf_world
    loss, grads = tad.param_grad(
        world["scene"], world["camera"], torch.tensor(world["target"]),
        world["config"].replace(enable_bsdf=False), param=group, spp=tg.SPP,
        rays_per_tile=tg.RAYS)
    ref_loss, ref = brdf_ref
    for g in tg.grad_leaves(group, grads).values():
        assert g is None or torch.isfinite(g).all()
    tg.assert_grads_agree(group, loss, grads, ref_loss, ref[group],
                          looser={"clearcoat": 1e-3})


@pytest.fixture(scope="module")
def brdf_ref(brdf_world):
    return tg.jax_grads(brdf_world["jdata"], brdf_world["jcam"],
                        brdf_world["target"], enable_bsdf=False)


@pytest.mark.parametrize("mat_name", ["brown_glass", "white"])
def test_material_grad_finite_256(mat_name):
    _, scene = build_test_scene(2, material=preset_materials()[mat_name],
                                device="cpu")
    cam = Camera.make(**CAM)
    cfg = RenderConfig(width=256, height=256, max_bounce=8)
    loss, grads = tad.material_grad(scene, cam, torch.zeros((256, 256, 3)),
                                    cfg, rays_per_tile=16384)
    assert np.isfinite(float(loss))
    leaves = [g for g in grads.mat if g is not None]
    assert len(leaves) == len(Material._fields) - 1
    for g in leaves:
        assert torch.isfinite(g).all()
    # the gradient is not degenerate: something nonzero flows to materials
    assert any(float(g.abs().max()) > 0 for g in leaves)
