"""PyTorch port, the sharded gradients: parallel/autodiff.py's
param_grad_sharded on gloo groups of CPU processes (spawn_ranks) against
the port's single-process param_grad for the material, camera and
geometry groups, and material_grad_sharded against the JAX package's on
the conftest's virtual CPU mesh.

Criteria: as tests/test_grad_sharding.py:108-168, loss to rtol 1e-4 and
every float leaf to rtol 5e-3 / atol 1e-4 (the ranks sum their rows'
gradients in another order). Against JAX, tests/test_torch_grad.py's
criterion (loss rtol 1e-5, each leaf 2e-4 of its largest entry, the
floor's three knife-edge entries 0.25).
"""

import numpy as np
import pytest
import torch

from opengl_ray_tracing_framework_tpu_torch import (
    Camera, Material, RenderConfig, build_test_scene)
from opengl_ray_tracing_framework_tpu_torch.models.material import (
    preset_materials)
from opengl_ray_tracing_framework_tpu_torch.parallel import autodiff
from opengl_ray_tracing_framework_tpu_torch.parallel import sharding

SIZE, BOUNCES = 16, 2
GROUPS = ("material", "camera", "geometry")
TIMEOUT_S = 120.0


def world():
    """Scene, camera, target and config of tests/test_torch_grad.py."""
    _, scene = build_test_scene(1, material=preset_materials()["tear_glass"],
                                device="cpu")
    cam = Camera.make(position=(0.0, 0.5, -2.0), yaw=90.0, pitch=-8.0,
                      zoom=30.0, aspect=1.0, device="cpu")
    target = torch.tensor(np.random.default_rng(5).uniform(
        0.0, 1.0, (SIZE, SIZE, 3)).astype(np.float32))
    return scene, cam, target, RenderConfig(width=SIZE, height=SIZE,
                                            max_bounce=BOUNCES)


def leaves(grads):
    """{leaf name: numpy or None} of a group's gradients."""
    if isinstance(grads, Camera):
        items = zip(Camera._fields, grads)
    elif isinstance(grads, torch.Tensor):
        items = [("vertices", grads)]
    else:
        items = zip(Material._fields, grads.mat)
    return {k: None if g is None else g.detach().cpu().numpy()
            for k, g in items}


def grad_worker(groups, rays):
    """One rank: param_grad_sharded of every group (material through
    material_grad_sharded) -> {group: (loss, leaves)}."""
    scene, cam, target, config = world()
    mesh = sharding.make_mesh()
    scene = sharding.replicate_scene(scene, mesh)
    out = {}
    for group in groups:
        if group == "material":
            loss, grads = autodiff.material_grad_sharded(
                scene, cam, target, config, mesh, rays_per_tile=rays)
        else:
            loss, grads = autodiff.param_grad_sharded(
                scene, cam, target, config, mesh, param=group,
                rays_per_tile=rays)
        out[group] = (float(loss), leaves(grads))
    bad = config.replace(height=SIZE + 1)
    with pytest.raises(ValueError, match="must divide the mesh size"):
        autodiff.param_grad_sharded(scene, cam, target, bad, mesh)
    return out


@pytest.fixture(scope="module")
def two_ranks():
    return sharding.spawn_ranks(grad_worker, 2, GROUPS, 64, device="cpu",
                                timeout_s=TIMEOUT_S)


def single_grads(group):
    scene, cam, target, config = world()
    loss, grads = autodiff.param_grad(scene, cam, target, config,
                                      param=group, rays_per_tile=256)
    return float(loss), leaves(grads)


def assert_close(got, want):
    loss, grads = got
    ref_loss, ref = want
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-4)
    assert grads.keys() == ref.keys()
    for name, g in grads.items():
        if ref[name] is None:
            assert g is None, name
            continue
        assert g.shape == ref[name].shape, name
        np.testing.assert_allclose(g, ref[name], rtol=5e-3, atol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("group", GROUPS)
def test_two_ranks_equal_single(two_ranks, group):
    """Every rank returns the same sums, equal to one process's."""
    want = single_grads(group)
    for rank in two_ranks:
        assert_close(rank[group], want)
    assert two_ranks[0][group][0] == two_ranks[1][group][0]


def test_four_ranks_material_equal_single():
    ranks = sharding.spawn_ranks(grad_worker, 4, ("material",), 32,
                                 device="cpu", timeout_s=TIMEOUT_S)
    want = single_grads("material")
    for rank in ranks:
        assert_close(rank["material"], want)


def test_rows_of_param_grad_sum_to_the_image():
    """param_grad over two row blocks adds up to the whole image's: the
    row0 / n_rows arguments the sharded gradients stand on."""
    scene, cam, target, config = world()
    loss, grads = autodiff.param_grad(scene, cam, target, config,
                                      rays_per_tile=256)
    parts = [autodiff.param_grad(scene, cam, target[r:r + 8], config,
                                 rays_per_tile=256, row0=r, n_rows=8)
             for r in (0, 8)]
    np.testing.assert_allclose(float(parts[0][0] + parts[1][0]),
                               float(loss), rtol=1e-5)
    for name, a, b, whole in zip(Material._fields, parts[0][1].mat,
                                 parts[1][1].mat, grads.mat):
        if whole is None:
            assert a is None and b is None
            continue
        np.testing.assert_allclose((a + b).numpy(), whole.numpy(),
                                   rtol=1e-5,
                                   atol=1e-5 * float(whole.abs().max()),
                                   err_msg=name)


def test_material_matches_jax_sharded(two_ranks):
    """The port's 2-rank material gradients against the JAX package's
    material_grad_sharded on a 2-device virtual CPU mesh."""
    import jax
    import jax.numpy as jnp
    from opengl_ray_tracing_framework_tpu.models.camera import (
        Camera as JCamera)
    from opengl_ray_tracing_framework_tpu.models.material import (
        preset_materials as jpresets)
    from opengl_ray_tracing_framework_tpu.models.scene import (
        build_test_scene as jbuild)
    from opengl_ray_tracing_framework_tpu.parallel import autodiff as jad
    from opengl_ray_tracing_framework_tpu.parallel import sharding as jshard
    from opengl_ray_tracing_framework_tpu.utils.config import (
        RenderConfig as JConfig)

    from test_torch_grad import assert_grads_agree

    # compaction_buckets=1: the JAX bounce runs unbucketed (exact either
    # way, tests/test_compaction.py), which halves its compile
    _, jscene = jbuild(1, material=jpresets()["tear_glass"])
    jcam = JCamera.make(position=(0.0, 0.5, -2.0), yaw=90.0, pitch=-8.0,
                        zoom=30.0, aspect=1.0)
    _, _, target, _ = world()
    mesh = jshard.make_mesh(jax.devices()[:2])
    loss, grads = jad.material_grad_sharded(
        jshard.replicate_scene(jscene, mesh), jcam, jnp.asarray(
            target.numpy()), JConfig(width=SIZE, height=SIZE,
                                     max_bounce=BOUNCES,
                                     compaction_buckets=1), mesh,
        rays_per_tile=64)
    ref = {k: None if v.dtype == jax.dtypes.float0 else np.asarray(v)
           for k, v in grads.mat._asdict().items()}
    port_loss, port = two_ranks[0]["material"]
    table = autodiff.MaterialTable(mat=Material(*(
        None if port[k] is None else torch.tensor(port[k])
        for k in Material._fields)))
    assert_grads_agree("material", port_loss, table, float(loss), ref)
