"""PyTorch port, the gradient path: parallel.autodiff's material, camera
and geometry gradients against the JAX package's on the same scene, camera,
target and counter-RNG streams (span-sweep tracer, Pallas kernel in
interpret mode on the JAX side, its plain version on the port's).

The JAX gradients of all three parameter groups come from ONE
value_and_grad over the JAX package's own pieces (its _PARAM_GROUPS put
functions, render_rows_radiance, block_order_rows and _grad_config), which
is what its material_grad / camera_grad / geometry_grad each compute; one
compile instead of three keeps this file under a minute.

Tolerances: the loss to rtol 1e-5; every float gradient leaf to 2e-4 of
that leaf's largest |g| (measured at this size: 3e-5 at worst; at 32x32, 3
bounces 1.8e-4). Same estimator, hits and random numbers, so only float
ordering differs. Three entries are held looser, to 0.25 of the leaf's
largest |g|: metallic, anisotropic and ior of material slot 0, the floor's
`white` preset. It has ior 1 and metallic 0, so its specular Fresnel F0 is
exactly 0 and the lobe gate `w_refl > 0` of disney_eval opens or shuts on
the rounding noise of dielectric_fresnel: the forward value is the same
either way (the lobe contributes 0) but d/d metallic is not, in both
packages. A leaf whose entries are all below 1e-9 of the group's largest
|g| (anisotropic here: ~1e-15 against ~1e2, a sum of products with exact
zeros) is float noise about 0 and is held to that floor. Integer leaves (medium_type) are None where JAX returns float0.

Derivative tie rules: torch.clamp(x, min=e) passes the whole gradient at
x == e where jnp.maximum halves it; torch.minimum, torch.maximum and
torch.abs agree with jnp. The clamp sites on the gradient path compare
computed floats with small epsilons (1e-30 .. 1e-3) or run on detached
random numbers; none of them ties at these inputs, which the 2e-4
agreement shows.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opengl_ray_tracing_framework_tpu.models.camera import Camera as JCamera
from opengl_ray_tracing_framework_tpu.models.material import (
    preset_materials)
from opengl_ray_tracing_framework_tpu.models.scene import build_test_scene
from opengl_ray_tracing_framework_tpu.parallel import autodiff as jad
from opengl_ray_tracing_framework_tpu.parallel.sharding import (
    block_order_rows)
from opengl_ray_tracing_framework_tpu.utils.config import (
    RenderConfig as JConfig)
from opengl_ray_tracing_framework_tpu_torch import (
    Camera, Material, MaterialTable, RenderConfig, camera_from_numpy,
    scene_from_numpy)
from opengl_ray_tracing_framework_tpu_torch.ops import sweep as tsweep
from opengl_ray_tracing_framework_tpu_torch.parallel import autodiff as tad

from test_torch_host import jax_camera_arrays, jax_scene_arrays

SIZE, BOUNCES, SPP = 16, 2, 1
RAYS = SIZE * SIZE // 2          # two batches per image
GROUPS = ("material", "camera", "geometry")
TOL, TOL_NOISY = 2e-4, 0.25
NOISY = {("metallic", 0), ("anisotropic", 0), ("ior", 0)}


def grad_leaves(group, grads):
    """{leaf name: tensor or None} of the port's gradients of a group."""
    if group == "material":
        assert isinstance(grads, MaterialTable)
        return dict(zip(Material._fields, grads.mat))
    if group == "camera":
        assert isinstance(grads, Camera)
        return dict(zip(Camera._fields, grads))
    return {"vertices": grads}


def jax_grads(jdata, jcam, target, **config_kw):
    """(loss, {group: {leaf: numpy or None}}) from the JAX package."""
    cfg = jad._grad_config(JConfig(
        width=SIZE, height=SIZE, max_bounce=BOUNCES, use_pallas=True,
        pallas_backend="sweep", pallas_interpret=True, compaction_buckets=1,
        **config_kw))
    want = block_order_rows(jnp.asarray(target), cfg)

    def loss_fn(params):
        sc, cam = jdata, jcam
        for group, p in zip(GROUPS, params):
            sc, cam = jad._PARAM_GROUPS[group][1](sc, cam, p)
        img = jad.render_rows_radiance(sc, cam, cfg, jnp.int32(0), SIZE, SPP,
                                       RAYS, flat=True)
        return jnp.sum((img - want) ** 2)

    params = tuple(jad._PARAM_GROUPS[g][0](jdata, jcam) for g in GROUPS)
    loss, grads = jax.jit(jax.value_and_grad(loss_fn, allow_int=True))(params)
    as_np = lambda x: None if x.dtype == jax.dtypes.float0 else np.asarray(x)
    mats, cam, verts = grads
    return float(loss), {
        "material": {k: as_np(v) for k, v in mats.mat._asdict().items()},
        "camera": {k: as_np(v) for k, v in cam._asdict().items()},
        "geometry": {"vertices": as_np(verts)},
    }


def assert_grads_agree(group, loss, grads, ref_loss, ref, looser=None):
    """looser: {leaf name: tolerance} for leaves held above TOL."""
    np.testing.assert_allclose(float(loss), ref_loss, rtol=1e-5)
    floor = 1e-9 * max(np.abs(v).max() for v in ref.values() if v is not None)
    for name, g in grad_leaves(group, grads).items():
        want = ref[name]
        if want is None:                       # integer leaf
            assert g is None, name
            continue
        g = g.numpy()
        assert g.shape == want.shape and np.isfinite(g).all(), name
        scale = np.abs(want).max()
        tol = np.full(want.shape,
                      (looser or {}).get(name, TOL) * scale + floor)
        for leaf, slot in NOISY:
            if leaf == name:
                tol[slot] = TOL_NOISY * scale + floor
        assert (np.abs(g - want) <= tol).all(), (
            name, np.abs(g - want).max() / max(scale, 1e-30))


def make_world():
    _, jdata = build_test_scene(1, material=preset_materials()["tear_glass"])
    jcam = JCamera.make(position=(0.0, 0.5, -2.0), yaw=90.0, pitch=-8.0,
                        zoom=30.0, aspect=1.0)
    target = np.random.default_rng(5).uniform(
        0.0, 1.0, (SIZE, SIZE, 3)).astype(np.float32)
    return dict(
        jdata=jdata, jcam=jcam, target=target,
        scene=scene_from_numpy(jax_scene_arrays(jdata), device="cpu"),
        camera=camera_from_numpy(jax_camera_arrays(jcam), device="cpu"),
        config=RenderConfig(width=SIZE, height=SIZE, max_bounce=BOUNCES))


@pytest.fixture(scope="module")
def world():
    return make_world()


@pytest.fixture(scope="module")
def jax_ref(world):
    return jax_grads(world["jdata"], world["jcam"], world["target"])


def port_grad(world, group, **kw):
    kw.setdefault("rays_per_tile", RAYS)
    config = kw.pop("config", world["config"])
    return tad.param_grad(world["scene"], world["camera"],
                          torch.tensor(world["target"]), config, param=group,
                          spp=kw.pop("spp", SPP), **kw)


@pytest.mark.parametrize("group", GROUPS)
def test_grad_matches_jax(world, jax_ref, group):
    launches = tsweep.sweep.launches
    fn = {"material": tad.material_grad, "camera": tad.camera_grad,
          "geometry": tad.geometry_grad}[group]
    loss, grads = fn(world["scene"], world["camera"],
                     torch.tensor(world["target"]), world["config"], spp=SPP,
                     rays_per_tile=RAYS)
    assert tsweep.sweep.launches == launches   # CPU: the plain version
    ref_loss, ref = jax_ref
    assert_grads_agree(group, loss, grads, ref_loss, ref[group])
    if group == "geometry":
        assert tuple(grads.shape) == (3, 3, world["scene"].n_triangles)


def test_unknown_group_raises(world):
    with pytest.raises(ValueError, match="unknown param group"):
        port_grad(world, "lights")


def test_integer_leaf_has_no_gradient(world):
    _, grads = port_grad(world, "material")
    assert grads.mat.medium_type is None
    assert all(g is not None and g.dtype == torch.float32
               for name, g in zip(Material._fields, grads.mat)
               if name != "medium_type")


@pytest.mark.parametrize("group", GROUPS)
def test_grad_independent_of_batch_size(world, group):
    """The per-batch backward sums to the whole: 1, 2 and 8 batches (and a
    ragged last batch) give the same loss and gradients, rtol 1e-5 with an
    atol of 1e-5 of the leaf's largest entry for its near-zero entries."""
    ref_loss, ref = port_grad(world, group, rays_per_tile=SIZE * SIZE)
    for rays in (RAYS, SIZE * SIZE // 8, 100):
        loss, grads = port_grad(world, group, rays_per_tile=rays)
        np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
        for (name, g), want in zip(grad_leaves(group, grads).items(),
                                   grad_leaves(group, ref).values()):
            if want is None:
                assert g is None
                continue
            np.testing.assert_allclose(
                g.numpy(), want.numpy(), rtol=1e-5,
                atol=1e-5 * float(want.abs().max()), err_msg=name)


def test_render_rows_and_loss_are_one_graph(world):
    """render_rows_radiance returns image-order rows and material_loss one
    differentiable scalar whose gradient is param_grad's."""
    scene, cam, cfg = world["scene"], world["camera"], world["config"]
    target = torch.tensor(world["target"])
    rows = tad.render_rows_radiance(scene, cam, cfg, 4, 8, SPP, RAYS)
    full = tad.render_rows_radiance(scene, cam, cfg, 0, SIZE, SPP, RAYS)
    assert rows.shape == (8, SIZE, 3)
    np.testing.assert_allclose(rows.numpy(), full[4:12].numpy(), rtol=1e-6,
                               atol=1e-7)
    bc = scene.materials.mat.base_color.clone().requires_grad_(True)
    table = MaterialTable(mat=scene.materials.mat._replace(base_color=bc))
    loss = tad.material_loss(table, scene, cam, target, cfg, 0, SIZE, SPP,
                             RAYS)
    loss.backward()
    ref_loss, ref = port_grad(world, "material")
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss),
                               rtol=1e-6)
    np.testing.assert_allclose(bc.grad.numpy(), ref.mat.base_color.numpy(),
                               rtol=1e-5, atol=1e-6)


def test_schedule_tracer_gives_the_same_gradients(world):
    """Traversal is detached and every tracer returns the exact closest
    hit, so cast_backend="schedule" differentiates the same graph."""
    for group in GROUPS:
        ref_loss, ref = port_grad(world, group)
        loss, grads = port_grad(
            world, group,
            config=world["config"].replace(cast_backend="schedule"))
        np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-6)
        for (name, g), want in zip(grad_leaves(group, grads).items(),
                                   grad_leaves(group, ref).values()):
            if want is None:
                continue
            assert torch.isfinite(g).all(), name
            np.testing.assert_allclose(
                g.numpy(), want.numpy(), rtol=1e-5,
                atol=1e-5 * float(want.abs().max()), err_msg=name)


def test_base_color_finite_difference(world):
    """Central difference of the loss in one base_color entry (the
    sphere's, green) against autograd: same RNG streams, so renders are
    deterministic; 25% as tests/test_inverse.py allows (detached sampling:
    the difference sees lobe choices flip, autograd does not)."""
    scene, cam, cfg = world["scene"], world["camera"], world["config"]
    target = torch.tensor(world["target"])
    _, grads = tad.material_grad(scene, cam, target, cfg, spp=2,
                                 rays_per_tile=RAYS)
    ad = float(grads.mat.base_color[1, 1])

    def loss_of(delta):
        bc = scene.materials.mat.base_color.clone()
        bc[1, 1] += delta
        table = MaterialTable(mat=scene.materials.mat._replace(base_color=bc))
        with torch.no_grad():
            return float(tad.material_loss(table, scene, cam, target, cfg, 0,
                                           SIZE, 2, RAYS))

    eps = 1e-2
    fd = (loss_of(eps) - loss_of(-eps)) / (2 * eps)
    assert abs(fd - ad) < 0.25 * max(abs(fd), abs(ad)), (fd, ad)


def test_vertex_finite_difference():
    """The vertex coordinate with the largest |gradient| against a central
    difference, on the scene of tests/test_inverse.py:71-102 (the default
    white sphere, target 0, eps 2e-3, 25%). The difference moves the
    vertex in the shading table only, as that test does: it sees the
    shading normal move, not the silhouette."""
    from opengl_ray_tracing_framework_tpu_torch import (
        Camera as TCamera, build_test_scene as tbuild)
    _, scene = tbuild(device="cpu")
    cam = TCamera.make(position=(0.0, 0.5, -2.0), yaw=90.0, pitch=-8.0,
                       zoom=30.0, aspect=1.0, device="cpu")
    cfg = RenderConfig(width=SIZE, height=SIZE, max_bounce=BOUNCES)
    target = torch.zeros((SIZE, SIZE, 3))
    loss, g = tad.geometry_grad(scene, cam, target, cfg, spp=1,
                                rays_per_tile=256)
    assert np.isfinite(float(loss)) and float(loss) > 0.0
    assert tuple(g.shape) == (3, 3, scene.n_triangles)
    assert torch.isfinite(g).all() and float(g.abs().max()) > 0.0
    k, ax, tri = np.unravel_index(int(g.abs().argmax()), g.shape)
    row = int(3 * k + ax)

    def loss_of(delta):
        tri_attr = scene.tri_attr.clone()
        tri_attr[row, tri] += delta
        sc = dataclasses.replace(scene, tri_attr=tri_attr)
        with torch.no_grad():
            img = tad.render_rows_radiance(sc, cam, cfg, 0, SIZE, 1, 256)
        return float(torch.sum((img - target) ** 2))

    eps = 2e-3
    fd = (loss_of(eps) - loss_of(-eps)) / (2 * eps)
    ad = float(g[k, ax, tri])
    assert abs(fd - ad) < 0.25 * max(abs(fd), abs(ad)), (fd, ad)
