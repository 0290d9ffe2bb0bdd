"""PyTorch port, multi-device rendering: parallel/sharding.py on gloo
groups of 2 and 4 CPU processes (spawn_ranks: a file store, the spawn
start method, a timeout on every group) against the port's
single-process render_pass, and once against the JAX package's
render_pass_sharded on the conftest's virtual CPU mesh.

Criteria: the sharded accumulators equal the single-process ones to
rtol 2e-5, atol 1e-6 (tests/test_grad_sharding.py:96-98): the RNG streams
are keyed by global pixel ids and casts are per ray, so a row's samples
do not depend on the block it is traced in. Against JAX, the image
criterion of tests/test_torch_render.py.
"""

import numpy as np
import pytest
import torch

from opengl_ray_tracing_framework_tpu_torch import (
    Camera, RenderConfig, build_test_scene, init_render_state, render_pass)
from opengl_ray_tracing_framework_tpu_torch.parallel import sharding

SIZE, BOUNCES = 16, 2
TIMEOUT_S = 120.0


def camera(device="cpu"):
    return Camera.make(position=(0.0, 0.5, -2.0), yaw=90.0, pitch=-8.0,
                       zoom=30.0, aspect=1.0, device=device)


def render_worker(two_d, n_tiles, spp_per_pass, passes, rays):
    """One rank: replicate the scene, run `passes` sharded passes, return
    the gathered image and sample count after each, and the rank's mesh.
    Also checks the errors a mesh raises."""
    mesh = sharding.make_mesh_2d(n_tiles) if two_d else sharding.make_mesh()
    scene = sharding.replicate_scene(build_test_scene(device="cpu")[1], mesh)
    config = RenderConfig(width=SIZE, height=SIZE, max_bounce=BOUNCES,
                          spp_per_pass=spp_per_pass)
    state = init_render_state(config, "cpu")
    out = []
    for _ in range(passes):
        state = sharding.render_pass_sharded(scene, camera(), state, config,
                                             mesh, rays_per_tile=rays)
        assert state.accum.shape == (SIZE // mesh.n_tiles, SIZE, 3)
        out.append((sharding.gather_image(state, mesh), state.n_samples))
    if two_d:
        with pytest.raises(ValueError, match="not divisible by the spp"):
            sharding.render_pass_sharded(
                scene, camera(), state,
                config.replace(spp_per_pass=mesh.n_spp + 1), mesh)
    with pytest.raises(ValueError, match="devices not divisible into"):
        sharding.make_mesh_2d(3)
    return out, (mesh.n_tiles, mesh.n_spp, mesh.tile, mesh.spp_id)


def single(spp_per_pass, passes):
    """The single-process accumulators after each pass."""
    _, scene = build_test_scene(device="cpu")
    config = RenderConfig(width=SIZE, height=SIZE, max_bounce=BOUNCES,
                          spp_per_pass=spp_per_pass)
    state = init_render_state(config, "cpu")
    out = []
    for _ in range(passes):
        state = render_pass(scene, camera(), state, config,
                            rays_per_tile=256)
        out.append(state.accum)
    return out


@pytest.fixture(scope="module")
def two_ranks_1d():
    return sharding.spawn_ranks(render_worker, 2, False, None, 1, 2, 64,
                                device="cpu", timeout_s=TIMEOUT_S)


def assert_same_passes(ranks, want, spp_per_pass):
    for out, _ in ranks:
        for i, ((img, n), ref) in enumerate(zip(out, want)):
            assert n == (i + 1) * spp_per_pass
            np.testing.assert_allclose(img.numpy(), ref.numpy(), rtol=2e-5,
                                       atol=1e-6)


def test_1d_two_ranks_equal_single(two_ranks_1d):
    """Two tiles of 8 rows; the second pass accumulates."""
    assert [m for _, m in two_ranks_1d] == [(2, 1, 0, 0), (2, 1, 1, 0)]
    assert_same_passes(two_ranks_1d, single(1, 2), 1)


def test_1d_four_ranks_equal_single():
    ranks = sharding.spawn_ranks(render_worker, 4, False, None, 1, 2, 64,
                                 device="cpu", timeout_s=TIMEOUT_S)
    assert_same_passes(ranks, single(1, 2), 1)


@pytest.mark.parametrize("world, n_tiles", [(4, 2), (2, None)],
                         ids=["2tiles-x-2spp", "default-1tile-x-2spp"])
def test_2d_mesh_equals_single(world, n_tiles):
    """(tiles, spp): each tile's ranks trace 2 of the 4 frames of a pass
    and all_reduce their means, equal to the sequential accumulation of
    the same frames; a second pass accumulates."""
    ranks = sharding.spawn_ranks(render_worker, world, True, n_tiles, 4, 2,
                                 64, device="cpu", timeout_s=TIMEOUT_S)
    n_tiles = n_tiles or 1
    n_spp = world // n_tiles
    assert [m for _, m in ranks] == [
        (n_tiles, n_spp, r // n_spp, r % n_spp) for r in range(world)]
    assert_same_passes(ranks, single(4, 2), 4)


def test_height_not_dividing_the_tiles_raises():
    config = RenderConfig(width=SIZE, height=SIZE, max_bounce=BOUNCES)
    _, scene = build_test_scene(device="cpu")
    mesh = sharding.Mesh(n_tiles=3, n_spp=1, tile=0, spp_id=0)
    with pytest.raises(ValueError, match="height 16 not divisible by 3"):
        sharding.render_pass_sharded(scene, camera(), init_render_state(
            config, "cpu"), config, mesh)


def test_single_process_is_a_mesh_of_one():
    """Without a group: a 1x1 mesh, no collective, render_pass's result."""
    mesh = sharding.make_mesh()
    assert (mesh.size, mesh.rank, sharding.make_mesh_2d().size) == (1, 0, 1)
    assert sharding.init_distributed(device="cpu") == 1
    _, scene = build_test_scene(device="cpu")
    assert sharding.replicate_scene(scene, mesh) is scene
    config = RenderConfig(width=SIZE, height=SIZE, max_bounce=BOUNCES)
    state = sharding.render_pass_sharded(scene, camera(), init_render_state(
        config, "cpu"), config, mesh, rays_per_tile=256)
    assert torch.equal(sharding.gather_image(state, mesh), single(1, 1)[0])


def failing_worker():
    if torch.distributed.get_rank() == 1:
        raise ArithmeticError("rank 1 fails")
    torch.distributed.barrier()   # rank 0 waits on the failed rank


def test_a_failed_rank_fails_the_run():
    with pytest.raises(RuntimeError, match="rank 1 fails"):
        sharding.spawn_ranks(failing_worker, 2, device="cpu",
                             timeout_s=TIMEOUT_S)


def test_matches_jax_sharded_render(two_ranks_1d):
    """The port's 2-rank image against the JAX package's render_pass_sharded
    on a 2-device virtual CPU mesh, first pass."""
    import jax
    from opengl_ray_tracing_framework_tpu import RenderConfig as JConfig
    from opengl_ray_tracing_framework_tpu.models.camera import (
        Camera as JCamera)
    from opengl_ray_tracing_framework_tpu.models.scene import (
        build_test_scene as jbuild)
    from opengl_ray_tracing_framework_tpu.parallel import sharding as jshard
    from opengl_ray_tracing_framework_tpu.render import init_render_state \
        as jinit

    from test_torch_render import assert_images_agree

    _, jscene = jbuild()
    jcam = JCamera.make(position=(0.0, 0.5, -2.0), yaw=90.0, pitch=-8.0,
                        zoom=30.0, aspect=1.0)
    cfg = JConfig(width=SIZE, height=SIZE, max_bounce=BOUNCES)
    mesh = jshard.make_mesh(jax.devices()[:2])
    ref = jshard.render_pass_sharded(jshard.replicate_scene(jscene, mesh),
                                     jcam, jinit(cfg), cfg, mesh,
                                     rays_per_tile=64)
    img, n = two_ranks_1d[0][0][0]
    assert n == int(ref.n_samples) == 1
    assert_images_agree(img.numpy(), np.asarray(ref.accum))
