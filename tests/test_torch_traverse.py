"""PyTorch port, the kernel-free tracers and the cast dispatch:
ops/intersect.py::ray_aabb, ops/traverse.py::bvh_closest_hit against the
JAX bvh_closest_hit and the brute-force oracle (the cases of
tests/test_intersect_bvh.py), closest_hit for every cast_backend x use_bvh,
and closest_hit_pair.

Tracers visit triangles in different orders, so the winner may differ where
two triangles tie in t: hits are held to test_torch_sweep's criterion
(hit/miss exact, t to 1e-4, the same triangle on >= 99.5% of hits)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from opengl_ray_tracing_framework_tpu.models.scene import (
    build_test_scene as jax_build_test_scene)
from opengl_ray_tracing_framework_tpu.ops import intersect as jint
from opengl_ray_tracing_framework_tpu.ops import traverse as jtrav
from opengl_ray_tracing_framework_tpu_torch import (
    RenderConfig, scene_from_numpy)
from opengl_ray_tracing_framework_tpu_torch.ops import intersect as tint
from opengl_ray_tracing_framework_tpu_torch.ops import traverse as ttrav

from test_torch_host import jax_scene_arrays
from test_torch_sweep import assert_hits_agree, inside_rays, random_rays

T = torch.as_tensor


@pytest.fixture(scope="module")
def scenes():
    _, jdata = jax_build_test_scene(n_sphere_subdiv=2)
    return jdata, scene_from_numpy(jax_scene_arrays(jdata), device="cpu")


def _f(x):
    return torch.tensor(x, dtype=torch.float32)


def test_ray_aabb_conventions():
    o = _f([[0.0, 0.0, 0.0]])
    inv = 1.0 / _f([[1.0, 1.0, 1.0]])
    aa, bb = _f([[1.0, 1.0, 1.0]]), _f([[2.0, 2.0, 2.0]])
    assert np.isclose(float(tint.ray_aabb(o, inv, aa, bb)[0]), 1.0,
                      atol=1e-6)                       # entry distance
    t = tint.ray_aabb(_f([[1.5, 1.5, 1.5]]), inv, aa, bb)
    assert np.isclose(float(t[0]), 0.5, atol=1e-6)     # inside: the exit
    t = tint.ray_aabb(o, 1.0 / _f([[1.0, -1.0, 1.0]]), aa, bb)
    assert float(t[0]) == -1.0                         # a miss


def test_ray_aabb_matches_jax():
    rng = np.random.default_rng(41)
    n = 4096
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    inv = (1.0 / d).astype(np.float32)
    aa = rng.uniform(-2, 1, (n, 3)).astype(np.float32)
    bb = aa + rng.uniform(0.1, 2, (n, 3)).astype(np.float32)
    j = jnp.asarray
    np.testing.assert_array_equal(
        tint.ray_aabb(T(o), T(inv), T(aa), T(bb)).numpy(),
        np.asarray(jint.ray_aabb(j(o), j(inv), j(aa), j(bb))))
    tv, tt = tint.ray_aabb_visit(T(o), T(inv), T(aa), T(bb))
    jv, jt = jint.ray_aabb_visit(j(o), j(inv), j(aa), j(bb))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


@pytest.mark.parametrize("case", ["camera", "random", "inside"])
def test_bvh_closest_hit_matches_jax_and_oracle(scenes, case):
    jdata, tdata = scenes
    rng = np.random.default_rng(43)
    if case == "camera":   # tests/test_intersect_bvh.py:134
        o = np.tile(np.array([0.0, 0.5, -2.0], np.float32), (256, 1))
        d = rng.normal(size=(256, 3)).astype(np.float32)
        d[:, 2] = np.abs(d[:, 2]) + 0.5
        d /= np.linalg.norm(d, axis=1, keepdims=True)
    elif case == "random":
        o, d = random_rays(rng, 512)
    else:
        o, d = inside_rays(rng, 256)
    port = ttrav.bvh_closest_hit(tdata, T(o), T(d))
    ref = jtrav.bvh_closest_hit(jdata, jnp.asarray(o), jnp.asarray(d))
    oracle = tint.closest_hit_brute(T(o), T(d), tdata.p1, tdata.p2,
                                    tdata.p3)
    assert (port.tri.numpy() >= 0).sum() > 30
    assert_hits_agree(port, oracle)
    # the same traversal order on both sides: the same winner everywhere
    np.testing.assert_array_equal(port.tri.numpy(), np.asarray(ref.tri))
    np.testing.assert_array_equal(port.inside.numpy(),
                                  np.asarray(ref.inside))
    np.testing.assert_allclose(port.t.numpy(), np.asarray(ref.t), rtol=1e-5)


CONFIGS = {
    "sweep": dict(),
    "schedule": dict(cast_backend="schedule"),
    "bvh": dict(cast_backend="bvh"),
    "brute": dict(use_bvh=False),
    "brute_whatever_backend": dict(use_bvh=False, cast_backend="schedule"),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_dispatch_returns_the_same_hits(scenes, name):
    _, tdata = scenes
    rng = np.random.default_rng(53)
    o, d = random_rays(rng, 640)
    mask = T(rng.random(640) < 0.7)
    oracle = tint.closest_hit_brute(T(o), T(d), tdata.p1, tdata.p2,
                                    tdata.p3)
    cfg = RenderConfig(**CONFIGS[name]).validate()
    o_t = T(o).requires_grad_()
    hit = ttrav.closest_hit(tdata, o_t, T(d), cfg)
    assert not hit.t.requires_grad          # traversal is detached
    assert hit.tri.dtype == torch.int32 and hit.inside.dtype == torch.bool
    assert_hits_agree(hit, oracle)
    # with a mask: live lanes as without; any-hit: hit/miss only
    m = mask.numpy()
    masked = ttrav.closest_hit(tdata, T(o), T(d), cfg, mask=mask)
    np.testing.assert_array_equal(masked.tri.numpy()[m], hit.tri.numpy()[m])
    occl = ttrav.closest_hit(tdata, T(o), T(d), cfg, mask=mask,
                             any_hit=True)
    np.testing.assert_array_equal(occl.tri.numpy()[m] >= 0,
                                  oracle.tri.numpy()[m] >= 0)


def test_unknown_backend_raises(scenes):
    _, tdata = scenes
    o, d = random_rays(np.random.default_rng(3), 8)
    with pytest.raises(ValueError, match="cast_backend"):
        ttrav.closest_hit(tdata, T(o), T(d),
                          RenderConfig(cast_backend="pallas"))


@pytest.mark.parametrize("name", ["schedule", "bvh", "brute"])
def test_pair_off_the_sweep_backend_is_two_casts(scenes, name):
    _, tdata = scenes
    rng = np.random.default_rng(59)
    oa, da = inside_rays(rng, 300)
    oc, dc = random_rays(rng, 420)
    ma, mc = T(rng.random(300) < 0.7), T(rng.random(420) < 0.8)
    cfg = RenderConfig(**CONFIGS[name])
    h_any, h_cls = ttrav.closest_hit_pair(tdata, T(oa), T(da), ma,
                                          T(oc), T(dc), mc, cfg)
    w_any = ttrav.closest_hit(tdata, T(oa), T(da), cfg, mask=ma,
                              any_hit=True)
    w_cls = ttrav.closest_hit(tdata, T(oc), T(dc), cfg, mask=mc)
    for got, want in ((h_any, w_any), (h_cls, w_cls)):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    # and the pair agrees with the sweep backend's merged cast
    s_any, s_cls = ttrav.closest_hit_pair(tdata, T(oa), T(da), ma,
                                          T(oc), T(dc), mc, RenderConfig())
    a, c = ma.numpy(), mc.numpy()
    np.testing.assert_array_equal(h_any.tri.numpy()[a] >= 0,
                                  s_any.tri.numpy()[a] >= 0)
    pick = lambda h: tuple(x.numpy()[c] for x in h)
    assert_hits_agree(pick(h_cls), pick(s_cls))


@pytest.fixture(scope="module")
def subdiv3_scenes():
    _, jdata = jax_build_test_scene(n_sphere_subdiv=3)
    return jdata, scene_from_numpy(jax_scene_arrays(jdata), device="cpu")


@pytest.mark.parametrize("stack_depth", [2, 3, 4, 64])
def test_bvh_stack_overflow_matches_jax(subdiv3_scenes, stack_depth):
    """A stack too shallow for the walk: pushes beyond it are dropped and
    the pops above it visit the dummy node 0 in both packages, so the port
    finds JAX's hits at every depth (re-reading the stack's last column,
    it once lost 776, 522 and 172 of them at depths 2, 3 and 4)."""
    jdata, tdata = subdiv3_scenes
    rng = np.random.default_rng(0)
    o = (rng.normal(0, 0.2, (2048, 3))
         + np.array([0.0, 1.0, 4.0])).astype(np.float32)
    d = rng.normal(size=(2048, 3)).astype(np.float32)
    d[:, 2] -= 3.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    port = ttrav.bvh_closest_hit(tdata, T(o), T(d), stack_depth=stack_depth)
    ref = jtrav.bvh_closest_hit(jdata, jnp.asarray(o), jnp.asarray(d),
                                stack_depth=stack_depth)
    assert (np.asarray(ref.tri) >= 0).sum() > 100
    np.testing.assert_array_equal(port.tri.numpy(), np.asarray(ref.tri))
    np.testing.assert_array_equal(port.inside.numpy(),
                                  np.asarray(ref.inside))
    np.testing.assert_allclose(port.t.numpy(), np.asarray(ref.t), rtol=1e-6)
