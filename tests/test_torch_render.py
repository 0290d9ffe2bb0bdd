"""PyTorch port, the slice as a whole: the port's render_radiance against
the JAX package's (span-sweep tracer, Pallas kernel in interpret mode) on
the same scene, camera and counter-RNG streams, with the ABSORB glass
sphere so the media branch runs.

Criterion: the hardware lane's (tests/test_tpu.py:57-60) — identical
estimator and random numbers, so only float ordering differs: the means
agree to 1e-4 relative and fewer than 1e-3 of the values differ by more
than atol/rtol 1e-3."""

import numpy as np
import pytest
import torch

from opengl_ray_tracing_framework_tpu.models.camera import Camera as JCamera
from opengl_ray_tracing_framework_tpu.models.material import (
    preset_materials)
from opengl_ray_tracing_framework_tpu.models.scene import build_test_scene
from opengl_ray_tracing_framework_tpu.render import (
    RenderState as JRenderState, finalize as jax_finalize,
    render_radiance as jax_render_radiance)
from opengl_ray_tracing_framework_tpu.utils.config import (
    RenderConfig as JConfig)
from opengl_ray_tracing_framework_tpu_torch import (
    RenderConfig, RenderState, camera_from_numpy, finalize, render_radiance,
    scene_from_numpy)
from opengl_ray_tracing_framework_tpu_torch.ops import sweep as tsweep

from test_torch_host import jax_camera_arrays, jax_scene_arrays

SIZE, SPP = 32, 2


@pytest.fixture(scope="module")
def scenes():
    _, jdata = build_test_scene(2, material=preset_materials()["tear_glass"])
    jcam = JCamera.make(position=(0.0, 0.5, -2.0), yaw=90.0, pitch=-8.0,
                        zoom=30.0, aspect=1.0)
    return (jdata, jcam,
            scene_from_numpy(jax_scene_arrays(jdata), device="cpu"),
            camera_from_numpy(jax_camera_arrays(jcam), device="cpu"))


def assert_images_agree(img, ref):
    assert np.isfinite(img).all()
    assert abs(img.mean() - ref.mean()) < 1e-4 * max(ref.mean(), 1e-6)
    mismatch = ~np.isclose(img, ref, atol=1e-3, rtol=1e-3)
    assert mismatch.mean() < 1e-3, f"{mismatch.mean():.5f} values diverge"


CASES = {
    "env_mis": dict(max_bounce=4),
    "sky": dict(max_bounce=4, enable_env_map=False),
    "env_no_mis": dict(max_bounce=3, enable_mis=False),
    "env_bilinear": dict(max_bounce=3, env_bilinear=True),
}


def check_case(scenes, case):
    """Render CASES[case] with both packages and hold them to the
    criterion."""
    jdata, jcam, tdata, tcam = scenes
    kw = dict(width=SIZE, height=SIZE, **CASES[case])
    # compaction_buckets=1: the JAX bounce runs unbucketed (exact either
    # way) so the test compiles one interpret-mode sweep per cast site
    ref = np.asarray(jax_render_radiance(
        jdata, jcam,
        JConfig(use_pallas=True, pallas_backend="sweep",
                pallas_interpret=True, compaction_buckets=1, **kw),
        spp=SPP))
    launches = tsweep.sweep.launches
    img = render_radiance(tdata, tcam, RenderConfig(**kw), spp=SPP,
                          rays_per_tile=SIZE * SIZE // 2)
    assert tsweep.sweep.launches == launches   # CPU: the plain version
    assert img.shape == (SIZE, SIZE, 3) and img.dtype == torch.float32
    assert_images_agree(img.numpy(), ref)


@pytest.mark.parametrize("case", ["env_mis", "sky"])
def test_render_radiance_matches_jax(scenes, case):
    check_case(scenes, case)


def test_finalize_matches_jax():
    rng = np.random.default_rng(29)
    accum = rng.gamma(1.0, 1.0, (SIZE, SIZE, 3)).astype(np.float32)
    for cfg_kw in (dict(), dict(enable_tone_mapping=False),
                   dict(enable_gamma_correction=False)):
        want = jax_finalize(JRenderState(accum=accum, n_samples=SPP),
                            JConfig(**cfg_kw))
        got = finalize(RenderState(accum=torch.tensor(accum),
                                   n_samples=SPP), RenderConfig(**cfg_kw))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)
