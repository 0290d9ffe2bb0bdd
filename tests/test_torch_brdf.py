"""PyTorch port, the legacy BRDF mode (enable_bsdf=False): the world-space
samplers, the 3-lobe Disney BRDF and the render as a whole against the JAX
package on the same numpy inputs.

Float results agree to rtol 1e-5 / atol 1e-6 (XLA and torch evaluate
sqrt, pow and log a few ulps apart). These outputs are ill-conditioned and
held to test_torch_sampling's close_ill_conditioned class (all but 0.2% at
1e-5, the rest at 1e-4): sample_gtr1_world, whose cos_theta is
sqrt((1 - a2^(1-r2)) / (1 - a2)), a cancelling difference as r2 -> 1 that
amplifies pow's ulps; sample_gtr2_world, whose denominator
1 + (a2 - 1) r2 cancels to a2 as r2 -> 1 (1 of 12,288 outputs was off at
1.6e-5); sample_brdf, which selects between them; and brdf_evaluate, whose
specular terms divide by 4 n.l n.v and l.h down to the 1e-4 cutoffs, which
amplifies the dot products' ulps the same way."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from opengl_ray_tracing_framework_tpu.ops import disney as jdis
from opengl_ray_tracing_framework_tpu.ops import sampling as jsam
from opengl_ray_tracing_framework_tpu.render import (
    render_radiance as jax_render_radiance)
from opengl_ray_tracing_framework_tpu.utils.config import (
    RenderConfig as JConfig)
from opengl_ray_tracing_framework_tpu_torch import (
    RenderConfig, render_radiance)
from opengl_ray_tracing_framework_tpu_torch.ops import disney as tdis
from opengl_ray_tracing_framework_tpu_torch.ops import sampling as tsam

from test_torch_render import assert_images_agree, scenes  # noqa: F401
from test_torch_sampling import (
    T, _bsdf_inputs, _tables, close, close_ill_conditioned, unit)


def _sampler_inputs(seed=61, n=4096):
    rng = np.random.default_rng(seed)
    r1, r2 = rng.random((2, n), dtype=np.float32)
    v, nrm = unit(rng, n), unit(rng, n)
    nrm[:4] = np.array([[1, 0, 0], [-1, 0, 0], [0.9995, 0.03, 0],
                        [0, 1, 0]], np.float32)   # both helper branches
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    alpha = rng.uniform(0.001, 1.0, n).astype(np.float32)
    return r1, r2, v, nrm.astype(np.float32), alpha


@pytest.mark.parametrize("name", [
    "onb_hemi", "sample_cosine_hemisphere_world", "uniform_sample_sphere",
    "sample_gtr2_world", "sample_gtr1_world"])
def test_brdf_samplers_match(name):
    r1, r2, v, nrm, alpha = _sampler_inputs()
    args = {"onb_hemi": (nrm,),
            "sample_cosine_hemisphere_world": (r1, r2, nrm),
            "uniform_sample_sphere": (r1, r2),
            "sample_gtr2_world": (r1, r2, v, nrm, alpha),
            "sample_gtr1_world": (r1, r2, v, nrm, alpha)}[name]
    want = getattr(jsam, name)(*(jnp.asarray(a) for a in args))
    got = getattr(tsam, name)(*(T(a) for a in args))
    if name == "onb_hemi":
        for g, w in zip(got, want):
            close(g, w)
    elif name in ("sample_gtr1_world", "sample_gtr2_world"):
        close_ill_conditioned(got, want)
    else:
        close(got, want)


def _materials(n):
    names, jt, tt = _tables()
    idx = np.arange(n, dtype=np.int32) % len(names)
    return jt.gather(jnp.asarray(idx)), tt.gather(T(idx))


def test_brdf_lobe_pdfs_match():
    jm, tm = _materials(64)
    for g, w in zip(tdis.brdf_lobe_pdfs(tm), jdis.brdf_lobe_pdfs(jm)):
        close(g, w)
    total = sum(tdis.brdf_lobe_pdfs(tm))
    np.testing.assert_allclose(total.numpy(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("seed", [62, 63])
def test_brdf_evaluate_all_presets(seed):
    v, nrm, l, _ = _bsdf_inputs(seed)
    # a quarter of the lanes at grazing l, v and l.h: the `valid` cutoffs
    q = v.shape[0] // 4
    l[:q] = -v[:q] + 1e-3 * l[:q]
    l[:q] /= np.linalg.norm(l[:q], axis=1, keepdims=True)
    jm, tm = _materials(v.shape[0])
    jx, jy = jsam.onb(jnp.asarray(nrm))
    tx, ty = tsam.onb(T(nrm))
    jf, jp = jdis.brdf_evaluate(jm, jnp.asarray(v), jnp.asarray(nrm),
                                jnp.asarray(l), jx, jy)
    tf, tp = tdis.brdf_evaluate(tm, T(v), T(nrm), T(l), tx, ty)
    # masked lanes return exactly (0, 1e-10) on both sides
    dead = np.asarray(jp) == np.float32(1e-10)
    assert 0.3 < dead.mean() < 0.9, dead.mean()
    np.testing.assert_array_equal(tp.numpy() == np.float32(1e-10), dead)
    assert (tf.numpy()[dead] == 0).all()
    close_ill_conditioned(tf, jf)
    close_ill_conditioned(tp, jp)


@pytest.mark.parametrize("seed", [64, 65])
def test_sample_brdf_all_presets(seed):
    v, nrm, _, xi = _bsdf_inputs(seed)
    jm, tm = _materials(v.shape[0])
    # r3 exactly on the lobe boundaries: the pick is `<=`
    p_diff, _, p_coat = (np.asarray(x) for x in jdis.brdf_lobe_pdfs(jm))
    xi[2, :64] = p_diff[:64]
    xi[2, 64:128] = (p_diff + p_coat)[64:128]
    want = jdis.sample_brdf(jm, jnp.asarray(v), jnp.asarray(nrm),
                            *(jnp.asarray(x) for x in xi))
    got = tdis.sample_brdf(tm, T(v), T(nrm), *(T(x) for x in xi))
    close_ill_conditioned(got, want)


@pytest.mark.parametrize("case", [
    dict(max_bounce=4), dict(max_bounce=4, enable_env_map=False)],
    ids=["env_mis", "sky"])
def test_brdf_render_matches_jax(scenes, case):  # noqa: F811
    jdata, jcam, tdata, tcam = scenes
    kw = dict(width=32, height=32, enable_bsdf=False, **case)
    ref = np.asarray(jax_render_radiance(
        jdata, jcam,
        JConfig(use_pallas=True, pallas_backend="sweep",
                pallas_interpret=True, compaction_buckets=1, **kw), spp=2))
    img = render_radiance(tdata, tcam, RenderConfig(**kw), spp=2,
                          rays_per_tile=512)
    assert img.shape == (32, 32, 3) and img.dtype == torch.float32
    assert_images_agree(img.numpy(), ref)
