"""PyTorch port, shading layer: counter RNG, Sobol, samplers, Disney BSDF,
environment lookups and tone mapping against the JAX package on the same
numpy inputs.

The RNG must agree bit for bit (it decides which pixel draws what). Float
results agree to rtol 1e-5 / atol 1e-6: XLA and torch evaluate
transcendentals (sqrt, pow, log, atan2) to a few ulps apart. disney_sample
and the environment's solid-angle pdfs hold it on all but 0.2% of their
outputs, which stay within rtol 1e-4: near r1 -> 1 the VNDF sampler's
sqrt(1 - p1^2 - p2^2) cancels, and near the poles the pdf's 1/sin(theta)
amplifies asin's ulps (ROADMAP Queue 3)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from opengl_ray_tracing_framework_tpu.models import material as jmat
from opengl_ray_tracing_framework_tpu.ops import disney as jdis
from opengl_ray_tracing_framework_tpu.ops import envmap as jenv
from opengl_ray_tracing_framework_tpu.ops import sampling as jsam
from opengl_ray_tracing_framework_tpu.ops import tonemap as jtm
from opengl_ray_tracing_framework_tpu_torch.models import material as tmat
from opengl_ray_tracing_framework_tpu_torch.ops import disney as tdis
from opengl_ray_tracing_framework_tpu_torch.ops import envmap as tenv
from opengl_ray_tracing_framework_tpu_torch.ops import sampling as tsam
from opengl_ray_tracing_framework_tpu_torch.ops import tonemap as ttm

RTOL, ATOL = 1e-5, 1e-6
T = torch.as_tensor


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def close_ill_conditioned(got, want, share=2e-3, rtol_tail=1e-4):
    """`close` on all but `share` of the elements; those within rtol_tail."""
    got, want = np.asarray(got), np.asarray(want)
    off = ~np.isclose(got, want, rtol=RTOL, atol=ATOL)
    assert off.mean() <= share, f"{off.mean():.5f} of outputs off at 1e-5"
    np.testing.assert_allclose(got, want, rtol=rtol_tail, atol=ATOL)


def unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def test_mix32_bit_exact():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        np.array([0, 1, 2, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF,
                  0x9E3779B9], np.uint32),
        rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)])
    want = np.asarray(jsam.mix32(jnp.asarray(x)))
    got = tsam.mix32(T(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


def test_rand01_bit_exact():
    pid = np.array([0, 1, 2, 31, 1024, 12345, 2**31 - 1, 2**31,
                    2**32 - 2, 2**32 - 1], np.uint32)
    frames = np.array([0, 1, 2, 3, 17, 100, 2**31 - 1], np.uint32)
    salts = np.array([0, 1, 2, 3, 4, 7, 8, 63, 1001, 1002], np.uint32)
    p, f, s = np.meshgrid(pid, frames, salts, indexing="ij")
    want = np.asarray(jsam.rand01(jnp.asarray(p), jnp.asarray(f),
                                  jnp.asarray(s)))
    got = tsam.rand01(T(p.astype(np.int64)), T(f.astype(np.int64)),
                      T(s.astype(np.int64))).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    # scalar frame / salt, as the integrator calls it
    for frame, salt in ((1, 0), (5, 8 * 7 + 4), (2**20, 1002)):
        want = np.asarray(jsam.rand01(jnp.asarray(pid), frame, salt))
        got = tsam.rand01(T(pid.astype(np.int64)), frame, salt).numpy()
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


def test_sobol_bit_exact():
    np.testing.assert_array_equal(tsam.SOBOL_TABLE, jsam.SOBOL_TABLE)
    for index in (0, 1, 2, 3, 7, 64, 1000, 3001, 2**31 - 1):
        want = np.asarray(jsam.sobol_all_dims(jnp.int32(index)))
        got = tsam.sobol_all_dims(index, "cpu").numpy()
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
        for b in range(8):
            ju, jv = jsam.sobol_bounce_uv(jnp.asarray(want), b)
            tu, tv = tsam.sobol_bounce_uv(T(got), b)
            assert float(ju) == float(tu) and float(jv) == float(tv)


def test_samplers_match():
    rng = np.random.default_rng(1)
    n = 2048
    r1, r2 = rng.random((2, n), dtype=np.float32)
    rough = rng.random(n, dtype=np.float32)
    aniso = rng.uniform(-0.9, 0.9, n).astype(np.float32)
    aniso[:64] = 0.0          # the isotropic branch
    v, nrm = unit(rng, n), unit(rng, n)
    v_loc = v.copy()
    v_loc[:, 2] = np.abs(v_loc[:, 2]) + 0.05
    v_loc /= np.linalg.norm(v_loc, axis=1, keepdims=True)
    ax, ay = (rng.uniform(0.01, 1.0, n).astype(np.float32) for _ in "ab")
    eta = rng.uniform(0.5, 1.8, n).astype(np.float32)
    cases = [
        ("cosine_sample_hemisphere", (r1, r2)),
        ("sample_gtr1", (rough, r1, r2)),
        ("sample_ggx_vndf", (v_loc, ax, ay, r1, r2)),
        ("sample_hg", (v, aniso, r1, r2)),
        ("phase_hg", (np.sum(v * nrm, 1).astype(np.float32), aniso)),
        ("cranley_patterson", (r1, r2)),
        ("reflect", (v, nrm)),
        ("refract", (v, nrm, eta)),
        ("onb", (nrm,)),
    ]
    for name, args in cases:
        want = getattr(jsam, name)(*(jnp.asarray(a) for a in args))
        got = getattr(tsam, name)(*(T(a) for a in args))
        if name == "onb":
            for g, w in zip(got, want):
                close(g, w)
        else:
            close(got, want)


def _tables():
    names = list(jmat.preset_materials())
    jt = jmat.MaterialTable.stack(list(jmat.preset_materials().values()))
    tt = tmat.MaterialTable.stack(list(tmat.preset_materials().values()))
    return names, jt, tt


def _bsdf_inputs(seed, n=4096):
    rng = np.random.default_rng(seed)
    v, nrm, l = unit(rng, n), unit(rng, n), unit(rng, n)
    # the shading normal faces the viewer (glsl:256-259, 295)
    flip = np.sum(v * nrm, 1) < 0
    nrm[flip] = -nrm[flip]
    xi = rng.random((3, n), dtype=np.float32)
    return v, nrm, l, xi


@pytest.mark.parametrize("seed", [2, 3])
def test_disney_eval_all_presets(seed):
    names, jt, tt = _tables()
    v, nrm, l, _ = _bsdf_inputs(seed)
    idx = np.arange(v.shape[0], dtype=np.int32) % len(names)
    jm, tm = jt.gather(jnp.asarray(idx)), tt.gather(T(idx))
    jf, jp = jdis.disney_eval(jm, jnp.asarray(v), jnp.asarray(nrm),
                              jnp.asarray(l))
    tf, tp = tdis.disney_eval(tm, T(v), T(nrm), T(l))
    close(tf, jf)
    close(tp, jp)


@pytest.mark.parametrize("seed", [4, 5])
def test_disney_sample_all_presets(seed):
    names, jt, tt = _tables()
    v, nrm, _, xi = _bsdf_inputs(seed)
    idx = np.arange(v.shape[0], dtype=np.int32) % len(names)
    jm, tm = jt.gather(jnp.asarray(idx)), tt.gather(T(idx))
    js = jdis.disney_sample(jm, jnp.asarray(v), jnp.asarray(nrm),
                            *(jnp.asarray(x) for x in xi))
    ts = tdis.disney_sample(tm, T(v), T(nrm), *(T(x) for x in xi))
    np.testing.assert_array_equal(ts.is_refract.numpy(),
                                  np.asarray(js.is_refract))
    close_ill_conditioned(ts.direction, js.direction)
    close_ill_conditioned(ts.f, js.f)
    close_ill_conditioned(ts.pdf, js.pdf)


def _env():
    from opengl_ray_tracing_framework_tpu.models.hdr import (
        build_env_fetch, build_hdr_cache, make_gradient_hdr)
    hdr = make_gradient_hdr(128, 64, bright_dir=(0.3, 0.8, 0.2))
    cache = build_hdr_cache(hdr)
    return hdr, cache, build_env_fetch(hdr, cache)


@pytest.mark.parametrize("angle", [0.0, 0.3])
def test_env_lookups_match(angle):
    hdr, cache, fetch = _env()
    h, w = hdr.shape[:2]
    rng = np.random.default_rng(6)
    d = unit(rng, 4096)
    xi1, xi2 = rng.random((2, 4096), dtype=np.float32)
    a_j, a_t = jnp.float32(angle), T(np.float32(angle))
    jh, th = jnp.asarray(hdr), T(hdr)
    jc, tc = jnp.asarray(cache), T(cache)
    jf, tf = jnp.asarray(fetch), T(fetch)

    for g, wnt in zip(
            tenv.env_sample_nearest(tf, h, w, T(xi1), T(xi2), a_t),
            jenv.env_sample_nearest(jf, h, w, jnp.asarray(xi1),
                                    jnp.asarray(xi2), a_j)):
        close(g, wnt)
    (trgb, tpdf), (jrgb, jpdf) = (
        tenv.env_radiance_pdf_nearest(tf, h, w, T(d), a_t),
        jenv.env_radiance_pdf_nearest(jf, h, w, jnp.asarray(d), a_j))
    close(trgb, jrgb)
    # the solid-angle pdf divides by sin(theta): near the poles asin's
    # ulps are amplified (d asin/dy = 1/sqrt(1 - y^2))
    close_ill_conditioned(tpdf, jpdf)
    close(tenv.hdr_color(th, T(d), a_t),
          jenv.hdr_color(jh, jnp.asarray(d), a_j))
    close_ill_conditioned(tenv.hdr_pdf(tc, T(d), a_t, w, h),
                          jenv.hdr_pdf(jc, jnp.asarray(d), a_j, w, h))
    close(tenv.sample_hdr_direction(tc, T(xi1), T(xi2)),
          jenv.sample_hdr_direction(jc, jnp.asarray(xi1), jnp.asarray(xi2)))
    close(tenv.default_sky_color(T(d[:, 1])),
          jenv.default_sky_color(jnp.asarray(d[:, 1])))


def test_tonemap_matches():
    rng = np.random.default_rng(8)
    c = rng.gamma(1.0, 1.0, (64, 64, 3)).astype(np.float32)
    for tm_on in (True, False):
        for gamma_on in (True, False):
            close(ttm.post_process(T(c), tm_on, gamma_on),
                  jtm.post_process(jnp.asarray(c), tm_on, gamma_on))
    for name in ("luminance_limit", "reinhard", "aces_fitted"):
        close(getattr(ttm, name)(T(c)), getattr(jtm, name)(jnp.asarray(c)))
