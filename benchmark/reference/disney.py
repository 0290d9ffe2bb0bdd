"""Disney-principled BSDF: evaluation and sampling (PyTorch port of opengl_ray_tracing_framework_tpu.ops.disney).

- lobe weights                    CalculateBSDFLobePdfs   glsl:537-550
- diffuse + sheen + subsurface    EvalDiffuse             glsl:925-948
- specular reflection (aniso GGX) EvalSpecReflection      glsl:950-964
- specular refraction             EvalSpecRefraction      glsl:966-984
- clearcoat (GTR1)                EvalClearcoat           glsl:986-1000
- combined eval                   DisneyEval              glsl:1002-1067
- combined sample                 DisneySample            glsl:1070-1161

Every lobe is evaluated for every ray and the result selected, with safe
denominators so unselected lanes carry no NaN/Inf. The documented
deviations of the JAX module are kept (dot(V,H) for the sample Fresnel,
the decorrelated clearcoat sampler, the _COS_EPS/_DENOM_EPS cutoffs).

A frozen copy of the port's ops/disney.py, cut to what the BSDF integrator
of the benchmark's configurations calls, for the plain reference: it
imports nothing of the port, so a change there cannot move the yardstick.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .microfacet import (
    INV_PI,
    calculate_tint,
    dielectric_fresnel,
    disney_fresnel,
    gtr1,
    gtr2_aniso,
    luminance,
    mix,
    safe_sqrt,
    schlick_fresnel,
    smith_g_ggx,
    smith_g_ggx_aniso,
    spec_and_sheen_color,
    sqr,
)
from .sampling import (
    _dot,
    _normalize,
    cosine_sample_hemisphere,
    onb,
    reflect,
    refract,
    sample_ggx_vndf,
    sample_gtr1,
    to_local,
    to_world,
)

_EPS = 1e-10

# Grazing-angle cutoff (cosine) and half-vector-Jacobian cutoff below which a
# lobe is treated as zero (the JAX module's reasons: bounded primal and
# cotangents; the measure-zero sliver is invisible in the image).
_COS_EPS = 1e-4
_DENOM_EPS = 1e-3


def _mask1(ok, x, sub=1.0):
    """Substitute `sub` on masked-off lanes BEFORE x enters a division."""
    return torch.where(ok, x, sub)


class BsdfSample(NamedTuple):
    f: torch.Tensor            # bsdf * |cos| (..., 3)
    direction: torch.Tensor    # world-space sampled direction (..., 3)
    pdf: torch.Tensor          # (...,)
    is_refract: torch.Tensor   # bool (...,)


def lobe_weights(mat, eta, spec_col, approx_fresnel):
    """Radiance-based lobe selection weights (glsl:537-550)."""
    lum_base = luminance(mat.base_color)
    one_m_metal = 1.0 - mat.metallic
    r_diffuse = one_m_metal * (1.0 - mat.transmission) * lum_base
    r_specular = luminance(
        spec_col + approx_fresnel[..., None] * (1.0 - spec_col))
    r_clearcoat = one_m_metal * 0.25 * mat.clearcoat
    r_refract = (one_m_metal * mat.transmission * lum_base
                 * (1.0 - approx_fresnel))
    inv_sum = 1.0 / torch.clamp(
        r_diffuse + r_specular + r_clearcoat + r_refract, min=_EPS)
    return (r_diffuse * inv_sum, r_specular * inv_sum,
            r_refract * inv_sum, r_clearcoat * inv_sum)


def eval_diffuse(mat, sheen_col, v, l, h):
    """Burley diffuse + fake subsurface + sheen, local frame (glsl:925-948).
    Returns (f, pdf); both zero where l.z <= _COS_EPS."""
    lz = l[..., 2]
    vz = v[..., 2]
    valid = lz > _COS_EPS

    lz = _mask1(valid, lz)
    ldoth = _dot(l, h)
    fl = schlick_fresnel(lz)
    fv = schlick_fresnel(vz)
    fh = schlick_fresnel(ldoth)
    fd90 = 0.5 + 2.0 * sqr(ldoth) * mat.roughness
    fd = mix(1.0, fd90, fl) * mix(1.0, fd90, fv)

    fss90 = sqr(ldoth) * mat.roughness
    fss = mix(1.0, fss90, fl) * mix(1.0, fss90, fv)
    ss = 1.25 * (fss * (1.0 / torch.clamp(lz + vz, min=_COS_EPS) - 0.5)
                 + 0.5)

    f_sheen = fh[..., None] * mat.sheen[..., None] * sheen_col
    scale = (1.0 - mat.metallic) * (1.0 - mat.transmission)
    f = scale[..., None] * (
        INV_PI * mix(fd, ss, mat.subsurface)[..., None] * mat.base_color
        + f_sheen)
    pdf = lz * INV_PI
    return (torch.where(valid[..., None], f, 0.0),
            torch.where(valid, pdf, 0.0))


def eval_spec_reflection(mat, eta, spec_col, v, l, h):
    """Anisotropic GGX reflection with VNDF pdf, local frame (glsl:950-964)."""
    lz = l[..., 2]
    vz = v[..., 2]
    valid = (lz > _COS_EPS) & (vz > _COS_EPS)

    lz = _mask1(valid, lz)
    vz = _mask1(valid, vz)
    ax, ay = mat.alpha_xy()
    fm = disney_fresnel(mat.metallic, eta, _dot(l, h), _dot(v, h))
    f_col = spec_col + fm[..., None] * (1.0 - spec_col)
    d = gtr2_aniso(h[..., 2], h[..., 0], h[..., 1], ax, ay)
    g1 = smith_g_ggx_aniso(vz, v[..., 0], v[..., 1], ax, ay)
    g2 = g1 * smith_g_ggx_aniso(lz, l[..., 0], l[..., 1], ax, ay)

    pdf = g1 * d / (4.0 * vz)
    f = f_col * (d * g2 / (4.0 * lz * vz))[..., None]
    return (torch.where(valid[..., None], f, 0.0),
            torch.where(valid, pdf, 0.0))


def eval_spec_refraction(mat, eta, v, l, h):
    """Rough dielectric transmission, local frame (glsl:966-984); zero
    outside the transmitted hemisphere."""
    lz = l[..., 2]
    vz = v[..., 2]
    vdoth = _dot(v, h)
    ldoth = _dot(l, h)
    denom_raw = ldoth + vdoth * eta
    valid = ((lz < -_COS_EPS) & (vz > _COS_EPS)
             & (torch.abs(denom_raw) > _DENOM_EPS))

    lz = _mask1(valid, lz, -1.0)
    vz = _mask1(valid, vz)
    denom = sqr(_mask1(valid, denom_raw))
    ax, ay = mat.alpha_xy()
    fr = dielectric_fresnel(torch.abs(vdoth), eta)
    d = gtr2_aniso(h[..., 2], h[..., 0], h[..., 1], ax, ay)
    g1 = smith_g_ggx_aniso(torch.abs(vz), v[..., 0], v[..., 1], ax, ay)
    g2 = g1 * smith_g_ggx_aniso(torch.abs(lz), l[..., 0], l[..., 1], ax, ay)
    jacobian = torch.abs(ldoth) / denom

    pdf = g1 * torch.clamp(vdoth, min=0.0) * d * jacobian / vz
    scale = ((1.0 - mat.metallic) * mat.transmission * (1.0 - fr) * d * g2
             * torch.abs(vdoth) * jacobian * sqr(eta)
             / torch.abs(lz * vz))
    f = safe_sqrt(mat.base_color) * scale[..., None]
    return (torch.where(valid[..., None], f, 0.0),
            torch.where(valid, pdf, 0.0))


def eval_clearcoat(mat, v, l, h):
    """GTR1 clearcoat lobe, local frame (glsl:986-1000)."""
    lz = l[..., 2]
    vz = v[..., 2]
    vdoth = _dot(v, h)
    valid = (lz > _COS_EPS) & (vz > _COS_EPS) & (torch.abs(vdoth) > _COS_EPS)

    lz = _mask1(valid, lz)
    vz = _mask1(valid, vz)
    vdoth = _mask1(valid, vdoth)
    fh = dielectric_fresnel(vdoth, 1.0 / 1.5)
    f_c = mix(0.04, 1.0, fh)
    d = gtr1(h[..., 2], mat.clearcoat_gloss)
    g = smith_g_ggx(lz, 0.25) * smith_g_ggx(vz, 0.25)
    jacobian = 1.0 / (4.0 * vdoth)

    pdf = d * h[..., 2] * jacobian
    f = (0.25 * mat.clearcoat * f_c * d * g
         / (4.0 * lz * vz))[..., None] * torch.ones(3, dtype=lz.dtype,
                                                    device=lz.device)
    return (torch.where(valid[..., None], f, 0.0),
            torch.where(valid, pdf, 0.0))


def _eta_of(mat, v_world, n):
    """Relative IOR (glsl:1010); 1/IOR in practice since the shading normal
    faces the viewer."""
    return torch.where(_dot(v_world, n) > 0.0, 1.0 / mat.ior, mat.ior)


def disney_eval(mat, v_world, n, l_world):
    """Full BSDF evaluation (DisneyEval, glsl:1002-1067).

    v_world: unit vector toward the viewer; n: shading normal oriented
    toward the viewer; l_world: sampled direction. Returns (f * |cos|, pdf).
    """
    eta = _eta_of(mat, v_world, n)
    t, b = onb(n)
    v = to_local(t, b, n, v_world)
    l = to_local(t, b, n, l_world)

    lz = l[..., 2]
    h_refl = l + v
    h_refr = l + v * eta[..., None]
    h = _normalize(torch.where((lz > 0.0)[..., None], h_refl, h_refr))
    h = torch.where((h[..., 2] < 0.0)[..., None], -h, h)

    spec_col, sheen_col = spec_and_sheen_color(
        mat.base_color, mat.specular_tint, mat.sheen_tint, mat.metallic, eta)
    fresnel = disney_fresnel(mat.metallic, eta, _dot(l, h), _dot(v, h))
    w_diff, w_refl, w_refr, w_coat = lobe_weights(mat, eta, spec_col, fresnel)

    f = torch.zeros_like(mat.base_color)
    pdf = torch.zeros_like(lz)

    fd, pd = eval_diffuse(mat, sheen_col, v, l, h)
    g = (w_diff > 0.0) & (lz > 0.0)
    f = f + torch.where(g[..., None], fd, 0.0)
    pdf = pdf + torch.where(g, pd * w_diff, 0.0)

    fs, ps = eval_spec_reflection(mat, eta, spec_col, v, l, h)
    g = (w_refl > 0.0) & (lz > 0.0) & (v[..., 2] > 0.0)
    f = f + torch.where(g[..., None], fs, 0.0)
    pdf = pdf + torch.where(g, ps * w_refl, 0.0)

    ft, pt = eval_spec_refraction(mat, eta, v, l, h)
    g = (w_refr > 0.0) & (lz < 0.0)
    f = f + torch.where(g[..., None], ft, 0.0)
    pdf = pdf + torch.where(g, pt * w_refr, 0.0)

    fc, pc = eval_clearcoat(mat, v, l, h)
    g = (w_coat > 0.0) & (lz > 0.0) & (v[..., 2] > 0.0)
    f = f + torch.where(g[..., None], fc, 0.0)
    pdf = pdf + torch.where(g, pc * w_coat, 0.0)

    return f * torch.abs(lz)[..., None], pdf


def disney_sample(mat, v_world, n, r1, r2, r3):
    """Importance-sample the BSDF (DisneySample, glsl:1070-1161).

    Returns BsdfSample(f*|cos|, world direction, single-lobe pdf weighted by
    its selection probability, is_refract). The lobe CDF's stretch of r1 is
    detached, as in the JAX module.
    """
    eta = _eta_of(mat, v_world, n)
    t, b = onb(n)
    v = to_local(t, b, n, v_world)

    spec_col, sheen_col = spec_and_sheen_color(
        mat.base_color, mat.specular_tint, mat.sheen_tint, mat.metallic, eta)
    approx_fresnel = disney_fresnel(mat.metallic, eta, v[..., 2], v[..., 2])
    w_diff, w_refl, w_refr, w_coat = lobe_weights(
        mat, eta, spec_col, approx_fresnel)

    cdf0 = w_diff
    cdf1 = cdf0 + w_coat
    cdf0_d = cdf0.detach()
    cdf1_d = cdf1.detach()

    # diffuse lobe
    r1_d = r1 / torch.clamp(cdf0_d, min=1e-6)
    l_d = cosine_sample_hemisphere(torch.clamp(r1_d, 0.0, 1.0), r2)
    h_d = _normalize(l_d + v)
    f_d, pdf_d = eval_diffuse(mat, sheen_col, v, l_d, h_d)
    pdf_d = pdf_d * w_diff

    # clearcoat lobe
    r1_c = (r1 - cdf0_d) / torch.clamp(cdf1_d - cdf0_d, min=1e-6)
    h_c = sample_gtr1(mat.clearcoat_gloss, torch.clamp(r1_c, 0.0, 1.0), r2)
    h_c = torch.where((h_c[..., 2] < 0.0)[..., None], -h_c, h_c)
    l_c = _normalize(reflect(-v, h_c))
    f_c, pdf_c = eval_clearcoat(mat, v, l_c, h_c)
    pdf_c = pdf_c * w_coat

    # specular reflect / refract lobes
    r1_s = (r1 - cdf1_d) / torch.clamp(1.0 - cdf1_d, min=1e-6)
    ax, ay = mat.alpha_xy()
    h_s = sample_ggx_vndf(v, ax, ay, torch.clamp(r1_s, 0.0, 1.0), r2)
    h_s = torch.where((h_s[..., 2] < 0.0)[..., None], -h_s, h_s)

    vdoth = _dot(v, h_s)
    fresnel_s = disney_fresnel(mat.metallic, eta, vdoth, vdoth)
    f_pick = 1.0 - ((1.0 - fresnel_s) * mat.transmission
                    * (1.0 - mat.metallic))

    l_r = _normalize(reflect(-v, h_s))
    f_r, pdf_r = eval_spec_reflection(mat, eta, spec_col, v, l_r, h_s)
    pdf_r = pdf_r * f_pick

    l_t = _normalize(refract(-v, h_s, eta))
    f_t, pdf_t = eval_spec_refraction(mat, eta, v, l_t, h_s)
    pdf_t = pdf_t * (1.0 - f_pick)

    spec_mass = w_refl + w_refr
    pdf_r = pdf_r * spec_mass
    pdf_t = pdf_t * spec_mass

    # select
    pick_diff = r1 < cdf0
    pick_coat = (~pick_diff) & (r1 < cdf1)
    pick_spec = (~pick_diff) & (~pick_coat)
    pick_refr = pick_spec & (r3 >= f_pick)
    pick_refl = pick_spec & (r3 < f_pick)

    def sel(mask, x, y):
        return torch.where(mask[..., None] if x.ndim > mask.ndim else mask,
                           x, y)

    l_local = sel(pick_diff, l_d,
                  sel(pick_coat, l_c, sel(pick_refl, l_r, l_t)))
    f = sel(pick_diff, f_d, sel(pick_coat, f_c, sel(pick_refl, f_r, f_t)))
    pdf = torch.where(pick_diff, pdf_d,
                      torch.where(pick_coat, pdf_c,
                                  torch.where(pick_refl, pdf_r, pdf_t)))

    l_world = to_world(t, b, n, l_local)
    fcos = f * torch.abs(l_local[..., 2])[..., None]
    return BsdfSample(f=fcos, direction=l_world, pdf=pdf,
                      is_refract=pick_refr)

