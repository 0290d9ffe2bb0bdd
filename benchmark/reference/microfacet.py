"""Microfacet distributions, shadowing terms and Fresnel models (PyTorch
port of opengl_ray_tracing_framework_tpu.ops.microfacet).

Branchless shading math of the reference megakernel
(src/shaders/fragment_shader_ray_tracing.glsl):

- GTR1 (Berry) / anisotropic GTR2 (GGX)           (glsl:431-452)
- Smith-GGX masking, isotropic + anisotropic        (glsl:456-471)
- Schlick and exact dielectric Fresnel              (glsl:475-497)
- Disney metallic/dielectric Fresnel mix            (glsl:501-506)
- luminance + tint helpers                          (glsl:142-145, 410-427)

Every function broadcasts over leading batch dimensions. Expressions keep
the JAX package's operation order, so both round alike in float32.

A frozen copy of the port's ops/microfacet.py, cut to what the BSDF integrator
of the benchmark's configurations calls, for the plain reference: it
imports nothing of the port, so a change there cannot move the yardstick.
"""

from __future__ import annotations

import torch

PI = 3.14159265358979323
INV_PI = 1.0 / PI
TWO_PI = 2.0 * PI
INV_4_PI = 1.0 / (4.0 * PI)


def sqr(x):
    return x * x


def safe_sqrt(x, eps=1e-12):
    """sqrt with a strictly positive floor: keeps reverse-mode finite at the
    clamp boundary (d sqrt/dx at 0 is inf)."""
    return torch.sqrt(torch.clamp(x, min=eps))


def luminance(c):
    """Rec.709 luminance (glsl:142-145). c: (..., 3)."""
    return 0.212671 * c[..., 0] + 0.715160 * c[..., 1] + 0.072169 * c[..., 2]


def calculate_tint(base_color):
    """Hue-preserving tint: baseColor normalized by luminance (glsl:410-416)."""
    lum = luminance(base_color)[..., None]
    return torch.where(lum > 0.0, base_color / torch.clamp(lum, min=1e-12),
                       1.0)


def spec_and_sheen_color(base_color, specular_tint, sheen_tint, metallic, eta):
    """Specular F0 color and sheen color (GetSpecColor, glsl:420-427).

    eta is the relative IOR (incident/transmitted) at the interface.
    Returns (spec_col, sheen_col), each (..., 3).
    """
    ctint = calculate_tint(base_color)
    f0 = (1.0 - eta) / (1.0 + eta)
    f0 = sqr(f0)[..., None]
    white = torch.ones_like(ctint)
    tinted = white + specular_tint[..., None] * (ctint - white)
    spec_col = f0 * tinted
    m = metallic[..., None]
    spec_col = spec_col + m * (base_color - spec_col)
    sheen_col = white + sheen_tint[..., None] * (ctint - white)
    return spec_col, sheen_col


def gtr1(n_dot_h, alpha):
    """Berry distribution, gamma=1 (glsl:431-436). alpha>=1 -> 1/pi.
    alpha is floored at 0.001 like the matching sampler (glsl:718)."""
    alpha = torch.clamp(alpha, min=0.001)
    a2 = sqr(alpha)
    t = 1.0 + (a2 - 1.0) * sqr(n_dot_h)
    safe_a2 = torch.clamp(torch.where(a2 >= 1.0, 0.5, a2), min=1e-6)
    d = (safe_a2 - 1.0) / (PI * torch.log(safe_a2) * t)
    return torch.where(alpha >= 1.0, INV_PI, d)


def gtr2_aniso(n_dot_h, h_dot_x, h_dot_y, ax, ay):
    """Anisotropic GGX (glsl:447-452)."""
    c = sqr(h_dot_x / ax) + sqr(h_dot_y / ay) + sqr(n_dot_h)
    return 1.0 / (PI * ax * ay * sqr(c) + 1e-20)


def smith_g_ggx(n_dot_v, alpha_g):
    """Smith-GGX masking, isotropic, with the 2*NdotV numerator the
    reference uses (glsl:456-460)."""
    a = sqr(alpha_g)
    b = sqr(n_dot_v)
    return (2.0 * n_dot_v) / (n_dot_v + safe_sqrt(a + b - a * b) + 1e-20)


def smith_g_ggx_aniso(n_dot_v, v_dot_x, v_dot_y, ax, ay):
    """Smith-GGX masking, anisotropic (glsl:465-469)."""
    a = v_dot_x * ax
    b = v_dot_y * ay
    c = n_dot_v
    return (2.0 * n_dot_v) / (n_dot_v + safe_sqrt(sqr(a) + sqr(b) + sqr(c))
                              + 1e-20)


def schlick_fresnel(u):
    """(1-u)^5, clamped (glsl:475-479)."""
    m = torch.clamp(1.0 - u, 0.0, 1.0)
    return sqr(sqr(m)) * m


def dielectric_fresnel(cos_theta_i, eta):
    """Exact unpolarized dielectric Fresnel (glsl:483-497).

    eta = n_incident / n_transmitted. Returns 1 on total internal reflection.
    """
    sin2_t = sqr(eta) * (1.0 - sqr(cos_theta_i))
    cos_t = safe_sqrt(1.0 - sin2_t)
    rs = (eta * cos_t - cos_theta_i) / (eta * cos_t + cos_theta_i + 1e-20)
    rp = (eta * cos_theta_i - cos_t) / (eta * cos_theta_i + cos_t + 1e-20)
    f = 0.5 * (sqr(rs) + sqr(rp))
    return torch.where(sin2_t > 1.0, 1.0, f)


def disney_fresnel(metallic, eta, l_dot_h, v_dot_h):
    """Lerp of exact dielectric and Schlick-metallic Fresnel (glsl:501-506)."""
    fm = schlick_fresnel(l_dot_h)
    fd = dielectric_fresnel(torch.abs(v_dot_h), eta)
    return fd + metallic * (fm - fd)


def mix(a, b, t):
    """GLSL mix(a, b, t) = a + t*(b-a), broadcasting."""
    return a + t * (b - a)
