"""HDR environment map sampling and evaluation (PyTorch port of
opengl_ray_tracing_framework_tpu.ops.envmap).

- direction -> equirectangular uv with envAngle rotation  (glsl:625-631)
- radiance lookup, bilinear                                (glsl:1165-1169)
- the in-loop accesses: nearest-texel row fetches from the fused (H*W, 16)
  env_fetch table (hdr.build_env_fetch): the NEE light sample with its
  solid-angle pdf and radiance, and a direction's radiance and pdf

A frozen copy of the port's ops/envmap.py, cut to what the BSDF integrator
of the benchmark's configurations calls, for the plain reference: it
imports nothing of the port, so a change there cannot move the yardstick.
"""

from __future__ import annotations

import torch

from .microfacet import PI, TWO_PI


def bilinear_lookup(tex, u, v):
    """GL-style bilinear texture fetch: wrap in u, clamp in v.

    tex: (H, W, C); u, v: (...,) in [0, 1) texture coords (v=0 is row 0).
    Texel centers sit at (i + 0.5) / size, matching GL_LINEAR.
    """
    h, w = tex.shape[0], tex.shape[1]
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0 = x0.long()
    y0 = y0.long()
    x1 = torch.remainder(x0 + 1, w)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    x0 = torch.remainder(x0, w)
    y0 = torch.clamp(y0, 0, h - 1)
    t00 = tex[y0, x0]
    t01 = tex[y0, x1]
    t10 = tex[y1, x0]
    t11 = tex[y1, x1]
    top = t00 + fx * (t01 - t00)
    bot = t10 + fx * (t11 - t10)
    return top + fy * (bot - top)


def to_spherical_uv(v, env_angle):
    """Direction -> equirect uv, rotated by env_angle in u (glsl:625-631).
    Returns u (possibly > 1, callers wrap) and v in [0, 1], v=0 at +y."""
    u = torch.atan2(v[..., 2], v[..., 0]) / TWO_PI + 0.5 + env_angle
    vv = 1.0 - (torch.asin(torch.clamp(v[..., 1], -1.0, 1.0)) / PI + 0.5)
    return u, vv


def hdr_color(hdr_map, direction, env_angle):
    """Environment radiance along `direction` (glsl:1165-1169)."""
    u, v = to_spherical_uv(direction, env_angle)
    return bilinear_lookup(hdr_map, torch.remainder(u, 1.0), v)


def _texel_index(u, v, h, w):
    x = torch.clamp((torch.remainder(u, 1.0) * w).long(), 0, w - 1)
    y = torch.clamp((v * h).long(), 0, h - 1)
    return y * w + x


def env_sample_nearest(env_fetch, h, w, xi_1, xi_2, env_angle):
    """NEE light sample from the inverse-CDF cache: one row fetch.

    Returns (direction, pdf_solid_angle, radiance) of the sampled texel,
    the direction rotated by env_angle so it tracks the rotated radiance
    lookup (see the JAX module)."""
    g = env_fetch[_texel_index(xi_1, xi_2, h, w)]
    x, y, pdf_img = g[..., 4], g[..., 5], g[..., 6]
    yy = 1.0 - y
    phi = TWO_PI * (x - env_angle - 0.5)
    theta = PI * (yy - 0.5)
    cos_t = torch.cos(theta)
    direction = torch.stack(
        [cos_t * torch.cos(phi), torch.sin(theta), cos_t * torch.sin(phi)],
        dim=-1)
    sin_col = torch.clamp(torch.sin(PI * y), min=1e-10)
    pdf = pdf_img * (w * h) / (TWO_PI * PI * sin_col)
    return direction, pdf, g[..., 7:10]


def env_radiance_pdf_nearest(env_fetch, h, w, direction, env_angle):
    """Radiance + solid-angle pdf along `direction` (the bounce-miss MIS
    site, glsl:1483-1506): one row fetch."""
    u, v = to_spherical_uv(direction, env_angle)
    g = env_fetch[_texel_index(u, v, h, w)]
    sin_theta = torch.clamp(torch.sin(PI * v), min=1e-10)
    pdf = g[..., 3] * (w * h) / (TWO_PI * PI * sin_theta)
    return g[..., 0:3], pdf


