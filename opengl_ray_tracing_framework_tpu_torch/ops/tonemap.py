"""Post-processing: tone mapping + gamma (PyTorch port of
opengl_ray_tracing_framework_tpu.ops.tonemap; the reference's
src/shaders/fragment_shader_tone_mapping.glsl):

- luminance-limited tone map          (glsl:14-17)
- Reinhard                            (glsl:19-22)
- ACES fitted (Hill/Baking Lab)       (glsl:29-64)
- simple ACES (Narkowicz) — default   (glsl:66-75, active at :83)
- gamma 1/2.2                         (glsl:88-90)
"""

from __future__ import annotations

import numpy as np
import torch

# sRGB => XYZ => D65->D60 => AP1 => RRT_SAT (tone_mapping.glsl:30-35); GLSL
# mat3 constructors are column-major and the shader multiplies color * M,
# so the map on a column vector is M^T with these rows.
_ACES_INPUT = np.array(
    [
        [0.59719, 0.35458, 0.04823],
        [0.07600, 0.90834, 0.01566],
        [0.02840, 0.13383, 0.83777],
    ],
    dtype=np.float32,
)

# ODT_SAT => XYZ => D60->D65 => sRGB (tone_mapping.glsl:38-43).
_ACES_OUTPUT = np.array(
    [
        [1.60475, -0.53108, -0.07367],
        [-0.10208, 1.10813, -0.00605],
        [-0.00327, -0.07276, 1.07602],
    ],
    dtype=np.float32,
)


def luminance_limit(c, limit=1.0):
    """c / (1 + lum/limit) with the shader's 0.3/0.6/0.1 weights (glsl:14-17)."""
    lum = 0.3 * c[..., 0] + 0.6 * c[..., 1] + 0.1 * c[..., 2]
    return c / (1.0 + lum / limit)[..., None]


def reinhard(c):
    """c / (c + 1) (glsl:19-22)."""
    return c / (c + 1.0)


def _rrt_odt_fit(v):
    a = v * (v + 0.0245786) - 0.000090537
    b = v * (0.983729 * v + 0.4329510) + 0.238081
    return a / b


def aces_fitted(c):
    """Full fitted ACES RRT+ODT (glsl:45-64)."""
    c = c @ torch.as_tensor(_ACES_INPUT.T, device=c.device)
    c = _rrt_odt_fit(c)
    c = c @ torch.as_tensor(_ACES_OUTPUT.T, device=c.device)
    return torch.clamp(c, 0.0, 1.0)


def simple_aces(c):
    """Narkowicz ACES approximation — the reference's active operator
    (glsl:66-75, used at :83)."""
    a, b, y, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((c * (a * c + b)) / (c * (y * c + d) + e), 0.0, 1.0)


def gamma_correct(c, gamma=2.2):
    """pow(c, 1/gamma) (glsl:88-90)."""
    return torch.pow(torch.clamp(c, min=0.0), 1.0 / gamma)


def post_process(c, enable_tone_mapping=True, enable_gamma=True):
    """The reference's display pipeline: simpleACES then gamma (glsl:77-93)."""
    if enable_tone_mapping:
        c = simple_aces(c)
    if enable_gamma:
        c = gamma_correct(c)
    return c
