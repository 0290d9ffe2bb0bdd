"""Random numbers and importance-sampling primitives (PyTorch port of
opengl_ray_tracing_framework_tpu.ops.sampling).

Every uniform is counter-based: a stateless mix of (pixel_id, frame, salt),
so a given pixel, frame and call site draws the same number in both
packages and no torch.Generator is involved. torch has no full uint32
arithmetic, so the 32-bit words live in int64 tensors, masked to 32 bits
after every add, and multiplied in 16-bit halves so no product leaves
int64's range.

Sobol dimensions (2b, 2b+1) drive bounce b, padded mod 8 for b >= 4, each
bounce decorrelated per pixel by a Cranley-Patterson shift (glsl:590-620,
772-785). Direction samplers: cosine hemisphere (glsl:650-685), GTR1
half-vector (glsl:716-729), Heitz VNDF GGX (glsl:751-769),
Henyey-Greenstein (glsl:1195-1222).

A frozen copy of the port's ops/sampling.py, cut to what the BSDF integrator
of the benchmark's configurations calls, for the plain reference: it
imports nothing of the port, so a change there cannot move the yardstick.
"""

from __future__ import annotations

import numpy as np
import torch

from .microfacet import INV_4_PI, TWO_PI, safe_sqrt, sqr

_MASK32 = 0xFFFFFFFF
_INV_U32 = float(np.float32(1.0 / 4294967296.0))


def _u32(x, device=None) -> torch.Tensor:
    """A uint32 word (or array of them) as int64 in [0, 2^32)."""
    return torch.as_tensor(x, dtype=torch.int64, device=device) & _MASK32


def _mul32(x, c: int):
    """x * c mod 2^32 for x in [0, 2^32): split c in 16-bit halves so every
    partial product stays below 2^48."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def mix32(x):
    """Low-bias 32-bit integer mixer (splitmix32 finalizer). x: uint32
    words as int64."""
    x = _u32(x)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def rand01(pixel_id, frame, salt):
    """Stateless uniform in [0, 1) for (pixel, frame, call-site) triples,
    bit-identical to the JAX package's rand01 (ints wrap as uint32)."""
    device = pixel_id.device if torch.is_tensor(pixel_id) else None
    p = _u32(pixel_id, device)
    f = _u32(frame, device)
    s = _u32(salt, device)
    h = mix32((p + mix32((f + mix32((s + 0x9E3779B9) & _MASK32))
                         & _MASK32)) & _MASK32)
    return h.to(torch.float32) * _INV_U32


# Sobol sequence (Joe-Kuo direction numbers, 8 dimensions)

# (s, a, [m_1..m_s]) for dimensions 2..8 of the standard Joe-Kuo table
# (dimension 1 is the van der Corput sequence); see the JAX module for the
# relation to the reference's embedded constants (glsl:590-592).
_JOE_KUO = [
    (1, 0, [1]),
    (2, 1, [1, 3]),
    (3, 1, [1, 3, 1]),
    (3, 2, [1, 1, 1]),
    (4, 1, [1, 1, 3, 3]),
    (4, 4, [1, 3, 5, 13]),
    (5, 2, [1, 1, 5, 5, 17]),
]

N_SOBOL_DIMS = 8
_SOBOL_BITS = 32


def _compute_sobol_table() -> np.ndarray:
    """(8, 32) uint32 direction numbers v_j = m_j << (32 - j)."""
    table = np.zeros((N_SOBOL_DIMS, _SOBOL_BITS), dtype=np.uint64)
    for j in range(_SOBOL_BITS):
        table[0, j] = np.uint64(1) << np.uint64(31 - j)
    for d, (s, a, m_init) in enumerate(_JOE_KUO, start=1):
        m = list(m_init)
        for j in range(s, _SOBOL_BITS):
            new = m[j - s] ^ (m[j - s] << s)
            for k in range(1, s):
                if (a >> (s - 1 - k)) & 1:
                    new ^= m[j - k] << k
            m.append(new)
        for j in range(_SOBOL_BITS):
            table[d, j] = np.uint64(m[j]) << np.uint64(31 - j)
    return table.astype(np.uint32)


SOBOL_TABLE = _compute_sobol_table()


def cranley_patterson(u, shift):
    """Toroidal shift keeping u in [0, 1) (glsl:772-785)."""
    v = u + shift
    return v - torch.floor(v)


# Orthonormal bases


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _normalize(v, eps=1e-12):
    return v * (1.0 / torch.sqrt(torch.clamp(_dot(v, v), min=eps)))[..., None]


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def onb(n):
    """Tangent frame used by the BSDF path (getTangent, glsl:396-407).

    helper = (1,0,0) unless |N.x| > 0.999 then (0,0,1);
    B = normalize(N x helper); T = normalize(N x B).
    """
    cond = (torch.abs(n[..., 0]) > 0.999)[..., None]
    helper = torch.where(
        cond, torch.tensor([0.0, 0.0, 1.0], dtype=n.dtype, device=n.device),
        torch.tensor([1.0, 0.0, 0.0], dtype=n.dtype, device=n.device))
    b = _normalize(_cross(n, helper))
    t = _normalize(_cross(n, b))
    return t, b


def to_world(t, b, n, v):
    """Local (x=t, y=b, z=n) -> world (glsl:508-511)."""
    return v[..., 0:1] * t + v[..., 1:2] * b + v[..., 2:3] * n


def to_local(t, b, n, v):
    """World -> local (glsl:513-516)."""
    return torch.stack([_dot(v, t), _dot(v, b), _dot(v, n)], dim=-1)


# Direction samplers (local-frame vectors unless noted)


def cosine_sample_hemisphere(r1, r2):
    """Cosine-weighted hemisphere in local frame (glsl:650-659)."""
    r = safe_sqrt(r1)
    phi = TWO_PI * r2
    x = r * torch.cos(phi)
    y = r * torch.sin(phi)
    z = safe_sqrt(1.0 - x * x - y * y)
    return torch.stack([x, y, z], dim=-1)


def sample_gtr1(roughness, r1, r2):
    """GTR1 half-vector in local frame, with (r1 -> phi, r2 -> cos_theta)
    decorrelated like the JAX package (glsl:716-729 reuses r1)."""
    a = torch.clamp(roughness, min=0.001)
    a2 = a * a
    phi = r1 * TWO_PI
    cos_t = torch.sqrt((1.0 - torch.pow(a2, 1.0 - r2))
                       / torch.clamp(1.0 - a2, min=1e-12))
    sin_t = torch.clamp(safe_sqrt(1.0 - cos_t * cos_t), 0.0, 1.0)
    return torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi),
                        cos_t], dim=-1)


def sample_ggx_vndf(v_local, ax, ay, r1, r2):
    """Heitz visible-NDF GGX sampling in local frame (glsl:751-769)."""
    vx = ax * v_local[..., 0]
    vy = ay * v_local[..., 1]
    vz = v_local[..., 2]
    vh = _normalize(torch.stack([vx, vy, vz], dim=-1))

    lensq = sqr(vh[..., 0]) + sqr(vh[..., 1])
    inv_len = 1.0 / torch.sqrt(torch.clamp(lensq, min=1e-12))
    t1 = torch.where(
        (lensq > 0.0)[..., None],
        torch.stack([-vh[..., 1], vh[..., 0], torch.zeros_like(vz)], dim=-1)
        * inv_len[..., None],
        torch.tensor([1.0, 0.0, 0.0], dtype=vh.dtype, device=vh.device))
    t2 = _cross(vh, t1)

    r = safe_sqrt(r1)
    phi = TWO_PI * r2
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * safe_sqrt(1.0 - p1 * p1) + s * p2

    nh = (p1[..., None] * t1 + p2[..., None] * t2
          + safe_sqrt(1.0 - p1 * p1 - p2 * p2)[..., None] * vh)
    h = torch.stack([ax * nh[..., 0], ay * nh[..., 1],
                     torch.clamp(nh[..., 2], min=0.0)], dim=-1)
    return _normalize(h)


def sample_hg(v, g, r1, r2):
    """Henyey-Greenstein phase direction about world vector v
    (glsl:1195-1216)."""
    iso = torch.abs(g) < 0.001
    g_safe = torch.where(iso, 0.5, g)
    sqr_term = (1.0 - g_safe * g_safe) / (1.0 + g_safe - 2.0 * g_safe * r2)
    cos_aniso = -(1.0 + g_safe * g_safe - sqr_term * sqr_term) / (2.0 * g_safe)
    cos_t = torch.where(iso, 1.0 - 2.0 * r2, cos_aniso)

    phi = r1 * TWO_PI
    sin_t = torch.clamp(safe_sqrt(1.0 - cos_t * cos_t), 0.0, 1.0)
    t, b = onb(v)
    return (sin_t[..., None] * torch.cos(phi)[..., None] * t
            + sin_t[..., None] * torch.sin(phi)[..., None] * b
            + cos_t[..., None] * v)


def phase_hg(cos_theta, g):
    """Henyey-Greenstein phase function (glsl:1218-1222)."""
    denom = 1.0 + g * g + 2.0 * g * cos_theta
    return INV_4_PI * (1.0 - g * g) / (denom * safe_sqrt(denom))


def reflect(incident, n):
    """GLSL reflect: i - 2 dot(n, i) n."""
    return incident - 2.0 * _dot(n, incident)[..., None] * n


def refract(incident, n, eta):
    """GLSL refract; returns zero vector on total internal reflection."""
    cos_i = -_dot(incident, n)
    k = 1.0 - sqr(eta) * (1.0 - sqr(cos_i))
    tir = k < 0.0
    refr = (eta[..., None] * incident
            + (eta * cos_i - safe_sqrt(k))[..., None] * n)
    return torch.where(tir[..., None], 0.0, refr)
