"""The plain reference path tracer: what one sample of a pixel should be.

Built from the benchmark's raw inputs alone (triangle soup with vertex
normals, per-triangle material slots, material values, the HDR image,
the camera pose): it derives its own environment tables (hdr.py) and its
own closest hit (cast.py). The shading is a frozen copy of the program's
BSDF integrator (ops/integrator.py `_bounce`, the reference's
shadingImportanceSampling_BSDF, glsl:1369-1516), of its surface
attributes (ops/intersect.py) and of its camera (models/camera.py), for
the settings the benchmark's configurations use: BSDF mode, the HDR
environment with MIS, nearest-texel environment fetches, no pixel jitter.

Every ray carries its own pixel id and 1-based frame, so the samples of
many progressive passes trace as one batch; the counter-based streams
(sampling.rand01, the Sobol points) make each the sample the program drew.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from . import disney
from .cast import Caster
from .envmap import env_radiance_pdf_nearest, env_sample_nearest, hdr_color
from .hdr import build_env_fetch, build_hdr_cache
from .sampling import (
    SOBOL_TABLE,
    N_SOBOL_DIMS,
    _INV_U32,
    _cross,
    _dot,
    cranley_patterson,
    phase_hg,
    rand01,
    sample_hg,
)

MEDIUM_ABSORB, MEDIUM_SCATTER, MEDIUM_EMISSIVE = 1, 2, 3
_EPS_PDF = 1e-10
FIELDS = ("emissive", "base_color", "subsurface", "metallic", "specular",
          "specular_tint", "roughness", "anisotropic", "sheen", "sheen_tint",
          "clearcoat", "clearcoat_gloss", "ior", "transmission",
          "medium_color", "medium_type", "medium_density",
          "medium_anisotropy")


class Material(NamedTuple):
    """Disney material fields (Material.h:25-50), each (M, ...) or per hit."""

    emissive: torch.Tensor
    base_color: torch.Tensor
    subsurface: torch.Tensor
    metallic: torch.Tensor
    specular: torch.Tensor
    specular_tint: torch.Tensor
    roughness: torch.Tensor
    anisotropic: torch.Tensor
    sheen: torch.Tensor
    sheen_tint: torch.Tensor
    clearcoat: torch.Tensor
    clearcoat_gloss: torch.Tensor
    ior: torch.Tensor
    transmission: torch.Tensor
    medium_color: torch.Tensor
    medium_type: torch.Tensor
    medium_density: torch.Tensor
    medium_anisotropy: torch.Tensor

    def alpha_xy(self):
        aspect = torch.sqrt(1.0 - self.anisotropic * 0.9)
        r2 = torch.square(self.roughness)
        return (torch.clamp(r2 / aspect, min=0.001),
                torch.clamp(r2 * aspect, min=0.001))


def material_table(values: list, device) -> Material:
    """Stacked Material of (M, ...) tensors from a list of dicts of field
    values (the configuration's materials)."""
    cols = []
    for f in FIELDS:
        dtype = torch.int32 if f == "medium_type" else torch.float32
        cols.append(torch.tensor([v[f] for v in values], dtype=dtype,
                                 device=device))
    return Material(*cols)


@dataclasses.dataclass
class RefScene:
    p1: torch.Tensor
    p2: torch.Tensor
    p3: torch.Tensor
    n1: torch.Tensor
    n2: torch.Tensor
    n3: torch.Tensor
    mat_idx: torch.Tensor        # (N,) int64 material slot per triangle
    materials: Material          # (M, ...) fields
    hdr_map: torch.Tensor        # (H, W, 3) the raw image
    env_fetch: torch.Tensor      # (H*W, 16), derived here from the image
    hdr_hw: tuple
    env_intensity: float
    env_angle: float
    caster: Caster

    def material_of(self, tri):
        slot = self.mat_idx[torch.clamp(tri, 0, self.p1.shape[0] - 1)]
        return Material(*(x[slot] for x in self.materials))


def build_scene(raw, device, materials=None) -> RefScene:
    """The reference's scene from the raw inputs (inputs.RawScene);
    `materials` replaces the table (a grad step's leaves)."""
    t = lambda a: torch.as_tensor(np.asarray(a), device=device)
    hdr = np.asarray(raw.hdr, np.float32)
    env_fetch = build_env_fetch(hdr, build_hdr_cache(hdr))
    p1, p2, p3 = t(raw.p1), t(raw.p2), t(raw.p3)
    nrm = []
    for n in (raw.n1, raw.n2, raw.n3):   # unit length, as the renderer
        n = np.asarray(n, np.float64)     # reads them (Triangle.h:91-95)
        n = n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-20)
        nrm.append(t(n.astype(np.float32)))
    return RefScene(
        p1=p1, p2=p2, p3=p3, n1=nrm[0], n2=nrm[1], n3=nrm[2],
        mat_idx=t(raw.mat_idx).long(),
        materials=(materials if materials is not None
                   else material_table(raw.materials, device)),
        hdr_map=t(hdr), env_fetch=t(env_fetch), hdr_hw=hdr.shape[:2],
        env_intensity=float(raw.env_intensity),
        env_angle=float(raw.env_angle), caster=Caster(p1, p2, p3))


def camera_rays(cam: dict, u, v):
    """Primary rays through film coordinates u, v (Camera.h:160-173,
    glsl:1525-1527); cam: position, yaw, pitch, zoom, aspect."""
    f = lambda x: torch.as_tensor(x, dtype=torch.float32, device=u.device)
    norm = lambda x: torch.sqrt(torch.sum(x * x, dim=-1))
    yaw, pitch = torch.deg2rad(f(cam["yaw"])), torch.deg2rad(f(cam["pitch"]))
    cp = torch.cos(pitch)
    front = torch.stack([torch.cos(yaw) * cp, torch.sin(pitch),
                         torch.sin(yaw) * cp])
    front = front / norm(front)
    right = torch.linalg.cross(front, f([0.0, 1.0, 0.0]))
    right = right / torch.clamp(norm(right), min=1e-12)
    up = torch.linalg.cross(right, front)
    up = up / torch.clamp(norm(up), min=1e-12)
    half_h = torch.tan(torch.deg2rad(f(cam["zoom"])))
    half_w = half_h * f(cam["aspect"])
    lbc = front - half_w * right - half_h * up
    d = (lbc[None, :] + (2.0 * u * half_w)[..., None] * right
         + (2.0 * v * half_h)[..., None] * up)
    d = d / norm(d)[..., None]
    return torch.broadcast_to(f(cam["position"]), d.shape), d


def sobol_points(frames: torch.Tensor) -> torch.Tensor:
    """(8, R) Sobol points of each ray's frame (Gray-code order,
    glsl:598-620)."""
    uniq, inv = torch.unique(frames.cpu(), return_inverse=True)
    pts = np.zeros((uniq.numel(), N_SOBOL_DIMS), np.uint32)
    for i, index in enumerate(uniq.tolist()):
        g = int(index) & 0xFFFFFFFF
        g ^= g >> 1
        for j in range(32):
            if (g >> j) & 1:
                pts[i] ^= SOBOL_TABLE[:, j]
    table = torch.as_tensor(pts.astype(np.int64)).to(torch.float32) \
        * _INV_U32
    return table[inv].T.contiguous().to(frames.device)


def surface(scene, origin, direction, t, tri, inside):
    """Hit point, shading normal (areal barycentrics, flipped inside),
    V = -d and the material of a hit (ops/intersect.py)."""
    safe = torch.clamp(tri, 0, scene.p1.shape[0] - 1)
    p1, p2, p3 = scene.p1[safe], scene.p2[safe], scene.p3[safe]
    n1, n2, n3 = scene.n1[safe], scene.n2[safe], scene.n3[safe]
    n_geo = _cross(p2 - p1, p3 - p1)
    denom = _dot(n_geo, direction)
    denom = torch.where(torch.abs(denom) < 1e-12,
                        torch.where(denom < 0, -1e-12, 1e-12), denom)
    t_diff = _dot(n_geo, p1 - origin) / denom - 1e-5
    t = t + (t_diff - t_diff.detach())
    p = origin + direction * t[..., None]
    den = torch.clamp(_dot(n_geo, n_geo), min=1e-30)
    w1 = _dot(_cross(p3 - p2, p - p2), n_geo) / den
    w2 = _dot(_cross(p1 - p3, p - p3), n_geo) / den
    w3 = 1.0 - w1 - w2
    ns = w1[..., None] * n1 + w2[..., None] * n2 + w3[..., None] * n3
    ns = ns / torch.sqrt(torch.clamp(_dot(ns, ns), min=1e-30))[..., None]
    ns = torch.where(inside[..., None], -ns, ns)
    return p, ns, -direction, scene.material_of(tri)


def _mis(a, b):
    t = a * a
    return t / torch.clamp(t + b * b, min=1e-20)


def _rcp(x, eps=_EPS_PDF):
    return 1.0 / torch.clamp(x, min=eps)


def _bounce(scene, b, frame, sobol, pid, origin, direction, t, tri, inside,
            history, lo):
    """One BSDF bounce (glsl:1369-1516) for the rays alive at its start."""
    hit_point, n, v, mat = surface(scene, origin, direction, t, tri, inside)
    hh, ww = scene.hdr_hw
    env = scene.env_fetch

    xl1 = rand01(pid, frame, 8 * b + 0)
    xl2 = rand01(pid, frame, 8 * b + 1)
    l_dir, light_pdf, light_fr = env_sample_nearest(env, hh, ww, xl1, xl2,
                                                    scene.env_angle)
    light_fr = light_fr * scene.env_intensity
    facing = torch.sum(n * l_dir, dim=-1) > 0.0

    u = sobol[(2 * b) % N_SOBOL_DIMS]
    vv = sobol[(2 * b + 1) % N_SOBOL_DIMS]
    xi1 = cranley_patterson(u, rand01(pid, frame, 8 * b + 2))
    xi2 = cranley_patterson(vv, rand01(pid, frame, 8 * b + 3))
    xi3 = rand01(pid, frame, 8 * b + 4)

    smp = disney.disney_sample(mat, v, n, xi1, xi2, xi3)
    alive = smp.pdf > _EPS_PDF

    refract = alive & smp.is_refract
    med_absorb = refract & (mat.medium_type == MEDIUM_ABSORB)
    med_emissive = refract & (mat.medium_type == MEDIUM_EMISSIVE)
    med_scatter_t = refract & (mat.medium_type == MEDIUM_SCATTER)

    dens = mat.medium_density
    absorb_mult = torch.exp(-(1.0 - mat.medium_color)
                            * t[..., None] * dens[..., None])
    lo = lo + torch.where(
        med_emissive[..., None],
        mat.medium_color * (t * dens)[..., None] * history, 0.0)

    scatter_dist = torch.minimum(
        -torch.log(torch.clamp(xi3, min=1e-12)) * _rcp(dens, 1e-6), t)
    med_sampled = med_scatter_t & (scatter_dist < t)
    hg_dir = sample_hg(v, mat.medium_anisotropy, xi1, xi2)
    hg_pdf = phase_hg(torch.sum(v * hg_dir, dim=-1), mat.medium_anisotropy)

    surf_mult = smp.f * _rcp(smp.pdf)[..., None]
    surf_mult = torch.where(med_absorb[..., None], surf_mult * absorb_mult,
                            surf_mult)
    scatter_mult = mat.medium_color * torch.exp(-scatter_dist)[..., None]
    mult = torch.where(med_sampled[..., None], scatter_mult, surf_mult)
    new_history = torch.where(alive[..., None], history * mult, history)

    new_dir = torch.where(med_sampled[..., None], hg_dir, smp.direction)
    scatter_org = hit_point + direction * scatter_dist[..., None]
    new_org = torch.where(med_sampled[..., None], scatter_org, hit_point)

    _, pdf_eval_dir = disney.disney_eval(mat, v, n, new_dir)
    pdf_for_mis = torch.where(med_sampled, hg_pdf, pdf_eval_dir)

    with torch.no_grad():
        caster = scene.caster
        shadow = caster.closest_hit(hit_point.detach(), l_dir.detach(),
                                    facing, any_hit=True)
        nxt = caster.closest_hit(new_org.detach(), new_dir.detach(), alive)
    vis = facing & ~(shadow[1] >= 0)
    f_eval, pdf_eval = disney.disney_eval(mat, v, n, l_dir)
    w = _mis(light_pdf, pdf_eval)
    contrib = (w * _rcp(light_pdf))[..., None] * history * light_fr * f_eval
    lo = lo + torch.where(vis[..., None], contrib, 0.0)
    nxt_hit = nxt[1] >= 0
    nxt_miss = alive & ~nxt_hit

    env_fr, light_pdf2 = env_radiance_pdf_nearest(env, hh, ww, new_dir,
                                                  scene.env_angle)
    env_fr = env_fr * scene.env_intensity
    w2 = torch.where(med_sampled, 1.0, _mis(pdf_for_mis, light_pdf2))
    lo = lo + torch.where(nxt_miss[..., None],
                          w2[..., None] * new_history * env_fr, 0.0)
    le = scene.material_of(nxt[1]).emissive
    lo = lo + torch.where((alive & nxt_hit)[..., None], new_history * le, 0.0)
    return lo, new_history, new_org, new_dir, nxt, alive


def trace(scene, cam, frame_w, frame_h, max_bounce, pixel_id, frame):
    """Radiance (R, 3) of one sample of each (pixel_id, frame) pair
    (glsl main, 1518-1550): pixel centers, the primary cast, then
    max_bounce bounces on the rays still alive."""
    px = (pixel_id % frame_w).to(torch.float32)
    py = (pixel_id // frame_w).to(torch.float32)
    origin, direction = camera_rays(cam, (px + 0.5) / frame_w,
                                    (py + 0.5) / frame_h)
    with torch.no_grad():
        t0, tri0, in0 = scene.caster.closest_hit(origin, direction)
    hit0 = tri0 >= 0
    miss_rgb = hdr_color(scene.hdr_map, direction, scene.env_angle) \
        * scene.env_intensity

    lo_out = torch.zeros_like(origin)
    lanes = torch.nonzero(hit0).squeeze(1)
    o, d = origin[lanes], direction[lanes]
    t, tri, inside = t0[lanes], tri0[lanes], in0[lanes]
    history = torch.ones_like(o)
    lo = torch.zeros_like(o)
    sobol = sobol_points(frame)
    for b in range(max_bounce):
        if lanes.numel() == 0:
            break
        lo, history, o, d, nxt, alive = _bounce(
            scene, b, frame[lanes], sobol[:, lanes], pixel_id[lanes], o, d,
            t, tri, inside, history, lo)
        lo_out = lo_out.index_put((lanes,), lo)
        keep = torch.nonzero(alive & (nxt[1] >= 0)).squeeze(1)
        lanes, o, d, history, lo = (x[keep] for x in
                                    (lanes, o, d, history, lo))
        t, tri, inside = nxt[0][keep], nxt[1][keep], nxt[2][keep]
    le0 = scene.material_of(tri0).emissive
    return torch.where(hit0[..., None], le0 + lo_out, miss_rgb)

