"""Wavefront path-tracing integrator, BSDF and legacy BRDF modes (PyTorch
port of opengl_ray_tracing_framework_tpu.ops.integrator).

The reference's per-fragment integrator shadingImportanceSampling_BSDF
(src/shaders/fragment_shader_ray_tracing.glsl:1369-1516) and kernel main
(glsl:1518-1550), batched over rays. Per bounce:
  1. next-event estimation toward the HDR environment with a shadow ray
     and power-heuristic MIS (glsl:1379-1406),
  2. Sobol-driven BSDF sampling with per-pixel Cranley-Patterson rotation
     (glsl:1408-1421),
  3. participating media on refraction: Beer-Lambert ABSORB, EMISSIVE
     line integral, SCATTER with Henyey-Greenstein phase (glsl:1429-1458),
  4. one merged shadow + bounce cast; on a miss the MIS-weighted
     environment (or the gradient sky), on a hit the emissive pickup
     (glsl:1476-1513).
The JAX module's documented deviations from the reference (single
application of f/pdf per interaction, NEE gated on enable_env_map) hold
here too. RenderConfig(enable_bsdf=False) selects the 3-lobe BRDF
integrator (shadingImportanceSampling, glsl:1290-1366): no media, an
explicit |cos| factor, and the power heuristic applied whatever
enable_mis says, as the reference does in that mode.

Compaction: each bounce runs only on the rays alive at its start (an
index of the live lanes, a dynamic shape), and writes their radiance back.
Exact for the JAX module's reason: a dead lane contributes nothing again,
so its radiance is final when it dies.

Autograd: everything here is differentiable with respect to the scene's
float tensors and the ray tensors except the casts, which are detached
(ops/traverse.py). The per-bounce write of the live lanes' radiance into
the output is an in-place index_put_: nothing saved for the backward reads
that tensor, and a lane a later bounce overwrites gets its gradient from
that later write only, which is the compaction's exactness argument again.

The BSDF bounce's shading is ops/shade.py's: on a CUDA device, when
autograd records nothing and the env map is sampled at its nearest
texels, one csrc/shade.cu kernel at each of its three sites (shade_light,
shade_bsdf, shade_env); otherwise the plain PyTorch code, which is their
specification and what the CPU and the gradient paths run.

Spans (utils/timing.py's tracing()): rt.bounce around each bounce, inside
it rt.shade.surface / .light / .bsdf / .env and the cast's rt.cast (the
kernels' bounce: shade_light in rt.shade.light, shade_bsdf in .bsdf,
shade_env in .env), and
rt.sync around each torch.nonzero of the compaction, the render loop's
only waits on the device; counters bounces, bounce_lanes (live lanes at a
bounce's start, known on the host after the nonzero) and syncs.
"""

from __future__ import annotations

import torch

from ..utils.timing import count, span
from . import disney, shade
from .envmap import default_sky_color, hdr_color
from .intersect import surface_attributes
from .sampling import (
    cranley_patterson,
    onb,
    rand01,
    sobol_all_dims,
    sobol_bounce_uv,
)
from .shade import (
    EPS_PDF,
    env_miss_radiance_pdf,
    env_pickup,
    light_sample,
    mis_weight,
    safe_rcp,
    shade_bsdf,
    shade_bsdf_plain,
    shade_env,
    shade_light,
    shade_nee_plain,
)
from .traverse import closest_hit, closest_hit_pair


def _env_radiance(scene, direction, config):
    if config.enable_env_map:
        return hdr_color(scene.hdr_map, direction, scene.env_angle) \
            * scene.env_intensity
    return default_sky_color(direction[..., 1])


def trace_radiance(scene, origin, direction, pixel_id, frame: int, config):
    """Path-traced radiance for a batch of primary rays (glsl main,
    1518-1550). pixel_id: (R,) int64 per-pixel RNG stream ids in
    [0, 2^32); frame: 1-based progressive sample index. Returns (R, 3)
    float32 linear radiance."""
    hit0 = closest_hit(scene, origin, direction, config)
    miss_rgb = _env_radiance(scene, direction, config)
    bounce = _bounce if config.enable_bsdf else _bounce_brdf
    lo = _bounce_loop(bounce, scene, origin, direction, hit0, pixel_id,
                      frame, config)
    le0 = scene.material_of(hit0.tri).emissive
    return torch.where(hit0.is_hit[..., None], le0 + lo, miss_rgb)


def _takes_kernels(scene, config, origin, direction, history, lo):
    """Whether _bounce runs csrc/shade.cu's kernels: the env map sampled at
    its nearest texels, and shade.use_kernels on the bounce's inputs (the
    card, and no autograd recording the scene's or the rays' tensors),
    asked through the module so that a test can stand in for it."""
    return (config.enable_env_map and not config.env_bilinear
            and shade.use_kernels(origin.device, (
                origin, direction, history, lo, scene.tri_attr,
                *scene.materials.mat)))


def _bounce(scene, b, frame, sobol_point, config, pid, origin, direction,
            t, tri, inside, history, lo):
    """One bounce of glsl:1369-1516 for rays alive at its start. Returns
    the rays' (lo, history, next origin, next direction, next hit, alive)."""
    if _takes_kernels(scene, config, origin, direction, history, lo):
        return _bounce_kernels(scene, b, frame, sobol_point, config, pid,
                               origin, direction, t, tri, inside, history, lo)
    with span("rt.shade.surface"):
        hit_point, n, v, mat = surface_attributes(scene, origin, direction,
                                                  t, tri, inside)

    # 1. next-event estimation: draw the light sample (its shadow ray is
    # traced with the bounce ray below)
    if config.enable_env_map:
        with span("rt.shade.light"):
            l_dir, light_pdf, light_fr, facing = light_sample(
                scene, config, b, frame, pid, n)

    # 2-3. sample the BSDF and the media
    with span("rt.shade.bsdf"):
        half = shade_bsdf_plain(b, frame, sobol_point, pid, mat, v, n,
                                hit_point, direction, t, history, lo)

    # 4. shadow + bounce rays in one cast
    if config.enable_env_map:
        shadow, nxt = closest_hit_pair(scene, hit_point, l_dir, facing,
                                       half.origin, half.direction,
                                       half.alive, config)
        with span("rt.shade.light"):
            lo = shade_nee_plain(mat, v, n, l_dir, light_pdf, light_fr,
                                 facing, shadow.is_hit, history, half.lo,
                                 config.enable_mis)
    else:
        nxt = closest_hit(scene, half.origin, half.direction, config,
                          mask=half.alive)
        lo = half.lo

    with span("rt.shade.env"):
        lo = env_pickup(scene, config, half, nxt.tri, lo)
    return lo, half.history, half.origin, half.direction, nxt, half.alive


def _bounce_kernels(scene, b, frame, sobol_point, config, pid, origin,
                    direction, t, tri, inside, history, lo):
    """_bounce on the card, one kernel at each site: shade_light before the
    cast, shade_bsdf, and shade_env after it; the same values as the plain
    code (ops/shade.py)."""
    with span("rt.shade.light"):
        surface = shade_light(scene, config, b, frame, pid, origin,
                              direction, t, tri, inside)
    with span("rt.shade.bsdf"):
        half = shade_bsdf(b, frame, sobol_point, pid, scene.materials,
                          surface, direction, t, history, lo)
    shadow, nxt = closest_hit_pair(scene, surface.hit_point, surface.l_dir,
                                   surface.facing, half.origin,
                                   half.direction, half.alive, config)
    with span("rt.shade.env"):
        lo = shade_env(scene, config, surface, direction, history, half,
                       shadow.tri, nxt.tri)
    return lo, half.history, half.origin, half.direction, nxt, half.alive


def _bounce_brdf(scene, b, frame, sobol_point, config, pid, origin,
                 direction, t, tri, inside, history, lo):
    """One bounce of the legacy BRDF integrator (glsl:1290-1366) for rays
    alive at its start; same contract as _bounce. enable_mis is not
    consulted: the reference's BRDF mode applies the power heuristic
    unconditionally in the NEE (glsl:1310-1322) and in the bounce-miss
    pickup (glsl:1345-1352)."""
    with span("rt.shade.surface"):
        hit_point, n, v, mat = surface_attributes(scene, origin, direction,
                                                  t, tri, inside)
        tangent, bitangent = onb(n)

    if config.enable_env_map:
        with span("rt.shade.light"):
            l_dir_nee, light_pdf, light_fr, facing = light_sample(
                scene, config, b, frame, pid, n)

    with span("rt.shade.bsdf"):
        u, vv = sobol_bounce_uv(sobol_point, b)
        xi1 = cranley_patterson(u, rand01(pid, frame, 8 * b + 2))
        xi2 = cranley_patterson(vv, rand01(pid, frame, 8 * b + 3))
        xi3 = rand01(pid, frame, 8 * b + 4)

        l_dir = disney.sample_brdf(mat, v, n, xi1, xi2, xi3)
        f_r, pdf_brdf = disney.brdf_evaluate(mat, v, n, l_dir, tangent,
                                             bitangent)
        ndotl = torch.abs(torch.sum(n * l_dir, dim=-1))
        alive = pdf_brdf > EPS_PDF
        mult = f_r * (ndotl * safe_rcp(pdf_brdf))[..., None]
        new_history = torch.where(alive[..., None], history * mult, history)

    # shadow + bounce rays in one cast
    if config.enable_env_map:
        shadow, nxt = closest_hit_pair(scene, hit_point, l_dir_nee, facing,
                                       hit_point, l_dir, alive, config)
        with span("rt.shade.light"):
            vis = facing & ~shadow.is_hit
            f_eval, pdf_eval = disney.brdf_evaluate(mat, v, n, l_dir_nee,
                                                    tangent, bitangent)
            ndotl_nee = torch.abs(torch.sum(n * l_dir_nee, dim=-1))
            w = mis_weight(light_pdf, pdf_eval)
            contrib = (w * ndotl_nee * safe_rcp(light_pdf))[..., None] \
                * history * light_fr * f_eval
            lo = lo + torch.where(vis[..., None], contrib, 0.0)
    else:
        nxt = closest_hit(scene, hit_point, l_dir, config, mask=alive)

    with span("rt.shade.env"):
        nxt_miss = alive & ~nxt.is_hit
        if config.enable_env_map:
            env_fr, light_pdf2 = env_miss_radiance_pdf(scene, config,
                                                       l_dir)
            env_fr = env_fr * scene.env_intensity
            w2 = mis_weight(pdf_brdf, light_pdf2)
            lo = lo + torch.where(nxt_miss[..., None],
                                  w2[..., None] * new_history * env_fr, 0.0)
        else:
            sky = default_sky_color(l_dir[..., 1])
            lo = lo + torch.where(nxt_miss[..., None], new_history * sky,
                                  0.0)

        le = scene.material_of(nxt.tri).emissive
        lo = lo + torch.where((alive & nxt.is_hit)[..., None],
                              new_history * le, 0.0)
    return lo, new_history, hit_point, l_dir, nxt, alive


def _live_lanes(flags):
    """Indices of the set flags: torch.nonzero, which waits for the device
    (a span rt.sync)."""
    with span("rt.sync"):
        count("syncs")
        return torch.nonzero(flags).squeeze(1)


def _bounce_loop(bounce, scene, origin, direction, hit0, pixel_id, frame,
                 config):
    """max_bounce bounces of `bounce` (_bounce or _bounce_brdf), each on
    the lanes still alive; returns the (R, 3) radiance gathered after the
    primary hit."""
    lo_out = torch.zeros_like(origin)
    lanes = _live_lanes(hit0.is_hit)
    o, d = origin[lanes], direction[lanes]
    t, tri, inside = hit0.t[lanes], hit0.tri[lanes], hit0.inside[lanes]
    history = torch.ones_like(o)
    lo = torch.zeros_like(o)
    sobol_point = sobol_all_dims(frame, device=origin.device)
    for b in range(config.max_bounce):
        if lanes.numel() == 0:
            break
        count("bounces")
        count("bounce_lanes", lanes.numel())
        with span("rt.bounce"):
            lo, history, o, d, nxt, alive = bounce(
                scene, b, frame, sobol_point, config, pixel_id[lanes], o, d,
                t, tri, inside, history, lo)
        lo_out[lanes] = lo
        keep = _live_lanes(alive & nxt.is_hit)
        lanes, o, d, history, lo = (x[keep] for x in
                                    (lanes, o, d, history, lo))
        t, tri, inside = nxt.t[keep], nxt.tri[keep], nxt.inside[keep]
    return lo_out
