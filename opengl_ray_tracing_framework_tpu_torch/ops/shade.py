"""The forward BSDF bounce's shading at its three sites (ops/integrator.py
_bounce): the plain PyTorch versions, and csrc/shade.cu's kernels that
compute each site in one launch.

  shade_light  before the cast: surface_attributes (hit point, shading
               normal, material id) and the NEE light sample of the
               nearest texel with its facing test (glsl:1379-1384)
  shade_bsdf   the rt.shade.bsdf span: the bounce's uniforms and Sobol
               pair, disney_sample, alive, the media on refraction
               (glsl:1429-1458), the throughput, the next ray, and the MIS
               pdf of its direction (glsl:1466-1474)
  shade_env    after the cast: the shadow-tested, power-heuristic NEE
               contribution (glsl:1379-1406), then the MIS-weighted
               environment on a bounce miss and the emissive pickup on a
               bounce hit (glsl:1476-1513)

_bounce takes the kernels where use_kernels says so (the lanes lie on a
CUDA device and autograd records nothing) and the env map is sampled at
its nearest texels; every other case runs the plain code, which is the
specification: light_sample, shade_bsdf_plain, shade_nee_plain and
env_pickup (the gradient paths in parallel/autodiff.py run it, since the
kernels have no backward). The wrappers take the plain versions on CPU
tensors and launch the kernel on CUDA ones; the kernels read a lane's
material by its id from the table MaterialTable.packed makes once.
`.launches` counts kernel launches, and while utils/timing.py's tracing is
on each launch adds its lanes to the host counter shade_light_lanes,
shade_fused_lanes (shade_bsdf) or shade_env_lanes.

A wrapper checks each tensor that enters the kernels' path: the batch's
ray tensors and the scene's tables. A Surface or BsdfHalf is what
shade_light or shade_bsdf (or their plain versions) made: the next
wrapper checks its type and its lanes, not each field again.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..models.material import (
    MEDIUM_ABSORB,
    MEDIUM_EMISSIVE,
    MEDIUM_SCATTER,
    PACKED_COLUMNS,
    PACKED_WIDTH,
)
from ..utils import nvcc
from ..utils.timing import count
from . import disney
from .envmap import (
    default_sky_color,
    env_radiance_pdf_nearest,
    env_sample_nearest,
    hdr_color,
    hdr_pdf,
    sample_hdr_direction,
)
from .intersect import surface_attributes
from .sampling import (
    cranley_patterson,
    phase_hg,
    rand01,
    sample_hg,
    sobol_all_dims,
    sobol_bounce_uv,
)

EPS_PDF = 1e-10

def mis_weight(a, b):
    """Power heuristic a^2 / (a^2 + b^2) (misMixWeight, glsl:1285-1288)."""
    t = a * a
    return t / torch.clamp(t + b * b, min=1e-20)


def safe_rcp(x, eps=EPS_PDF):
    return 1.0 / torch.clamp(x, min=eps)


class Surface(NamedTuple):
    """shade_light's outputs, one row a lane."""

    hit_point: torch.Tensor     # (R, 3)
    n: torch.Tensor             # (R, 3) shading normal, facing the ray
    mat_id: torch.Tensor        # (R,) int32 material slot
    l_dir: torch.Tensor         # (R, 3) NEE light direction
    light_pdf: torch.Tensor     # (R,) its solid-angle pdf
    light_fr: torch.Tensor      # (R, 3) its radiance times env_intensity
    facing: torch.Tensor        # (R,) bool: l_dir . n > 0


class BsdfHalf(NamedTuple):
    """shade_bsdf's outputs, one row a lane."""

    lo: torch.Tensor            # (R, 3) radiance, with an emissive medium's
    history: torch.Tensor       # (R, 3) throughput after the bounce
    origin: torch.Tensor        # (R, 3) next ray
    direction: torch.Tensor     # (R, 3)
    alive: torch.Tensor         # (R,) bool: pdf > EPS_PDF
    med_sampled: torch.Tensor   # (R,) bool: scattered inside a medium
    pdf_for_mis: torch.Tensor   # (R,) pdf of `direction` for the env MIS


def env_nee_sample(scene, config, xl1, xl2):
    """In-loop NEE light sample -> (direction, pdf, radiance): one row
    fetch from the fused table, or the reference's three GL_LINEAR fetches
    under config.env_bilinear (SampleHdr glsl:635-646, hdrPdf
    glsl:1173-1186, hdrColor glsl:1165-1169; only the pdf/radiance lookups
    add env_angle)."""
    hh, ww = scene.hdr_map.shape[0], scene.hdr_map.shape[1]
    if config.env_bilinear:
        l_dir = sample_hdr_direction(scene.hdr_cache, xl1, xl2)
        pdf = hdr_pdf(scene.hdr_cache, l_dir, scene.env_angle, ww, hh)
        fr = hdr_color(scene.hdr_map, l_dir, scene.env_angle)
        return l_dir, pdf, fr
    return env_sample_nearest(scene.env_fetch, hh, ww, xl1, xl2,
                              scene.env_angle)


def env_miss_radiance_pdf(scene, config, direction):
    """Bounce-miss environment radiance + pdf (the MIS pickup site,
    glsl:1483-1506)."""
    hh, ww = scene.hdr_map.shape[0], scene.hdr_map.shape[1]
    if config.env_bilinear:
        fr = hdr_color(scene.hdr_map, direction, scene.env_angle)
        pdf = hdr_pdf(scene.hdr_cache, direction, scene.env_angle, ww, hh)
        return fr, pdf
    return env_radiance_pdf_nearest(scene.env_fetch, hh, ww, direction,
                                    scene.env_angle)


def light_sample(scene, config, b, frame, pid, n):
    """The NEE light sample of bounce b for the lanes of pixel ids pid
    (glsl:1379-1384): its direction, pdf, radiance times env_intensity,
    and whether it faces the shading normal n."""
    xl1 = rand01(pid, frame, 8 * b + 0)
    xl2 = rand01(pid, frame, 8 * b + 1)
    l_dir, light_pdf, light_fr = env_nee_sample(scene, config, xl1, xl2)
    light_fr = light_fr * scene.env_intensity
    facing = torch.sum(n * l_dir, dim=-1) > 0.0
    return l_dir, light_pdf, light_fr, facing


def shade_light_plain(scene, config, b, frame, pid, origin, direction, t,
                      tri, inside) -> Surface:
    """The surface of each lane's hit (origin, direction, t, tri, inside)
    and the NEE light sample of bounce b."""
    hit_point, n, _, _ = surface_attributes(scene, origin, direction, t, tri,
                                            inside)
    return Surface(hit_point, n, scene.material_ids(tri),
                   *light_sample(scene, config, b, frame, pid, n))


def shade_bsdf_plain(b, frame, sobol_point, pid, mat, v, n, hit_point,
                     direction, t, history, lo) -> BsdfHalf:
    """Sample the BSDF and the media of bounce b for the lanes of pixel ids
    pid (glsl:1408-1474)."""
    u, vv = sobol_bounce_uv(sobol_point, b)
    xi1 = cranley_patterson(u, rand01(pid, frame, 8 * b + 2))
    xi2 = cranley_patterson(vv, rand01(pid, frame, 8 * b + 3))
    xi3 = rand01(pid, frame, 8 * b + 4)

    smp = disney.disney_sample(mat, v, n, xi1, xi2, xi3)
    alive = smp.pdf > EPS_PDF

    # media on refraction (glsl:1429-1458)
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
        -torch.log(torch.clamp(xi3, min=1e-12)) * safe_rcp(dens, 1e-6), t)
    med_sampled = med_scatter_t & (scatter_dist < t)
    hg_dir = sample_hg(v, mat.medium_anisotropy, xi1, xi2)
    hg_pdf = phase_hg(torch.sum(v * hg_dir, dim=-1), mat.medium_anisotropy)

    # throughput & next ray
    surf_mult = smp.f * safe_rcp(smp.pdf)[..., None]
    surf_mult = torch.where(med_absorb[..., None],
                            surf_mult * absorb_mult, surf_mult)
    scatter_mult = mat.medium_color * torch.exp(-scatter_dist)[..., None]
    mult = torch.where(med_sampled[..., None], scatter_mult, surf_mult)
    new_history = torch.where(alive[..., None], history * mult, history)

    new_dir = torch.where(med_sampled[..., None], hg_dir, smp.direction)
    # glsl:1450 marches straight through the surface to the scatter point
    scatter_org = hit_point + direction * scatter_dist[..., None]
    new_org = torch.where(med_sampled[..., None], scatter_org, hit_point)

    # mixture pdf of the sampled direction, for env MIS (glsl:1466-1474)
    _, pdf_eval_dir = disney.disney_eval(mat, v, n, new_dir)
    pdf_for_mis = torch.where(med_sampled, hg_pdf, pdf_eval_dir)
    return BsdfHalf(lo, new_history, new_org, new_dir, alive, med_sampled,
                    pdf_for_mis)


def shade_nee_plain(mat, v, n, l_dir, light_pdf, light_fr, facing,
                    shadow_hit, history, lo, enable_mis):
    """lo plus the NEE contribution of the light sample (l_dir, light_pdf,
    light_fr) where it faces the surface and its shadow ray missed
    (glsl:1379-1406); `history` is the throughput before the bounce."""
    vis = facing & ~shadow_hit
    f_eval, pdf_eval = disney.disney_eval(mat, v, n, l_dir)
    w = mis_weight(light_pdf, pdf_eval)
    if not enable_mis:
        w = torch.ones_like(w)
    contrib = (w * safe_rcp(light_pdf))[..., None] \
        * history * light_fr * f_eval
    return lo + torch.where(vis[..., None], contrib, 0.0)


def env_pickup(scene, config, half: BsdfHalf, nxt_tri, lo):
    """lo plus what the bounce ray of `half` picks up at the triangle
    nxt_tri it hit (-1: a miss; glsl:1476-1513): the MIS-weighted
    environment (or the gradient sky) on a miss, the surface's emission on
    a hit."""
    nxt_hit = nxt_tri >= 0
    nxt_miss = half.alive & ~nxt_hit
    if config.enable_env_map:
        env_fr, light_pdf2 = env_miss_radiance_pdf(scene, config,
                                                   half.direction)
        env_fr = env_fr * scene.env_intensity
        w2 = mis_weight(half.pdf_for_mis, light_pdf2)
        if not config.enable_mis:
            w2 = torch.ones_like(w2)
        # phase-sampled lanes have no competing NEE: full weight
        w2 = torch.where(half.med_sampled, 1.0, w2)
        lo = lo + torch.where(nxt_miss[..., None],
                              w2[..., None] * half.history * env_fr, 0.0)
    else:
        sky = default_sky_color(half.direction[..., 1])
        lo = lo + torch.where(nxt_miss[..., None], half.history * sky, 0.0)

    le = scene.material_of(nxt_tri).emissive
    return lo + torch.where((half.alive & nxt_hit)[..., None],
                            half.history * le, 0.0)


def shade_env_plain(scene, config, surface: Surface, direction, history,
                    half: BsdfHalf, shadow_tri, nxt_tri):
    """half.lo plus the NEE contribution of `surface`'s light sample
    (shadow_tri: the shadow ray's hit, -1 a miss; `history` the throughput
    before the bounce), then env_pickup's."""
    lo = shade_nee_plain(
        scene.materials.gather(surface.mat_id), -direction, surface.n,
        surface.l_dir, surface.light_pdf, surface.light_fr, surface.facing,
        shadow_tri >= 0, history, half.lo, config.enable_mis)
    return env_pickup(scene, config, half, nxt_tri, lo)


def use_kernels(device, tensors) -> bool:
    """Whether _bounce takes the kernels on these inputs: the lanes lie on
    a CUDA device and autograd would record nothing (grad mode off, or no
    input requires grad). Decided from what the inputs show; there is no
    knob."""
    if torch.device(device).type != "cuda":
        return False
    return not (torch.is_grad_enabled()
                and any(x.requires_grad for x in tensors))


# The kernels' argument blocks (csrc/shade.cu SceneTabs, LightArgs,
# BsdfArgs, EnvArgs)

_SCENE_PTRS = ("tri_attr", "env_fetch", "materials", "env_angle",
               "env_intensity")
_LIGHT_PTRS = ("pid", "origin", "direction", "t", "tri", "inside",
               "hit_point", "n", "l_dir", "light_pdf", "light_fr", "mat_id",
               "facing")
_BSDF_PTRS = ("materials", "mat_id", "pid", "sobol", "n", "hit_point",
              "direction", "t", "history", "lo", "lo_out", "new_history",
              "new_org", "new_dir", "pdf_for_mis", "alive", "med_sampled",
              "lobe", "uniforms")
_ENV_PTRS = ("mat_id", "direction", "n", "l_dir", "light_pdf", "light_fr",
             "history", "facing", "shadow_tri", "lo", "new_history",
             "new_dir", "pdf_for_mis", "alive", "med_sampled", "nxt_tri",
             "lo_out", "texel")


def _ptrs(names):
    return [(f, ctypes.c_void_p) for f in names]


class _SceneTabs(ctypes.Structure):
    _fields_ = _ptrs(_SCENE_PTRS) + [
        ("n_tri", ctypes.c_longlong), ("n_mat", ctypes.c_int),
        ("env_h", ctypes.c_int), ("env_w", ctypes.c_int)]


class _LightArgs(ctypes.Structure):
    _fields_ = [("scene", _SceneTabs)] + _ptrs(_LIGHT_PTRS) + [
        ("frame", ctypes.c_uint), ("bounce", ctypes.c_int),
        ("n_lanes", ctypes.c_int)]


class _BsdfArgs(ctypes.Structure):
    _fields_ = _ptrs(_BSDF_PTRS) + [
        ("frame", ctypes.c_uint), ("bounce", ctypes.c_int),
        ("n_lanes", ctypes.c_int), ("n_mat", ctypes.c_int)]


class _EnvArgs(ctypes.Structure):
    _fields_ = [("scene", _SceneTabs)] + _ptrs(_ENV_PTRS) + [
        ("enable_mis", ctypes.c_int), ("n_lanes", ctypes.c_int)]


_ARGS = {"shade_light": _LightArgs, "shade_bsdf": _BsdfArgs,
         "shade_env": _EnvArgs}


def _declare(lib):
    """Declare the C signatures of a loaded csrc/shade.cu; raise unless its
    argument blocks and its material columns are ops/shade.py's and
    models/material.py's."""
    for name in ("shade_threads", *(f"{k}_args_bytes" for k in _ARGS)):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    lib.shade_material_columns.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.shade_material_columns.restype = ctypes.c_int
    for name, args in _ARGS.items():
        launch = getattr(lib, f"{name}_launch")
        launch.argtypes = [ctypes.POINTER(args), ctypes.c_void_p]
        launch.restype = ctypes.c_int
        if getattr(lib, f"{name}_args_bytes")() != ctypes.sizeof(args):
            raise RuntimeError(f"csrc/shade.cu's {name} argument block "
                               "differs from ops/shade.py's")
    cols = (ctypes.c_int * len(PACKED_COLUMNS))()
    if (lib.shade_material_columns(cols) != PACKED_WIDTH
            or list(cols) != list(PACKED_COLUMNS.values())):
        raise RuntimeError("csrc/shade.cu's material columns differ from "
                           "models/material.py's PACKED_COLUMNS")
    return lib


def _check(fn, dev, named):
    """Raise ValueError unless each (name, tensor, dtype, shape) is a
    contiguous tensor of that dtype and shape on dev."""
    for name, x, dtype, shape in named:
        if (x.device != dev or x.dtype != dtype or x.shape != shape
                or not x.is_contiguous()):
            raise ValueError(
                f"{fn}: {name} must be a contiguous {dtype} tensor of shape "
                f"{shape} on {dev}; got {x.dtype} {tuple(x.shape)} on "
                f"{x.device}")


def _made(fn, name, x, kind, dev, r):
    """x, a Surface or BsdfHalf, as `kind` (the wrapper that made it left
    it): its type and its lanes checked, not each field again."""
    if type(x) is not kind or x[0].device != dev or x[0].shape[0] != r:
        raise ValueError(f"{fn}: {name} must be the {kind.__name__} of "
                         f"{r} lanes on {dev} that shade_light / shade_bsdf "
                         f"made; got {type(x).__name__}")
    return x


def _no_grad(fn, dev, tensors):
    """Raise ValueError where autograd would record these inputs."""
    if not use_kernels(dev, tensors):
        raise ValueError(f"{fn}: autograd would record the kernel, which "
                         "has no backward; the plain version is the one")


def _scene_tabs(fn, scene, config, dev) -> _SceneTabs:
    """The scene's tables as the kernels take them, each checked."""
    if not config.enable_env_map or config.env_bilinear:
        raise ValueError(f"{fn}: the kernel samples the env map at its "
                         "nearest texels; enable_env_map must be on and "
                         "env_bilinear off")
    hh, ww = scene.hdr_map.shape[0], scene.hdr_map.shape[1]
    table = scene.materials.packed
    n_mat = table.shape[0]
    f32 = torch.float32
    tabs = (("tri_attr", scene.tri_attr, f32, (20, scene.n_triangles)),
            ("env_fetch", scene.env_fetch, f32, (hh * ww, 16)),
            ("materials.packed", table, f32, (max(n_mat, 1), PACKED_WIDTH)),
            ("env_angle", scene.env_angle, f32, ()),
            ("env_intensity", scene.env_intensity, f32, ()))
    _check(fn, dev, tabs)
    return _SceneTabs(*(x.data_ptr() for _, x, _, _ in tabs),
                      scene.n_triangles, n_mat, hh, ww)


def _launch(fn, dev, args):
    launch = getattr(nvcc.load("shade"), f"{fn}_launch")
    with torch.cuda.device(dev):
        rc = launch(ctypes.byref(args),
                    torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn} kernel launch failed: cudaError {rc}")


def shade_light(scene, config, b, frame, pid, origin, direction, t, tri,
                inside) -> Surface:
    """shade_light_plain's Surface: csrc/shade.cu's shade_light kernel on a
    CUDA device, the plain version on a CPU one."""
    dev = origin.device
    if dev.type != "cuda":
        return shade_light_plain(scene, config, b, frame, pid, origin,
                                 direction, t, tri, inside)
    _no_grad("shade_light", dev, (origin, direction, t, scene.tri_attr))
    r = origin.shape[0]
    tabs = _scene_tabs("shade_light", scene, config, dev)
    _check("shade_light", dev, (
        ("pid", pid, torch.int64, (r,)),
        ("origin", origin, torch.float32, (r, 3)),
        ("direction", direction, torch.float32, (r, 3)),
        ("t", t, torch.float32, (r,)), ("tri", tri, torch.int32, (r,)),
        ("inside", inside, torch.bool, (r,))))
    hit_point, n, l_dir, light_fr = torch.empty(
        (4, r, 3), dtype=torch.float32, device=dev).unbind(0)
    out = Surface(hit_point, n,
                  torch.empty(r, dtype=torch.int32, device=dev), l_dir,
                  torch.empty(r, dtype=torch.float32, device=dev), light_fr,
                  torch.empty(r, dtype=torch.bool, device=dev))
    ptrs = [y.data_ptr() for y in (
        pid, origin, direction, t, tri, inside, out.hit_point, out.n,
        out.l_dir, out.light_pdf, out.light_fr, out.mat_id, out.facing)]
    _launch("shade_light", dev, _LightArgs(
        tabs, *ptrs, int(frame) & 0xFFFFFFFF, int(b), r))
    shade_light.launches += 1
    count("shade_light_lanes", r)
    return out


shade_light.launches = 0


def shade_bsdf(b, frame, sobol_point, pid, materials, surface: Surface,
               direction, t, history, lo, probes=False):
    """shade_bsdf_plain's BsdfHalf for the lanes of `surface`, each of the
    material materials.gather(surface.mat_id): csrc/shade.cu's shade_bsdf
    kernel on a CUDA device, the plain version on a CPU one. With
    probes=True (the kernel) returns (BsdfHalf, lobe, uniforms): each
    lane's picked lobe (int8: 0 diffuse, 1 clearcoat, 2 reflection, 3
    refraction) and its three uniforms of salts 8b+2..8b+4 (R, 3)."""
    dev = direction.device
    if dev.type != "cuda":
        if probes:
            raise NotImplementedError(f"the shade_bsdf kernel has no {dev} "
                                      "version")
        return shade_bsdf_plain(
            b, frame, sobol_point, pid, materials.gather(surface.mat_id),
            -direction, surface.n, surface.hit_point, direction, t, history,
            lo)
    r = direction.shape[0]
    _made("shade_bsdf", "surface", surface, Surface, dev, r)
    _no_grad("shade_bsdf", dev, (*materials.mat, surface.n,
                                 surface.hit_point, direction, t, history,
                                 lo))
    table = materials.packed
    _check("shade_bsdf", dev, (
        ("materials.packed", table, torch.float32,
         (max(table.shape[0], 1), PACKED_WIDTH)),
        ("sobol_point", sobol_point, torch.float32, (8,)),
        ("pid", pid, torch.int64, (r,)),
        ("direction", direction, torch.float32, (r, 3)),
        ("t", t, torch.float32, (r,)),
        ("history", history, torch.float32, (r, 3)),
        ("lo", lo, torch.float32, (r, 3))))
    lo_out, new_history, new_org, new_dir = torch.empty(
        (4, r, 3), dtype=torch.float32, device=dev).unbind(0)
    alive, med_sampled = torch.empty((2, r), dtype=torch.bool,
                                     device=dev).unbind(0)
    half = BsdfHalf(lo_out, new_history, new_org, new_dir, alive,
                    med_sampled,
                    torch.empty(r, dtype=torch.float32, device=dev))
    lobe = uniforms = None
    if probes:
        lobe = torch.empty(r, dtype=torch.int8, device=dev)
        uniforms = torch.empty((r, 3), dtype=torch.float32, device=dev)
    ptrs = [y.data_ptr() for y in (
        table, surface.mat_id, pid, sobol_point, surface.n,
        surface.hit_point, direction, t, history, lo, lo_out, new_history,
        new_org, new_dir, half.pdf_for_mis, alive, med_sampled)]
    ptrs += [None if y is None else y.data_ptr() for y in (lobe, uniforms)]
    _launch("shade_bsdf", dev, _BsdfArgs(
        *ptrs, int(frame) & 0xFFFFFFFF, int(b), r, table.shape[0]))
    shade_bsdf.launches += 1
    count("shade_fused_lanes", r)
    return (half, lobe, uniforms) if probes else half


shade_bsdf.launches = 0


def shade_env(scene, config, surface: Surface, direction, history,
              half: BsdfHalf, shadow_tri, nxt_tri, probes=False):
    """shade_env_plain's radiance (a new tensor): csrc/shade.cu's shade_env
    kernel on a CUDA device, the plain version on a CPU one. With
    probes=True (the kernel) returns (radiance, texel): the env_fetch row
    each bounce miss read, int32, -1 on the other lanes."""
    dev = direction.device
    if dev.type != "cuda":
        if probes:
            raise NotImplementedError(f"the shade_env kernel has no {dev} "
                                      "version")
        return shade_env_plain(scene, config, surface, direction, history,
                               half, shadow_tri, nxt_tri)
    r = direction.shape[0]
    _made("shade_env", "surface", surface, Surface, dev, r)
    _made("shade_env", "half", half, BsdfHalf, dev, r)
    _no_grad("shade_env", dev, (*scene.materials.mat, surface.n,
                                surface.light_fr, direction, history,
                                half.lo, half.history))
    tabs = _scene_tabs("shade_env", scene, config, dev)
    _check("shade_env", dev, (
        ("direction", direction, torch.float32, (r, 3)),
        ("history", history, torch.float32, (r, 3)),
        ("shadow_tri", shadow_tri, torch.int32, (r,)),
        ("nxt_tri", nxt_tri, torch.int32, (r,))))
    out = torch.empty((r, 3), dtype=torch.float32, device=dev)
    texel = torch.empty(r, dtype=torch.int32, device=dev) if probes else None
    ptrs = [y.data_ptr() for y in (
        surface.mat_id, direction, surface.n, surface.l_dir,
        surface.light_pdf, surface.light_fr, history, surface.facing,
        shadow_tri, half.lo, half.history, half.direction, half.pdf_for_mis,
        half.alive, half.med_sampled, nxt_tri, out)]
    _launch("shade_env", dev, _EnvArgs(
        tabs, *ptrs, None if texel is None else texel.data_ptr(),
        int(bool(config.enable_mis)), r))
    shade_env.launches += 1
    count("shade_env_lanes", r)
    return (out, texel) if probes else out


shade_env.launches = 0


def _smoke(device):
    """The three kernels on 256 of probes/shade_kernels.py's random lanes
    at bounce 1 of frame 3."""
    from ..probes.shade_kernels import light_args, random_lanes

    x = random_lanes(256, 0, device)
    sobol = sobol_all_dims(3, device=device)

    def launch():
        surface = shade_light(*light_args(x, 1, 3))
        half = shade_bsdf(1, 3, sobol, x["pid"], x["scene"].materials,
                          surface, x["direction"], x["t"], x["history"],
                          x["lo"])
        return shade_env(x["scene"], x["config"], surface, x["direction"],
                         x["history"], half, x["shadow_tri"], x["nxt_tri"])

    return launch


nvcc.register("shade", _declare, _smoke, flags=("-fmad=false",))
