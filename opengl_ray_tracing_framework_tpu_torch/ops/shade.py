"""The forward BSDF bounce's shading in two halves (ops/integrator.py
_bounce): the plain PyTorch versions, and csrc/shade.cu's kernels that
compute each half in one launch.

  shade_bsdf  the rt.shade.bsdf span: the bounce's uniforms and Sobol
              pair, disney_sample, alive, the media on refraction
              (glsl:1429-1458), the throughput, the next ray, and the MIS
              pdf of its direction (glsl:1466-1474)
  shade_nee   the post-cast half of rt.shade.light: the shadow-tested,
              power-heuristic NEE contribution (glsl:1379-1406)

shade_bsdf / shade_nee launch the kernels where use_kernels says so: the
lanes lie on a CUDA device and autograd records nothing. Otherwise they
run the plain versions: every CPU tensor does, and so do the gradient
paths (parallel/autodiff.py), since the kernels have no backward.
`.launches` counts kernel launches, and while utils/timing.py's tracing
is on each shade_bsdf launch adds its lanes to the host counter
shade_fused_lanes.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..models.material import MEDIUM_ABSORB, MEDIUM_EMISSIVE, MEDIUM_SCATTER
from ..utils import nvcc
from ..utils.timing import count
from . import disney
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


class BsdfHalf(NamedTuple):
    """shade_bsdf's outputs, one row a lane."""

    lo: torch.Tensor            # (R, 3) radiance, with an emissive medium's
    history: torch.Tensor       # (R, 3) throughput after the bounce
    origin: torch.Tensor        # (R, 3) next ray
    direction: torch.Tensor     # (R, 3)
    alive: torch.Tensor         # (R,) bool: pdf > EPS_PDF
    med_sampled: torch.Tensor   # (R,) bool: scattered inside a medium
    pdf_for_mis: torch.Tensor   # (R,) pdf of `direction` for the env MIS


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


def use_kernels(device, tensors) -> bool:
    """Whether _bounce's halves take the kernels: the lanes lie on a CUDA
    device and autograd would record nothing (grad mode off, or no input
    requires grad). Decided from what the inputs show; there is no knob."""
    if torch.device(device).type != "cuda":
        return False
    return not (torch.is_grad_enabled()
                and any(x.requires_grad for x in tensors))


# The kernels' argument blocks (csrc/shade.cu MatPtrs, BsdfArgs, NeeArgs)

_MAT_FIELDS = ("base_color", "subsurface", "metallic", "specular_tint",
               "roughness", "anisotropic", "sheen", "sheen_tint",
               "clearcoat", "clearcoat_gloss", "ior", "transmission",
               "medium_color", "medium_density", "medium_anisotropy",
               "medium_type")
_BSDF_PTRS = ("pid", "sobol", "v", "n", "hit_point", "direction", "t",
              "history", "lo", "lo_out", "new_history", "new_org", "new_dir",
              "pdf_for_mis", "alive", "med_sampled", "lobe", "uniforms")
_NEE_PTRS = ("v", "n", "l_dir", "light_pdf", "light_fr", "history", "lo",
             "facing", "shadow_hit", "lo_out")


class _MatPtrs(ctypes.Structure):
    _fields_ = [(f, ctypes.c_void_p) for f in _MAT_FIELDS]


class _BsdfArgs(ctypes.Structure):
    _fields_ = ([("mat", _MatPtrs)]
                + [(f, ctypes.c_void_p) for f in _BSDF_PTRS]
                + [("frame", ctypes.c_uint), ("bounce", ctypes.c_int),
                   ("n_lanes", ctypes.c_int)])


class _NeeArgs(ctypes.Structure):
    _fields_ = ([("mat", _MatPtrs)]
                + [(f, ctypes.c_void_p) for f in _NEE_PTRS]
                + [("enable_mis", ctypes.c_int), ("n_lanes", ctypes.c_int)])


def _declare(lib):
    """Declare the C signatures of a loaded csrc/shade.cu."""
    for name in ("shade_threads", "shade_bsdf_args_bytes",
                 "shade_nee_args_bytes"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    lib.shade_bsdf_launch.argtypes = [ctypes.POINTER(_BsdfArgs),
                                      ctypes.c_void_p]
    lib.shade_bsdf_launch.restype = ctypes.c_int
    lib.shade_nee_launch.argtypes = [ctypes.POINTER(_NeeArgs),
                                     ctypes.c_void_p]
    lib.shade_nee_launch.restype = ctypes.c_int
    if (lib.shade_bsdf_args_bytes() != ctypes.sizeof(_BsdfArgs)
            or lib.shade_nee_args_bytes() != ctypes.sizeof(_NeeArgs)):
        raise RuntimeError(
            "csrc/shade.cu's argument blocks differ from ops/shade.py's")
    return lib


def _checked(fn, dev, r, named):
    """Each (name, tensor, dtype, width) as a contiguous tensor of that
    type and shape (r,) (width 0) or (r, width) on dev, else ValueError."""
    out = {}
    for name, x, dtype, width in named:
        shape = (r, width) if width else (r,)
        if (x.device != dev or x.dtype != dtype
                or tuple(x.shape) != shape):
            raise ValueError(
                f"{fn}: {name} must be a {dtype} tensor of shape {shape} on "
                f"{dev}; got {x.dtype} {tuple(x.shape)} on {x.device}")
        out[name] = x.contiguous()
    return out


def _mat_inputs(mat):
    return [(f, getattr(mat, f),
             torch.int32 if f == "medium_type" else torch.float32,
             3 if f in ("base_color", "medium_color") else 0)
            for f in _MAT_FIELDS]


def _ptr(x):
    return None if x is None else x.data_ptr()


def _launch(fn, dev, launch, args):
    with torch.cuda.device(dev):
        rc = launch(ctypes.byref(args),
                    torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn} kernel launch failed: cudaError {rc}")


def shade_bsdf(b, frame, sobol_point, pid, mat, v, n, hit_point, direction,
               t, history, lo, probes=False):
    """shade_bsdf_plain's BsdfHalf: csrc/shade.cu's shade_bsdf kernel where
    use_kernels says so, else the plain version. With probes=True (the
    kernel, whatever use_kernels says) returns (BsdfHalf, lobe, uniforms):
    each lane's picked lobe (int8: 0 diffuse, 1 clearcoat, 2 reflection,
    3 refraction) and its three uniforms of salts 8b+2..8b+4 (R, 3)."""
    dev = v.device
    if not probes and not use_kernels(dev, (*mat, v, n, hit_point,
                                            direction, t, history, lo)):
        return shade_bsdf_plain(b, frame, sobol_point, pid, mat, v, n,
                                hit_point, direction, t, history, lo)
    if dev.type != "cuda":
        raise NotImplementedError(f"the shade_bsdf kernel has no {dev} "
                                  "version")
    r = v.shape[0]
    x = _checked("shade_bsdf", dev, r, _mat_inputs(mat) + [
        ("pid", pid, torch.int64, 0), ("v", v, torch.float32, 3),
        ("n", n, torch.float32, 3), ("hit_point", hit_point, torch.float32, 3),
        ("direction", direction, torch.float32, 3),
        ("t", t, torch.float32, 0), ("history", history, torch.float32, 3),
        ("lo", lo, torch.float32, 3)])
    if (sobol_point.device != dev or sobol_point.dtype != torch.float32
            or tuple(sobol_point.shape) != (8,)):
        raise ValueError("shade_bsdf: sobol_point must be an (8,) float32 "
                         f"tensor on {dev}")
    f3 = lambda: torch.empty((r, 3), dtype=torch.float32, device=dev)
    half = BsdfHalf(f3(), f3(), f3(), f3(),
                    torch.empty(r, dtype=torch.bool, device=dev),
                    torch.empty(r, dtype=torch.bool, device=dev),
                    torch.empty(r, dtype=torch.float32, device=dev))
    lobe = uniforms = None
    if probes:
        lobe = torch.empty(r, dtype=torch.int8, device=dev)
        uniforms = f3()
    ptrs = {**x, "sobol": sobol_point.contiguous(), "lo_out": half.lo,
            "new_history": half.history, "new_org": half.origin,
            "new_dir": half.direction, "pdf_for_mis": half.pdf_for_mis,
            "alive": half.alive, "med_sampled": half.med_sampled,
            "lobe": lobe, "uniforms": uniforms}
    args = _BsdfArgs(
        mat=_MatPtrs(*(x[f].data_ptr() for f in _MAT_FIELDS)),
        frame=int(frame) & 0xFFFFFFFF, bounce=int(b), n_lanes=r,
        **{f: _ptr(ptrs[f]) for f in _BSDF_PTRS})
    _launch("shade_bsdf", dev, nvcc.load("shade").shade_bsdf_launch, args)
    shade_bsdf.launches += 1
    count("shade_fused_lanes", r)
    return (half, lobe, uniforms) if probes else half


shade_bsdf.launches = 0


def shade_nee(mat, v, n, l_dir, light_pdf, light_fr, facing, shadow_hit,
              history, lo, enable_mis):
    """shade_nee_plain's radiance: csrc/shade.cu's shade_nee kernel where
    use_kernels says so (a new tensor; lo is only read), else the plain
    version."""
    dev = v.device
    if not use_kernels(dev, (*mat, v, n, l_dir, light_pdf, light_fr,
                             history, lo)):
        return shade_nee_plain(mat, v, n, l_dir, light_pdf, light_fr, facing,
                               shadow_hit, history, lo, enable_mis)
    r = v.shape[0]
    x = _checked("shade_nee", dev, r, _mat_inputs(mat) + [
        ("v", v, torch.float32, 3), ("n", n, torch.float32, 3),
        ("l_dir", l_dir, torch.float32, 3),
        ("light_pdf", light_pdf, torch.float32, 0),
        ("light_fr", light_fr, torch.float32, 3),
        ("history", history, torch.float32, 3), ("lo", lo, torch.float32, 3),
        ("facing", facing, torch.bool, 0),
        ("shadow_hit", shadow_hit, torch.bool, 0)])
    x["lo_out"] = out = torch.empty((r, 3), dtype=torch.float32, device=dev)
    args = _NeeArgs(
        mat=_MatPtrs(*(x[f].data_ptr() for f in _MAT_FIELDS)),
        enable_mis=int(bool(enable_mis)), n_lanes=r,
        **{f: x[f].data_ptr() for f in _NEE_PTRS})
    _launch("shade_nee", dev, nvcc.load("shade").shade_nee_launch, args)
    shade_nee.launches += 1
    return out


shade_nee.launches = 0


def _smoke(device):
    """Both halves on 256 of probes/shade_kernels.py's random lanes at
    bounce 1 of frame 3."""
    from ..probes.shade_kernels import random_lanes

    x = random_lanes(256, 0, device)
    sobol = sobol_all_dims(3, device=device)

    def launch():
        half = shade_bsdf(1, 3, sobol, x["pid"], x["mat"], x["v"], x["n"],
                          x["hit_point"], x["direction"], x["t"],
                          x["history"], x["lo"])
        return shade_nee(x["mat"], x["v"], x["n"], x["l_dir"],
                         x["light_pdf"], x["light_fr"], x["facing"],
                         x["shadow_hit"], x["history"], half.lo, True)

    return launch


nvcc.register("shade", _declare, _smoke, flags=("-fmad=false",))
