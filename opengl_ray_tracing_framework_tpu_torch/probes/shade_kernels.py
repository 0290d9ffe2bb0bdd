"""csrc/shade.cu's three kernels alone on the card, at the main path's
131,072 lanes a batch, beside their plain versions and their bounds:

    python -m opengl_ray_tracing_framework_tpu_torch.probes.shade_kernels

Each kernel runs on random_lanes (hits on random triangles, every lobe and
medium, a random environment), timed by probes.hbm_ms (CUDA-graph launches
rotating over copies of the inputs, so they come from HBM); its plain
version by probes.cuda_ms, the time a bounce spent on the same work before
the kernels (hundreds of launches); its wrapper by the host time of a
Python loop of calls (the kernels run behind it). The bound is the larger
of the bytes the launch moves over the HBM rate (LANE_BYTES a lane, each
table row that some lane reads counted once) and the lanes' FP32
operations over the FP32 peak, the operations counted from the kernel's
SASS: the kernels have no loop, so a lane executes each instruction at
most once (the slow paths of division and square root aside), and FFMA
counts two. Registers, stack and spills come from a fresh nvcc build's
ptxas lines. Each kernel is also held to its plain version on the same
lanes, by tests/test_torch_shade.py's close_ill_conditioned limits: the
share of lanes whose decisions agree (shade_light: facing, the material id
and the light sample's texel; shade_bsdf: the lobe, alive and
med_sampled; shade_env: the miss texel), at least 99.99%, and on those
lanes the share of output values off by more than 1e-5 + 1e-5 |plain| (at
most 0.2%), the count off by more than 1e-5 + 1e-4 |plain| (none), the
share of lanes whose outputs are all bit-equal, and the largest absolute
and relative difference. `within` says whether the limits hold. Prints
one JSON line.
"""

from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import tempfile
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch

from ..models.hdr import build_env_fetch, build_hdr_cache
from ..models.material import Material, MaterialTable
from ..models.scene import SceneData
from ..ops import disney, envmap, shade
from ..ops.microfacet import disney_fresnel, spec_and_sheen_color
from ..ops.sampling import (_dot, cranley_patterson, onb, rand01,
                            sample_ggx_vndf, sobol_all_dims, sobol_bounce_uv,
                            to_local)
from ..utils import nvcc
from ..utils.config import RenderConfig
from . import PEAK_FP32_FLOPS, PEAK_HBM_BYTES, cuda_ms, device_line, hbm_ms
from .prep_kernels import _INSTR

LANES = 131072
ENV_H, ENV_W = 128, 256     # the random environment's texels
# Bytes a lane moves at most (csrc/shade.cu's bound), table rows apart:
# shade_light reads the pixel id (8), origin, direction, t, the triangle id
# and inside (33), and writes the hit point, normal, material id, light
# direction, pdf, radiance and facing (57); its triangle's 19 floats of
# tri_attr (76) and its texel's 6 floats (24) are counted once a row.
# shade_bsdf reads the pixel id and material id (12), direction, n, hit
# point, t, throughput and radiance (64) and writes radiance, throughput,
# origin, direction, alive, med_sampled and the pdf (54); its material's
# 15 fields (76, 4 more on a phase-sampled lane) once a row. shade_env
# reads facing, the shadow hit, alive, the next hit and the radiance (22)
# and writes the radiance (12); a visible light sample also reads the
# material id, direction, n, light direction, pdf, radiance and the
# throughput (68) and 14 material fields (56) once a row; a miss its new
# direction, med_sampled, pdf and throughput (29) and its texel's 4 floats
# (16) once a row; a hit its throughput (12), its triangle's material
# (tri_attr row 18, 4) and that material's emission (12) once a row.
LANE_BYTES = {"shade_light": 98, "tri_attr_row": 76, "texel_light": 24,
              "shade_bsdf": 130, "material_bsdf": 76, "scatter": 4,
              "shade_env": 34, "env_visible": 68, "material_nee": 56,
              "env_miss": 29, "texel_miss": 16, "env_hit": 12,
              "tri_attr_mat": 4, "emissive": 12}
# tests/test_torch_shade.py's close_ill_conditioned: within ATOL + RTOL
# |plain| on all but OFF_SHARE of the values, all within ATOL + RTOL_TAIL
ATOL = RTOL = 1e-5
RTOL_TAIL, OFF_SHARE = 1e-4, 2e-3
DECIDED = 0.9999        # decisions equal on at least this share of lanes
KERNELS = ("shade_light_kernel", "shade_bsdf_kernel", "shade_env_kernel")
FP32_OPS = {"FADD": 1, "FMUL": 1, "FADD32I": 1, "FMUL32I": 1, "FMNMX": 1,
            "MUFU": 1, "FFMA": 2, "FFMA32I": 2}


def fp32_ops(sass: str) -> dict:
    """{kernel: FP32 operations in its SASS} for KERNELS, FFMA as two."""
    out = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        kernel = next((k for k in KERNELS if k in part.split(None, 1)[0]),
                      None)
        if kernel is not None:
            ops = Counter(m.group(2) for m in map(_INSTR.search,
                                                  part.splitlines()) if m)
            out[kernel] = sum(FP32_OPS.get(op, 0) * n
                              for op, n in ops.items())
    return out


def ptxas(log: str) -> dict:
    """{kernel: {"registers", "stack", "spill_bytes"}} from an `-Xptxas -v`
    log."""
    out, kernel = {}, None
    for line in log.splitlines():
        name = next((k for k in KERNELS if k in line), None)
        if name is not None and "Compiling entry function" in line:
            kernel = name
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and kernel:
            out[kernel] = {"stack": int(m.group(1)),
                           "spill_bytes": int(m.group(2)) + int(m.group(3))}
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            out[kernel]["registers"] = int(m.group(1))
            kernel = None
    return out


def bound_us(nbytes: int, ops: int) -> tuple[float, str]:
    """(least microseconds, "bytes" or "operations") of a launch that
    moves nbytes and computes ops FP32 operations."""
    return max((nbytes / PEAK_HBM_BYTES * 1e6, "bytes"),
               (ops / PEAK_FP32_FLOPS * 1e6, "operations"))


def lane_scene(tri_attr, env_fetch, hdr, hdr_cache, materials, env_angle,
               env_intensity) -> SceneData:
    """A SceneData of the tables the shading reads; the casts' fields are
    empty."""
    empty = torch.empty(0, device=tri_attr.device)
    ax = lambda rows: tri_attr[rows].T.contiguous()
    fields = {f.name: empty for f in dataclasses.fields(SceneData)}
    fields.update(
        p1=ax(slice(0, 3)), p2=ax(slice(3, 6)), p3=ax(slice(6, 9)),
        n1=ax(slice(9, 12)), n2=ax(slice(12, 15)), n3=ax(slice(15, 18)),
        mat_idx=tri_attr[18].to(torch.int32), materials=materials,
        hdr_map=hdr, env_intensity=env_intensity, env_angle=env_angle,
        tri_attr=tri_attr, env_fetch=env_fetch, hdr_cache=hdr_cache)
    return SceneData(**fields)


def random_lanes(r: int, seed: int, device) -> dict:
    """Inputs of the three kernels for r lanes, drawn from `seed`.

    The scene: one triangle a lane (N = r, 1% degenerate, 0.5% with a
    material id past the table), a material of its own a lane (M = r)
    that reaches every lobe and medium (metallic and transmission at 0, 1
    or between, ior 1.0-2.4, roughness down to 0, anisotropic, every
    medium type, isotropic and forward phase functions, 30% emissive), a
    random environment of ENV_H x ENV_W texels through the scene build's
    own tables, env_angle in [-0.5, 1.5) and env_intensity in [0.5, 2).
    The lanes: hits (`tri` a permutation, 1% of them -1; inside, t,
    origin, a unit direction), and for the kernels alone the records the
    kernel before each would give: a Surface (its hit's material id; a
    normal facing the view; a light sample, half of them facing) and a
    BsdfHalf (85% alive, a tenth of those phase-sampled), the shadow ray's
    hit (30% blocked) and the bounce ray's (40% of them a miss). `mat` is
    each lane's material, `v` = -direction and `shadow_hit`, as the plain
    versions take them, and the Surface's fields are keys too. The smoke
    launch's and the card tests' lanes."""
    rng = np.random.default_rng(seed)
    u = lambda *shape: rng.random(shape, dtype=np.float32)
    n_tri = n_mat = max(r, 1)

    def some(values, shape=(n_mat,)):
        """Each entry one of `values` (None: uniform in [0, 1))."""
        pick = rng.integers(0, len(values), shape)
        out = u(*shape)
        for k, val in enumerate(values):
            if val is not None:
                out[pick == k] = val
        return out

    def unit(k=r):
        x = rng.normal(size=(k, 3)).astype(np.float32)
        return x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-6)

    g = (1.8 * u(n_mat) - 0.9).astype(np.float32)
    g[rng.random(n_mat) < 0.2] = 0.0   # the isotropic branch of sample_hg
    emissive = u(n_mat, 3) * (rng.random((n_mat, 1)) < 0.3)
    table = Material(
        emissive=emissive.astype(np.float32), base_color=u(n_mat, 3),
        subsurface=some((0.0, None)), metallic=some((0.0, 1.0, None)),
        specular=u(n_mat), specular_tint=some((0.0, None)),
        roughness=some((0.0, 0.02, None)), anisotropic=some((0.0, None)),
        sheen=some((0.0, None)), sheen_tint=u(n_mat),
        clearcoat=some((0.0, 1.0, None)), clearcoat_gloss=u(n_mat),
        ior=(1.0 + 1.4 * u(n_mat)).astype(np.float32),
        transmission=some((0.0, 1.0, None)), medium_color=u(n_mat, 3),
        medium_type=rng.integers(0, 4, n_mat).astype(np.int32),
        medium_density=(2.0 * u(n_mat)).astype(np.float32),
        medium_anisotropy=g)

    tri_attr = np.zeros((20, n_tri), np.float32)
    tri_attr[0:9] = rng.normal(size=(9, n_tri))
    flat = rng.random(n_tri) < 0.01
    tri_attr[6:9, flat] = tri_attr[3:6, flat]     # p3 = p2: no area
    tri_attr[9:18] = unit(3 * n_tri).reshape(n_tri, 9).T
    tri_attr[18] = rng.permutation(n_mat)
    tri_attr[18, rng.random(n_tri) < 0.005] = n_mat + 3
    tri = rng.permutation(n_tri)[:r].astype(np.int32)
    tri[rng.random(r) < 0.01] = -1

    hdr = (4.0 * u(ENV_H, ENV_W, 3)).astype(np.float32)
    cache = build_hdr_cache(hdr)
    t = lambda x: torch.as_tensor(x, device=device)
    scene = lane_scene(
        t(tri_attr), t(build_env_fetch(hdr, cache)), t(hdr), t(cache),
        MaterialTable(mat=Material(*(t(f) for f in table))),
        t(np.float32(2.0 * rng.random() - 0.5)),
        t(np.float32(0.5 + 1.5 * rng.random())))

    direction = unit()
    nrm = unit()
    flip = np.sum(direction * nrm, 1) > 0
    nrm[flip] = -nrm[flip]
    l_dir = unit()
    alive = rng.random(r) < 0.85
    x = dict(
        scene=scene, config=RenderConfig(), pid=t(rng.integers(
            0, 2**32, r, dtype=np.int64)),
        origin=t(rng.normal(size=(r, 3)).astype(np.float32)),
        direction=t(direction), t=t((0.01 + 3.0 * u(r)).astype(np.float32)),
        tri=t(tri), inside=t(rng.random(r) < 0.5),
        history=t(u(r, 3)), lo=t(u(r, 3)),
        shadow_tri=t(np.where(rng.random(r) < 0.3,
                              rng.integers(0, n_tri, r), -1).astype(np.int32)),
        nxt_tri=t(np.where(rng.random(r) < 0.6,
                           rng.integers(0, n_tri, r), -1).astype(np.int32)))
    x["surface"] = shade.Surface(
        hit_point=t(rng.normal(size=(r, 3)).astype(np.float32)), n=t(nrm),
        mat_id=scene.material_ids(x["tri"]), l_dir=t(l_dir),
        light_pdf=t((0.01 + 4.0 * u(r)).astype(np.float32)),
        light_fr=t(u(r, 3)), facing=t(np.sum(l_dir * nrm, 1) > 0))
    x["half"] = shade.BsdfHalf(
        lo=t(u(r, 3)), history=t(u(r, 3)),
        origin=t(rng.normal(size=(r, 3)).astype(np.float32)),
        direction=t(unit()), alive=t(alive),
        med_sampled=t(alive & (rng.random(r) < 0.1)),
        pdf_for_mis=t((0.01 + 4.0 * u(r)).astype(np.float32)))
    x.update(x["surface"]._asdict(),
             mat=scene.materials.gather(x["surface"].mat_id),
             v=-x["direction"], shadow_hit=x["shadow_tri"] >= 0)
    return x


def light_args(x, b, frame, config=None):
    """shade_light's (and shade_light_plain's) arguments on lanes x."""
    return (x["scene"], config or x["config"], b, frame, x["pid"],
            x["origin"], x["direction"], x["t"], x["tri"], x["inside"])


def bsdf_args(x, b, frame):
    """shade_bsdf's arguments on lanes x."""
    return (b, frame, sobol_all_dims(frame, device=x["pid"].device),
            x["pid"], x["scene"].materials, x["surface"], x["direction"],
            x["t"], x["history"], x["lo"])


def bsdf_plain_args(x, b, frame):
    """shade_bsdf_plain's arguments on lanes x."""
    s = x["surface"]
    return (b, frame, sobol_all_dims(frame, device=x["pid"].device),
            x["pid"], x["mat"], x["v"], s.n, s.hit_point, x["direction"],
            x["t"], x["history"], x["lo"])


def env_args(x, config=None):
    """shade_env's (and shade_env_plain's) arguments on lanes x."""
    return (x["scene"], config or x["config"], x["surface"], x["direction"],
            x["history"], x["half"], x["shadow_tri"], x["nxt_tri"])


def miss_texels(scene, direction):
    """The env_fetch row a bounce-miss direction reads
    (env_radiance_pdf_nearest's)."""
    u, v = envmap.to_spherical_uv(direction, scene.env_angle)
    return envmap._texel_index(u, v, scene.hdr_map.shape[0],
                               scene.hdr_map.shape[1])


def light_texels(x, b, frame):
    """The env_fetch row each lane's light sample reads
    (env_sample_nearest's)."""
    hh, ww = x["scene"].hdr_map.shape[0], x["scene"].hdr_map.shape[1]
    return envmap._texel_index(rand01(x["pid"], frame, 8 * b),
                               rand01(x["pid"], frame, 8 * b + 1), hh, ww)


def agreement(pairs, same) -> dict:
    """How a kernel's outputs agree with its plain version's: pairs of
    (got, want) tensors with one row a lane, compared on the lanes where
    `same` (bool, one a lane) holds. NaN agrees only with NaN."""
    off = tail_off = values = 0
    abs_err = rel_err = 0.0
    equal = same.clone()
    for got, want in pairs:
        g, w = got[same].double(), want[same].double()
        close = torch.isclose(g, w, rtol=RTOL, atol=ATOL, equal_nan=True)
        tail = torch.isclose(g, w, rtol=RTOL_TAIL, atol=ATOL, equal_nan=True)
        off += int((~close).sum())
        tail_off += int((~tail).sum())
        values += close.numel()
        both_nan = g.isnan() & w.isnan()
        d = torch.where(both_nan, 0.0, (g - w).abs()).nan_to_num(
            nan=float("inf"))
        if d.numel():
            abs_err = max(abs_err, float(d.max()))
            rel_err = max(rel_err, float(
                (d / w.abs().clamp(min=ATOL)).nan_to_num(
                    nan=float("inf")).max()))
        lane_equal = (got == want) | (got.isnan() & want.isnan())
        equal &= lane_equal if lane_equal.dim() == 1 else lane_equal.all(1)
    return {"values_off_share": off / max(values, 1),
            "values_off_tail": tail_off,
            "lanes_bit_equal": float(equal.float().mean()) if equal.numel()
            else 1.0,
            "max_abs_err": abs_err, "max_rel_err": rel_err}


def compare(x, b: int = 3, frame: int = 7) -> dict:
    """{kernel: agreement with its plain version on lanes x, with
    decisions_equal (the share of lanes whose decisions agree) and
    `within`}. shade_light's decisions: facing, the material id and the
    light sample's texel (its radiance bit-equal to the plain one's: one
    texel gives the same float32 product, another a different one);
    shade_bsdf's: the lobe, alive and med_sampled; shade_env's: the texel
    of each bounce miss."""
    got = shade.shade_light(*light_args(x, b, frame))
    want = shade.shade_light_plain(*light_args(x, b, frame))
    decided = {"shade_light": (got.facing == want.facing)
               & (got.mat_id == want.mat_id)
               & (got.light_fr == want.light_fr).all(1)}
    pairs = {"shade_light": [(g, w) for g, w in zip(got, want)
                             if g.dtype == torch.float32]}
    half, lobe, _ = shade.shade_bsdf(*bsdf_args(x, b, frame), probes=True)
    plain = shade.shade_bsdf_plain(*bsdf_plain_args(x, b, frame))
    decided["shade_bsdf"] = ((half.alive == plain.alive)
                             & (half.med_sampled == plain.med_sampled)
                             & (lobe == plain_lobes(x, b, frame)))
    pairs["shade_bsdf"] = [(g, w) for g, w in zip(half, plain)
                           if g.dtype == torch.float32]
    lo, texel = shade.shade_env(*env_args(x), probes=True)
    h = x["half"]
    miss = h.alive & (x["nxt_tri"] < 0)
    want_texel = torch.where(miss, miss_texels(x["scene"], h.direction), -1)
    decided["shade_env"] = texel.long() == want_texel
    pairs["shade_env"] = [(lo, shade.shade_env_plain(*env_args(x)))]
    out = {}
    for name, same in decided.items():
        row = {"decisions_equal": float(same.float().mean())
               if same.numel() else 1.0,
               **agreement(pairs[name], same)}
        row["within"] = (row["decisions_equal"] >= DECIDED
                         and row["values_off_share"] <= OFF_SHARE
                         and row["values_off_tail"] == 0)
        out[name] = row
    return out


def plain_lobes(x, b, frame):
    """The lobe shade_bsdf_plain's disney_sample picks on each lane of x (0
    diffuse, 1 clearcoat, 2 reflection, 3 refraction), from its own
    functions."""
    mat, v_world, n, pid = x["mat"], x["v"], x["n"], x["pid"]
    u, vv = sobol_bounce_uv(sobol_all_dims(frame, device=n.device), b)
    r1 = cranley_patterson(u, rand01(pid, frame, 8 * b + 2))
    r2 = cranley_patterson(vv, rand01(pid, frame, 8 * b + 3))
    r3 = rand01(pid, frame, 8 * b + 4)
    eta = disney._eta_of(mat, v_world, n)
    t, bt = onb(n)
    v = to_local(t, bt, n, v_world)
    spec_col, _ = spec_and_sheen_color(mat.base_color, mat.specular_tint,
                                       mat.sheen_tint, mat.metallic, eta)
    fresnel = disney_fresnel(mat.metallic, eta, v[..., 2], v[..., 2])
    w_diff, _, _, w_coat = disney.lobe_weights(mat, eta, spec_col, fresnel)
    cdf1 = w_diff + w_coat
    r1_s = (r1 - cdf1) / torch.clamp(1.0 - cdf1, min=1e-6)
    ax, ay = mat.alpha_xy()
    h = sample_ggx_vndf(v, ax, ay, torch.clamp(r1_s, 0.0, 1.0), r2)
    h = torch.where((h[..., 2] < 0.0)[..., None], -h, h)
    vdoth = _dot(v, h)
    f_pick = 1.0 - ((1.0 - disney_fresnel(mat.metallic, eta, vdoth, vdoth))
                    * mat.transmission * (1.0 - mat.metallic))
    spec = torch.where(r3 < f_pick, 2, 3)
    return torch.where(r1 < w_diff, 0, torch.where(r1 < cdf1, 1, spec)) \
        .to(torch.int8)


def lane_bytes(x, b: int = 3, frame: int = 7) -> dict:
    """{kernel: bytes its launch on lanes x moves}: LANE_BYTES a lane, and
    each table row some lane reads once."""
    scene, s, h = x["scene"], x["surface"], x["half"]
    r = x["pid"].numel()
    rows = lambda ids: int(torch.unique(ids).numel())
    tri = x["tri"].clamp(0, scene.n_triangles - 1)
    visible = s.facing & (x["shadow_tri"] < 0)
    miss = h.alive & (x["nxt_tri"] < 0)
    hit = h.alive & (x["nxt_tri"] >= 0)
    plain = shade.shade_bsdf_plain(*bsdf_plain_args(x, b, frame))
    b_ = LANE_BYTES
    return {
        "shade_light": (b_["shade_light"] * r + b_["tri_attr_row"] * rows(tri)
                        + b_["texel_light"] * rows(light_texels(x, b, frame))),
        "shade_bsdf": (b_["shade_bsdf"] * r
                       + b_["material_bsdf"] * rows(s.mat_id)
                       + b_["scatter"] * rows(s.mat_id[plain.med_sampled])),
        "shade_env": (b_["shade_env"] * r
                      + b_["env_visible"] * int(visible.sum())
                      + b_["material_nee"] * rows(s.mat_id[visible])
                      + b_["env_miss"] * int(miss.sum())
                      + b_["texel_miss"] * rows(
                          miss_texels(scene, h.direction[miss]))
                      + b_["env_hit"] * int(hit.sum())
                      + b_["tri_attr_mat"] * rows(x["nxt_tri"][hit])
                      + b_["emissive"] * rows(
                          scene.material_ids(x["nxt_tri"][hit])))}


def _table(packed, mat) -> MaterialTable:
    """The MaterialTable of `mat` whose packed table is `packed` itself, a
    copy of its own: the timed launches read the copy hbm_ms hands them."""
    table = MaterialTable(mat=mat)
    table.__dict__["packed"] = packed   # functools.cached_property's slot
    return table


def wrapper_us(fn, repeats: int = 200) -> float:
    """Host microseconds a call of fn() takes, the card running behind it:
    a loop of calls timed on the host clock after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(repeats):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host / repeats * 1e6


def run(device="cuda", lanes: int = LANES) -> dict:
    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError("probes.shade_kernels times the card's kernels; "
                           f"{device} has none")
    with tempfile.TemporaryDirectory(prefix="shade_") as tmp:
        lib = Path(tmp) / "shade.so"
        _, log = nvcc.compile_source("shade", lib)
        tool = Path(nvcc._nvcc()).parent / "cuobjdump"
        ops = fp32_ops(subprocess.run(
            [str(tool), "-sass", str(lib)], capture_output=True, text=True,
            check=True, timeout=120).stdout)
    regs = ptxas(log)

    b, frame = 3, 7
    x = random_lanes(lanes, 0, device)
    scene, config = x["scene"], x["config"]
    agree = compare(x, b, frame)
    nbytes = lane_bytes(x, b, frame)
    sobol = sobol_all_dims(frame, device=device)
    packed = scene.materials.packed

    def on(tri_attr, env_fetch, table):
        return dataclasses.replace(
            scene, tri_attr=tri_attr, env_fetch=env_fetch,
            materials=_table(table, scene.materials.mat))

    light_in = (x["pid"], x["origin"], x["direction"], x["t"], x["tri"],
                x["inside"], scene.tri_attr, scene.env_fetch)

    def light(pid, origin, direction, t, tri, inside, tri_attr, env_fetch,
              kernel=True):
        fn = shade.shade_light if kernel else shade.shade_light_plain
        sc = dataclasses.replace(scene, tri_attr=tri_attr,
                                 env_fetch=env_fetch)
        return fn(sc, config, b, frame, pid, origin, direction, t, tri,
                  inside).n

    bsdf_in = (packed, x["pid"], *x["surface"], x["direction"], x["t"],
               x["history"], x["lo"])

    def bsdf(table, pid, *rest, kernel=True):
        s, (direction, t, history, lo) = shade.Surface(*rest[:7]), rest[7:]
        if kernel:
            return shade.shade_bsdf(
                b, frame, sobol, pid, _table(table, scene.materials.mat), s,
                direction, t, history, lo).history
        return shade.shade_bsdf_plain(
            b, frame, sobol, pid, scene.materials.gather(s.mat_id),
            -direction, s.n, s.hit_point, direction, t, history, lo).history

    env_in = (scene.tri_attr, scene.env_fetch, packed, *x["surface"],
              x["direction"], x["history"], *x["half"], x["shadow_tri"],
              x["nxt_tri"])

    def env(tri_attr, env_fetch, table, *rest, kernel=True):
        fn = shade.shade_env if kernel else shade.shade_env_plain
        s, (direction, history) = shade.Surface(*rest[:7]), rest[7:9]
        h, (shadow_tri, nxt_tri) = shade.BsdfHalf(*rest[9:16]), rest[16:]
        return fn(on(tri_attr, env_fetch, table), config, s, direction,
                  history, h, shadow_tri, nxt_tri)

    calls = {"shade_light": (shade.shade_light, light_args(x, b, frame)),
             "shade_bsdf": (shade.shade_bsdf, bsdf_args(x, b, frame)),
             "shade_env": (shade.shade_env, env_args(x))}
    out = {"device": device_line(), "lanes": lanes}
    for name, fn, inputs in (("shade_light", light, light_in),
                             ("shade_bsdf", bsdf, bsdf_in),
                             ("shade_env", env, env_in)):
        kernel = f"{name}_kernel"
        us = hbm_ms(fn, inputs) * 1e3
        plain_ms = cuda_ms(lambda: fn(*inputs, kernel=False), repeats=5)
        wrapper, args = calls[name]
        host_us = wrapper_us(lambda: wrapper(*args))
        bound, by = bound_us(nbytes[name], ops[kernel] * lanes)
        out[name] = {"us": us, "wrapper_us": host_us, "plain_ms": plain_ms,
                     "bound_us": bound, "bound_by": by,
                     "bytes": nbytes[name],
                     "fp32_ops_per_lane": ops[kernel], **agree[name],
                     **regs.get(kernel, {})}
        row = out[name]
        print(f"shade_kernels: {name} {us:.2f} us at {lanes} lanes, wrapper "
              f"{host_us:.1f} us of host a call | bound {bound:.2f} us "
              f"({by}; {nbytes[name]} bytes, {ops[kernel]} FP32 operations "
              f"a lane) = {100 * bound / us:.1f}% | plain {plain_ms:.3f} ms "
              f"| {regs.get(kernel)} | decisions equal on "
              f"{row['decisions_equal']:.6f} of the lanes; there "
              f"{row['values_off_share']:.3g} of the values off by more than "
              f"1e-5, {row['values_off_tail']} by more than 1e-4 relative, "
              f"{row['lanes_bit_equal']:.6f} of the lanes bit-equal, max |d| "
              f"{row['max_abs_err']:.3g}, relative {row['max_rel_err']:.3g}"
              f" | within the limits: {row['within']}")
    return out


def main():
    print(json.dumps(run()))


if __name__ == "__main__":
    main()
