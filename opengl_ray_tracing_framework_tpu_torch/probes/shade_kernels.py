"""csrc/shade.cu's two kernels alone on the card, at the main path's
131,072 lanes a batch, beside their plain versions and their bounds:

    python -m opengl_ray_tracing_framework_tpu_torch.probes.shade_kernels

Each kernel runs on ops/shade.py's random lanes (every lobe and medium),
timed by probes.hbm_ms (CUDA-graph launches rotating over copies of the
inputs, so they come from HBM); its plain version by probes.cuda_ms, the
time a bounce spent on the same work before the kernels (hundreds of
launches). The bound is the larger of the bytes a lane moves
(ops/shade.py LANE_BYTES) over the HBM rate and the lane's FP32 operations
over the FP32 peak, the operations counted from the kernel's SASS: the
kernels have no loop, so a lane executes each instruction at most once
(the slow paths of division and square root aside), and FFMA counts two.
Registers, stack and spills come from a fresh nvcc build's ptxas lines.
Each kernel is also held to its plain version on the same lanes, by
tests/test_torch_shade.py's close_ill_conditioned limits: the share of
lanes whose alive and med_sampled agree (shade_bsdf; shade_nee decides
nothing), and on those lanes the share of output values off by more than
1e-5 + 1e-5 |plain| (at most 0.2%), the count off by more than
1e-5 + 1e-4 |plain| (none), the share of lanes whose outputs are all
bit-equal, and the largest absolute and relative difference. `within`
says whether the limits hold. Prints one JSON line.
"""

from __future__ import annotations

import json
import re
import subprocess
import tempfile
from collections import Counter
from pathlib import Path

import numpy as np
import torch

from ..models.material import Material
from ..ops import shade
from ..ops.sampling import sobol_all_dims
from ..utils import nvcc
from . import PEAK_FP32_FLOPS, PEAK_HBM_BYTES, cuda_ms, device_line, hbm_ms
from .prep_kernels import _INSTR

LANES = 131072
# Bytes a lane moves at most (csrc/shade.cu's bound): shade_bsdf reads the
# pixel id (8), 15 material fields (76), v, n, hit point, t, throughput
# and radiance (64) and writes radiance, throughput, origin, direction,
# alive, med_sampled and the pdf (54); a phase-sampled lane also reads its
# direction and the medium's anisotropy (16 more). shade_nee reads facing
# and the shadow hit (2) and reads and writes the radiance (24); a visible
# lane also reads 12 material fields (56), v, n, the light's direction,
# pdf and radiance and the throughput (64).
LANE_BYTES = {"shade_bsdf": 202, "shade_bsdf_scatter": 218,
              "shade_nee": 146, "shade_nee_hidden": 26}
# tests/test_torch_shade.py's close_ill_conditioned: within ATOL + RTOL
# |plain| on all but OFF_SHARE of the values, all within ATOL + RTOL_TAIL
ATOL = RTOL = 1e-5
RTOL_TAIL, OFF_SHARE = 1e-4, 2e-3
KERNELS = ("shade_bsdf_kernel", "shade_nee_kernel")
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


def random_lanes(r: int, seed: int, device) -> dict:
    """Inputs of both halves for r lanes, drawn from `seed`: a material of
    its own a lane that reaches every lobe and medium (metallic and
    transmission at 0, 1 or between, ior 1.0-2.4, roughness down to 0,
    anisotropic, every medium type, isotropic and forward phase
    functions), unit view vectors with the normal facing them, light
    samples half of them facing. The smoke launch's and the card tests'
    lanes."""
    rng = np.random.default_rng(seed)
    u = lambda *shape: rng.random(shape, dtype=np.float32)

    def some(values, shape=(r,)):
        """Each entry one of `values` (None: uniform in [0, 1))."""
        pick = rng.integers(0, len(values), shape)
        out = u(*shape)
        for k, val in enumerate(values):
            if val is not None:
                out[pick == k] = val
        return out

    def unit():
        x = rng.normal(size=(r, 3)).astype(np.float32)
        return x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-6)

    v, nrm, l_dir = unit(), unit(), unit()
    flip = np.sum(v * nrm, 1) < 0
    nrm[flip] = -nrm[flip]
    g = (1.8 * u(r) - 0.9).astype(np.float32)
    g[rng.random(r) < 0.2] = 0.0   # the isotropic branch of sample_hg
    mat = Material(
        emissive=np.zeros((r, 3), np.float32), base_color=u(r, 3),
        subsurface=some((0.0, None)), metallic=some((0.0, 1.0, None)),
        specular=u(r), specular_tint=some((0.0, None)),
        roughness=some((0.0, 0.02, None)), anisotropic=some((0.0, None)),
        sheen=some((0.0, None)), sheen_tint=u(r),
        clearcoat=some((0.0, 1.0, None)), clearcoat_gloss=u(r),
        ior=(1.0 + 1.4 * u(r)).astype(np.float32),
        transmission=some((0.0, 1.0, None)), medium_color=u(r, 3),
        medium_type=rng.integers(0, 4, r).astype(np.int32),
        medium_density=(2.0 * u(r)).astype(np.float32),
        medium_anisotropy=g)
    t = lambda x: torch.as_tensor(x, device=device)
    return dict(
        mat=Material(*(t(f) for f in mat)), v=t(v), n=t(nrm),
        hit_point=t(rng.normal(size=(r, 3)).astype(np.float32)),
        direction=t(-v), t=t((0.01 + 3.0 * u(r)).astype(np.float32)),
        history=t(u(r, 3)), lo=t(u(r, 3)),
        pid=t(rng.integers(0, 2**32, r, dtype=np.int64)),
        l_dir=t(l_dir), light_pdf=t((0.01 + 4.0 * u(r)).astype(np.float32)),
        light_fr=t(u(r, 3)), facing=t(np.sum(l_dir * nrm, 1) > 0),
        shadow_hit=t(rng.random(r) < 0.3))


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

    x = random_lanes(lanes, 0, device)
    sobol = sobol_all_dims(7, device=device)
    mat = x["mat"]
    names = ("pid", "v", "n", "hit_point", "direction", "t", "history", "lo",
             "l_dir", "light_pdf", "light_fr", "facing", "shadow_hit")
    inputs = tuple(mat) + tuple(x[k] for k in names)

    def unpack(flat):
        y = dict(zip(names, flat[len(mat):]))
        return type(mat)(*flat[:len(mat)]), y

    def bsdf(*flat, kernel=True):
        m, y = unpack(flat)
        fn = shade.shade_bsdf if kernel else shade.shade_bsdf_plain
        return fn(3, 7, sobol, y["pid"], m, y["v"], y["n"], y["hit_point"],
                  y["direction"], y["t"], y["history"], y["lo"]).history

    def nee(*flat, kernel=True):
        m, y = unpack(flat)
        fn = shade.shade_nee if kernel else shade.shade_nee_plain
        return fn(m, y["v"], y["n"], y["l_dir"], y["light_pdf"],
                  y["light_fr"], y["facing"], y["shadow_hit"], y["history"],
                  y["lo"], True)

    out = {"device": device_line(), "lanes": lanes}
    got = shade.shade_bsdf(3, 7, sobol, x["pid"], mat, x["v"], x["n"],
                           x["hit_point"], x["direction"], x["t"],
                           x["history"], x["lo"])
    want = shade.shade_bsdf_plain(3, 7, sobol, x["pid"], mat, x["v"],
                                  x["n"], x["hit_point"], x["direction"],
                                  x["t"], x["history"], x["lo"])
    same = (got.alive == want.alive) & (got.med_sampled == want.med_sampled)
    agree = {
        "shade_bsdf": {"decisions_equal": float(same.float().mean()),
                       **agreement([(g, w) for g, w in zip(got, want)
                                    if g.dtype == torch.float32], same)},
        "shade_nee": {"decisions_equal": None,
                      **agreement([(nee(*inputs), nee(*inputs, kernel=False))],
                                  torch.ones_like(same))}}
    for row in agree.values():
        row["within"] = ((row["decisions_equal"] is None
                          or row["decisions_equal"] >= 0.9999)
                         and row["values_off_share"] <= OFF_SHARE
                         and row["values_off_tail"] == 0)
    scatter = int(want.med_sampled.sum())
    visible = int((x["facing"] & ~x["shadow_hit"]).sum())
    for name, fn, kernel, nbytes in (
            ("shade_bsdf", bsdf, "shade_bsdf_kernel",
             LANE_BYTES["shade_bsdf"] * lanes
             + (LANE_BYTES["shade_bsdf_scatter"]
                - LANE_BYTES["shade_bsdf"]) * scatter),
            ("shade_nee", nee, "shade_nee_kernel",
             LANE_BYTES["shade_nee_hidden"] * lanes
             + (LANE_BYTES["shade_nee"]
                - LANE_BYTES["shade_nee_hidden"]) * visible)):
        us = hbm_ms(fn, inputs) * 1e3
        plain_ms = cuda_ms(lambda: fn(*inputs, kernel=False), repeats=5)
        bound, by = bound_us(nbytes, ops[kernel] * lanes)
        out[name] = {"us": us, "plain_ms": plain_ms, "bound_us": bound,
                     "bound_by": by, "bytes": nbytes,
                     "fp32_ops_per_lane": ops[kernel], **agree[name],
                     **regs.get(kernel, {})}
        row = out[name]
        decided = ("decides nothing" if row["decisions_equal"] is None else
                   f"alive and med_sampled equal on "
                   f"{row['decisions_equal']:.6f} of the lanes")
        print(f"shade_kernels: {name} {us:.2f} us at {lanes} lanes | bound "
              f"{bound:.2f} us ({by}; {nbytes} bytes, {ops[kernel]} FP32 "
              f"operations a lane) = {100 * bound / us:.1f}% | plain "
              f"{plain_ms:.3f} ms | {regs.get(kernel)} | {decided}; there "
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
