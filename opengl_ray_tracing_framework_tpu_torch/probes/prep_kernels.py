"""K1's preparation kernels alone (csrc/sweep_prep.cu: sweep_groups,
sweep_key, sweep_spans) at the main path's shapes, what their code issues
per (ray, cluster) pair, and their device time in one sweep pass.

    python -m opengl_ray_tracing_framework_tpu_torch.probes.prep_kernels

The casts are those of chip_smoke.py phase 3: on the 81,922-triangle scene
in blocks of 256 (484 clusters) a 131,072-ray primary cast, the merged
NEE-shadow + bounce cast of the first bounce of 65,536 primary rays (the
pair) and that of bounce 4 (the deep pair); the primary cast and pair on
the scene rebuilt in blocks of 512, 1,024 and 8 (243, 121 and 14,172
clusters) and on mesh_scene (29,442 clusters: group boxes in two chunks);
the same three casts on the 5,122-triangle jade scene (33 clusters, a
512x512 frame, the deep pair of bounce 3); and 8,193 boxes that every ray
enters (finite_case: every tile minimum finite, so every tile takes
sweep_spans's runs path). run_case holds each kernel to its plain version
on every output (torch.equal), then times it by CUDA-graph replays
(probes.graph_ms: the kernels back to back, no host between them, so a
cast of a few hundred rays is resolved too) beside the stable torch.sort
of the keys (probes.cuda_ms), its bound at the all-pairs count
(probes.prep_bound) and the member pairs both kernels test (the device
counter k1a_pairs_tested) against 2 x cast_pairs, with the cast's K1(a)
time: the two kernels and, where sweep_inputs launches it, sweep_groups;
chip_smoke.py phase 3 calls it with the plain versions' times. groups_case
holds sweep_groups to group_boxes_plain and times it, on the 14,172
clusters and on 30,741 random boxes (glass5m's count). sass_report reads
cuobjdump's SASS of the loaded library: for each kernel's innermost loops
that hold a slab test, the instructions per pair (a slab test has six
FMUL), split by the pipe they issue on, and at the pair the least time
each pipe's rate allows: pairs x instructions per pair over 132 SMs x (64
per clock on the ALU pipe, 128 on the FMA pipe, 128 issued) at the card's
top SM clock. pass_profile renders one sweep pass of chip_smoke.py's frame
(1024x512, 8 bounces, 1 spp, 65,536 rays a batch) under torch.profiler
after a warm pass: each kernel's device time and launches over the pass,
beside the device's time in all kernels. Last, the peak device memory of
one primary cast (sweep_inputs and K1) and one render_pass of the bench's
frame (131,072 rays a batch) on 484 and on 14,172 clusters.

It uses only entry points every tree of the port has had since the group
boxes came, so a copy of it runs in an older tree; two trees are compared
only inside one call on one card, in turns (parent, change, change,
parent). It prints a line per case and one JSON line last.
"""

from __future__ import annotations

import json
import re
import subprocess
import time
from collections import Counter
from pathlib import Path

import torch

from ..ops import sweep as sw
from ..utils import nvcc
from . import N_SMS, cuda_ms, device_line, graph_ms, prep_bound

PRIMARY_RAYS = 131072
PAIR_BATCH = 65536       # primary rays whose first bounce makes the pair
DEEP_BOUNCE = 5          # the deep pair: the merged cast of bounce 4
WIDE_T = (512, 1024)
SMALL_T = 8              # blocks of 8: 14,172 clusters
JADE = dict(subdiv=4, material="jade", width=512, height=512, bounces=4,
            label="jade ")   # jade5k's scene: 5,122 triangles, 33 clusters
MESH_SUBDIV, MESH_T = 7, 16   # 327,682 triangles in blocks of 16: 29,442
                              # clusters, group boxes in two chunks of 512
GLASS5M_CLUSTERS = 30741   # glass5m's clusters: group boxes in two chunks
BENCH_TILE = 131072      # the bench's rays a batch
PASS_BOUNCES = 8         # pass_profile's frame: chip_smoke.py's
ALU_PER_CLOCK, FMA_PER_CLOCK, ISSUE_PER_CLOCK = 64, 128, 128   # per SM
FMA_PIPE = {"FADD", "FMUL", "FFMA", "FADD32I", "FMUL32I", "FFMA32I", "IMAD",
            "IMUL", "IMAD32I", "HADD2", "HMUL2", "HFMA2"}
ALU_PIPE = {"FMNMX", "FSETP", "FSEL", "FSET", "ISETP", "IMNMX", "VIMNMX",
            "LOP3", "SEL", "PLOP3", "IADD3", "SHF", "LEA", "P2R", "R2P",
            "PRMT", "FCHK", "IABS"}
MEMORY = {"LDS", "STS", "ATOMS", "LDG", "STG", "SHFL"}
KERNELS = ("sweep_key_kernel", "sweep_spans_kernel")
OUTPUTS = ("key", "nspan", "spans", "tile_sorted", "rayfeat", "best")

_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                    r"([A-Z][A-Z0-9_]*)[^;]*?"
                    r"(?:(0x[0-9a-f]+)|`\((\.L_x_\d+)\))?\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")


def casts(device, blocks=WIDE_T, subdiv=6, material="tear_glass",
          width=1024, height=512, bounces=DEEP_BOUNCE, label=""):
    """{case: (scene, (origin, direction, mask, anyhit))} of the module's
    casts, on the card: the primary cast, the pair and the deep pair (of
    bounce `bounces` - 1) on the glass scene (or, with **JADE, the jade
    scene, each name after `label`), then the primary cast and the pair on
    the scene rebuilt in blocks of each of `blocks` triangles."""
    from .. import Camera, RenderConfig, build_test_scene
    from ..models.hdr import make_gradient_hdr
    from ..models.material import preset_materials
    from ..ops import integrator
    from ..render import pixel_order

    host, scene = build_test_scene(
        subdiv, material=preset_materials()[material],
        env=make_gradient_hdr(1024, 512), device=device)
    config = RenderConfig(width=width, height=height, max_bounce=bounces)
    camera = Camera.make(aspect=width / height).to(device)
    pid = pixel_order(config, 0, config.height, device)[:PRIMARY_RAYS]
    o, d = camera.generate_rays(
        ((pid % config.width).float() + 0.5) / config.width,
        ((pid // config.width).float() + 0.5) / config.height)
    ones = torch.ones(PRIMARY_RAYS, dtype=torch.bool, device=device)
    primary = (o, d, ones, torch.zeros_like(ones))

    captured, real = [], integrator.closest_hit_pair

    def capture(scene_, *rest):
        captured.append(rest[:6])
        return real(scene_, *rest)

    integrator.closest_hit_pair = capture
    try:
        with torch.no_grad():
            integrator.trace_radiance(scene, o[:PAIR_BATCH], d[:PAIR_BATCH],
                                      pid[:PAIR_BATCH], 1, config)
    finally:
        integrator.closest_hit_pair = real

    def merged(pair):
        o_a, d_a, m_a, o_c, d_c, m_c = pair
        return (torch.cat([o_a, o_c]), torch.cat([d_a, d_c]),
                torch.cat([m_a, m_c]),
                torch.cat([torch.ones_like(m_a), torch.zeros_like(m_c)]))

    pair = merged(captured[0])
    out = {f"{label}primary": (scene, primary), f"{label}pair": (scene, pair),
           f"{label}deep pair (bounce {bounces - 1})":
               (scene, merged(captured[-1]))}
    for t_blk in blocks:
        wide = host.build(cluster_size=t_blk, device=device)
        out[f"{label}primary, T {t_blk}"] = (wide, primary)
        out[f"{label}pair, T {t_blk}"] = (wide, pair)
    return out


def mesh_scene(device):
    """The glass scene's sphere at MESH_SUBDIV subdivisions (327,682
    triangles) in blocks of MESH_T: past 16,384 clusters, so the kernels
    stage their group boxes in two chunks, as on glass5m."""
    from .. import build_test_scene

    host, _ = build_test_scene(MESH_SUBDIV, device="cpu")
    return host.build(cluster_size=MESH_T, device=device)


def run_case(name, scene, rays, plain=False):
    """Hold sweep_key and sweep_spans to their plain versions on every
    output of one cast (padded as sweep_inputs pads it; RuntimeError if
    any differs), time each and print the case's line. Returns {"rays",
    "live", "clusters", "tiles", "pairs", "key_dtype", "nspan_min",
    "nspan_max", "sort_ms", "tested" (pairs_tested), "groups_ms" (the
    group boxes' time where sweep_inputs launches them, else None),
    "k1a_ms" (the two kernels' and the group boxes' times), "sweep_key":
    ..., "sweep_spans": ...}, each kernel's entry {"ms", "bound", "err"}
    (err 0.0: every output equal) and, with `plain`, the plain version's
    "plain_ms"."""
    o, d, m, a = sw.pad_cast(*rays)
    lo, hi = scene.cl_aabb_min, scene.cl_aabb_max
    args = (o, d, m, a, lo, hi)
    groups = sw.group_boxes(lo, hi)
    key = sw.sweep_key(o, d, m, lo, hi, groups)
    perm = torch.sort(key, stable=True).indices
    got = (key, *sw.sweep_spans(o, d, m, a, perm, lo, hi, groups))
    want = (sw.sweep_key_plain(o, d, m, lo, hi),
            *sw.sweep_spans_plain(o, d, m, a, perm, lo, hi))
    torch.cuda.synchronize()
    for label, g, w in zip(OUTPUTS, got, want):
        if g.dtype != w.dtype or not torch.equal(g, w):
            raise RuntimeError(
                f"prep {name}: {label} differs from the plain version in "
                f"{int((g != w).sum())} of {w.numel()} entries")
    calls = {"sweep_key": (lambda: sw.sweep_key(o, d, m, lo, hi, groups),
                           lambda: sw.sweep_key_plain(o, d, m, lo, hi)),
             "sweep_spans": (
                 lambda: sw.sweep_spans(o, d, m, a, perm, lo, hi, groups),
                 lambda: sw.sweep_spans_plain(o, d, m, a, perm, lo, hi))}
    r, c, live = o.shape[0], lo.shape[0], int(m.sum())
    launched = sw.group_boxes.launches
    sw.sweep_inputs(scene, o, d, m, a)
    out = dict(rays=r, live=live, clusters=c, tiles=r // sw.TILE_R,
               pairs=live * c, key_dtype=key.dtype,
               nspan_min=int(want[1].min()), nspan_max=int(want[1].max()),
               sort_ms=cuda_ms(lambda: torch.sort(key, stable=True)),
               tested=pairs_tested(args, perm, groups),
               groups_ms=(graph_ms(lambda: sw.group_boxes(lo, hi))
                          if sw.group_boxes.launches > launched else None))
    parts = []
    for kname, bound in zip(calls, bounds(args)[:2]):
        kernel, plain_fn = calls[kname]
        entry = dict(ms=graph_ms(kernel), bound=bound, err=0.0)
        # the group boxes skip most pairs: a kernel's time can fall below
        # the bound of testing them all
        text = (f"{kname} {entry['ms']:.4f} ms ({bound[0] / entry['ms']:.1%}"
                f" of the all-pairs bound {bound[0]:.4f} ms by {bound[1]})")
        if plain:
            entry["plain_ms"] = cuda_ms(plain_fn, repeats=2)
            text += f", plain {entry['plain_ms']:.3f} ms"
        out[kname] = entry
        parts.append(text)
    out["k1a_ms"] = (out["sweep_key"]["ms"] + out["sweep_spans"]["ms"]
                     + (out["groups_ms"] or 0.0))
    groups_text = ("no sweep_groups" if out["groups_ms"] is None
                   else f"sweep_groups {out['groups_ms']:.4f} ms")
    print(f"prep {name}: {r} rays ({live} live), {c} clusters, "
          f"{out['tiles']} tiles, spans/tile mean "
          f"{want[1].float().mean().item():.1f} max {out['nspan_max']} | "
          "every output equal | " + " | ".join(parts)
          + f" | {groups_text} | K1(a) {out['k1a_ms']:.4f} ms | torch.sort "
          f"of the {key.dtype} keys {out['sort_ms']:.4f} ms | member pairs "
          f"tested {out['tested']} of 2 x {r * c} cast_pairs "
          f"({out['tested'] / (2 * r * c):.4f})")
    return out


def random_boxes(device, c, seed=0):
    """c random cluster boxes (cl_min, cl_max) on the card, with -0.0 and
    zero-thick coordinates among them."""
    gen = torch.Generator(device=device).manual_seed(seed)
    lo = torch.rand((c, 3), generator=gen, device=device) * 10 - 5
    lo = torch.where(torch.rand((c, 3), generator=gen, device=device) < 0.05,
                     torch.tensor(-0.0, device=device), lo)
    size = torch.rand((c, 3), generator=gen, device=device) * 2
    flat = torch.rand((c, 3), generator=gen, device=device) < 0.1
    return lo, lo + torch.where(flat, torch.zeros_like(size), size)


def groups_case(name, lo, hi, plain=False):
    """Hold group_boxes (csrc/sweep_prep.cu's sweep_groups) to
    group_boxes_plain on the boxes lo / hi (torch.equal; RuntimeError if
    they differ), time it by CUDA-graph replays beside its bound (each box
    read once, each group box written once) and print the case's line.
    Returns {"clusters", "groups", "ms", "bound", "err"} and, with `plain`,
    "plain_ms"."""
    got, want = sw.group_boxes(lo, hi), sw.group_boxes_plain(lo, hi)
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.equal(got, want):
        raise RuntimeError(f"prep groups {name}: the group boxes differ from "
                           "the plain version")
    c, g = lo.shape[0], want.shape[1]
    bound = prep_bound(0, (c + g) * 24)
    out = dict(clusters=c, groups=g, bound=bound, err=0.0,
               ms=graph_ms(lambda: sw.group_boxes(lo, hi)))
    text = (f"prep groups {name}: {c} clusters, {g} group boxes, equal | "
            f"sweep_groups {out['ms']:.4f} ms ({bound[0] / out['ms']:.1%} of "
            f"its bound {bound[0]:.4f} ms by {bound[1]})")
    if plain:
        out["plain_ms"] = cuda_ms(lambda: sw.group_boxes_plain(lo, hi),
                                  repeats=5)
        text += f", plain {out['plain_ms']:.3f} ms"
    print(text)
    return out


def pairs_tested(args, perm, groups):
    """The member slab tests both kernels make on one cast (the device
    counter k1a_pairs_tested under tracing())."""
    from ..utils import timing

    o, d, m, a, lo, hi = args
    with timing.tracing(o.device) as rec:
        sw.sweep_key(o, d, m, lo, hi, groups)
        sw.sweep_spans(o, d, m, a, perm, lo, hi, groups)
    return rec.counters["k1a_pairs_tested"]


def bounds(args):
    """(sweep_key's, sweep_spans's probes.prep_bound, pairs) on these
    inputs at the all-pairs count: each input read once and each output
    written once, and sweep_spans's (G, C) scratch of 8-byte keys written
    once and read once."""
    o, _, m, _, lo, _ = args
    r, c, live = o.shape[0], lo.shape[0], int(m.sum())
    g = r // sw.TILE_R
    key_bytes = r * (24 + 1 + 4) + c * 24
    spans_bytes = (r * (24 + 2 + 8) + c * 24 + g * 4 + g * c * 8
                   + r * (16 + 8) * 4 + 2 * g * c * 8)
    return (prep_bound(live * c, key_bytes), prep_bound(live * c, spans_bytes),
            live * c)


def finite_case(device, n_rays=PRIMARY_RAYS):
    """(boxes, rays) where every ray enters every box: 8,193 unit cubes
    along the diagonal (cube k from k * 1e-3), rays along (1, 1, 1) from
    within 0.3 of (-1, -1, -1) on each axis (a line parallel to the
    diagonal enters every such cube), so every tile minimum is finite and
    each tile sorts and merges all of them. `boxes` has cl_aabb_min /
    cl_aabb_max and a cl_trifeat of empty blocks, as a scene has."""
    from types import SimpleNamespace

    c = 8193
    lo = torch.arange(c, device=device, dtype=torch.float32)[:, None] \
        * 1e-3 + torch.zeros((1, 3), device=device)
    gen = torch.Generator(device=device).manual_seed(c)
    o = torch.rand((n_rays, 3), generator=gen, device=device) * 0.6 - 1.3
    d = torch.full((n_rays, 3), 3 ** -0.5, device=device)
    ones = torch.ones(n_rays, dtype=torch.bool, device=device)
    return (SimpleNamespace(cl_aabb_min=lo, cl_aabb_max=lo + 1,
                            cl_trifeat=torch.zeros((c, 16, 4), device=device)),
            (o, d, ones, torch.zeros_like(ones)))


def sass_per_pair(lib: Path) -> dict:
    """parse_sass of `cuobjdump -sass` of the library."""
    tool = Path(nvcc._nvcc()).parent / "cuobjdump"
    return parse_sass(subprocess.run(
        [str(tool), "-sass", str(lib)], capture_output=True, text=True,
        check=True, timeout=120).stdout)


def parse_sass(text: str) -> dict:
    """{kernel: [loop, ...]}: for each innermost loop (a backward BRA, to
    a hex address or a .L_x label) of sweep_key_kernel / sweep_spans_kernel
    that holds a slab test, the pairs per iteration (its FMUL / 6) and the
    instructions per pair, in all, by pipe and by opcode; the loop with
    the most pairs an iteration first."""
    out = {}
    for part in re.split(r"\n\s*Function : ", text)[1:]:
        fname = part.split(None, 1)[0]
        # the name whole (mangled: its length before it, E after it), not
        # inside a longer one
        kernel = next((k for k in KERNELS
                       if f"{len(k)}{k}E" in fname or f"{k}(" in fname),
                      None)
        if kernel is None:
            continue
        instrs, labels, pending = [], {}, []
        for line in part.splitlines():
            lab = _LABEL.match(line)
            if lab:
                pending.append(lab.group(1))
                continue
            mt = _INSTR.search(line)
            if mt:
                addr = int(mt.group(1), 16)
                for name in pending:
                    labels[name] = addr
                pending = []
                instrs.append((addr, mt.group(2), mt.group(3) or mt.group(4)))
        loops = []
        for addr, op, target in instrs:
            if op != "BRA" or target is None:
                continue
            t = labels.get(target) if target.startswith(".") \
                else int(target, 16)
            if t is not None and t <= addr:
                loops.append((t, addr))
        inner = [lp for lp in loops if not any(
            o != lp and lp[0] <= o[0] and o[1] <= lp[1] for o in loops)]
        found = []
        for t, a in inner:
            ops = Counter(op for addr, op, _ in instrs if t <= addr <= a)
            pairs = ops["FMUL"] / 6
            if pairs < 1:
                continue
            per = {k: v / pairs for k, v in ops.items()}
            found.append(dict(
                pairs_per_iteration=pairs,
                instructions=sum(per.values()),
                fma=sum(v for k, v in per.items() if k in FMA_PIPE),
                alu=sum(v for k, v in per.items() if k in ALU_PIPE),
                memory=sum(v for k, v in per.items() if k in MEMORY),
                opcodes=dict(sorted(per.items()))))
        out[kernel] = sorted(found, key=lambda f: -f["pairs_per_iteration"])
    return out


def clocks_mhz():
    """(SM clock now, top SM clock) in MHz by nvidia-smi."""
    text = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    now, top = (float(x) for x in text.split(","))
    return now, top


def pipe_ms(loop, pairs, mhz):
    """The least ms each pipe's rate allows `pairs` pairs of `loop`."""
    per_ms = N_SMS * mhz * 1e3
    return {"alu": pairs * loop["alu"] / (ALU_PER_CLOCK * per_ms),
            "fma": pairs * loop["fma"] / (FMA_PER_CLOCK * per_ms),
            "issue": pairs * loop["instructions"] / (ISSUE_PER_CLOCK * per_ms)}


def sass_report(pairs):
    """sass_per_pair of the loaded sweep_prep library, each loop with its
    pipe_ms at `pairs` pairs and the card's top SM clock; prints a line a
    loop. Returns {"sass", "sm_clock_mhz", "sm_clock_max_mhz"}."""
    now, top = clocks_mhz()
    sass = sass_per_pair(nvcc.build("sweep_prep")[0])
    for kernel, loops in sass.items():
        for i, loop in enumerate(loops):
            reck = pipe_ms(loop, pairs, top)
            loop["pair_ms_by_pipe"] = reck
            print(f"prep sass {kernel} loop {i}: "
                  f"{loop['pairs_per_iteration']:g} pairs an iteration | per "
                  f"pair {loop['instructions']:.2f} instructions: FMA pipe "
                  f"{loop['fma']:.2f}, ALU pipe {loop['alu']:.2f}, memory "
                  f"{loop['memory']:.2f} | at {pairs} pairs ({top:.0f} MHz) "
                  f"ALU {reck['alu']:.4f} ms, FMA {reck['fma']:.4f} ms, "
                  f"issue {reck['issue']:.4f} ms | "
                  + ", ".join(f"{k} {v:.2f}"
                              for k, v in loop["opcodes"].items()))
    if set(sass) != set(KERNELS) or not all(sass.values()):
        raise RuntimeError(f"prep sass: no slab-test loop found in {sass}")
    return {"sass": sass, "sm_clock_mhz": now, "sm_clock_max_mhz": top}


def pass_profile(scene, device):
    """One sweep pass of chip_smoke.py's frame under torch.profiler, after
    a warm pass. Returns {"pass_s", "busy_ms", kernel: {"ms", "launches"}}
    for KERNELS and K1 (sweep_kernel): device times over the pass."""
    from torch.profiler import ProfilerActivity, profile
    from .. import Camera, RenderConfig, render_progressive

    config = RenderConfig(width=1024, height=512, max_bounce=PASS_BOUNCES)
    camera = Camera.make(aspect=2.0).to(device)

    def one_pass():
        image, _ = render_progressive(scene, camera, config, n_iterations=1,
                                      rays_per_tile=PAIR_BATCH)
        float(image[0, 0, 0])   # host copy: the pass has finished

    one_pass()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one_pass()
        pass_s = time.perf_counter() - t0
    # device-side events only: a host op's row repeats its kernels' time
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    out = {"pass_s": pass_s, "busy_ms": sum(r[1] for r in rows)}
    for kernel in (*KERNELS, "sweep_kernel"):
        hits = [r for r in rows if re.search(rf"\b{kernel}\b", r[0])]
        out[kernel] = {"ms": sum(r[1] for r in hits),
                       "launches": sum(r[2] for r in hits)}
    if not all(out[k]["launches"] for k in KERNELS):
        raise RuntimeError(f"prep pass: the profiler saw {out}")
    k1a = sum(out[k]["ms"] for k in KERNELS)
    print(f"prep pass: {pass_s:.3f} s under the profiler, device in kernels "
          f"{out['busy_ms']:.3f} ms | "
          + " | ".join(f"{k} {out[k]['ms']:.4f} ms in {out[k]['launches']} "
                       "launches" for k in (*KERNELS, "sweep_kernel"))
          + f" | K1(a) {k1a:.4f} ms a pass")
    return out


def cast_peak_gib(scene, rays):
    """Peak device GiB of one sweep cast (sweep_inputs, then K1) on rays
    already on the card, above what was allocated before it."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    args, _ = sw.sweep_inputs(scene, *rays)
    sw.sweep(*args)
    del args
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - before) / 2**30


def bench_pass(scene, device):
    """One render_pass of the bench's frame with the sweep tracer after a
    warm pass: {"pass_s", "peak_gib", "k1_launches", "prep_launches",
    "plain_calls"}, fenced by a host copy; RuntimeError if a plain
    version ran."""
    from .. import Camera, RenderConfig
    from ..bench import counts
    from ..render import init_render_state, render_pass

    config = RenderConfig(width=1024, height=512, max_bounce=PASS_BOUNCES)
    camera = Camera.make(aspect=2.0).to(device)
    state = render_pass(scene, camera, init_render_state(config, device),
                        config, BENCH_TILE)
    float(state.accum[0, 0, 0])
    torch.cuda.reset_peak_memory_stats()
    before = counts()
    prep = sw.sweep_spans.launches
    t0 = time.perf_counter()
    state = render_pass(scene, camera, state, config, BENCH_TILE)
    float(state.accum[0, 0, 0])   # host copy: the pass has finished
    out = {"pass_s": time.perf_counter() - t0,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "k1_launches": counts()[0] - before[0],
           "prep_launches": sw.sweep_spans.launches - prep,
           "plain_calls": counts()[2] - before[2],
           "image_mean": state.accum.mean().item()}
    if out["plain_calls"] or not out["k1_launches"]:
        raise RuntimeError(f"bench pass: {out}")
    return out


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.parse_args(argv)
    dev = torch.device("cuda")
    print(device_line())
    result = {"device": device_line(), "cases": {}, "groups": {},
              "cast_peak_gib": {}, "bench_pass": {}}
    cases = casts(dev, blocks=(*WIDE_T, SMALL_T))
    cases.update(casts(dev, blocks=(), **JADE))
    mesh = mesh_scene(dev)
    for cast in ("primary", "pair"):
        cases[f"{cast}, {mesh.cl_aabb_min.shape[0]} clusters"] = (
            mesh, cases[cast][1])
    boxes, rays = finite_case(dev)
    finite = f"{boxes.cl_aabb_min.shape[0]} clusters, every minimum finite"
    cases[finite] = (boxes, rays)
    for name, (scene, rays) in cases.items():
        result["cases"][name] = run_case(name, scene, rays)
    if result["cases"][finite]["nspan_min"] != boxes.cl_aabb_min.shape[0]:
        raise RuntimeError(f"prep {finite}: a tile minimum is INF")
    small = cases[f"primary, T {SMALL_T}"][0]
    for name, (lo, hi) in (
            (f"T {SMALL_T}", (small.cl_aabb_min, small.cl_aabb_max)),
            (f"random, {GLASS5M_CLUSTERS}",
             random_boxes(dev, GLASS5M_CLUSTERS))):
        result["groups"][name] = groups_case(name, lo, hi)
    result.update(sass_report(result["cases"]["pair"]["pairs"]))
    result["pass"] = pass_profile(cases["primary"][0], dev)
    for scene, rays in (cases["primary"], cases[f"primary, T {SMALL_T}"]):
        label = f"{scene.cl_aabb_min.shape[0]} clusters"
        peak = result["cast_peak_gib"][label] = cast_peak_gib(scene, rays)
        res = result["bench_pass"][label] = bench_pass(scene, dev)
        print(f"prep pass {label}: one primary cast of {rays[0].shape[0]} "
              f"rays peaks {peak:.4f} GiB above its inputs | one bench pass "
              f"(1024x512, {PASS_BOUNCES} bounces, {BENCH_TILE} rays a "
              f"batch) {res['pass_s']:.3f} s, peak {res['peak_gib']:.4f} "
              f"GiB, K1 launches {res['k1_launches']}, sweep_spans launches "
              f"{res['prep_launches']}, plain calls {res['plain_calls']}, "
              f"image mean {res['image_mean']:.6f}")
    for res in result["cases"].values():
        res["key_dtype"] = str(res["key_dtype"])
    print(json.dumps(result))


if __name__ == "__main__":
    main()
