#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py [--png PATH] [--profile]

Run from the repository root. It fails (exit code != 0, no result line)
when torch sees no CUDA device, and when anything below fails:

 1. device: the card's name and power limit (nvidia-smi);
 2. build: nvcc compiles every source of csrc/ (sweep.cu, the span-sweep
    kernel K1; sweep_prep.cu, K1's preparation kernels sweep_groups,
    sweep_key and sweep_spans; cluster_intersect.cu, the cluster-intersect kernel K2;
    shade.cu, the forward bounce's shading kernels shade_light,
    shade_bsdf and shade_env; the four probe kernels probe_copy,
    probe_gather, probe_smem (with the empty launch-floor kernel),
    probe_stream), all started together;
 3. K1 against its plain version on the card, at the main path's shapes:
    the 81,922-triangle procedural scene (loong-100k's scale), a
    65,536-ray primary cast, the first bounce's merged NEE-shadow + bounce
    cast of the same rays, the merged cast of bounce 4 (few rays whose
    tiles overlap many clusters: where a pass spends the kernel's time),
    the primary cast against cluster blocks cut to a T that is no multiple
    of 4, and the span-latency cases (1, 132 and 1,024 tiles that each
    walk exactly 64 spans: microseconds per span of a tile's walk), each
    held against sweep_plain on the same inputs and timed with CUDA events;
    then wide cluster blocks: the scene rebuilt with cluster_size 512 and
    1,024 (the primary cast, the pair and the deep pair), its 512 blocks
    cut to T = 302, and a 20,482-triangle scene in blocks of 4,096 cast at
    a 128x64 grid of the frame, each equal to sweep_plain (every hit and
    triangle, t to 1e-6 relative), with its bound and microseconds per
    span of the longest walk; then K1's preparation kernels (sweep_key,
    sweep_spans, both culled by the group boxes of sweep_groups) against
    their plain versions, every output equal (torch.equal; the key
    int32), on a 131,072-ray primary cast, the first bounce's merged pair,
    the bounce-4 pair, the primary cast and pair on the blocks of 512 and
    1,024, 8,193 boxes that every ray enters (every tile minimum finite,
    so every tile takes sweep_spans's runs path), and the primary cast and
    pair on the scene rebuilt in blocks of 8 (14,172 clusters) and on its
    sphere at 7 subdivisions in blocks of 16 (327,682 triangles in 29,442
    clusters: group boxes in two chunks), each timed by CUDA-graph replays
    beside its plain version, the stable torch.sort of the keys and its
    bound (probes/prep_kernels.py's run_case), and the SASS instructions
    per (ray, cluster) pair of each kernel's slab-test loop by pipe; the
    group boxes (sweep_groups) of the last two scenes and of 30,741 random
    boxes (glass5m's count) equal to group_boxes_plain, timed beside their
    bound; and K1 on the primary cast and pair on blocks of 8 against
    sweep_plain (every hit and triangle equal);
 4. K2 against its plain version at the schedule path's shapes: the same
    primary batch and the first bounce's bounce cast, with spans / nspan
    from the tracer's real votes; every round's launch is compared, the
    first round and the round with the most elected spans are timed, and
    the mean launch over all rounds of the bounce cast beside the plain
    version's and the mean bound; then the same casts on the wide blocks
    of phase 3 (and the 4,096 scene's grid), every round equal to the
    plain version as in phase 3, round 0 timed;
 5. the default render: render_progressive at 1024x512, 8 bounces, BSDF,
    HDR environment + MIS, tear-glass sphere, 1024x512 procedural HDR,
    sweep tracer; one warm-up pass and two timed passes, each fenced by a
    host copy; K1 and both preparation kernels must be launched, with one
    sweep_groups a cast, and their plain versions never called, and the
    shading kernels shade_light, shade_bsdf and shade_env once a bounce
    each (as many launches of each, at most one a bounce of a batch);
 6. card against CPU: render_radiance at 128x64, 2 spp, 8 bounces, on the
    card (kernel) and on the CPU (plain version), held to the hardware
    lane's image criterion (tests/test_tpu.py:57-60); then the same on
    phase 3's blocks of 8 (sweep_key, sweep_spans and one sweep_groups a
    cast launched, no plain version called on the card);
 7. the schedule render: the same frame with cast_backend="schedule", one
    warm-up and one timed pass; K2 must be launched, its plain version and
    K1 never; then the schedule image against the sweep image on the card
    at 128x64, 2 spp, by the same criterion; then one pass of the full
    frame with each cluster tracer on the scene in blocks of 1,024, held
    against phase 5's first pass by the same criterion (K1 or K2 launched,
    no plain call);
 8. BRDF mode (enable_bsdf=False, sweep tracer): one full-width pass, and
    card against CPU at 128x64;
 9. cast_backend="bvh" and use_bvh=False at 128x64, 1 spp against the
    sweep image (kernel-free tracers, host loops).

10. the probe kernels against their plain versions at the probes' own
    shapes (the copy probe at tile 8,192, then at tile 128 with and
    without span rows, then a finding line: the copy reading every
    rayfeat row whole against half of it, in turns, an empty grid of the
    same 1,024 CTAs, and one add of the bound's bytes in contiguous rows;
    the gather at a 4,096-entry table from global and from shared memory,
    each beside its one-call library counterpart; the 8 chained lookups
    (probe_chained) on (S, 128) tables whose columns differ, S = 512,
    1,024, 2,048, 3,000 and last the TPU's 4,096, with one torch.gather
    step timed as context: no PyTorch call chains them; the card's launch
    floor, an empty one-CTA kernel, on a line of its own, then the
    shared-memory probe at 512 B and at 227 KB, each bounded by that floor
    (the larger of it and the bytes bound, "launch"); the block sums for
    132 rows of starts, with the L2 rate their re-reads reach, and last
    for the TPU's own single row, each beside embedding_bag), by exact
    equality (they copy, add, gather and chain integer lookups; the block
    sums of integer-valued floats are exact in any order; with random
    floats they are held to rtol 1e-5), each with its kernel, plain and
    library time and its bytes bound (the block sums' bound counts each
    distinct table row that the starts cover once). Kernel and library
    times are device times with the inputs coming from HBM (launches of
    one CUDA graph rotate over enough copies of the inputs to evict each
    from L2 before its turn comes again), which is what the bound
    assumes: a time below the bound fails the run. The time with the
    inputs left in L2 is printed beside it and goes nowhere else;
    Then the shading kernels (probes/shade_kernels.py) at 131,072 random
    lanes (hits on random triangles, materials read by id that reach
    every lobe and medium, a random environment), held to the plain
    versions: each kernel's decisions (shade_light: facing, the material
    id, the light sample's texel; shade_bsdf: the lobe, alive and
    med_sampled; shade_env: the miss texel) equal on at least 99.99% of
    the lanes, and there every output within tests/test_torch_shade.py's
    close_ill_conditioned limits (1e-5 + 1e-5 relative on all but 0.2% of
    the values, 1e-5 + 1e-4 relative on all); each kernel's time (from
    HBM) no less than its bytes bound, beside the plain versions' time and
    the wrapper's host time a call;
11. the probes as a user runs them (probes/launch_overhead.py, gather.py,
    card_perf.py, kernel_build.py): microseconds per CTA, lookups per
    second from global and shared memory, the chained lookups at every S,
    the shared-memory ceiling (the 228 KB request must be refused and
    nothing below it), the block sums for one and 132 rows of starts,
    torch's sorts and gathers, cold nvcc builds into a temporary directory
    with first and steady launches, and the ladder host prep / kernel
    alone / casts / batch / pass;
12. the gradient path: material_grad at full width (1024x512, 8 bounces,
    65,536 rays per batch) against a target rendered with another sphere
    material, one warm-up and one timed step fenced by a host copy of the
    gradients: loss and every gradient finite, one nonzero, the forward
    pass's count of K1 launches and not one more (the backward launches no
    kernel) and no shading kernel (autograd records the plain code), no
    plain call; camera_grad and geometry_grad at 128x64;
    material_grad at 128x64 on the scene in blocks of 1,024 against the
    same step on blocks of 256 (loss to rtol 1e-5, leaves to 2e-4 of their
    largest entry); card
    against CPU gradients at 128x64, 2 spp (loss to rtol 1e-4, every
    gradient leaf to 5e-3 of its largest entry, the camera's scalar
    leaves to 2e-2: same hits, float order differs; camera and geometry
    at 2 bounces, where the gradients are well-conditioned); material_grad at 256x256, 8 bounces for brown_glass and
    white; one central finite difference of a base_color entry (within
    25%: detached sampling sees no lobe flips);
13. the CLI on the card: cli.main in this process with --scene test at
    1024x512, 8 bounces, 3 spp, --progress-every 1, --timing and
    --save-state (its JSON line parsed, K1 launched, the plain sweep never
    called), then --resume with 1 spp more, whose accumulator must equal a
    continuous 4-spp render exactly; the --timing table (host ms a pass
    by span, the pass's wall and CUDA-event ms) of that run and of phase 3's
    81,922-triangle scene; then the CLI as a user runs it, a subprocess
    `python -m ...cli --scene loong --material brown_glass` at 1024x512,
    8 bounces, 2 spp, with ORTF_ASSETS naming a temporary directory that
    holds the floor quad and, as objects/loong_100000.obj, a stand-in for
    the loong asset (which is not in the repository): the subdiv-6
    icosphere, 81,920 triangles, written as OBJ text;
14. multi-device on the card (parallel/sharding.py, spawned ranks): NCCL
    with one rank, render_pass_sharded at full width against phase 5's
    first pass (image criterion) and material_grad_sharded against phase
    12's material_grad (loss to rtol 1e-5, leaves to 2e-4 of their
    largest entry); gloo with two ranks sharing the card (NCCL refuses
    that), the 1-D mesh (2 tiles) and the 2-D mesh (1 tile x 2 spp)
    against phase 5's first and second passes, param_grad_sharded for the
    material at full width and for the camera and the geometry at 128x64,
    2 bounces against one process's gradients (loss rtol 1e-4, leaves
    rtol 5e-3 with an atol of 1e-4 of the leaf's largest entry). Each
    rank's K1 launches (> 0), plain calls (0) and seconds are printed; two
    ranks on one card give no scaling figure;
15. the bench as a user runs it: `python3 bench_torch.py` in a subprocess
    once per tracer (BENCH_TRACER sweep, then schedule) at the reference
    frame with BENCH_PASSES=2; each run's JSON line is printed and must
    carry every field, name this card with its power limit, hold its
    correctness check (`correct`), call no plain version, and launch its
    tracer's kernel (K1 or K2) and not the other's.
16. the row-balance probe (probes/row_balance.py, the port of
    exp/scaling_probe.py's `tpu` mode) once per tracer on phase 5's
    scene and frame: 8 blocks of 64 rows, 131,072 rays per batch, frame 1,
    a warm-up and 3 timed calls per block, and one call per block with
    CUDA events around each K1 or K2 launch; the stacked blocks must agree
    with one whole-frame _trace_rows of the same frame by the image
    criterion, every block be finite with a positive mean, launch its
    tracer's kernel and not the other's and call no plain version, every
    efficiency (wall and kernel) lie in (0, 1] and every block's kernel
    time be positive. Its JSON line is printed with the phase's seconds.

Each kernel's bound is the least time the card could take for the work
this run's inputs need: the larger of its FP32 operations over the card's
CUDA-core peak and its bytes (each input read once, each output written
once) over the HBM rate (NVIDIA's H100 SXM data sheet: 67 TFLOP/s FP32,
3.35 TB/s); the shared-memory probe's work is one launch of one CTA, so
its bound is the card's launch floor measured in the same run (an empty
one-CTA kernel), "launch", where that is the larger. Neither K1 nor K2 has
one PyTorch call that computes the same
function, so their library_ms is null, as are the chained lookups' and
the preparation kernels' (torch.sort, the one library call inside their
function, is timed alone beside them); the
other probe kernels have one each (an add of a slice, index_select,
embedding_bag), timed here and used nowhere in the port. The kernels line
has one entry per kernel: csrc/probe_gather.cu holds two, the gather
(probe_gather) and the chained lookups (probe_chained), and csrc/shade.cu
three, shade_light, shade_bsdf and shade_env, which replace no TPU kernel;
and
csrc/sweep_prep.cu three, sweep_key and sweep_spans (their main case the
pair on 484 clusters) and sweep_groups (which replaces no TPU kernel; its
main case the 30,741 random boxes), their launches phase 5's.

It prints one line of numbers per phase, then a JSON line describing the
kernels, then {"ok": true, "device": {...}} as the last line. --profile
adds, before those two, a torch.profiler summary of one sweep pass and one
schedule pass (device time in kernels, the kernels that took most of it,
K1's, K1's preparation kernels' and K2's time per launch), K1's device
time by cast site, and for each of phase 16's row blocks the profiler's
K1 or K2 device time and its device time in all kernels beside the
probe's CUDA-event figure.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor

WIDTH, HEIGHT, BOUNCES = 1024, 512, 8
RAYS_PER_TILE = 65536
REPEATS = 5
DEEP_BOUNCE = 5             # phase 3 also takes the merged cast of bounce 4
RAGGED_T = 250              # a cluster block width that is no multiple of 4
WIDE_T = (512, 1024)        # the scene rebuilt in cluster blocks this wide
RAGGED_WIDE_T = 302         # a wide block width that is no multiple of 4
WIDEST_T, WIDEST_SUBDIV = 4096, 5   # the widest block, on a 20,482-triangle
                                    # scene, cast at WIDEST_GRID
WIDEST_GRID = (128, 64)
PEAK_HBM_BYTES = 3.35e12    # H100 SXM, HBM3
CLI_RAYS_PER_TILE = 131072  # the CLI's default --rays-per-tile
RANKS_TIMEOUT_S = 600       # a spawned group that takes longer fails
PREP_RAYS = 131072          # the preparation kernels' primary cast
SMALL_T = 8                 # blocks of 8: 14,172 clusters
GROUP_CASE_CLUSTERS = 30741   # glass5m's clusters: random boxes for
                              # sweep_groups
PORT = "opengl_ray_tracing_framework_tpu_torch"
EXPECTED_KERNELS = {"sweep", "sweep_prep", "cluster_intersect", "shade",
                    "probe_copy", "probe_gather", "probe_smem",
                    "probe_stream"}
SHADE_KERNELS = ("shade_light", "shade_bsdf", "shade_env")   # shade.cu's


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, repeats=REPEATS) -> float:
    """Mean milliseconds of fn() over `repeats` runs, by CUDA events, after
    one warm-up run."""
    from opengl_ray_tracing_framework_tpu_torch import probes
    return probes.cuda_ms(fn, repeats)


def compare_records(got, want, slot2tri, label, min_hit_agree=0.9999,
                    strict=False, k2=False):
    """The sweep criterion on two (R, 8) records: hit/miss agreement, t to
    1e-4, the same triangle on >= 99.5% of common hits, inside equal where
    the triangle agrees; strict: every hit and triangle equal, t to 1e-6
    relative (the plain version's cuBLAS product may sum in another order
    than the kernel's fmaf chain and round t 1 ulp apart). The slot lane
    holds K1's int32 bits (ops/sweep.py::record_slots), or with k2 K2's
    float32 value. Returns (max |t_got - t_want| over common hits, hit/miss
    agreement, triangle agreement)."""
    import torch

    from opengl_ray_tracing_framework_tpu_torch.ops.sweep import record_slots
    slots = (lambda b: b[:, 1].long()) if k2 else \
        (lambda b: record_slots(b).long())
    gs, ws = slots(got), slots(want)
    gh, wh = gs >= 0, ws >= 0
    agree = (gh == wh).float().mean().item()
    if agree < min_hit_agree:
        fail(f"{label}: hit/miss agreement {agree:.6f} < {min_hit_agree}")
    both = gh & wh
    gt, wt = got[both, 0], want[both, 0]
    if not torch.allclose(gt, wt, rtol=1e-4, atol=1e-4):
        fail(f"{label}: t differs beyond 1e-4")
    same = slot2tri[gs[both]] == slot2tri[ws[both]]
    tri_agree = same.float().mean().item() if same.numel() else 1.0
    if tri_agree < 0.995:
        fail(f"{label}: triangle agreement {tri_agree:.6f} < 0.995")
    if not torch.equal(got[both, 2][same], want[both, 2][same]):
        fail(f"{label}: inside flag differs")
    err = (gt - wt).abs().max().item() if gt.numel() else 0.0
    # strict: counts, not the means above (a mean over the card can round
    # to 1 - 2^-24 where every element agrees)
    if strict and not (bool((gh == wh).all()) and bool(same.all())
                       and torch.allclose(gt, wt, rtol=1e-6, atol=0.0)):
        fail(f"{label}: hit/miss agreement {agree:.6f}, triangle agreement "
             f"{tri_agree:.6f}, max |dt| {err:.3g}: not equal")
    return err, agree, tri_agree


def compare_images(label, img, ref, note=""):
    """The port's image criterion (bench.images_agree: tests/test_tpu.py:
    57-60) on two (H, W, 3) tensors; prints the gaps, fails unless held."""
    from opengl_ray_tracing_framework_tpu_torch.bench import images_agree
    g, c = img.cpu().numpy(), ref.cpu().numpy()
    held, rel_mean, mismatch = images_agree(g, c)
    print(f"{label}: {note}mean {g.mean():.6f} vs {c.mean():.6f} (rel "
          f"{rel_mean:.2e}) | values off at 1e-3: {mismatch:.2e}")
    if not held:
        fail(f"{label}: the images disagree")


def timed_passes(ortf, scene, camera, config, n_passes, keep=None):
    """render_progressive for n_passes, each fenced by a host copy.
    Returns (display image, per-pass seconds); `keep`, a list, receives
    the accumulator after each pass."""
    stamps = [time.perf_counter()]

    def fence(state, i):
        float(state.accum[0, 0, 0])   # host copy: the pass has finished
        stamps.append(time.perf_counter())
        if keep is not None:
            keep.append(state.accum)

    image, _ = ortf.render_progressive(
        scene, camera, config, n_iterations=n_passes, callback=fence,
        rays_per_tile=RAYS_PER_TILE)
    return image.float(), [b - a for a, b in zip(stamps, stamps[1:])]


def profile_pass(label, ortf, scene, camera, config):
    """One warm pass under torch.profiler: its wall time, the time the
    device spent in kernels, and the kernels that took most of it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, pass_s = timed_passes(ortf, scene, camera, config, 1)
        torch.cuda.synchronize()
    # device-side events only: a host op's row repeats its kernels' time
    rows = [(e.key, e.self_device_time_total / 1e6, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not rows:
        fail(f"profile {label}: the profiler saw no device time")
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    top = "; ".join(f"{k[:48]} {t * 1e3:.1f} ms x{n}" for k, t, n in rows[:6])
    print(f"profile {label}: pass {pass_s[0]:.3f} s under the profiler | "
          f"device in kernels {busy:.3f} s ({busy / pass_s[0]:.1%} of it), "
          f"{sum(r[2] for r in rows)} device operations | top: {top}")
    for kernel in ("sweep_kernel", "sweep_groups_kernel", "sweep_key_kernel",
                   "sweep_spans_kernel", "cluster_intersect_kernel"):
        hits = [r for r in rows if kernel in r[0]]
        if hits:
            t, n = sum(r[1] for r in hits), sum(r[2] for r in hits)
            print(f"profile {label}: {kernel} {t * 1e3:.1f} ms in {n} "
                  f"launches, {t / n * 1e3:.4f} ms each")


def profile_row_blocks(scene, camera, config):
    """Each of phase 16's row blocks traced once under torch.profiler per
    tracer: the device time of its K1 or K2 launches and of all its
    kernels, beside the probe's CUDA-event kernel_ms of the same blocks,
    with the efficiency of each."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from opengl_ray_tracing_framework_tpu_torch.probes import row_balance
    from opengl_ray_tracing_framework_tpu_torch.render import _trace_rows
    for tracer, kernel in (("sweep", "sweep_kernel"),
                           ("schedule", "cluster_intersect_kernel")):
        cfg = config.replace(cast_backend=tracer)
        res = row_balance.block_seconds(scene, camera, cfg, repeats=1)
        rows = cfg.height // res["blocks"]
        own, busy = [], []
        for b in range(res["blocks"]):
            with torch.no_grad(), profile(activities=[
                    ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                _trace_rows(scene, camera, res["frame"], cfg, b * rows, rows,
                            res["rays_per_tile"])
                torch.cuda.synchronize()
            dev = [(e.key, e.self_device_time_total / 1e3)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
            own.append(sum(t for k, t in dev if kernel in k))
            busy.append(sum(t for _, t in dev))
        if not all(own):
            fail(f"profile row blocks, {tracer}: no {kernel} time")
        for label, ms in (("events", res["kernel_ms"]),
                          (f"profiler {kernel}", own),
                          ("profiler all kernels", busy)):
            print(f"profile row blocks, {tracer} tracer, {label}: ms "
                  f"{json.dumps(ms)} | efficiency "
                  f"{json.dumps(row_balance.efficiency(ms))}")


def profile_k1_casts(ortf, sw, scene, camera, config):
    """One warm sweep pass with CUDA events around every K1 launch: the
    kernel's device time by cast site (the primary cast and each bounce's
    merged cast, summed over the pass's batches), with the rays, the live
    rays and the clusters each tile overlaps. The reads of the span counts
    synchronise the host, so this pass's wall time is not a reading."""
    import torch
    real_sweep, log = sw.sweep, []

    def timed_sweep(nspan, spans, tile_sorted, rayfeat, best, trifeat):
        live = int((best[:, 0] > 0).sum())     # masked rays carry -INF
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = real_sweep(nspan, spans, tile_sorted, rayfeat, best, trifeat)
        end.record()
        log.append((start, end, best.shape[0], live,
                    nspan.float().mean().item(), int(nspan.max())))
        return out

    timed_sweep.launches = 0   # the wrapper counts on the module's name
    sw.sweep = timed_sweep
    try:
        timed_passes(ortf, scene, camera, config, 1)
    finally:
        sw.sweep = real_sweep
    torch.cuda.synchronize()
    sites = 1 + config.max_bounce
    if len(log) % sites:
        fail(f"profile: {len(log)} K1 launches are not batches of {sites}")
    total = 0.0
    for site in range(sites):
        rows = log[site::sites]
        ms = sum(a.elapsed_time(b) for a, b, *_ in rows)
        total += ms
        n = len(rows)
        print(f"profile K1 {'primary' if site == 0 else f'bounce {site - 1}'}"
              f": {n} launches, {ms:.2f} ms | per launch "
              f"{sum(r[2] for r in rows) / n:,.0f} rays, "
              f"{sum(r[3] for r in rows) / n:,.0f} live, clusters "
              f"overlapped per tile mean {sum(r[4] for r in rows) / n:.1f} "
              f"max {max(r[5] for r in rows)}")
    print(f"profile K1: {len(log)} launches, {total:.2f} ms by CUDA events")


def check_image(label, img):
    import torch
    finite = bool(torch.isfinite(img).all())
    mean = img.mean().item()
    if not finite or not mean > 0:
        fail(f"{label}: the image is not finite with a positive mean")
    return mean


def probe_phases(scene, camera, config):
    """Phases 10 and 11. Returns the probe kernels' entries of the kernels
    line (without their launch counts) and the counts of phase 11."""
    import torch
    import torch.nn.functional as F
    from opengl_ray_tracing_framework_tpu_torch import probes
    from opengl_ray_tracing_framework_tpu_torch.probes import (
        card_perf, gather, kernel_build, launch_overhead)

    dev = scene.device
    entries = {}

    def compare(name, label, kernel, plain, library, inputs, nbytes,
                replaces, rtol=0.0, library_inputs=None, context=None,
                source=None, floor_ms=None):
        """Hold kernel(*inputs) against plain(*inputs) (exactly, or to
        rtol), time both and the one-call library(*library_inputs) (None:
        there is none), and record the case as the kernel's entry: the
        last case of a kernel is the one the kernels line reports. The
        kernel's and the library's times are device times with the inputs
        coming from HBM (probes.hbm_ms), as the bound assumes; the time
        with the inputs left in L2 is printed on this line only, as is
        the time of `context` (a call that computes part of the function,
        on library_inputs; not the library's). `source`: the kernel's
        file under csrc/ when it is not the name's. `floor_ms`: the
        card's launch floor, measured in this run, for a kernel whose work
        is one launch: its bound is then the larger of the bytes bound and
        the floor (bound_by "launch"); a time below the bytes bound still
        fails."""
        if library_inputs is None:
            library_inputs = inputs
        got, want = kernel(*inputs), plain(*inputs)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        ok = torch.equal(got, want) if rtol == 0.0 \
            else torch.allclose(got, want, rtol=rtol, atol=0.0)
        if not ok:
            fail(f"{name} {label}: kernel and plain version differ "
                 f"(max |d| {err:.3g})")
        if library is not None and not torch.allclose(
                library(*library_inputs).reshape(want.shape).float(), want,
                rtol=1e-5):
            fail(f"{name} {label}: the library call computes another "
                 "function")
        ms = probes.hbm_ms(kernel, inputs)
        warm_ms = probes.graph_ms(lambda: kernel(*inputs))
        plain_ms = cuda_ms(lambda: plain(*inputs), 5)
        library_ms = probes.hbm_ms(library, library_inputs) \
            if library is not None else None
        bound_ms = nbytes / PEAK_HBM_BYTES * 1e3
        print(f"{name} {label}: max |d| {err:.3g} | kernel {ms * 1e3:.2f} "
              f"us (inputs left in L2: {warm_ms * 1e3:.2f} us), plain "
              f"{plain_ms * 1e3:.2f} us, library "
              + (f"{library_ms * 1e3:.2f} us" if library is not None
                 else "none")
              + (f" (context, {context[0]}: "
                 f"{probes.hbm_ms(context[1], library_inputs) * 1e3:.2f} "
                 "us)" if context is not None else "")
              + f", bound {bound_ms * 1e3:.4f} us by bytes ({nbytes} B)")
        if ms < bound_ms:
            fail(f"{name} {label}: {ms * 1e3:.2f} us is below the bound of "
                 f"{bound_ms * 1e3:.2f} us: the inputs did not come from "
                 "HBM")
        bound_by = "bytes"
        if floor_ms is not None and floor_ms > bound_ms:
            bound_ms, bound_by = floor_ms, "launch"
            print(f"{name} {label}: bound {bound_ms * 1e3:.3f} us by the "
                  f"launch floor = {bound_ms / ms:.1%} of it")
        worst = max(err, entries.get(name, {}).get("max_abs_err", 0.0))
        entries[name] = {
            "name": name, "route": "cuda",
            "source": f"{PORT}/csrc/{source or name}.cu",
            "replaces": replaces,
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}
        return ms

    # 10. each probe kernel against its plain version
    n_rows = launch_overhead.N_ROWS
    rayfeat, best = launch_overhead.make_inputs(dev)
    # the last case is the one the kernels line reports: tile 128 without
    # span rows, the function best + rayfeat[:, :8] computes
    for tile, with_rows in ((8192, False), (128, True), (128, False)):
        extra = launch_overhead.make_span_rows(dev, n_rows, tile) \
            if with_rows else ()
        compare(
            "probe_copy", f"{n_rows} rows, tile {tile}, "
            f"{'span rows' if with_rows else 'no span rows'}",
            lambda *x: launch_overhead.probe_copy(x[0], x[1], tile, *x[2:]),
            lambda *x: launch_overhead.probe_copy_plain(x[0], x[1], tile),
            launch_overhead.library_copy, (rayfeat, best, *extra),
            launch_overhead.copy_bytes(
                n_rows, tile, launch_overhead.N_CLUSTERS if with_rows else 0),
            "exp/grid_overhead.py:52")
    # finding: what the unused half of each rayfeat row and the grid of
    # 1,024 CTAs cost, beside the same 12.6 MB in contiguous rows
    n_ctas = -(-n_rows // 128)
    rf8 = rayfeat[:, :8].contiguous()
    got = launch_overhead.probe_copy(rayfeat, best, 128, whole_rows=True)
    torch.cuda.synchronize()
    if not torch.equal(got, launch_overhead.probe_copy_plain(rayfeat, best,
                                                             128)):
        fail("probe_copy whole rows: kernel and plain version differ")
    turns = {"half rows": [], "whole rows": []}
    for key in ("half rows", "whole rows", "whole rows", "half rows"):
        turns[key].append(probes.hbm_ms(
            lambda r, b: launch_overhead.probe_copy(
                r, b, 128, whole_rows=key == "whole rows"),
            (rayfeat, best)) * 1e3)
    grid_us = probes.hbm_ms(
        lambda: card_perf.probe_floor(dev, n_ctas)) * 1e3
    flat_us = probes.hbm_ms(lambda r, b: b + r, (rf8, best)) * 1e3
    whole, half = (" / ".join(f"{x:.2f}" for x in turns[k])
                   for k in ("whole rows", "half rows"))
    print(f"probe_copy finding, {n_rows} rows, tile 128: reading each "
          f"rayfeat row whole {whole} us against half of it {half} us (in "
          f"turns; max |d| 0) | an empty grid of the same {n_ctas} CTAs "
          f"{grid_us:.2f} us | the bound's bytes in contiguous rows, best + "
          f"rayfeat[:, :8].contiguous(): {flat_us:.2f} us")

    n_idx = 1 << 22
    for label, n_table, kw in (
            ("4096-entry table staged in shared memory", 4096,
             dict(staged=True)),
            ("4096-entry table from global memory", 4096, {}),
            ("2^26-entry table (256 MiB) from global memory", 1 << 26, {})):
        table, idx = gather.make_inputs(dev, n_table, (n_idx,))
        compare(
            "probe_gather", f"{label}, {idx.numel()} indices",
            lambda t, i: gather.probe_gather(t, i, **kw),
            lambda t, i: gather.probe_gather_plain(t, i, **kw),
            lambda t, i: torch.index_select(t, 0, i),
            (table, idx), gather.gather_bytes(idx.numel()),
            "exp/pallas_gather_probe.py:46")

    # K4c-2 on tables whose columns differ; the TPU probe's S = 4,096
    # last. No PyTorch call chains 8 lookups: one torch.gather step is
    # printed as context
    for s in sorted(gather.CHAINED_S, key=lambda s: s == 4096):
        table, idx = gather.make_chained_inputs(dev, s)
        compare(
            "probe_chained", f"8 chained lookups, ({s}, 128) table whose "
            f"columns differ, {idx.numel()} chains",
            gather.probe_chained,
            lambda t, i: gather.probe_gather_plain(t, i, steps=8), None,
            (table, idx), gather.chained_bytes(table, idx),
            "exp/pallas_perf_probe.py:66",
            library_inputs=(table, idx.long()),
            context=("one torch.gather step",
                     lambda t, i: torch.gather(t, 0, i)),
            source="probe_gather")

    # K4c-1 at 512 B, then the 227 KB block the kernels line reports, each
    # bounded by the card's launch floor: an empty one-CTA kernel of the
    # same 128 threads, timed in this run as every probe kernel is
    floor_ms = card_perf.launch_floor_ms(dev)
    print(f"launch floor: an empty kernel of one CTA of 128 threads without "
          f"shared memory, {floor_ms * 1e3:.3f} us (probes.hbm_ms)")
    smem_us = [compare(
        "probe_smem", f"{n_bytes} B of dynamic shared memory "
        "(reservation included)",
        lambda: card_perf.probe_smem(n_bytes, dev),
        lambda: card_perf.probe_smem_plain(n_bytes, dev), None, (),
        card_perf.LANES * 4, "exp/pallas_perf_probe.py:36",
        floor_ms=floor_ms) * 1e3 for n_bytes in (512, 227 * 1024)]
    print(f"probe_smem: 512 B {smem_us[0]:.3f} us, 227 KB {smem_us[1]:.3f} "
          f"us, beside the launch floor {floor_ms * 1e3:.3f} us")

    # K4c-3 for one row of starts per SM, then the TPU's own single row,
    # the case the kernels line reports
    for integer, g in ((False, card_perf.N_SMS), (True, card_perf.N_SMS),
                       (False, 1), (True, 1)):
        table, starts = card_perf.make_stream_inputs(dev, g,
                                                     integer=integer)
        bag = starts.long()[..., None] + torch.arange(
            card_perf.BLOCK_ROWS, device=dev)
        bag = bag.reshape(g, -1)
        parts = card_perf.stream_plan(g, starts.shape[1])
        compare(
            "probe_stream", f"{g} row(s) of 64 blocks of (128, 128) on "
            f"{g * parts} CTAs, "
            f"{'integer-valued' if integer else 'random'} floats",
            card_perf.probe_stream, card_perf.probe_stream_plain,
            lambda t, b: F.embedding_bag(b, t, mode="sum"), (table, starts),
            card_perf.stream_bound_bytes(starts),
            "exp/pallas_perf_probe.py:129", rtol=0.0 if integer else 1e-5,
            library_inputs=(table, bag))
        if g > 1:
            ms = entries["probe_stream"]["ms"]
            print(f"probe_stream: {g} rows re-read "
                  f"{card_perf.stream_bytes(g)} B of blocks in "
                  f"{ms * 1e3:.2f} us = "
                  f"{card_perf.stream_bytes(g) / ms / 1e6:.1f} GB/s (the "
                  "4 MiB table stays in L2: the L2 rate)")

    # 11. the probes as a user runs them; counts set to 0 just before
    wrappers = {"probe_copy": launch_overhead.probe_copy,
                "probe_gather": gather.probe_gather,
                "probe_chained": gather.probe_chained,
                "probe_smem": card_perf.probe_smem,
                "probe_floor": card_perf.probe_floor,
                "probe_stream": card_perf.probe_stream}
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    launch_overhead.run(dev)
    gather.run(dev)
    perf = card_perf.run(dev)
    largest, refused, limit = perf["smem"]
    if (largest, refused) != (227, 228):
        fail(f"shared memory: largest block {largest} KB, refused "
             f"{refused} KB; expected 227 and 228 on this card")
    kernel_build.run_builds(dev)
    kernel_build.run_ladder(scene, camera, config)
    counts = {name: w.launches for name, w in wrappers.items()}
    print(f"probes: all four modules in {time.perf_counter() - t0:.1f} s | "
          f"launches {counts}")
    for name, n in counts.items():
        if n <= 0:
            fail(f"the probes launched no {name} kernel")
    return entries, counts


def grad_leaves(grads):
    """{leaf name: tensor or None} of a MaterialTable, a Camera or the
    vertex gradients (a dict of them is returned as it is)."""
    from opengl_ray_tracing_framework_tpu_torch import Camera
    from opengl_ray_tracing_framework_tpu_torch.models.material import (
        Material, MaterialTable)
    if isinstance(grads, dict):
        return grads
    if isinstance(grads, MaterialTable):
        return dict(zip(Material._fields, grads.mat))
    if isinstance(grads, Camera):
        return dict(zip(Camera._fields, grads))
    return {"vertices": grads}


def grad_phases(ortf, scene, camera, config, k1_per_pass, wide_scene):
    """Phase 12: the gradient path on the card; wide_scene is the scene in
    blocks of 1,024 triangles."""
    import numpy as np
    import torch
    from opengl_ray_tracing_framework_tpu_torch.models.material import (
        Material, MaterialTable, preset_materials)
    from opengl_ray_tracing_framework_tpu_torch.ops import (
        cluster_intersect as ci)
    from opengl_ray_tracing_framework_tpu_torch.ops import shade
    from opengl_ray_tracing_framework_tpu_torch.ops import sweep as sw
    from opengl_ray_tracing_framework_tpu_torch.parallel import autodiff

    dev = scene.device
    presets = preset_materials()

    def check_grads(label, loss, grads):
        """Finite loss and gradients, one of them nonzero, integer leaves
        None. Returns the largest |g|."""
        leaves = grad_leaves(grads)
        if not np.isfinite(float(loss)):
            fail(f"{label}: the loss is not finite")
        top = 0.0
        for name, g in leaves.items():
            if g is None:
                if name != "medium_type":
                    fail(f"{label}: no gradient for {name}")
                continue
            if not bool(torch.isfinite(g).all()):
                fail(f"{label}: the gradient of {name} is not finite")
            top = max(top, g.abs().max().item())
        if not top > 0:
            fail(f"{label}: every gradient is zero")
        return top

    def with_sphere(sc, name):
        """The scene with the sphere's material slot (1) set to a preset."""
        mat = Material(*(
            torch.stack([field[0], p.to(dev)])
            for field, p in zip(sc.materials.mat, presets[name])))
        return sc.with_materials(MaterialTable(mat=mat))

    # material_grad at full width
    target = ortf.render_radiance(with_sphere(scene, "brown_glass"), camera,
                                  config, spp=1)
    rays = WIDTH * HEIGHT * (1 + 2 * BOUNCES)
    for step in ("warm-up", "timed"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        sw.sweep.launches = 0
        sw.sweep_plain.calls = 0
        ci.cluster_intersect.launches = 0
        for k in SHADE_KERNELS:
            getattr(shade, k).launches = 0
        t0 = time.perf_counter()
        loss, grads = autodiff.material_grad(
            scene, camera, target, config, spp=1,
            rays_per_tile=RAYS_PER_TILE)
        host = [g.cpu() for g in grads.mat if g is not None]   # the fence
        seconds = time.perf_counter() - t0
        launches, plain_calls = sw.sweep.launches, sw.sweep_plain.calls
        peak = torch.cuda.max_memory_allocated()
        top = check_grads("material_grad", loss, grads)
        print(f"material_grad ({step}): {WIDTH}x{HEIGHT}, {BOUNCES} bounces,"
              f" 1 spp, {RAYS_PER_TILE} rays per batch | loss "
              f"{float(loss):.4f}, max |g| {top:.4g}, {len(host)} float "
              f"leaves | fwd+bwd {seconds:.3f} s, {rays / seconds:,.0f} "
              f"rays/s | peak {peak / 2**30:.2f} GiB | K1 launches "
              f"{launches} (a forward pass: {k1_per_pass}), plain calls "
              f"{plain_calls}")
        if launches != k1_per_pass:
            fail(f"material_grad launched K1 {launches} times; the forward "
                 f"pass launches it {k1_per_pass} times and the backward "
                 "must launch none")
        if plain_calls or ci.cluster_intersect.launches:
            fail("material_grad left the sweep kernel's path")
        if any(getattr(shade, k).launches for k in SHADE_KERNELS):
            fail("material_grad launched a shading kernel, which has no "
                 "backward")
    material_ref = dict(target=target, loss=loss, grads=grads)

    # camera and geometry gradients at 128x64
    small = config.replace(width=128, height=64)
    cam_small = ortf.Camera.make(aspect=2.0)
    target_small = ortf.render_radiance(
        with_sphere(scene, "brown_glass"), cam_small, small, spp=2)
    for name in ("camera", "geometry"):
        t0 = time.perf_counter()
        loss, grads = autodiff.param_grad(scene, cam_small, target_small,
                                          small, param=name, spp=1)
        top = check_grads(f"{name}_grad", loss, grads)
        shape = {k: tuple(v.shape) for k, v in grad_leaves(grads).items()}
        print(f"{name}_grad: 128x64, {BOUNCES} bounces, 1 spp | loss "
              f"{float(loss):.4f}, max |g| {top:.4g}, shapes {shape} | "
              f"{time.perf_counter() - t0:.2f} s")
    if tuple(grads.shape) != (3, 3, scene.n_triangles):
        fail(f"geometry_grad returned shape {tuple(grads.shape)}")

    # material_grad on the scene in blocks of 1,024 triangles: K1 launched,
    # no plain call, held against the same step on blocks of 256 (the same
    # hits, so the same gradients up to float order)
    sw.sweep.launches = sw.sweep_plain.calls = 0
    wide = autodiff.material_grad(wide_scene, cam_small, target_small, small,
                                  spp=2)
    launches, plain_calls = sw.sweep.launches, sw.sweep_plain.calls
    check_grads("material_grad, blocks of 1024", *wide)
    hold_grads(
        f"material_grad 128x64, {BOUNCES} bounces, 2 spp, blocks of 1024 "
        f"(K1 launches {launches}, plain calls {plain_calls}) vs blocks of "
        "256", wide, autodiff.material_grad(scene, cam_small, target_small,
                                            small, spp=2), 1e-5, 2e-4)
    if launches <= 0 or plain_calls:
        fail(f"material_grad on blocks of 1024: K1 launches {launches}, "
             f"plain calls {plain_calls}")

    # card against CPU, 128x64, 2 spp. The floor's material has ior 1 and
    # metallic 0, so its specular weight is 0 up to rounding and the
    # `w_refl > 0` gate of disney_eval opens or shuts on float noise: its
    # metallic, anisotropic and ior entries are left out.
    noisy = {("metallic", 0), ("anisotropic", 0), ("ior", 0)}

    def leaf_gap(grads_a, grads_b):
        """(worst over the leaves of max |a - b| over the leaf's largest
        |b|, that leaf's name)."""
        worst, worst_leaf = 0.0, ""
        for leaf, a in grad_leaves(grads_a).items():
            b = grad_leaves(grads_b)[leaf]
            if a is None and b is None:
                continue
            a, b = a.cpu().clone(), b.cpu().clone()
            for f, slot in noisy:
                if f == leaf:
                    a[slot], b[slot] = 0.0, 0.0
            scale = b.abs().max().item()
            err = (a - b).abs().max().item() / scale if scale > 0 \
                else a.abs().max().item()
            if err > worst:
                worst, worst_leaf = err, leaf
        return worst, worst_leaf

    # Camera and geometry gradients are held at 2 bounces. At 8 bounces
    # they are ill-conditioned in the camera itself: the conditioning lines
    # below move the camera by 1e-6 on the card and print how far the
    # gradients move (tests/test_torch_grad_conditioning.py shows the same
    # on the CPU), so two float orders cannot agree there; the 8-bounce
    # card-vs-CPU reading is printed and not held. A camera leaf is one
    # number, the sum over all pixels of terms of both signs (yaw: 1.4 out
    # of terms of order 10), so float order shows at 4e-3 of it; it is held
    # to 2e-2, the others to 5e-3.
    scene_cpu, cam_cpu = scene.to("cpu"), cam_small.to("cpu")
    cam_moved = cam_small._replace(
        position=cam_small.position
        + torch.tensor([1e-6, 0.0, 0.0], device=dev))
    for name, bounces, tol in (
            ("material", BOUNCES, 5e-3), ("camera", 2, 2e-2),
            ("geometry", 2, 5e-3), ("camera", BOUNCES, None),
            ("geometry", BOUNCES, None)):
        cfg = small.replace(max_bounce=bounces)
        loss_g, grads_g = autodiff.param_grad(
            scene, cam_small, target_small, cfg, param=name, spp=2)
        loss_c, grads_c = autodiff.param_grad(
            scene_cpu, cam_cpu, target_small.cpu(), cfg, param=name, spp=2)
        rel_loss = abs(float(loss_g) - float(loss_c)) / abs(float(loss_c))
        worst, worst_leaf = leaf_gap(grads_g, grads_c)
        print(f"{name}_grad card vs cpu: 128x64, 2 spp, {bounces} bounces | "
              f"loss {float(loss_g):.5f} vs {float(loss_c):.5f} (rel "
              f"{rel_loss:.2e}) | worst leaf {worst_leaf or '-'}: "
              f"{worst:.2e} of its largest entry"
              + (f" (held to {tol:g})" if tol is not None
                 else " (not held: ill-conditioned at this depth)"))
        if rel_loss >= 1e-4 or (tol is not None and worst >= tol):
            fail(f"{name}_grad at {bounces} bounces: card and CPU disagree "
                 f"(loss rel {rel_loss:.2e}, worst leaf {worst:.2e})")
        if name == "material":
            continue
        _, grads_m = autodiff.param_grad(
            scene, cam_moved, target_small, cfg, param=name, spp=2)
        moved, moved_leaf = leaf_gap(grads_m, grads_g)
        print(f"{name}_grad conditioning: {bounces} bounces, the camera "
              f"moved by 1e-6 on the card | worst leaf {moved_leaf or '-'} "
              f"moves by {moved:.2e} of its largest entry")

    # the shapes at which material gradients once went NaN: 256x256, 8
    # bounces, an ABSORB glass and a rough dielectric
    cam_sq = ortf.Camera.make(position=(0.0, 0.5, -2.0), yaw=90.0,
                              pitch=-8.0, zoom=30.0, aspect=1.0)
    cfg_sq = ortf.RenderConfig(width=256, height=256, max_bounce=8)
    for mat_name in ("brown_glass", "white"):
        _, sc = ortf.build_test_scene(2, material=presets[mat_name])
        loss, grads = autodiff.material_grad(
            sc, cam_sq, torch.zeros((256, 256, 3), device=dev), cfg_sq,
            rays_per_tile=16384)
        top = check_grads(f"material_grad 256 {mat_name}", loss, grads)
        print(f"material_grad 256x256, 8 bounces, {mat_name}: loss "
              f"{float(loss):.3f}, max |g| {top:.4g}, all finite")

    # one finite difference: the sphere's base_color, green channel
    loss, grads = autodiff.material_grad(scene, cam_small, target_small,
                                         small, spp=2)
    ad = grads.mat.base_color[1, 1].item()
    eps = 1e-2

    def loss_at(delta):
        bc = scene.materials.mat.base_color.clone()
        bc[1, 1] += delta
        sc = scene.with_materials(MaterialTable(
            mat=scene.materials.mat._replace(base_color=bc)))
        img = ortf.render_radiance(sc, cam_small, small, spp=2)
        return torch.sum((img.double() - target_small.double()) ** 2).item()

    fd = (loss_at(eps) - loss_at(-eps)) / (2 * eps)
    print(f"finite difference, base_color[1, 1], eps {eps}: central "
          f"difference {fd:.5f}, autograd {ad:.5f}")
    if not abs(fd - ad) < 0.25 * max(abs(fd), abs(ad)):
        fail("the base_color gradient disagrees with its finite difference")
    return dict(material_ref, target_small=target_small)


def hold_grads(label, got, want, loss_rtol, scale_tol, rtol=0.0):
    """Hold (loss, grads) against (loss, grads): the loss to loss_rtol,
    every float leaf elementwise to rtol of the entry plus scale_tol of
    the leaf's largest entry. Prints the worst leaf."""
    (loss, grads), (ref_loss, ref) = got, want
    rel_loss = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
    worst, worst_leaf = 0.0, "-"
    ok = rel_loss <= loss_rtol
    for name, g in grad_leaves(grads).items():
        r = grad_leaves(ref)[name]
        if g is None or r is None:
            ok &= g is None and r is None
            continue
        g, r = g.detach().cpu().double(), r.detach().cpu().double()
        top = r.abs().max().item()
        err = (g - r).abs()
        ok &= bool((err <= rtol * r.abs() + scale_tol * top).all())
        gap = err.max().item() / top if top > 0 else err.max().item()
        if gap > worst:
            worst, worst_leaf = gap, name
    print(f"{label}: loss {float(loss):.5f} vs {float(ref_loss):.5f} (rel "
          f"{rel_loss:.2e}) | worst leaf {worst_leaf}: {worst:.2e} of its "
          f"largest entry (held to rtol {rtol:g} + {scale_tol:g} of it)")
    if not ok:
        fail(f"{label}: the gradients disagree")


def cli_phase(ortf, scene, camera, config):
    """Phase 13: the CLI on the card, in this process and as a
    subprocess."""
    import contextlib
    import io
    import os
    import subprocess
    import tempfile
    from pathlib import Path

    import torch
    from opengl_ray_tracing_framework_tpu_torch import cli
    from opengl_ray_tracing_framework_tpu_torch.models import mesh
    from opengl_ray_tracing_framework_tpu_torch.ops import sweep as sw
    from opengl_ray_tracing_framework_tpu_torch.utils.image import read_png
    from opengl_ray_tracing_framework_tpu_torch.utils.timing import (
        format_breakdown, pass_breakdown)

    def result_line(out, label):
        try:
            res = json.loads(out.strip().splitlines()[-1])
        except (IndexError, ValueError):
            fail(f"{label}: no JSON result line")
        if set(res) != {"out", "spp", "seconds", "rays_per_sec"} or not (
                res["seconds"] > 0 and res["rays_per_sec"] > 0):
            fail(f"{label}: malformed result line {res}")
        return res

    def run_cli(label, *argv):
        """cli.main in this process: (result line, stderr, K1 launches,
        plain calls)."""
        sw.sweep.launches = 0
        sw.sweep_plain.calls = 0
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            cli.main(list(argv))
        res = result_line(out.getvalue(), label)
        launches, plain = sw.sweep.launches, sw.sweep_plain.calls
        print(f"{label}: {json.dumps(res)} | K1 launches {launches}, plain "
              f"calls {plain}")
        if launches <= 0 or plain:
            fail(f"{label}: K1 launched {launches} times, the plain sweep "
                 f"called {plain} times")
        return res, err.getvalue()

    frame = ["--scene", "test", "--width", str(WIDTH), "--height",
             str(HEIGHT), "--max-bounce", str(BOUNCES)]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        res, err = run_cli(
            "cli", *frame, "--spp", "3", "--progress-every", "1", "--timing",
            "--save-state", str(tmp / "a.npz"), "--out", str(tmp / "a.png"))
        for line in err.splitlines():
            print(f"cli stderr: {line}")
        res, _ = run_cli(
            "cli --resume", *frame, "--spp", "1", "--resume",
            str(tmp / "a.npz"), "--save-state", str(tmp / "b.npz"), "--out",
            str(tmp / "b.png"))
        resumed = ortf.load_render_state(str(tmp / "b.npz"))
        _, test_scene = ortf.build_test_scene()
        test_cam = ortf.Camera.make(position=(0.0, 0.5, -2.0), yaw=90.0,
                                    pitch=-8.0, zoom=30.0,
                                    aspect=WIDTH / HEIGHT)
        state = ortf.render_passes(
            test_scene, test_cam, ortf.init_render_state(config), config, 4,
            rays_per_tile=CLI_RAYS_PER_TILE)
        d = (resumed.accum - state.accum).abs().max().item()
        print(f"cli resume: 3 spp + --resume 1 spp = {resumed.n_samples} "
              f"spp against a continuous 4-spp render | max |d| {d:.3g}")
        if res["spp"] != 4 or resumed.n_samples != 4 or d != 0.0:
            fail("the resumed render differs from the continuous one")

        # the --timing table of the 81,922-triangle scene
        times = pass_breakdown(scene, camera, config,
                               rays_per_tile=CLI_RAYS_PER_TILE)
        for line in format_breakdown(times).splitlines():
            print(f"timing, {scene.n_triangles} triangles, "
                  f"{CLI_RAYS_PER_TILE} rays per batch: {line}")

        # the CLI as a user runs it, on OBJ files at the loong's scale
        objects = tmp / "assets" / "objects"
        objects.mkdir(parents=True)
        mesh.save_obj(str(objects / "floor.obj"), mesh.make_quad())
        mesh.save_obj(str(objects / "loong_100000.obj"),
                      mesh.make_icosphere(6))
        out = tmp / "loong.png"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", f"{PORT}.cli", "--scene", "loong",
             "--material", "brown_glass", *frame[2:], "--spp", "2",
             "--progress-every", "1", "--out", str(out)],
            capture_output=True, text=True, timeout=600,
            cwd=Path(__file__).resolve().parent,
            env={**os.environ, "ORTF_ASSETS": str(tmp / "assets")})
        wall = time.perf_counter() - t0
        for line in proc.stderr.splitlines()[-20:]:
            print(f"cli loong stand-in stderr: {line}")
        if proc.returncode != 0:
            fail(f"the CLI subprocess exited with {proc.returncode}")
        res = result_line(proc.stdout, "cli loong stand-in")
        image = torch.tensor(read_png(str(out)))
        print(f"cli loong stand-in (the subdiv-6 icosphere, 81,920 "
              f"triangles, as objects/loong_100000.obj; the loong asset is "
              f"not in the repository): {json.dumps(res)} | process "
              f"{wall:.1f} s | PNG {tuple(image.shape)}, mean "
              f"{image.float().mean().item():.2f}")
        if res["spp"] != 2 or tuple(image.shape) != (HEIGHT, WIDTH, 3) \
                or not image.float().mean() > 0:
            fail("the CLI subprocess wrote no image of the frame")


def shard_rank(backend, target, target_small):
    """One rank of phase 14 (a spawned process): phase 3's scene, the
    sharded passes and gradients. Returns the gathered images, the
    gradients (on the host), seconds, K1 launches and plain calls."""
    import torch
    import opengl_ray_tracing_framework_tpu_torch as ortf
    from opengl_ray_tracing_framework_tpu_torch.models.hdr import (
        make_gradient_hdr)
    from opengl_ray_tracing_framework_tpu_torch.models.material import (
        preset_materials)
    from opengl_ray_tracing_framework_tpu_torch.ops import sweep as sw
    from opengl_ray_tracing_framework_tpu_torch.parallel import (
        autodiff, sharding)

    def host(grads):
        return {k: None if g is None else g.cpu()
                for k, g in grad_leaves(grads).items()}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    t0 = time.perf_counter()
    host_scene, scene = ortf.build_test_scene(
        6, material=preset_materials()["tear_glass"],
        env=make_gradient_hdr(1024, 512))
    camera = ortf.Camera.make(aspect=WIDTH / HEIGHT)
    config = ortf.RenderConfig(width=WIDTH, height=HEIGHT,
                               max_bounce=BOUNCES)
    mesh = sharding.make_mesh()
    scene = sharding.replicate_scene(scene, mesh)
    out = {"rank": mesh.rank, "device": str(scene.device),
           "build_s": time.perf_counter() - t0}
    sw.sweep.launches = 0
    sw.sweep_plain.calls = 0
    meshes = [("1-D", mesh, config)]
    if backend == "gloo":
        meshes.append(("2-D", sharding.make_mesh_2d(1),
                       config.replace(spp_per_pass=2)))
    for name, m, cfg in meshes:
        img, out[f"{name} s"] = timed(lambda: sharding.gather_image(
            sharding.render_pass_sharded(
                scene, camera, ortf.init_render_state(cfg), cfg, m,
                rays_per_tile=RAYS_PER_TILE), m))
        out[name] = img.cpu()
    (loss, grads), out["material s"] = timed(
        lambda: autodiff.material_grad_sharded(
            scene, camera, target.cuda(), config, mesh,
            rays_per_tile=RAYS_PER_TILE))
    out["material"] = (float(loss), host(grads))
    if backend == "gloo":
        small = config.replace(width=128, height=64, max_bounce=2)
        cam_small = ortf.Camera.make(aspect=2.0)
        for group in ("camera", "geometry"):
            (loss, grads), out[f"{group} s"] = timed(
                lambda: autodiff.param_grad_sharded(
                    scene, cam_small, target_small.cuda(), small, mesh,
                    param=group, spp=2))
            out[group] = (float(loss), host(grads))
    out["launches"], out["plain"] = sw.sweep.launches, sw.sweep_plain.calls
    return out


def shard_phase(ortf, scene, config, passes, grad_ref):
    """Phase 14: spawned ranks of parallel/sharding.py on the card, held
    against this process's results."""
    from opengl_ray_tracing_framework_tpu_torch.parallel import (
        autodiff, sharding)

    target = grad_ref["target"].cpu()
    target_small = grad_ref["target_small"].cpu()
    material = (grad_ref["loss"], grad_ref["grads"])
    small = config.replace(width=128, height=64, max_bounce=2)
    cam_small = ortf.Camera.make(aspect=2.0)
    singles = {g: autodiff.param_grad(scene, cam_small, grad_ref[
        "target_small"], small, param=g, spp=2)
        for g in ("camera", "geometry")}

    for backend, world in (("nccl", 1), ("gloo", 2)):
        t0 = time.perf_counter()
        ranks = sharding.spawn_ranks(shard_rank, world, backend, target,
                                     target_small, backend=backend,
                                     timeout_s=RANKS_TIMEOUT_S)
        label = f"sharded {backend}, world {world}"
        print(f"{label}: {world} spawned rank(s) done in "
              f"{time.perf_counter() - t0:.1f} s"
              + (" | both ranks share the one card: no scaling figure"
                 if world > 1 else ""))
        for r in ranks:
            secs = ", ".join(f"{k} {v:.3f}" for k, v in r.items()
                             if k.endswith(" s") or k == "build_s")
            print(f"{label}, rank {r['rank']} on {r['device']}: K1 launches "
                  f"{r['launches']}, plain calls {r['plain']} | seconds: "
                  f"{secs}")
            if r["launches"] <= 0 or r["plain"]:
                fail(f"{label}, rank {r['rank']}: K1 launched "
                     f"{r['launches']} times, plain calls {r['plain']}")
        r = ranks[0]
        for name, ref in (("1-D", passes[0]), ("2-D", passes[1])):
            if name not in r:
                continue
            d = (r[name] - ref.cpu()).abs().max().item()
            compare_images(f"{label} {name} pass", r[name], ref,
                           f"{WIDTH}x{HEIGHT}, {BOUNCES} bounces, max |d| "
                           f"{d:.3g} | ")
        loss_rtol, scale_tol, rtol = (1e-5, 2e-4, 0.0) if world == 1 \
            else (1e-4, 1e-4, 5e-3)
        for rank in ranks:
            hold_grads(f"{label} rank {rank['rank']} material_grad_sharded "
                       f"{WIDTH}x{HEIGHT}", rank["material"],
                       material, loss_rtol, scale_tol, rtol)
            for group in ("camera", "geometry"):
                if group in rank:
                    hold_grads(
                        f"{label} rank {rank['rank']} {group} "
                        "param_grad_sharded 128x64, 2 bounces, 2 spp",
                        rank[group], singles[group], loss_rtol, scale_tol,
                        rtol)


BENCH_TIMEOUT_S = 600       # one bench_torch.py run that takes longer fails


def bench_phase():
    """Phase 15: bench_torch.py as a user runs it, once per tracer at the
    reference frame with 2 timed passes; each run's last line must carry
    every field, name this card, hold its correctness check, call no plain
    version and launch its tracer's kernel and not the other's."""
    import os
    import subprocess
    from pathlib import Path

    import torch
    from opengl_ray_tracing_framework_tpu_torch.bench import FIELDS
    kernel_counts = {"sweep": ("k1_launches_per_pass",
                               "k2_launches_per_pass"),
                     "schedule": ("k2_launches_per_pass",
                                  "k1_launches_per_pass")}
    for tracer, (own, other) in kernel_counts.items():
        label = f"bench_torch.py, {tracer} tracer"
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(
                [sys.executable, "bench_torch.py"],
                cwd=Path(__file__).resolve().parent, capture_output=True,
                text=True, timeout=BENCH_TIMEOUT_S,
                env={**os.environ, "BENCH_TRACER": tracer,
                     "BENCH_PASSES": "2"})
        except subprocess.TimeoutExpired:
            fail(f"{label}: no result in {BENCH_TIMEOUT_S} s")
        for ln in proc.stderr.strip().splitlines()[-3:]:
            print(f"{label} stderr: {ln}")
        if proc.returncode != 0:
            fail(f"{label}: exit code {proc.returncode}")
        try:
            res = json.loads(proc.stdout.strip().splitlines()[-1])
        except (IndexError, ValueError):
            fail(f"{label}: no JSON line")
        print(f"{label} ({time.perf_counter() - t0:.1f} s): "
              f"{json.dumps(res)}")
        missing = [f for f in FIELDS if f not in res]
        if missing:
            fail(f"{label}: the line lacks {missing}")
        if res["device"] != torch.cuda.get_device_name(0) \
                or not res["power_limit"]:
            fail(f"{label}: device {res['device']!r}, power limit "
                 f"{res['power_limit']!r}")
        if res["correct"] is not True or res["plain_calls"] != 0:
            fail(f"{label}: correct {res['correct']}, plain calls "
                 f"{res['plain_calls']}")
        if not (res[own] > 0 and res[other] == 0):
            fail(f"{label}: {own} {res[own]}, {other} {res[other]}")


def row_balance_phase(scene, camera, config):
    """Phase 16: probes/row_balance.py's blocks per tracer at the
    reference frame, held against one whole-frame trace."""
    import torch
    from opengl_ray_tracing_framework_tpu_torch.probes import row_balance
    from opengl_ray_tracing_framework_tpu_torch.render import _trace_rows
    for tracer, (own, other) in (("sweep", ("sweep", "cluster_intersect")),
                                 ("schedule", ("cluster_intersect",
                                               "sweep"))):
        label = f"row balance, {tracer} tracer"
        cfg = config.replace(cast_backend=tracer)
        t0 = time.perf_counter()
        res = row_balance.block_seconds(scene, camera, cfg, keep=True)
        line = row_balance.probe_line(res, scene, "stand-in")
        probe_s = time.perf_counter() - t0
        print(f"{label} ({probe_s:.1f} s): {json.dumps(line)}")
        with torch.no_grad():
            whole = _trace_rows(
                scene, camera, line["frame"], cfg, 0, cfg.height,
                line["rays_per_tile"])
        compare_images(f"{label}, blocks vs whole frame", res["radiance"],
                       whole, f"{line['blocks']} blocks of "
                       f"{cfg.height // line['blocks']} rows, frame "
                       f"{line['frame']} | ")
        for b, block in enumerate(res["radiance"].chunk(line["blocks"])):
            check_image(f"{label}, block {b}", block)
        effs = [*line["efficiency"].values(),
                *line["kernel_efficiency"].values()]
        if not (all(n > 0 for n in line["launches"][own])
                and not any(line["launches"][other])
                and not any(line["plain_calls"])
                and all(0 < e <= 1 for e in effs)
                and all(ms > 0 for ms in line["kernel_ms"])):
            fail(f"{label}: launches {line['launches']}, plain calls "
                 f"{line['plain_calls']}, efficiencies {effs}, kernel ms "
                 f"{line['kernel_ms']}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--png", help="also save the rendered image here")
    parser.add_argument("--profile", action="store_true",
                        help="also profile one sweep pass and one schedule "
                             "pass with torch.profiler")
    args = parser.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        return 1
    t_start = time.perf_counter()

    import opengl_ray_tracing_framework_tpu_torch as ortf
    from opengl_ray_tracing_framework_tpu_torch.models.hdr import (
        make_gradient_hdr)
    from opengl_ray_tracing_framework_tpu_torch.models.material import (
        preset_materials)
    from opengl_ray_tracing_framework_tpu_torch.ops import (
        cluster_intersect as ci)
    from opengl_ray_tracing_framework_tpu_torch.ops import integrator
    from opengl_ray_tracing_framework_tpu_torch.ops import schedule as sched
    from opengl_ray_tracing_framework_tpu_torch.ops import shade
    from opengl_ray_tracing_framework_tpu_torch.ops import sweep as sw
    from opengl_ray_tracing_framework_tpu_torch import probes
    from opengl_ray_tracing_framework_tpu_torch.probes import (  # noqa: F401
        kernel_build,   # its import registers every kernel's source
        prep_kernels, shade_kernels, staging)
    from opengl_ray_tracing_framework_tpu_torch.utils import nvcc

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    smi = probes.device_line()
    print(smi)
    print(f"device: torch {torch.__version__}, cuda {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    # 2. build: one nvcc per source, started together
    names = sorted(nvcc.KERNELS)
    missing = EXPECTED_KERNELS - set(names)
    if missing:
        fail(f"no wrapper registered the kernels {sorted(missing)}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        built = list(pool.map(nvcc.build, names))
    for name, (path, build_s, log) in zip(names, built):
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"build: {name}.cu -> {path.name} in {build_s:.2f} s"
              + (f" | ptxas: {regs[-1]}" if regs else " (cached)"))
    print(f"build: all {len(names)} in {time.perf_counter() - t0:.2f} s")

    # 3. K1 vs plain at main-path shapes
    t0 = time.perf_counter()
    host_scene, scene = ortf.build_test_scene(
        6, material=preset_materials()["tear_glass"],
        env=make_gradient_hdr(1024, 512))
    camera = ortf.Camera.make(aspect=WIDTH / HEIGHT)
    dev = scene.device
    if dev.type != "cuda":
        fail(f"the scene was built on {dev}, not on the card")
    config = ortf.RenderConfig(width=WIDTH, height=HEIGHT,
                               max_bounce=BOUNCES)
    sched_config = config.replace(cast_backend="schedule")
    n_clusters = scene.cl_trifeat.shape[0]
    t_blk = scene.cl_trifeat.shape[2] // 4
    print(f"scene: {scene.n_triangles} triangles, {n_clusters} clusters of "
          f"{t_blk}, env {tuple(scene.hdr_map.shape[:2])}, built in "
          f"{time.perf_counter() - t0:.2f} s")

    # the first ray tile of the frame, in the renderer's 32x32-block order
    n_pix = WIDTH * HEIGHT
    frame_order = torch.arange(n_pix, device=dev).reshape(
        HEIGHT // 32, 32, WIDTH // 32, 32).permute(0, 2, 1, 3).reshape(-1)
    pixel_id = frame_order[:RAYS_PER_TILE]
    u = ((pixel_id % WIDTH).float() + 0.5) / WIDTH
    v = ((pixel_id // WIDTH).float() + 0.5) / HEIGHT
    origin, direction = camera.generate_rays(u, v)
    ones = torch.ones(RAYS_PER_TILE, dtype=torch.bool, device=dev)

    captured = []
    real_pair = integrator.closest_hit_pair

    def capture_pair(scene_, *rest):
        captured.append(rest[:6])   # the rays, not the config
        return real_pair(scene_, *rest)

    integrator.closest_hit_pair = capture_pair
    try:
        with torch.no_grad():
            integrator.trace_radiance(scene, origin, direction, pixel_id, 1,
                                      config.replace(max_bounce=DEEP_BOUNCE))
    finally:
        integrator.closest_hit_pair = real_pair
    if len(captured) != DEEP_BOUNCE:
        fail(f"{len(captured)} merged casts in {DEEP_BOUNCE} bounces")

    def merged(pair):
        o_a, d_a, m_a, o_c, d_c, m_c = pair
        return (torch.cat([o_a, o_c]), torch.cat([d_a, d_c]),
                torch.cat([m_a, m_c]),
                torch.cat([torch.ones_like(m_a), torch.zeros_like(m_c)]))

    o_any, d_any, m_any, o_cls, d_cls, m_cls = captured[0]
    w = o_any.shape[0]
    slot2tri = scene.cl_slot2tri.long()
    k1 = {}

    def k1_case(name, kargs, live, slots=slot2tri, strict=False):
        """Hold K1 against sweep_plain on one set of kernel arguments,
        time both and print the case's line."""
        nspan, spans, best0 = kargs[0], kargs[1], kargs[4]
        t_case = kargs[5].shape[2] // 4
        got = sw.sweep(*kargs[:4], best0.clone(), kargs[5])
        want = sw.sweep_plain(*kargs)
        torch.cuda.synchronize()
        err, agree, tri_agree = compare_records(got, want, slots,
                                                f"K1 {name}", strict=strict)
        # the work these inputs need: the spans the walk visits before
        # its stop test ends it (counted by the plain version's walk)
        visited = sw.sweep_plain.visited
        walked = torch.arange(spans.shape[1], device=dev)[None, :] \
            < visited[:, None]
        bound = probes.span_bound(
            int(visited.sum()), int(torch.unique(spans[walked]).numel()),
            t_case, best0.shape[0],
            index_bytes=nspan.numel() * 4 + 2 * int(visited.sum()) * 4)
        ms = cuda_ms(lambda: sw.sweep(*kargs[:4], best0.clone(), kargs[5]))
        plain_ms = cuda_ms(lambda: sw.sweep_plain(*kargs), repeats=2)
        clone_ms = cuda_ms(lambda: best0.clone())
        walk = int(visited.max())
        k1[name] = dict(err=err, ms=ms, plain_ms=plain_ms, bound=bound,
                        clone_ms=clone_ms, visits=int(visited.sum()),
                        us_per_span=(ms - clone_ms) * 1e3 / max(walk, 1))
        ctas = nvcc.load("sweep").sweep_cluster_size(spans.shape[0], t_case)
        print(f"K1 sweep {name}: {best0.shape[0]} rays ({live} live), "
              f"{spans.shape[0]} tiles x {ctas} CTA(s), T {t_case}, "
              f"spans/tile overlapped mean {nspan.float().mean().item():.1f}"
              f" max {int(nspan.max())}, visited {int(visited.sum())} (max "
              f"{int(visited.max())} on one tile) | "
              f"hit/miss agree {agree:.6f}, tri agree {tri_agree:.6f}, "
              f"max |dt| {err:.3g} | kernel {ms:.3f} ms (incl. "
              f"{clone_ms:.3f} ms record copy), plain {plain_ms:.3f} ms, "
              f"bound {bound[0]:.4f} ms by {bound[1]} (operations "
              f"{bound[2]:.4f} ms, bytes {bound[3]:.4f} ms) | "
              f"{k1[name]['us_per_span']:.2f} us per span of the longest "
              f"walk")

    def cut_blocks(trifeat, slots, t_new):
        """Cluster blocks cut to their first t_new triangle columns (the
        four T-column groups of every row cut alike), and their slots."""
        c, _, cols = trifeat.shape
        t_old = cols // 4
        cut = trifeat.reshape(c, 16, 4, t_old)[..., :t_new]
        return (cut.reshape(c, 16, 4 * t_new).contiguous(),
                slots.reshape(c, t_old)[:, :t_new].reshape(-1))

    # the primary cast, the first bounce's merged pair, and the merged pair
    # of a deep bounce: few rays whose tiles overlap many clusters
    for name, rays in (("primary", (origin, direction, ones,
                                    torch.zeros_like(ones))),
                       ("pair", merged(captured[0])),
                       (f"deep pair (bounce {DEEP_BOUNCE - 1})",
                        merged(captured[-1]))):
        kargs, _ = sw.sweep_inputs(scene, *rays)
        k1_case(name, kargs, int(rays[2].sum()))
    if w != RAYS_PER_TILE:
        print(f"note: the first bounce's pair holds {w} shadow + "
              f"{o_cls.shape[0]} bounce rays")

    # ragged T: the primary cast against cluster blocks cut to RAGGED_T
    # triangles (not a multiple of 4: the kernel's unaligned staging path)
    kargs, _ = sw.sweep_inputs(scene, origin, direction, ones,
                               torch.zeros_like(ones))
    cut, cut_slots = cut_blocks(scene.cl_trifeat, slot2tri, RAGGED_T)
    k1_case("primary, ragged T", (*kargs[:5], cut), RAYS_PER_TILE, cut_slots)

    # wide cluster blocks, as the reference's Scene.build(cluster_size=...)
    # makes them: the scene rebuilt in blocks of 512 and 1,024 (tensor-map
    # copies of each CTA's chunks of columns), the 512 blocks cut to a T
    # that is no multiple of 4 (hand-copied chunks), and a small scene in
    # blocks of 4,096 cast at a coarse grid of the frame; every case must
    # equal its plain version (compare_records, strict)
    wide_scenes = {}
    for t_wide in WIDE_T:
        t0 = time.perf_counter()
        sc = wide_scenes[t_wide] = host_scene.build(cluster_size=t_wide)
        print(f"scene: rebuilt in {sc.cl_trifeat.shape[0]} clusters of "
              f"{t_wide} in {time.perf_counter() - t0:.2f} s")
        for name, rays in (("primary", (origin, direction, ones,
                                        torch.zeros_like(ones))),
                           ("pair", merged(captured[0])),
                           (f"deep pair (bounce {DEEP_BOUNCE - 1})",
                            merged(captured[-1]))):
            kargs, _ = sw.sweep_inputs(sc, *rays)
            k1_case(f"{name}, T {t_wide}", kargs, int(rays[2].sum()),
                    sc.cl_slot2tri.long(), strict=True)
    sc = wide_scenes[512]
    kargs, _ = sw.sweep_inputs(sc, origin, direction, ones,
                               torch.zeros_like(ones))
    cut, cut_slots = cut_blocks(sc.cl_trifeat, sc.cl_slot2tri.long(),
                                RAGGED_WIDE_T)
    k1_case(f"primary, ragged T {RAGGED_WIDE_T}", (*kargs[:5], cut),
            RAYS_PER_TILE, cut_slots, strict=True)
    t0 = time.perf_counter()
    widest_host, _ = ortf.build_test_scene(
        WIDEST_SUBDIV, material=preset_materials()["tear_glass"])
    widest = widest_host.build(cluster_size=WIDEST_T)
    print(f"scene: {widest.n_triangles} triangles in "
          f"{widest.cl_trifeat.shape[0]} clusters of {WIDEST_T}, built in "
          f"{time.perf_counter() - t0:.2f} s")
    gw, gh = WIDEST_GRID
    gu, gv = torch.meshgrid((torch.arange(gw, device=dev) + 0.5) / gw,
                            (torch.arange(gh, device=dev) + 0.5) / gh,
                            indexing="xy")
    grid_o, grid_d = camera.generate_rays(gu.reshape(-1), gv.reshape(-1))
    grid_ones = torch.ones(gw * gh, dtype=torch.bool, device=dev)
    kargs, _ = sw.sweep_inputs(widest, grid_o, grid_d, grid_ones,
                               torch.zeros_like(grid_ones))
    k1_case(f"primary {gw}x{gh}, T {WIDEST_T}", kargs, gw * gh,
            widest.cl_slot2tri.long(), strict=True)

    # span latency: G tiles of rays that hit nothing, every tile entry
    # distance 0 and every cap INF, so no stop test fires and each tile
    # walks exactly SPAN_WALK spans
    for n_tiles in (1, 132, 1024):
        name = f"span latency, {n_tiles} tile(s)"
        k1_case(name, staging.walk_inputs(scene.cl_trifeat, n_tiles),
                n_tiles * sw.TILE_R)
        if int(sw.sweep_plain.visited.min()) != staging.SPAN_WALK:
            fail(f"K1 {name}: a tile stopped before {staging.SPAN_WALK} "
                 "spans")
        print(f"K1 {name}: {k1[name]['us_per_span']:.2f} us per span of a "
              f"tile's walk ({staging.SPAN_WALK} spans each)")

    # K1's preparation kernels against their plain versions, every output
    # equal, at the main path's shapes, by the probe's own run_case; the
    # SASS instructions per (ray, cluster) pair at the pair
    prep = {"sweep_key": {}, "sweep_spans": {}, "sweep_groups": {}}
    prep_pid = frame_order[:PREP_RAYS]
    prep_o, prep_d = camera.generate_rays(
        ((prep_pid % WIDTH).float() + 0.5) / WIDTH,
        ((prep_pid // WIDTH).float() + 0.5) / HEIGHT)
    prep_ones = torch.ones(PREP_RAYS, dtype=torch.bool, device=dev)
    prep_primary = (prep_o, prep_d, prep_ones, torch.zeros_like(prep_ones))

    # boxes that every ray enters (every tile minimum finite) and the scene
    # rebuilt in blocks of SMALL_T triangles
    t0 = time.perf_counter()
    small_scene = host_scene.build(cluster_size=SMALL_T)
    n_small = small_scene.cl_trifeat.shape[0]
    print(f"scene: rebuilt in {n_small} clusters of {SMALL_T} in "
          f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    mesh_sc = prep_kernels.mesh_scene(dev)
    n_mesh = mesh_sc.cl_trifeat.shape[0]
    print(f"scene: {mesh_sc.n_triangles} triangles in {n_mesh} clusters of "
          f"{prep_kernels.MESH_T} in {time.perf_counter() - t0:.2f} s")
    if n_mesh <= 512 * sw.CULL_GROUP:
        fail(f"{n_mesh} clusters: group boxes in one chunk")
    finite_boxes, finite_rays = prep_kernels.finite_case(dev)
    finite_name = (f"{finite_boxes.cl_aabb_min.shape[0]} clusters, every "
                   "minimum finite")
    for name, sc, rays in (
            ("primary", scene, prep_primary),
            ("pair", scene, merged(captured[0])),
            (f"deep pair (bounce {DEEP_BOUNCE - 1})", scene,
             merged(captured[-1])),
            *((f"{cast}, T {t_wide}", wide_scenes[t_wide], rays)
              for t_wide in WIDE_T
              for cast, rays in (("primary", prep_primary),
                                 ("pair", merged(captured[0])))),
            (finite_name, finite_boxes, finite_rays),
            (f"primary, T {SMALL_T}", small_scene, prep_primary),
            (f"pair, T {SMALL_T}", small_scene, merged(captured[0])),
            (f"primary, {n_mesh} clusters", mesh_sc, prep_primary),
            (f"pair, {n_mesh} clusters", mesh_sc, merged(captured[0]))):
        res = prep_kernels.run_case(name, sc, rays, plain=True)
        if res["key_dtype"] != torch.int32:
            fail(f"prep {name}: the key is {res['key_dtype']}, not "
                 "torch.int32")
        if name == finite_name and res["nspan_min"] != res["clusters"]:
            fail(f"prep {name}: a tile minimum is INF")
        for kname in ("sweep_key", "sweep_spans"):
            prep[kname][name] = res[kname]
        if name == "pair":
            prep_kernels.sass_report(res["pairs"])
    del finite_boxes, finite_rays
    for name, sc in ((f"T {SMALL_T}", small_scene),
                     (f"{n_mesh} clusters", mesh_sc)):
        prep["sweep_groups"][name] = prep_kernels.groups_case(
            name, sc.cl_aabb_min, sc.cl_aabb_max, plain=True)
    group_case = f"random, {GROUP_CASE_CLUSTERS}"
    prep["sweep_groups"][group_case] = prep_kernels.groups_case(
        group_case, *prep_kernels.random_boxes(dev, GROUP_CASE_CLUSTERS),
        plain=True)
    del mesh_sc
    # K1 on the span lists of those clusters (the primary cast's tiles
    # overlap one cluster each; the pair's walk up to hundreds)
    for name, rays in (("primary", prep_primary),
                       ("pair", merged(captured[0]))):
        kargs, _ = sw.sweep_inputs(small_scene, *rays)
        k1_case(f"{name}, T {SMALL_T}", kargs, int(rays[2].sum()),
                small_scene.cl_slot2tri.long(), strict=True)
    del kargs

    # 4. K2 vs plain at the schedule path's shapes: every round of the
    # primary cast and of the first bounce's bounce cast is compared; the
    # first round and the round with the most elected spans are timed
    real_ci = sched.cluster_intersect

    def all_rounds(sc, o, d, mask):
        seen = []

        def capture(rayfeat, best, spans, nspan, trifeat):
            seen.append((rayfeat, best.clone(), spans, nspan, trifeat))
            return real_ci(rayfeat, best, spans, nspan, trifeat)

        sched.cluster_intersect = capture
        try:
            with torch.no_grad():
                sched.closest_hit_scheduled(sc, o, d, sched_config,
                                            mask=mask)
        finally:
            sched.cluster_intersect = real_ci
        return seen

    def elected_spans(spans, nspan, c):
        return (torch.arange(spans.shape[1], device=dev)[None, :]
                < nspan[:, None]) & (spans < c)

    def round_bound(r, c):
        rayfeat, best0, spans, nspan, trifeat = r
        elected = elected_spans(spans, nspan, c)
        visits = int(elected.sum()) * (sched.RAY_TILE // 128)
        return probes.span_bound(
            visits, int(torch.unique(spans[elected]).numel()),
            trifeat.shape[2] // 4, best0.shape[0],
            index_bytes=(spans.numel() + nspan.numel()) * 4), visits, \
            int(elected.sum(dim=1).max())

    k2 = {}

    def k2_cast(sc, cast, rays, trifeat=None, slots=slot2tri, busiest=True,
                strict=False):
        """Hold every round's K2 launch of one scheduled cast against the
        plain version and time the first round (and the one with the most
        elected spans). trifeat replaces the scene's blocks in every
        round's launch. Returns the rounds."""
        rounds = all_rounds(sc, *rays)
        if trifeat is not None:
            rounds = [(*r[:4], trifeat) for r in rounds]
        c = sc.cl_trifeat.shape[0]
        err = 0.0
        for i, (rayfeat, best0, spans, nspan, tf) in enumerate(rounds):
            got = ci.cluster_intersect(rayfeat, best0.clone(), spans, nspan,
                                       tf)
            want = ci.cluster_intersect_plain(rayfeat, best0, spans, nspan,
                                              tf)
            torch.cuda.synchronize()
            e, agree, tri_agree = compare_records(
                got, want, slots, f"K2 {cast} round {i}", strict=strict,
                k2=True)
            err = max(err, e)
        print(f"K2 cluster_intersect {cast}: {len(rounds)} rounds, each "
              f"held against the plain version | max |dt| {err:.3g}")
        n_elected = [round_bound(r, c)[1] for r in rounds]
        top = max(range(len(rounds)), key=n_elected.__getitem__)
        for i in sorted({0, top} if busiest else {0}):
            rayfeat, best0, spans, nspan, tf = rounds[i]
            bound, visits, walk = round_bound(rounds[i], c)
            ms = cuda_ms(lambda: ci.cluster_intersect(
                rayfeat, best0.clone(), spans, nspan, tf))
            plain_ms = cuda_ms(lambda: ci.cluster_intersect_plain(
                rayfeat, best0, spans, nspan, tf), repeats=2)
            name = f"{cast} round {i}"
            k2[name] = dict(err=err, ms=ms, plain_ms=plain_ms, bound=bound,
                            visits=visits,
                            us_per_span=ms * 1e3 / max(walk, 1))
            print(f"K2 cluster_intersect {name} of {len(rounds)}: "
                  f"{best0.shape[0]} rays ({int(rays[2].sum())} live), "
                  f"{spans.shape[0]} tiles of {sched.RAY_TILE}, K "
                  f"{spans.shape[1]}, T {tf.shape[2] // 4}, elected spans "
                  f"{visits} (max {walk} per tile) | kernel {ms:.3f} ms "
                  f"(incl. record copy), plain {plain_ms:.3f} ms, bound "
                  f"{bound[0]:.4f} ms by {bound[1]} (operations "
                  f"{bound[2]:.4f} ms, bytes {bound[3]:.4f} ms) | "
                  f"{k2[name]['us_per_span']:.2f} us per elected span of "
                  "the busiest tile")
        return rounds

    k2_cast(scene, "primary", (origin, direction, ones))
    rounds = k2_cast(scene, "bounce", (o_cls, d_cls, m_cls))
    # the mean launch over all rounds of the bounce cast, each on a fresh
    # copy of its records: the figure that scales the pass; beside it the
    # plain version's mean over the same rounds and the mean bound
    copies = [r[1].clone() for r in rounds]
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for fn in (ci.cluster_intersect, ci.cluster_intersect_plain):
        for _ in range(2):   # a warm-up run, then the timed one
            start.record()
            for r, rec in zip(rounds, copies):
                rec.copy_(r[1])
                fn(r[0], rec, *r[2:])
            end.record()
            torch.cuda.synchronize()
        if fn is ci.cluster_intersect:
            k2_mean_ms = start.elapsed_time(end) / len(rounds)
        else:
            k2_mean_plain_ms = start.elapsed_time(end) / len(rounds)
    bounds = [round_bound(r, n_clusters) for r in rounds]
    n_elected = [b[1] for b in bounds]
    print(f"K2 cluster_intersect bounce: mean launch over the "
          f"{len(rounds)} rounds {k2_mean_ms:.4f} ms (incl. record copy), "
          f"plain {k2_mean_plain_ms:.4f} ms, mean bound "
          f"{sum(b[0][0] for b in bounds) / len(rounds):.4f} ms (operations "
          f"on {sum(b[0][1] == 'operations' for b in bounds)} of "
          f"{len(rounds)} rounds), elected spans per round mean "
          f"{sum(n_elected) / len(rounds):.1f} max {max(n_elected)}")
    # the kernels line reports the call with the most work on the main
    # path's blocks of 256
    k2_main = max(k2, key=lambda name: (k2[name]["visits"], k2[name]["ms"]))

    # the wide blocks of phase 3: the primary and the first bounce's cast,
    # every round equal to the plain version
    for t_wide, sc in wide_scenes.items():
        for cast, rays in (("primary", (origin, direction, ones)),
                           ("bounce", (o_cls, d_cls, m_cls))):
            k2_cast(sc, f"{cast}, T {t_wide}", rays,
                    slots=sc.cl_slot2tri.long(), busiest=False, strict=True)
    sc = wide_scenes[512]
    cut, cut_slots = cut_blocks(sc.cl_trifeat, sc.cl_slot2tri.long(),
                                RAGGED_WIDE_T)
    k2_cast(sc, f"primary, ragged T {RAGGED_WIDE_T}",
            (origin, direction, ones), trifeat=cut, slots=cut_slots,
            busiest=False, strict=True)
    k2_cast(widest, f"primary {gw}x{gh}, T {WIDEST_T}",
            (grid_o, grid_d, grid_ones), slots=widest.cl_slot2tri.long(),
            busiest=False, strict=True)

    # 5. the default render (sweep tracer)
    rays = WIDTH * HEIGHT * config.spp_per_pass * (1 + 2 * BOUNCES)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sw.sweep.launches = 0
    sw.sweep_plain.calls = 0
    sw.sweep_key.launches = sw.sweep_spans.launches = 0
    sw.group_boxes.launches = 0
    sw.sweep_key_plain.calls = sw.sweep_spans_plain.calls = 0
    ci.cluster_intersect.launches = 0
    ci.cluster_intersect_plain.calls = 0
    for k in SHADE_KERNELS:
        getattr(shade, k).launches = 0
    first_passes = []   # phase 14 holds the sharded passes against them
    img, pass_s = timed_passes(ortf, scene, camera, config, 3,
                               keep=first_passes)
    k1_launches, plain_calls = sw.sweep.launches, sw.sweep_plain.calls
    prep_launches = {"sweep_key": sw.sweep_key.launches,
                     "sweep_spans": sw.sweep_spans.launches,
                     "sweep_groups": sw.group_boxes.launches}
    prep_plain = (sw.sweep_key_plain.calls, sw.sweep_spans_plain.calls)
    timed = pass_s[1:]
    mean_s = sum(timed) / len(timed)
    peak = torch.cuda.max_memory_allocated()
    mean = check_image("render", img)
    shade_counts = [str(getattr(shade, k).launches) for k in SHADE_KERNELS]
    print(f"render: sweep tracer, {WIDTH}x{HEIGHT}, {BOUNCES} bounces, 3 "
          f"passes | warm-up {pass_s[0]:.3f} s, timed "
          f"{', '.join(f'{s:.3f}' for s in timed)} s, mean {mean_s:.3f} s | "
          f"{rays / mean_s:,.0f} rays/s | peak {peak / 2**30:.2f} GiB | K1 "
          f"launches {k1_launches} ({k1_launches // 3} per pass), plain "
          f"calls {plain_calls} | sweep_groups / sweep_key / sweep_spans "
          f"launches {prep_launches['sweep_groups']} / "
          f"{prep_launches['sweep_key']} / {prep_launches['sweep_spans']} "
          f"({prep_launches['sweep_groups'] // 3} / "
          f"{prep_launches['sweep_key'] // 3} / "
          f"{prep_launches['sweep_spans'] // 3} per pass), plain calls "
          f"{prep_plain[0]} / {prep_plain[1]} | shade_light / shade_bsdf / "
          f"shade_env launches {' / '.join(shade_counts)} | image mean "
          f"{mean:.4f}")
    shade_launches = shade.shade_bsdf.launches
    bounce_batches = 3 * BOUNCES * -(-WIDTH * HEIGHT // RAYS_PER_TILE)
    if not (0 < shade_launches <= bounce_batches and all(
            getattr(shade, k).launches == shade_launches
            for k in SHADE_KERNELS)):
        fail("the render launched shade_light / shade_bsdf / shade_env "
             f"{[getattr(shade, k).launches for k in SHADE_KERNELS]} times: "
             f"one of each a bounce, at most {bounce_batches}")
    if k1_launches <= 0:
        fail("the render launched no sweep kernel")
    if plain_calls != 0:
        fail(f"the render called the plain sweep {plain_calls} times")
    if min(prep_launches.values()) <= 0:
        fail(f"the render launched the preparation kernels {prep_launches}")
    if prep_plain != (0, 0):
        fail(f"the render called sweep_key_plain / sweep_spans_plain "
             f"{prep_plain} times")
    if prep_launches["sweep_groups"] != prep_launches["sweep_spans"]:
        fail(f"the render launched sweep_groups "
             f"{prep_launches['sweep_groups']} times in "
             f"{prep_launches['sweep_spans']} casts")
    if ci.cluster_intersect.launches or ci.cluster_intersect_plain.calls:
        fail("the sweep render reached the cluster-intersect kernel")
    if args.png:
        from opengl_ray_tracing_framework_tpu_torch.utils.image import (
            save_render)
        save_render(args.png, img.cpu().numpy())

    # 6. card vs CPU, default path
    small = config.replace(width=128, height=64)
    cam_small = ortf.Camera.make(aspect=2.0)
    scene_cpu, cam_cpu = scene.to("cpu"), cam_small.to("cpu")
    t0 = time.perf_counter()
    sweep_small = ortf.render_radiance(scene, cam_small, small, spp=2)
    torch.cuda.synchronize()
    gpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_img = ortf.render_radiance(scene_cpu, cam_cpu, small, spp=2)
    cpu_s = time.perf_counter() - t0
    compare_images("parity card vs cpu", sweep_small, cpu_img,
                   f"128x64, 2 spp, {BOUNCES} bounces | card {gpu_s:.2f} s, "
                   f"cpu {cpu_s:.2f} s | ")
    # the same on phase 3's blocks of SMALL_T
    sw.sweep_key.launches = sw.sweep_spans.launches = 0
    sw.group_boxes.launches = sw.sweep_key_plain.calls = 0
    sw.sweep_spans_plain.calls = sw.sweep_plain.calls = 0
    t0 = time.perf_counter()
    small_img = ortf.render_radiance(small_scene, cam_small, small, spp=2)
    torch.cuda.synchronize()
    gpu_s = time.perf_counter() - t0
    launched = {"sweep_groups": sw.group_boxes.launches,
                "sweep_key": sw.sweep_key.launches,
                "sweep_spans": sw.sweep_spans.launches}
    plain = (sw.sweep_key_plain.calls + sw.sweep_spans_plain.calls
             + sw.sweep_plain.calls)
    t0 = time.perf_counter()
    cpu_img = ortf.render_radiance(small_scene.to("cpu"), cam_cpu, small,
                                   spp=2)
    cpu_s = time.perf_counter() - t0
    compare_images(f"parity card vs cpu, {n_small} clusters", small_img,
                   cpu_img,
                   f"128x64, 2 spp, {BOUNCES} bounces | card {gpu_s:.2f} s "
                   f"(sweep_groups / sweep_key / sweep_spans launches "
                   f"{' / '.join(str(n) for n in launched.values())}, plain "
                   f"calls {plain}), cpu {cpu_s:.2f} s | ")
    if (min(launched.values()) <= 0 or plain
            or launched["sweep_groups"] != launched["sweep_spans"]):
        fail(f"the render on {n_small} clusters launched {launched} and "
             f"called a plain version {plain} times (one sweep_groups a "
             "cast)")

    # 7. the schedule render
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sw.sweep.launches = 0
    sw.sweep_plain.calls = 0
    ci.cluster_intersect.launches = 0
    ci.cluster_intersect_plain.calls = 0
    stats = sched.closest_hit_scheduled
    stats.rounds = stats.casts = stats.max_rounds = 0
    img, pass_s = timed_passes(ortf, scene, camera, sched_config, 2)
    k2_launches = ci.cluster_intersect.launches
    peak = torch.cuda.max_memory_allocated()
    mean = check_image("schedule render", img)
    print(f"schedule render: {WIDTH}x{HEIGHT}, {BOUNCES} bounces, 2 passes "
          f"| warm-up {pass_s[0]:.3f} s, timed {pass_s[1]:.3f} s | "
          f"{rays / pass_s[1]:,.0f} rays/s | peak {peak / 2**30:.2f} GiB | "
          f"K2 launches {k2_launches} ({k2_launches // 2} per pass), plain "
          f"calls {ci.cluster_intersect_plain.calls}, K1 launches "
          f"{sw.sweep.launches} | casts {stats.casts}, rounds per cast mean "
          f"{stats.rounds / max(stats.casts, 1):.2f} max {stats.max_rounds} "
          f"| image mean {mean:.4f}")
    if k2_launches <= 0:
        fail("the schedule render launched no cluster-intersect kernel")
    if k2_launches != stats.rounds:
        fail(f"{k2_launches} K2 launches in {stats.rounds} rounds")
    if ci.cluster_intersect_plain.calls != 0:
        fail("the schedule render called the plain cluster intersect")
    if sw.sweep.launches or sw.sweep_plain.calls:
        fail("the schedule render reached the sweep tracer")
    sched_small = ortf.render_radiance(
        scene, cam_small, small.replace(cast_backend="schedule"), spp=2)
    compare_images("schedule vs sweep", sched_small, sweep_small,
                   "128x64, 2 spp, on the card | ")

    # the full frame on the scene in blocks of 1,024 triangles: one pass
    # with each cluster tracer, held against phase 5's first pass (blocks
    # of 256; the same frame index draws the same samples)
    for label, cfg in (("sweep", config), ("schedule", sched_config)):
        sw.sweep.launches = sw.sweep_plain.calls = 0
        ci.cluster_intersect.launches = ci.cluster_intersect_plain.calls = 0
        keep = []
        _, pass_s = timed_passes(ortf, wide_scenes[1024], camera, cfg, 1,
                                 keep=keep)
        launched = (sw.sweep.launches, ci.cluster_intersect.launches)
        plain = sw.sweep_plain.calls + ci.cluster_intersect_plain.calls
        compare_images(
            f"blocks of 1024, {label} tracer", keep[0], first_passes[0],
            f"{WIDTH}x{HEIGHT}, {BOUNCES} bounces, one pass (no warm-up) "
            f"{pass_s[0]:.3f} s | K1 launches {launched[0]}, K2 launches "
            f"{launched[1]}, plain calls {plain} | against the pass on "
            "blocks of 256: ")
        if (launched[0] > 0) != (label == "sweep") \
                or (launched[1] > 0) != (label == "schedule") or plain:
            fail(f"blocks of 1024, {label} tracer: K1 launches "
                 f"{launched[0]}, K2 launches {launched[1]}, plain calls "
                 f"{plain}")

    # 8. BRDF mode
    brdf = config.replace(enable_bsdf=False)
    img, pass_s = timed_passes(ortf, scene, camera, brdf, 1)
    mean = check_image("BRDF render", img)
    print(f"BRDF render: sweep tracer, {WIDTH}x{HEIGHT}, {BOUNCES} bounces "
          f"| one pass (no warm-up) {pass_s[0]:.3f} s | image mean "
          f"{mean:.4f}")
    brdf_small = small.replace(enable_bsdf=False)
    compare_images(
        "BRDF card vs cpu",
        ortf.render_radiance(scene, cam_small, brdf_small, spp=2),
        ortf.render_radiance(scene_cpu, cam_cpu, brdf_small, spp=2),
        "128x64, 2 spp | ")

    # 9. the kernel-free tracers against the sweep image
    sweep_1spp = ortf.render_radiance(scene, cam_small, small, spp=1)
    for label, kw in (("bvh", dict(cast_backend="bvh")),
                      ("brute", dict(use_bvh=False))):
        t0 = time.perf_counter()
        got = ortf.render_radiance(scene, cam_small, small.replace(**kw),
                                   spp=1)
        torch.cuda.synchronize()
        compare_images(f"{label} vs sweep", got, sweep_1spp,
                       f"128x64, 1 spp, {time.perf_counter() - t0:.2f} s | ")

    # 10-11. the probe kernels, the shading kernels and the probes; 12. the
    # gradient path
    probe_entries, probe_counts = probe_phases(scene, camera, config)
    shaded = shade_kernels.run()
    for name in SHADE_KERNELS:
        row = shaded[name]
        if not row["within"] or row["us"] < row["bound_us"]:
            fail(f"{name}: {row}")
    grad_ref = grad_phases(ortf, scene, camera, config, k1_launches // 3,
                           wide_scenes[1024])

    # 13. the CLI; 14. multi-device
    cli_phase(ortf, scene, camera, config)
    shard_phase(ortf, scene, config, first_passes[:2], grad_ref)

    # 15. the bench, as a subprocess per tracer
    bench_phase()

    # 16. the row-balance probe, per tracer
    row_balance_phase(scene, camera, config)

    if args.profile:
        profile_pass("sweep", ortf, scene, camera, config)
        profile_k1_casts(ortf, sw, scene, camera, config)
        profile_pass("schedule", ortf, scene, camera, sched_config)
        profile_row_blocks(scene, camera, config)

    print(f"chip_smoke: every phase passed in "
          f"{time.perf_counter() - t_start:.1f} s")

    def entry(name, replaces, launches, cases, main_case, source=None):
        c = cases[main_case]
        return {
            "name": name, "route": "cuda",
            "source": f"{PORT}/csrc/{source or name}.cu",
            "replaces": replaces,
            "launches": launches,
            "max_abs_err": max(x["err"] for x in cases.values()),
            "ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound"][0], "bound_by": c["bound"][1],
            "library_ms": None}

    print(json.dumps({"kernels": [
        entry("sweep", "opengl_ray_tracing_framework_tpu/ops/sweep.py:104",
              k1_launches, k1, "pair"),
        entry("sweep_key", "opengl_ray_tracing_framework_tpu/ops/sweep.py:286",
              prep_launches["sweep_key"], prep["sweep_key"], "pair",
              source="sweep_prep"),
        entry("sweep_spans",
              "opengl_ray_tracing_framework_tpu/ops/sweep.py:299",
              prep_launches["sweep_spans"], prep["sweep_spans"], "pair",
              source="sweep_prep"),
        entry("sweep_groups", None, prep_launches["sweep_groups"],
              prep["sweep_groups"], group_case, source="sweep_prep"),
        entry("cluster_intersect",
              "opengl_ray_tracing_framework_tpu/ops/intersect_pallas.py:66",
              k2_launches, k2, k2_main),
        *({"name": name, "route": "cuda", "source": f"{PORT}/csrc/shade.cu",
           "replaces": None, "launches": shade_launches,
           "max_abs_err": shaded[name]["max_abs_err"],
           "ms": shaded[name]["us"] / 1e3,
           "plain_ms": shaded[name]["plain_ms"],
           "bound_ms": shaded[name]["bound_us"] / 1e3,
           "bound_by": shaded[name]["bound_by"], "library_ms": None}
          for name in SHADE_KERNELS),
        *({**probe_entries[name], "launches": probe_counts[name]}
          for name in ("probe_copy", "probe_gather", "probe_chained",
                       "probe_smem", "probe_stream")),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
