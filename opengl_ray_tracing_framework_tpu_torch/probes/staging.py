"""Whether K1's narrow cluster blocks would gain from the wide blocks'
staging: every CTA copying only its own columns by a tensor-map copy,
against the whole-block bulk copy that blocks of T <= 256 take.

    python -m opengl_ray_tracing_framework_tpu_torch.probes.staging

csrc/mt_span.cuh stages a block of T <= 256 triangles by one cp.async.bulk
of all its 41 x T floats into every CTA of a tile's thread-block cluster,
and a wider block by one tensor-map copy per chunk of a CTA's own columns.
This probe builds csrc/sweep.cu a second time, with staging() choosing the
tensor-map copy for every T that is a multiple of 4, and times the two
libraries in turns (bulk, tensor, tensor, bulk) on span walks of the
81,922-triangle scene's blocks of 256: tiles of rays that hit nothing, so
that each tile walks exactly SPAN_WALK spans (chip_smoke.py's span-latency
cases), at 1, 132, 264, 528 and 1,024 tiles, which take 8, 8, 4, 2 and 1
CTAs per tile. Every launch is held against sweep_plain first. It reports
microseconds per span of a tile's walk.
"""

from __future__ import annotations

import contextlib
import tempfile
from pathlib import Path

import torch

from ..ops import cluster_intersect as ci
from ..ops import sweep as sw
from ..utils import nvcc
from . import cuda_ms, device_line

SPAN_WALK = 64                       # spans each tile walks
TILES = (1, 132, 264, 528, 1024)     # 8, 8, 4, 2 and 1 CTAs per tile
_RULE = "return t_blk % 4 ? HAND : t_blk <= CHUNK_TRIS ? BULK : TENSOR;"


def walk_inputs(trifeat, n_tiles):
    """sweep arguments for n_tiles tiles of rays that hit nothing, each
    tile's span list SPAN_WALK clusters with entry distance 0 and every
    ray's cap INF, so that no stop test fires before the list ends."""
    dev = trifeat.device
    n, c = n_tiles * sw.TILE_R, trifeat.shape[0]
    best = ci.init_best(n, dev)
    best[:, 3] = sw.INF
    walk = (torch.arange(n_tiles, device=dev)[:, None] * 7
            + torch.arange(SPAN_WALK, device=dev)[None, :]) % c
    spans = torch.zeros((n_tiles, c), dtype=torch.int32, device=dev)
    spans[:, :SPAN_WALK] = walk.to(torch.int32)
    far = torch.tensor([0.0, 1000.0, 0.0], device=dev)
    up = torch.tensor([0.0, 1.0, 0.0], device=dev)
    return (torch.full((n_tiles,), SPAN_WALK, dtype=torch.int32, device=dev),
            spans, torch.zeros((n_tiles, c), device=dev),
            sw.ray_features(far.expand(n, 3), up.expand(n, 3)), best,
            trifeat.contiguous())


def build_tensor_variant(out_dir) -> Path:
    """csrc/sweep.cu built into out_dir with every T that is a multiple of
    4 staged by tensor-map copies of each CTA's columns."""
    src = Path(out_dir) / "csrc"
    src.mkdir(parents=True)
    for f in nvcc.CSRC.glob("*.cu*"):
        text = f.read_text()
        if f.name == "mt_span.cuh":
            if _RULE not in text:
                raise RuntimeError("csrc/mt_span.cuh: staging() no longer "
                                   "reads as this probe expects")
            text = text.replace(_RULE, "return t_blk % 4 ? HAND : TENSOR;")
        (src / f.name).write_text(text)
    lib = Path(out_dir) / "sweep_tensor.so"
    nvcc.compile_source("sweep", lib, src)
    return lib


def run(device="cuda", scene=None):
    """Microseconds per span of a tile's walk by staging and tile count:
    {(staging, n_tiles): [us, ...]} over the two turns of each."""
    device = torch.device(device)
    if scene is None:
        from .. import build_test_scene
        _, scene = build_test_scene(6, device=device)
    if scene.cl_trifeat.shape[2] != 4 * 256:
        raise ValueError("staging: the probe walks blocks of 256 triangles")
    cases = {g: walk_inputs(scene.cl_trifeat, g) for g in TILES}
    want = {g: sw.sweep_plain(*a) for g, a in cases.items()}
    rows = {}
    with tempfile.TemporaryDirectory() as tmp:
        variant = build_tensor_variant(tmp)
        for staging in ("bulk", "tensor", "tensor", "bulk"):
            with (nvcc.loaded_from("sweep", variant) if staging == "tensor"
                  else contextlib.nullcontext()):
                for g, a in cases.items():
                    launch = lambda: sw.sweep(*a[:4], a[4].clone(), a[5])
                    got = launch()
                    ms = cuda_ms(launch, 20)
                    torch.cuda.synchronize(device)
                    if not torch.equal(got[:, :3], want[g][:, :3]):
                        raise RuntimeError(
                            f"staging: {staging} staging at {g} tiles "
                            "differs from sweep_plain")
                    rows.setdefault((staging, g), []).append(
                        ms * 1e3 / SPAN_WALK)
    ctas = nvcc.load("sweep").sweep_cluster_size
    for g in TILES:
        bulk, tensor = rows[("bulk", g)], rows[("tensor", g)]
        print(f"staging: {g:5d} tiles x {ctas(g, 256)} CTA(s), T 256, "
              f"{SPAN_WALK} spans each | us per span of a walk: whole-block "
              f"bulk copy {' / '.join(f'{x:.2f}' for x in bulk)}, each "
              f"CTA's columns by tensor map "
              f"{' / '.join(f'{x:.2f}' for x in tensor)}")
    return rows


if __name__ == "__main__":
    print(device_line())
    run()
