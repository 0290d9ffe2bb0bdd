"""Row-block load balance of the bench frame on one card (PyTorch port of
the `tpu` mode of exp/scaling_probe.py, `run_tpu`).

    python -m opengl_ray_tracing_framework_tpu_torch.probes.row_balance \\
        [--tracer sweep|schedule] [--device D] [--repeats R]

The sharded render (parallel/sharding.py::render_pass_sharded) gives rank r
of N the rows [r * H/N, (r + 1) * H/N) and has no collective inside a
pass, so an N-card pass lasts as long as its slowest rank's rows. This
probe traces each of 8 row blocks of the bench frame alone with
render.py::_trace_rows, the per-rank unit of that pass, and gives
efficiency(N) = mean / max of the sums of N contiguous groups of blocks
for N = 2, 4 and 8 (exp/scaling_probe.py:125-127). It is an extrapolation
from one card: it measures the one term that a pass without collectives
leaves, how unevenly the frame's content loads its rows.

Two figures come out. `block_seconds` are wall seconds per block (median
of `repeats` calls taken round-robin over the blocks, each fenced by a
host copy of its radiance), and `efficiency` is the formula on them. On
the card `kernel_ms` is each block's device time in the tracer's kernel
(K1, csrc/sweep.cu, for the sweep tracer; K2, csrc/cluster_intersect.cu,
for the schedule tracer), summed from CUDA events recorded just before
and after every launch call (utils/nvcc.py::launch_events) in one more
call per block, and `kernel_efficiency` the formula on those: while
passes are host-bound the wall figure follows the host's noise more than
the content, and the kernel figure shows the content's imbalance.

The frame and scene are the bench's (bench.WIDTH x bench.HEIGHT,
bench.BOUNCES bounces, the 81,922-triangle `stand-in` scene,
Camera.make(aspect=W/H)), 8 blocks of rows, 131,072 rays per batch and
frame 1, as exp/scaling_probe.py:103-111 has them. It prints one JSON line
(FIELDS). On the CPU the kernels' plain versions run: `kernel_ms` and
`kernel_efficiency` are null. With no card and no --device cpu it fails
with torch's own error before printing anything.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from .. import bench
from ..models.camera import Camera
from ..render import _trace_rows
from ..utils import nvcc
from ..utils.config import RenderConfig, resolve_device

BLOCKS = 8
NDEVS = (2, 4, 8)
RAYS_PER_TILE = 131072
FRAME = 1
STAND_IN_SUBDIV = 6
FIELDS = ("mode", "block_seconds", "efficiency", "device", "power_limit",
          "scene", "triangles", "frame", "tracer", "blocks", "rays_per_tile",
          "repeats", "block_spread", "launches", "plain_calls", "kernel_ms",
          "kernel_efficiency")


def efficiency(times, ndevs=NDEVS) -> dict:
    """{str(N): mean / max of the N contiguous group sums of `times`}, the
    blocks of group r being r's rows in render_pass_sharded. Raises
    ValueError when N does not divide the block count."""
    times = np.asarray(times, np.float64)
    out = {}
    for n in ndevs:
        if times.size % n:
            raise ValueError(f"{n} devices do not divide {times.size} "
                             "blocks")
        groups = times.reshape(n, -1).sum(axis=1)
        out[str(n)] = float(groups.mean() / groups.max())
    return out


def _fence(radiance):
    float(radiance[-1, -1, 0])    # host copy: the block has finished


def _kernel_ms(trace, blocks, tracer) -> list[float]:
    """One more call per block, each launch of the tracer's kernel between
    two CUDA events (nvcc.launch_events): each block's summed device
    milliseconds."""
    logs = []
    for b in range(blocks):
        with nvcc.launch_events(bench.TRACERS[tracer], []) as log:
            _fence(trace(b))
        logs.append(log)
    torch.cuda.synchronize()
    return [sum(a.elapsed_time(z) for a, z in log) for log in logs]


def block_seconds(scene, camera, config: RenderConfig, *, blocks=BLOCKS,
                  rays_per_tile=RAYS_PER_TILE, frame=FRAME, repeats=3,
                  keep=False) -> dict:
    """Time each of `blocks` row blocks of the frame with _trace_rows
    (exp/scaling_probe.py:107-122): one warm-up call per block, then
    `repeats` calls round-robin over the blocks, each fenced by a host
    copy. Returns the tracer, blocks, rays_per_tile, frame and repeats, and
    per block: `block_seconds` (median), `block_spread` ((max - min) /
    median), `launches` ({kernel name: launches over the timed calls}),
    `plain_calls` (calls of the kernels' plain versions over the timed
    calls) and `kernel_ms` (on the card, else None); with keep, also
    `radiance`, the blocks' (H, W, 3) radiance stacked."""
    if config.height % blocks:
        raise ValueError(f"{blocks} blocks do not divide the height "
                         f"{config.height}")
    if config.cast_backend not in bench.TRACERS or not config.use_bvh:
        raise ValueError(f"the {config.cast_backend} tracer has no kernel; "
                         f"take one of {sorted(bench.TRACERS)}")
    rows = config.height // blocks

    def trace(b):
        return _trace_rows(scene, camera, frame, config, b * rows, rows,
                           rays_per_tile)

    seconds = [[] for _ in range(blocks)]
    launches = {"sweep": [0] * blocks, "cluster_intersect": [0] * blocks}
    plain, radiance = [0] * blocks, [None] * blocks
    with torch.no_grad():
        for b in range(blocks):
            _fence(trace(b))
        for _ in range(repeats):
            for b in range(blocks):
                before = bench.counts()
                t0 = time.perf_counter()
                radiance[b] = trace(b)
                _fence(radiance[b])
                seconds[b].append(time.perf_counter() - t0)
                k1, k2, n_plain = (a - z for a, z in zip(bench.counts(),
                                                         before))
                launches["sweep"][b] += k1
                launches["cluster_intersect"][b] += k2
                plain[b] += n_plain
        kernel_ms = (_kernel_ms(trace, blocks, config.cast_backend)
                     if scene.device.type == "cuda" else None)
    medians = [statistics.median(s) for s in seconds]
    out = {"tracer": config.cast_backend, "blocks": blocks,
           "rays_per_tile": rays_per_tile, "frame": frame,
           "repeats": repeats, "block_seconds": medians,
           "block_spread": [(max(s) - min(s)) / m
                            for s, m in zip(seconds, medians)],
           "launches": launches, "plain_calls": plain,
           "kernel_ms": kernel_ms}
    if keep:
        out["radiance"] = torch.cat(radiance)
    return out


def probe_line(res: dict, scene, scene_name: str) -> dict:
    """block_seconds' result as the probe's JSON line (FIELDS): JAX's
    fields under JAX's names (`mode` "card" for its "tpu"), then the
    card, the scene and the per-block counts."""
    dev = scene.device
    kernel_ms = res["kernel_ms"]
    out = {
        "mode": "card",
        "block_seconds": res["block_seconds"],
        "efficiency": efficiency(res["block_seconds"]),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev)),
        "power_limit": bench.power_limit(dev),
        "scene": scene_name,
        "triangles": scene.n_triangles,
        **{k: res[k] for k in ("frame", "tracer", "blocks", "rays_per_tile",
                               "repeats", "block_spread", "launches",
                               "plain_calls", "kernel_ms")},
        "kernel_efficiency": efficiency(kernel_ms) if kernel_ms else None,
    }
    assert tuple(out) == FIELDS
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--tracer", choices=sorted(bench.TRACERS),
                   default="sweep")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    p.add_argument("--repeats", type=int, default=3,
                   help="timed calls per block")
    p.add_argument("--width", type=int, default=bench.WIDTH)
    p.add_argument("--height", type=int, default=bench.HEIGHT)
    p.add_argument("--bounces", type=int, default=bench.BOUNCES)
    p.add_argument("--subdiv", type=int, default=STAND_IN_SUBDIV,
                   help="icosphere subdivisions of the stand-in scene "
                        f"({STAND_IN_SUBDIV}: 81,922 triangles)")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    torch.zeros((), device=device)    # no card: torch's error, nothing else
    scene = bench.build_scene("stand-in", device, args.subdiv)
    camera = Camera.make(aspect=args.width / args.height, device=device)
    config = RenderConfig(width=args.width, height=args.height,
                          max_bounce=args.bounces,
                          cast_backend=args.tracer).validate()
    res = block_seconds(scene, camera, config, repeats=args.repeats)
    name = ("stand-in" if args.subdiv == STAND_IN_SUBDIV
            else f"stand-in, subdiv {args.subdiv}")
    line = probe_line(res, scene, name)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
