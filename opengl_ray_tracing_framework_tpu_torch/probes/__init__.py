"""Measurement probes of the card (PyTorch + CUDA port of the TPU cost
probes under exp/: compile_bisect, grid_overhead, pallas_gather_probe,
pallas_perf_probe).

The TPU files probe Mosaic lowerings and VMEM; their counterparts ask the
same questions of an NVIDIA Hopper card: what a CTA costs to schedule
(launch_overhead), how fast a table lookup is from global and from shared
memory (gather), how much shared memory a block can claim, how fast one
CTA and all SMs stream cluster-sized blocks through it, what torch's sorts
and index gathers cost (card_perf), and what the kernels cost to build,
load and launch beside their host preparation (kernel_build). Each module
runs as `python -m opengl_ray_tracing_framework_tpu_torch.probes.<name>`
on a machine with a card; every kernel has a plain PyTorch version beside
it that a CPU tensor gets.
"""

from __future__ import annotations

import ctypes

import torch

PEAK_HBM_BYTES = 3.35e12   # H100 SXM HBM3, bytes/s (NVIDIA data sheet)
PEAK_FP32_FLOPS = 67e12    # H100 SXM, FP32 outside the tensor cores
FLOPS_PER_PAIR = 80        # 40 FMAs per ray x triangle (csrc/mt_span.cuh)
SLAB_OPS = 27              # a ray x box slab test (csrc/sweep_prep.cu): per
                           # axis 2 subtractions, 2 products, 4 min / max;
                           # 2 comparisons and the clamp
L2_BYTES = 50 * 2**20      # H100 SXM L2 cache
N_SMS = 132                # H100 SXM streaming multiprocessors
SMEM_OPTIN_BYTES = 227 * 1024   # H100 shared memory a block may opt in to


def span_bound(visits, clusters_read, t_blk, n_rays, index_bytes):
    """(bound_ms, bound_by, ops_ms, bytes_ms) of a cluster kernel call that
    walks `visits` (ray tile of 128, cluster) spans over `clusters_read`
    distinct clusters of T = t_blk triangles: 128 * T * 80 FP32 operations
    per span; bytes are the 41*T floats of each distinct cluster block
    once, the ray features once, the records read and written once, and
    the span lists (index_bytes)."""
    ops = visits * 128 * t_blk * FLOPS_PER_PAIR
    nbytes = (clusters_read * 41 * t_blk * 4 + n_rays * (16 + 2 * 8) * 4
              + index_bytes)
    ops_ms = ops / PEAK_FP32_FLOPS * 1e3
    bytes_ms = nbytes / PEAK_HBM_BYTES * 1e3
    by = "operations" if ops_ms >= bytes_ms else "bytes"
    return max(ops_ms, bytes_ms), by, ops_ms, bytes_ms


def prep_bound(pairs, nbytes):
    """(bound_ms, bound_by, ops_ms, bytes_ms) of a preparation kernel call
    (csrc/sweep_prep.cu) whose function needs `pairs` slab tests of
    SLAB_OPS FP32 operations, one per (live ray, cluster), and moves
    `nbytes` (each input read once, each output written once)."""
    ops_ms = pairs * SLAB_OPS / PEAK_FP32_FLOPS * 1e3
    bytes_ms = nbytes / PEAK_HBM_BYTES * 1e3
    by = "operations" if ops_ms >= bytes_ms else "bytes"
    return max(ops_ms, bytes_ms), by, ops_ms, bytes_ms


def cuda_ms(fn, repeats: int = 20) -> float:
    """Mean milliseconds of fn() over `repeats` back-to-back runs between
    two CUDA events, after one warm-up run."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(repeats):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / repeats


def _replay_ms(capture, launches: int, replays: int) -> float:
    """Milliseconds per launch of a CUDA graph that capture() fills with
    `launches` launches, replayed `replays` times after one warm replay."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        kept = capture()   # noqa: F841, the graph's outputs stay allocated
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (launches * replays)


def graph_ms(fn, launches: int = 20, replays: int = 10) -> float:
    """Device milliseconds of one fn() on the same tensors every time:
    `launches` calls captured into a CUDA graph and replayed, so the
    kernels run back to back with no host between them. Inputs smaller
    than the L2 cache stay in it, so this is the L2-warm time and must not
    stand beside a bound computed at the HBM rate (hbm_ms does). cuda_ms of
    a microsecond kernel measures the Python wrapper's launch rate (15-25 us
    a call), not the kernel."""
    fn()
    torch.cuda.synchronize()

    def capture():
        for _ in range(launches):
            fn()   # its output is freed and the next launch writes there

    return _replay_ms(capture, launches, replays)


def hbm_ms(fn, inputs=(), replays: int = 10) -> float:
    """Device milliseconds of one fn(*inputs) whose inputs come from HBM
    and whose output goes there. The graph's launches rotate over distinct
    copies of the input tensors, each writing an output of its own, enough
    of them (2 to 64) that one round touches three times the L2 cache: by
    the time a copy comes round again it has been evicted. This is the
    time to hold against a bound of bytes over the HBM rate. fn may return
    None (a kernel without inputs or output: 64 launches)."""
    out = fn(*inputs)
    torch.cuda.synchronize()
    outs = () if out is None else (out,)
    set_bytes = sum(t.numel() * t.element_size() for t in (*inputs, *outs))
    n = min(max(-(-3 * L2_BYTES // max(set_bytes, 1)), 2), 64)
    copies = [inputs] + [tuple(t.clone() for t in inputs)
                         for _ in range(n - 1)]
    return _replay_ms(lambda: [fn(*c) for c in copies], n, replays)


def check_tensor(fn: str, name: str, x, dtype, shape, dev) -> None:
    """Raise unless x is a contiguous, 16-byte aligned `dtype` tensor of
    `shape` on `dev`: what the probe kernels take."""
    if (x.device != dev or x.dtype != dtype or tuple(x.shape) != tuple(shape)
            or not x.is_contiguous() or x.data_ptr() % 16):
        raise ValueError(
            f"{fn}: {name} must be a contiguous, 16-byte aligned {dtype} "
            f"tensor of shape {tuple(shape)} on {dev}; got {x.dtype} "
            f"{tuple(x.shape)} on {x.device}")


def launch(fn: str, dev, call) -> None:
    """Run call(stream) with dev current; raise on a CUDA launch error."""
    with torch.cuda.device(dev):
        rc = call(ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"{fn} kernel launch failed: cudaError {rc}")


def device_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    import subprocess
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
