"""Timing probes that size a traversal kernel for this card: the
counterpart of exp/pallas_perf_probe.py.

    python -m opengl_ray_tracing_framework_tpu_torch.probes.card_perf

1. shared-memory capacity: the largest dynamic shared memory a block can
   claim (csrc/probe_smem.cu; the TPU file probes the largest VMEM scratch),
2. chained table lookups (probes/gather.py::run_chained; the TPU file's
   axis-0 gather),
3. torch.sort / torch.argsort throughput (the ray binning of the sweep's
   host preparation; no kernel of this repository, as the TPU file times
   XLA's sort),
4. torch index gathers (un-permuting ray records; likewise),
5. the column sums of 64 dynamically addressed (128, 128) blocks
   (csrc/probe_stream.cu; the TPU file's dynamic ref-slice stream), for
   the TPU's one row of block starts and for one row per SM.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import nvcc
from . import (N_SMS, check_tensor, cuda_ms, device_line, graph_ms, hbm_ms,
               launch)
from . import gather as gather_probe

SMEM_SIZES_KB = (48, 64, 96, 128, 164, 200, 227, 228)
CUDA_ERROR_INVALID_VALUE = 1
LANES = 128                # row width of both probes
BLOCK_ROWS = 128           # rows per streamed block
N_STREAM_BLOCKS = 64
STREAM_TABLE_ROWS = 8192


# 1. shared-memory capacity


class SharedMemoryRefused(RuntimeError):
    """The card refused the requested dynamic shared memory size: the
    finding of the capacity probe, not a fault."""


def probe_smem_plain(n_bytes, device="cpu"):
    """Plain PyTorch version of csrc/probe_smem.cu: thread j writes
    j + n_bytes / 1024 into the last row and reads column 127 - j back."""
    probe_smem_plain.calls += 1
    lane = torch.arange(LANES, dtype=torch.float32, device=device)
    return (LANES - 1 - lane) + float(n_bytes // 1024)


probe_smem_plain.calls = 0


def _declare_smem(lib):
    lib.probe_smem_optin_limit.argtypes = [ctypes.c_int,
                                           ctypes.POINTER(ctypes.c_int)]
    lib.probe_smem_optin_limit.restype = ctypes.c_int
    lib.probe_smem_reserve.argtypes = [ctypes.c_int]
    lib.probe_smem_reserve.restype = ctypes.c_int
    lib.probe_smem_launch.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_void_p]
    lib.probe_smem_launch.restype = ctypes.c_int
    lib.probe_floor_launch.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.probe_floor_launch.restype = ctypes.c_int
    return lib


def smem_optin_limit(device="cuda") -> int:
    """Bytes of shared memory a block may opt in to, by the CUDA runtime."""
    device = torch.device(device)
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    n = ctypes.c_int(0)
    rc = nvcc.load("probe_smem").probe_smem_optin_limit(index, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"cudaDeviceGetAttribute failed: cudaError {rc}")
    return n.value


def probe_smem(n_bytes, device="cuda"):
    """One block that claims n_bytes (a multiple of 512) of dynamic shared
    memory, writes its last row and reads it back -> (128,) f32:
    csrc/probe_smem.cu on the card, probe_smem_plain on the CPU. Raises
    SharedMemoryRefused when the card refuses the size (cudaErrorInvalidValue
    from the reservation), RuntimeError on any other CUDA error.
    `probe_smem.launches` counts kernel launches."""
    device = torch.device(device)
    if n_bytes < 512 or n_bytes % 512:
        raise ValueError("probe_smem: n_bytes must be a positive multiple "
                         "of 512")
    if device.type == "cpu":
        return probe_smem_plain(n_bytes)
    if device.type != "cuda":
        raise NotImplementedError(f"probe_smem has no {device} version")
    lib = nvcc.load("probe_smem")
    out = torch.empty(LANES, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        rc = lib.probe_smem_reserve(n_bytes)
    if rc == CUDA_ERROR_INVALID_VALUE:
        raise SharedMemoryRefused(
            f"{n_bytes} bytes of dynamic shared memory refused")
    if rc != 0:
        raise RuntimeError(f"probe_smem reservation failed: cudaError {rc}")
    launch("probe_smem", device, lambda stream: lib.probe_smem_launch(
        out.data_ptr(), n_bytes, stream))
    probe_smem.launches += 1
    return out


probe_smem.launches = 0


def probe_floor(device="cuda", ctas=1):
    """Launch `ctas` CTAs of an empty kernel of 128 threads without shared
    memory (csrc/probe_smem.cu): with one CTA, the card's launch floor,
    K4c-1's bound. Returns None: the kernel has no output and no plain
    version. `probe_floor.launches` counts kernel launches."""
    device = torch.device(device)
    if device.type != "cuda":
        raise NotImplementedError(
            f"probe_floor times a launch on the card; {device} has none")
    if ctas < 1:
        raise ValueError(f"probe_floor: ctas must be >= 1, got {ctas}")
    lib = nvcc.load("probe_smem")
    launch("probe_floor", device,
           lambda stream: lib.probe_floor_launch(ctas, stream))
    probe_floor.launches += 1


probe_floor.launches = 0


def launch_floor_ms(device="cuda"):
    """Device milliseconds of one launch of the empty one-CTA kernel,
    timed as every probe kernel is (probes.hbm_ms)."""
    return hbm_ms(lambda: probe_floor(device))


def run_smem(device="cuda"):
    """Walk SMEM_SIZES_KB upward. Returns (largest size in KB that worked,
    first size refused or None, the runtime's opt-in limit in bytes)."""
    device = torch.device(device)
    limit = smem_optin_limit(device)
    largest, refused = 0, None
    for kb in SMEM_SIZES_KB:
        try:
            got = probe_smem(kb * 1024, device)
        except SharedMemoryRefused:
            refused = kb
            print(f"card_perf: shared memory {kb} KB: refused (finding: the "
                  f"limit is below {kb} KB)")
            break
        torch.cuda.synchronize(device)
        if not torch.equal(got, probe_smem_plain(kb * 1024, device)):
            raise RuntimeError(f"card_perf: the {kb} KB block read back "
                               "other values than it wrote")
        largest = kb
        print(f"card_perf: shared memory {kb} KB: OK")
    print(f"card_perf: largest block {largest} KB; the runtime's opt-in "
          f"limit is {limit} bytes ({limit / 1024:.0f} KB)")
    if refused is not None and refused * 1024 <= limit:
        raise RuntimeError(f"card_perf: {refused} KB refused below the "
                           f"runtime's limit of {limit} bytes")
    return largest, refused, limit


# 5. the column sums of dynamically addressed blocks


def probe_stream_plain(table, starts):
    """Plain PyTorch version of csrc/probe_stream.cu: for each row of
    starts (G, B), the sum over the rows of the B blocks
    table[start:start + 128] -> (G, 128). Float sums in another order than
    the kernel's: equal exactly for integer-valued tables, to float32
    rounding otherwise."""
    probe_stream_plain.calls += 1
    rows = starts.long()[..., None] + torch.arange(BLOCK_ROWS,
                                                   device=table.device)
    return table[rows].sum(dim=(1, 2))


probe_stream_plain.calls = 0


def _declare_stream(lib):
    lib.probe_stream_launch.argtypes = ([ctypes.c_void_p] * 4
                                        + [ctypes.c_int] * 3
                                        + [ctypes.c_void_p])
    lib.probe_stream_launch.restype = ctypes.c_int
    return lib


STREAM_WARPS = 8         # warps of a CTA of csrc/probe_stream.cu
STREAM_CTAS_PER_SM = 8   # as many as an SM holds: the most loads in flight
STREAM_MIN_ROWS = 32     # table rows a CTA sums at least, where it can


def stream_plan(g, n_blocks, n_sms=N_SMS):
    """P, the CTAs that share each of the g rows of starts: enough to fill
    every SM with STREAM_CTAS_PER_SM CTAs, each with STREAM_MIN_ROWS table
    rows or more, but two CTAs per SM at least (the TPU's one row of starts
    is 8,192 rows: P = 264), and one row per warp at most. CTA p of a row
    sums the virtual rows [p V / P, (p + 1) V / P) of V = n_blocks * 128."""
    rows = n_blocks * BLOCK_ROWS
    cap = max(rows // STREAM_MIN_ROWS, -(-2 * n_sms // g))
    return max(1, min(-(-STREAM_CTAS_PER_SM * n_sms // g), cap,
                      rows // STREAM_WARPS))


def probe_stream(table, starts):
    """Per row of starts, the column sums of its blocks: a split reduction
    over the whole card (csrc/probe_stream.cu: P = stream_plan CTAs per
    row write partials, a second kernel sums them) on CUDA tensors,
    probe_stream_plain on CPU tensors. table (N, 128) f32; starts (G, B)
    i32 first rows in [0, N - 128]. `probe_stream.launches` counts
    launches of the pair of kernels."""
    dev = table.device
    if dev.type == "cpu":
        return probe_stream_plain(table, starts)
    if dev.type != "cuda":
        raise NotImplementedError(f"probe_stream has no {dev} version")
    check_tensor("probe_stream", "table", table, torch.float32,
                 (table.shape[0], LANES), dev)
    check_tensor("probe_stream", "starts", starts, torch.int32,
                 tuple(starts.shape[:2]), dev)
    g, b = starts.shape
    parts = stream_plan(g, b, torch.cuda.get_device_properties(dev)
                        .multi_processor_count)
    out = torch.empty((g, LANES), dtype=torch.float32, device=dev)
    partials = torch.empty((g, parts, LANES), dtype=torch.float32,
                           device=dev)
    lib = nvcc.load("probe_stream")
    launch("probe_stream", dev, lambda s: lib.probe_stream_launch(
        table.data_ptr(), starts.data_ptr(), out.data_ptr(),
        partials.data_ptr(), g, b, parts, s))
    probe_stream.launches += 1
    return out


probe_stream.launches = 0


def make_stream_inputs(device, n_ctas, seed=0, integer=True,
                       n_blocks=N_STREAM_BLOCKS):
    """The TPU probe's shapes: an (8192, 128) table and 64 block starts
    (multiples of 128 rows) for each of n_ctas rows of starts. integer=True
    draws integer-valued floats in [0, 16) so every order of summation is
    exact."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    shape = (STREAM_TABLE_ROWS, LANES)
    if integer:
        table = torch.randint(0, 16, shape, generator=gen).float()
    else:
        table = torch.rand(shape, generator=gen)
    starts = torch.randint(
        0, STREAM_TABLE_ROWS // BLOCK_ROWS - 1, (n_ctas, n_blocks),
        generator=gen, dtype=torch.int32) * BLOCK_ROWS
    return table.to(device), starts.to(device)


def stream_bytes(n_ctas, n_blocks=N_STREAM_BLOCKS):
    """Bytes one launch streams: every row of starts reads its blocks and
    its starts and writes one row of sums."""
    return n_ctas * (n_blocks * (BLOCK_ROWS * LANES * 4 + 4) + LANES * 4)


def stream_bound_bytes(starts):
    """Bytes the function must move for these starts: each distinct table
    row that a block covers once, the starts and the sums."""
    rows = starts.long().reshape(-1, 1) + torch.arange(BLOCK_ROWS,
                                                       device=starts.device)
    return (rows.unique().numel() * LANES * 4 + starts.numel() * 4
            + starts.shape[0] * LANES * 4)


def run_stream(device="cuda"):
    """The TPU probe's one row of 64 block starts, and one row per SM: the
    sums equal to the plain version's, the device time with the table from
    HBM and left in L2, and the rate of the blocks' bytes (with 132 rows,
    553 MB of re-reads of a 4 MiB table: the L2 rate)."""
    device = torch.device(device)
    n_sms = torch.cuda.get_device_properties(device).multi_processor_count
    rows = []
    for g in (1, N_SMS):
        table, starts = make_stream_inputs(device, g)
        got = probe_stream(table, starts)
        if not torch.equal(got, probe_stream_plain(table, starts)):
            raise RuntimeError(f"card_perf: the block sums of {g} row(s) "
                               "of starts differ from the plain version")
        ms = hbm_ms(probe_stream, (table, starts))
        warm_ms = graph_ms(lambda: probe_stream(table, starts))
        nbytes = stream_bytes(g)
        ctas = g * stream_plan(g, N_STREAM_BLOCKS, n_sms)
        rows.append(dict(rows=g, ctas=ctas, ms=ms, warm_ms=warm_ms,
                         gb_s=nbytes / ms / 1e6,
                         warm_gb_s=nbytes / warm_ms / 1e6))
        print(f"card_perf: sums of 64 x (128, 128) blocks, {g} row(s) of "
              f"starts on {ctas} CTAs, table from HBM: {ms * 1e3:.2f} us = "
              f"{nbytes / ms / 1e6:.1f} GB/s of blocks | table left in L2: "
              f"{warm_ms * 1e3:.2f} us = {nbytes / warm_ms / 1e6:.1f} GB/s")
    return rows


# 3, 4. torch's sorts and index gathers (no kernel of this repository)


def run_sort(device="cuda", repeats=10, sizes=(1 << 19, 1 << 21)):
    device = torch.device(device)
    rows = []
    for n in sizes:
        gen = torch.Generator(device="cpu").manual_seed(0)
        keys = torch.randint(0, 1 << 30, (n,), generator=gen).to(device)
        for label, fn in (
                ("sort", lambda: torch.sort(keys)),
                ("stable sort", lambda: torch.sort(keys, stable=True)),
                ("argsort", lambda: torch.argsort(keys))):
            ms = cuda_ms(fn, repeats)
            rows.append(dict(n=n, op=label, ms=ms))
            print(f"card_perf: torch {label} of {n} int64 keys: {ms:.3f} ms "
                  f"({n / ms / 1e3:.1f} M/s)")
    return rows


def run_big_gather(device="cuda", repeats=10, sizes=(1 << 20, 1 << 22)):
    device = torch.device(device)
    rows = []
    for n in sizes:
        gen = torch.Generator(device="cpu").manual_seed(0)
        table = torch.arange(n, dtype=torch.float32, device=device)
        perm = torch.randperm(n, generator=gen).to(device)
        ms = cuda_ms(lambda: table[perm], repeats)
        rows.append(dict(n=n, op="perm-gather", ms=ms))
        print(f"card_perf: torch perm-gather of {n} f32: {ms:.3f} ms "
              f"({n / ms / 1e3:.1f} M/s)")
        rows8 = table.reshape(-1, 8)
        perm8 = torch.randperm(n // 8, generator=gen).to(device)
        ms = cuda_ms(lambda: rows8[perm8], repeats)
        rows.append(dict(n=n // 8, op="row-gather x8", ms=ms))
        print(f"card_perf: torch row-gather of {n // 8} x 8 f32: {ms:.3f} ms "
              f"({n // 8 / ms / 1e3:.1f} Mrow/s)")
    return rows


def run(device="cuda"):
    """All five probes; returns their results by name."""
    return dict(smem=run_smem(device),
                chained=gather_probe.run_chained(device),
                sort=run_sort(device), big_gather=run_big_gather(device),
                stream=run_stream(device))


def _smoke_stream(device):
    table, starts = make_stream_inputs(device, 1)
    starts = starts[:, :1].contiguous()
    return lambda: probe_stream(table, starts)


nvcc.register("probe_smem", _declare_smem,
              lambda device: lambda: probe_smem(48 * 1024, device))
nvcc.register("probe_stream", _declare_stream, _smoke_stream)


if __name__ == "__main__":
    print(device_line())
    run()
