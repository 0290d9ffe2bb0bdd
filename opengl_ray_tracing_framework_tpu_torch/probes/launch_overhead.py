"""What one CTA costs: the card's counterpart of exp/grid_overhead.py.

    python -m opengl_ray_tracing_framework_tpu_torch.probes.launch_overhead

The function is the TPU probe's: out = best + rayfeat[:, :8] per tile of
rows, the span-sweep kernel's block structure without its work, with and
without every tile reading its own (C,) span and entry-distance rows.
csrc/probe_copy.cu runs one CTA per tile (copy_plan: one thread per
16-byte piece of the tile's best rows, at most 1,024, a thread with more
pieces loading four at a time before it adds); `run` times it at tiles of 128,
256, 1,024 and 8,192 rows against the one-call best + rayfeat[:, :8] and
against the bytes it must move over the card's memory rate, with its inputs
coming from HBM (hbm_ms), and reports microseconds per CTA: the scheduling
cost a kernel with one CTA per ray tile (K1, K2) pays before any work,
and then an empty grid of each tile's CTAs (card_perf.probe_floor). The
time with the inputs left in the L2 cache (graph_ms) is printed beside it.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import nvcc
from . import (PEAK_HBM_BYTES, card_perf, check_tensor, cuda_ms, device_line,
               graph_ms, hbm_ms, launch)

N_ROWS, N_CLUSTERS = 131072, 589   # the TPU probe's shapes
TILES = (128, 256, 1024, 8192)
COPY_THREADS = 1024   # the most threads of a CTA of csrc/probe_copy.cu


def copy_plan(tile):
    """(threads, pieces per thread) of a CTA of csrc/probe_copy.cu: one
    thread per 16-byte piece of the tile's best rows (two per row), at most
    COPY_THREADS. Thread x takes pieces k * threads + x of its tile, k <
    pieces per thread (four at a time where it has more than one); piece j
    is half j % 2 of the tile's row j // 2."""
    if tile < 1:
        raise ValueError(f"probe_copy: tile must be >= 1, got {tile}")
    threads = min(2 * tile, COPY_THREADS)
    return threads, -(-2 * tile // threads)


def probe_copy_plain(rayfeat, best, tile, spans=None, tnear=None):
    """Plain PyTorch version of csrc/probe_copy.cu: best + rayfeat[:, :8].
    The span rows are read by the kernel and change nothing."""
    probe_copy_plain.calls += 1
    return best + rayfeat[:, :8]


probe_copy_plain.calls = 0


def _declare(lib):
    lib.probe_copy_launch.argtypes = ([ctypes.c_void_p] * 5
                                      + [ctypes.c_int] * 5
                                      + [ctypes.c_void_p])
    lib.probe_copy_launch.restype = ctypes.c_int
    return lib


def probe_copy(rayfeat, best, tile, spans=None, tnear=None,
               whole_rows=False):
    """out = best + rayfeat[:, :8], one CTA per `tile` rows
    (csrc/probe_copy.cu) on CUDA tensors, probe_copy_plain on CPU tensors.

    rayfeat (R, 16) f32; best (R, 8) f32; spans (G, C) i32 cluster ids
    >= 0 and tnear (G, C) f32 distances >= 0 with G = ceil(R / tile), or
    both None. whole_rows=True makes the kernel also load the half of
    every rayfeat row it does not use (the same output): what reading
    whole rows would cost. `probe_copy.launches` counts kernel launches."""
    dev = rayfeat.device
    if dev.type == "cpu":
        return probe_copy_plain(rayfeat, best, tile, spans, tnear)
    if dev.type != "cuda":
        raise NotImplementedError(f"probe_copy has no {dev} version")
    r = rayfeat.shape[0]
    threads, _ = copy_plan(tile)
    check_tensor("probe_copy", "rayfeat", rayfeat, torch.float32, (r, 16),
                 dev)
    check_tensor("probe_copy", "best", best, torch.float32, (r, 8), dev)
    n_cols = 0
    if (spans is None) != (tnear is None):
        raise ValueError("probe_copy: give spans and tnear together")
    if spans is not None:
        g, n_cols = -(-r // tile), spans.shape[1]
        check_tensor("probe_copy", "spans", spans, torch.int32, (g, n_cols),
                     dev)
        check_tensor("probe_copy", "tnear", tnear, torch.float32,
                     (g, n_cols), dev)
    out = torch.empty_like(best)
    lib = nvcc.load("probe_copy")
    launch("probe_copy", dev, lambda stream: lib.probe_copy_launch(
        rayfeat.data_ptr(), best.data_ptr(),
        spans.data_ptr() if n_cols else None,
        tnear.data_ptr() if n_cols else None,
        out.data_ptr(), r, tile, n_cols, threads, int(whole_rows), stream))
    probe_copy.launches += 1
    return out


probe_copy.launches = 0


def copy_bytes(n_rows, tile, n_cols):
    """Bytes the function must move: 32 B of each rayfeat row, each best
    row in, each out row, and the span + entry-distance rows."""
    return n_rows * 3 * 32 + (-(-n_rows // tile)) * n_cols * 8


def make_inputs(device, n_rows=N_ROWS, seed=0):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    rayfeat = torch.rand((n_rows, 16), generator=gen).to(device)
    best = torch.rand((n_rows, 8), generator=gen).to(device)
    return rayfeat, best


def make_span_rows(device, n_rows, tile, n_cols=N_CLUSTERS, seed=1):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    g = -(-n_rows // tile)
    spans = torch.randint(0, n_cols, (g, n_cols), generator=gen,
                          dtype=torch.int32).to(device)
    tnear = torch.rand((g, n_cols), generator=gen).to(device)
    return spans, tnear


def library_copy(rayfeat, best, *span_rows):
    """The one PyTorch call that computes the same function."""
    return best + rayfeat[:, :8]


def run(device="cuda", repeats=50):
    """Time the copy kernel per tile size, with and without span rows: on
    the device alone with its inputs from HBM (hbm_ms) and left in L2
    (graph_ms), and as a Python loop launches it (cuda_ms). Returns a list of
    dict rows (also printed)."""
    device = torch.device(device)
    rayfeat, best = make_inputs(device)
    want = probe_copy_plain(rayfeat, best, 0)
    library_ms = hbm_ms(library_copy, (rayfeat, best))
    print(f"launch_overhead: {N_ROWS} rows | one-call best + rayfeat[:, :8] "
          f"{library_ms * 1e3:.2f} us on the device from HBM, "
          f"{graph_ms(lambda: library_copy(rayfeat, best)) * 1e3:.2f} us "
          f"from L2, "
          f"{cuda_ms(lambda: library_copy(rayfeat, best), repeats) * 1e3:.2f}"
          " us in a Python loop")
    rows = []
    for tile in TILES:
        span_rows = make_span_rows(device, N_ROWS, tile)
        for label, extra in (("no span rows", ()), ("span rows", span_rows)):
            got = probe_copy(rayfeat, best, tile, *extra)
            if not torch.equal(got, want):
                raise RuntimeError(
                    f"launch_overhead: tile {tile} ({label}) differs from "
                    "best + rayfeat[:, :8]")
            ms = hbm_ms(lambda *x: probe_copy(x[0], x[1], tile, *x[2:]),
                        (rayfeat, best, *extra))
            warm_ms = graph_ms(lambda: probe_copy(rayfeat, best, tile,
                                                  *extra))
            loop_ms = cuda_ms(lambda: probe_copy(rayfeat, best, tile, *extra),
                              repeats)
            n_ctas = -(-N_ROWS // tile)
            bound_ms = copy_bytes(N_ROWS, tile, N_CLUSTERS if extra else 0) \
                / PEAK_HBM_BYTES * 1e3
            rows.append(dict(tile=tile, span_rows=bool(extra), ctas=n_ctas,
                             ms=ms, warm_ms=warm_ms, loop_ms=loop_ms,
                             us_per_cta=ms * 1e3 / n_ctas,
                             bound_ms=bound_ms, library_ms=library_ms))
            print(f"launch_overhead: tile {tile:5d}, {label:12s}: "
                  f"{ms * 1e3:8.2f} us for {n_ctas:5d} CTAs = "
                  f"{ms * 1e3 / n_ctas:.4f} us/CTA | bytes bound "
                  f"{bound_ms * 1e3:.2f} us | inputs left in L2 "
                  f"{warm_ms * 1e3:.2f} us | {loop_ms * 1e3:.2f} us in a "
                  "Python loop")
    # the empty grids last: a copy timed right after a run of empty
    # launches read 4% slower (PERF.md)
    for tile in TILES:
        n_ctas = -(-N_ROWS // tile)
        empty_ms = hbm_ms(lambda: card_perf.probe_floor(device, n_ctas))
        print(f"launch_overhead: tile {tile:5d}: an empty grid of "
              f"{n_ctas:5d} CTAs {empty_ms * 1e3:.2f} us")
    return rows


def _smoke(device):
    rayfeat, best = make_inputs(device, 128)
    return lambda: probe_copy(rayfeat, best, 128)


nvcc.register("probe_copy", _declare, _smoke)


if __name__ == "__main__":
    print(device_line())
    run()
