"""Table-lookup throughput: the card's counterpart of
exp/pallas_gather_probe.py and exp/pallas_perf_probe.py::probe_axis0_gather.

    python -m opengl_ray_tracing_framework_tpu_torch.probes.gather

The functions are the TPU probes': out = table[idx] (probe_gather, K4b),
and the chained form out[i, j] = acc after `steps` times acc =
(int(table[acc, j]) + 1) % S from acc = idx[i, j] (probe_chained, K4c-2).
Every thread of this card can load any address, so no lowering can fail;
what the probe measures is the rate: the plain gather with the table read
from global memory and staged in shared memory first, from the TPU probe's
4,096 entries up to a table that leaves the 50 MB L2; the chained lookups
in a column slice of the table staged in shared memory (csrc/
probe_gather.cu, both). Indices come from HBM and results go there
(hbm_ms); the time with both left in the L2 cache (graph_ms) is printed
beside it.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import nvcc
from . import (N_SMS, PEAK_HBM_BYTES, SMEM_OPTIN_BYTES, check_tensor,
               device_line, graph_ms, hbm_ms, launch)

MAX_STAGED_BYTES = SMEM_OPTIN_BYTES - 16   # less the table copy's barrier
SECTOR_COLS = 8       # f32 columns of one 32-byte sector of a table row
CHAINED_S = (512, 1024, 2048, 3000, 4096)   # the TPU probe's S, and one
                                            # that is no power of two


def probe_gather_plain(table, idx, steps=0, staged=False):
    """Plain PyTorch version of csrc/probe_gather.cu. table (S,) or (S, W)
    f32; idx any shape (last dim W for a 2-D table) integer in [0, S).
    steps = 0: table[idx] (column j of a 2-D table for idx[..., j]);
    steps > 0: `steps` chained lookups acc = (int(table[acc]) + 1) % S,
    returned as float32."""
    probe_gather_plain.calls += 1
    s = table.shape[0]
    if table.ndim == 2:
        col = torch.arange(table.shape[1], device=table.device)
        look = lambda a: table[a, col]
    else:
        look = lambda a: table[a]
    acc = idx.long()
    if steps == 0:
        return look(acc)
    for _ in range(steps):
        acc = (look(acc).long() + 1) % s
    return acc.to(torch.float32)


probe_gather_plain.calls = 0


def _declare(lib):
    lib.probe_gather_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_longlong]
        + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lib.probe_gather_launch.restype = ctypes.c_int
    lib.probe_chain_launch.argtypes = ([ctypes.c_void_p] * 3
                                       + [ctypes.c_int] * 7
                                       + [ctypes.c_void_p])
    lib.probe_chain_launch.restype = ctypes.c_int
    return lib


def probe_gather(table, idx, staged=False):
    """out = table[idx]: csrc/probe_gather.cu on CUDA tensors,
    probe_gather_plain on CPU tensors. staged=True copies the table into
    the shared memory of each CTA first (it must fit 227 KB), with as many
    CTAs as fit per SM. idx is int32. `probe_gather.launches` counts
    kernel launches."""
    dev = table.device
    if dev.type == "cpu":
        return probe_gather_plain(table, idx, staged=staged)
    if dev.type != "cuda":
        raise NotImplementedError(f"probe_gather has no {dev} version")
    s = table.shape[0]
    cols = table.shape[1] if table.ndim == 2 else 1
    check_tensor("probe_gather", "table", table, torch.float32,
                 (s, cols) if table.ndim == 2 else (s,), dev)
    check_tensor("probe_gather", "idx", idx, torch.int32, idx.shape, dev)
    if table.ndim == 2 and idx.shape[-1] != cols:
        raise ValueError(f"probe_gather: idx rows must hold {cols} columns")
    if staged and s * cols * 4 > MAX_STAGED_BYTES:
        raise ValueError(
            f"probe_gather: a staged table of {s * cols * 4} bytes exceeds "
            f"the {MAX_STAGED_BYTES} a block can claim")
    out = torch.empty(idx.shape, dtype=torch.float32, device=dev)
    n_idx = idx.numel()
    # the global form's grid; the staged form's is as many CTAs as fit the
    # card with the table in shared memory (csrc/probe_gather.cu)
    n_ctas = min(-(-n_idx // 256), 8 * N_SMS)
    lib = nvcc.load("probe_gather")
    launch("probe_gather", dev, lambda stream: lib.probe_gather_launch(
        table.data_ptr(), idx.data_ptr(), out.data_ptr(), s, cols, n_idx,
        int(staged), max(n_ctas, 1), stream))
    probe_gather.launches += 1
    return out


probe_gather.launches = 0


def chained_plan(s, cols, rows, n_sms=N_SMS, limit=SMEM_OPTIN_BYTES):
    """(c, splits) of the chained kernel on an (s, cols) table and (rows,
    cols) indices: CTA (x, y) stages columns [x c, x c + c) of the table
    (the last group may be narrower), s * c * 4 bytes of its `limit` of
    shared memory, and runs the chains of idx rows [y rows / splits,
    (y + 1) rows / splits). c is a power of two (so it divides a warp's
    32 banks) up to the 8 columns of one 32-byte sector; the split fills
    the n_sms SMs once, as each CTA stages its slice anew. Raises
    ValueError when one column does not fit."""
    fit = limit // (4 * s)
    if fit < 1:
        raise ValueError(
            f"probe_chained: one column of a {s}-row table is {4 * s} bytes "
            f"of shared memory, over the card's opt-in limit of {limit} "
            f"bytes per block (S <= {limit // 4})")
    c = 1 << (min(SECTOR_COLS, fit, cols).bit_length() - 1)
    groups = -(-cols // c)
    return c, max(1, min(rows, n_sms // groups))


def probe_chained(table, idx, steps=8):
    """`steps` chained lookups acc = (int(table[acc, j]) + 1) % S from acc
    = idx[i, j], as float32: csrc/probe_gather.cu's chained kernel on CUDA
    tensors (the table's column slices staged in shared memory, the plan
    of chained_plan on this card), probe_gather_plain on CPU tensors.
    table (S, C) f32 with idx (R, C), or table (S,) with idx of any shape;
    idx int32 in [0, S). `probe_chained.launches` counts kernel
    launches."""
    dev = table.device
    if dev.type == "cpu":
        return probe_gather_plain(table, idx, steps)
    if dev.type != "cuda":
        raise NotImplementedError(f"probe_chained has no {dev} version")
    from .card_perf import smem_optin_limit
    s = table.shape[0]
    cols = table.shape[1] if table.ndim == 2 else 1
    check_tensor("probe_chained", "table", table, torch.float32,
                 table.shape, dev)
    check_tensor("probe_chained", "idx", idx, torch.int32, idx.shape, dev)
    if table.ndim == 2 and (idx.ndim != 2 or idx.shape[1] != cols):
        raise ValueError(f"probe_chained: idx must be (R, {cols})")
    rows = idx.numel() // cols
    c, splits = chained_plan(
        s, cols, rows, torch.cuda.get_device_properties(dev)
        .multi_processor_count, smem_optin_limit(dev))
    out = torch.empty(idx.shape, dtype=torch.float32, device=dev)
    lib = nvcc.load("probe_gather")
    launch("probe_chained", dev, lambda stream: lib.probe_chain_launch(
        table.data_ptr(), idx.data_ptr(), out.data_ptr(), s, cols, rows,
        steps, c, splits, int(cols % 4 == 0 and c % 4 == 0), stream))
    probe_chained.launches += 1
    return out


probe_chained.launches = 0


def make_inputs(device, n_table, idx_shape, cols=None, seed=0):
    """The TPU probes' data: table[i] = 2 i (1-D) or a lane-replicated
    table[i, j] = i (cols given), and uniform random int32 indices."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    if cols is None:
        table = torch.arange(n_table, dtype=torch.float32) * 2.0
    else:
        table = torch.arange(n_table, dtype=torch.float32)[:, None] \
            .repeat(1, cols)
    idx = torch.randint(0, n_table, idx_shape, generator=gen,
                        dtype=torch.int32)
    return table.to(device), idx.to(device)


def make_chained_inputs(device, s, cols=128, seed=0, integer=True):
    """An (s, cols) table whose columns differ, table[i, j] = (7 i + 13 j)
    % s (integer=True; random floats in [0, s) otherwise), and (s, cols)
    uniform random int32 indices: the TPU probe's shapes, on a table where
    a lookup of the wrong column gives another chain."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    if integer:
        i = torch.arange(s)[:, None]
        table = ((7 * i + 13 * torch.arange(cols)) % s).float()
    else:
        table = torch.rand((s, cols), generator=gen) * s
    idx = torch.randint(0, s, (s, cols), generator=gen, dtype=torch.int32)
    return table.to(device), idx.to(device)


def gather_bytes(n_idx):
    """Bytes a gather must move: each index in, each value out, and at
    least the 4 B it looks up."""
    return n_idx * 12


def chained_bytes(table, idx):
    """Bytes the chained lookups must move: the table once, each index in
    and each result out."""
    return table.numel() * 4 + idx.numel() * 8


def run(device="cuda", n_idx=1 << 22):
    """Gather rates by table size and source (device time, indices from
    HBM). Returns dict rows."""
    device = torch.device(device)
    rows = []
    # the TPU probe's own shape: a yes/no probe there, one tiny launch here
    table, idx = make_inputs(device, 4096, (8, 128))
    for staged in (False, True):
        got = probe_gather(table, idx, staged=staged)
        if not torch.equal(got, probe_gather_plain(table, idx)):
            raise RuntimeError("gather: the (8, 128) lookup differs")
    print("gather: table (4096,), idx (8, 128): global and staged lookups "
          "equal table[idx]")
    for log2 in (12, 14, 15, 20, 24, 26):
        n_table = 1 << log2
        table, idx = make_inputs(device, n_table, (n_idx,))
        want = probe_gather_plain(table, idx)
        library_ms = hbm_ms(lambda t, i: torch.index_select(t, 0, i),
                            (table, idx))
        for staged in (False, True):
            if staged and n_table * 4 > MAX_STAGED_BYTES:
                continue
            got = probe_gather(table, idx, staged=staged)
            if not torch.equal(got, want):
                raise RuntimeError(f"gather: table 2^{log2} staged={staged} "
                                   "differs from table[idx]")
            ms = hbm_ms(lambda t, i: probe_gather(t, i, staged=staged),
                        (table, idx))
            warm_ms = graph_ms(lambda: probe_gather(table, idx,
                                                    staged=staged))
            bound_ms = gather_bytes(n_idx) / PEAK_HBM_BYTES * 1e3
            rows.append(dict(n_table=n_table, staged=staged, n_idx=n_idx,
                             ms=ms, warm_ms=warm_ms,
                             gelem_s=n_idx / ms / 1e6,
                             bound_ms=bound_ms, library_ms=library_ms))
            print(f"gather: table 2^{log2} f32 ({n_table * 4 / 2**20:.3f} "
                  f"MiB) from {'shared' if staged else 'global'} memory, "
                  f"{n_idx} lookups: {ms * 1e3:.1f} us = "
                  f"{n_idx / ms / 1e6:.1f} Gelem/s | bytes bound "
                  f"{bound_ms * 1e3:.1f} us | index_select "
                  f"{library_ms * 1e3:.1f} us | indices and results left in "
                  f"L2 {warm_ms * 1e3:.1f} us")
    return rows


def run_chained(device="cuda", steps=8):
    """The TPU probe's 8 dependent lookups on an (S, 128) table whose
    columns differ, S = 512..4,096 and 3,000, each equal to the plain
    version."""
    device = torch.device(device)
    rows = []
    for s in CHAINED_S:
        table, idx = make_chained_inputs(device, s)
        got = probe_chained(table, idx, steps)
        if not torch.equal(got, probe_gather_plain(table, idx, steps)):
            raise RuntimeError(f"gather: chained S={s} differs")
        ms = hbm_ms(lambda t, i: probe_chained(t, i, steps), (table, idx))
        n = steps * idx.numel()
        bound_ms = chained_bytes(table, idx) / PEAK_HBM_BYTES * 1e3
        rows.append(dict(s=s, ms=ms, bound_ms=bound_ms,
                         gelem_s=n / ms / 1e6))
        print(f"gather: chained x{steps}, S={s}, (S, 128) column slices in "
              f"shared memory (c, splits = {chained_plan(s, 128, s)}): "
              f"{ms * 1e3:.2f} us for {n} lookups = {n / ms / 1e6:.1f} "
              f"Gelem/s | bytes bound {bound_ms * 1e3:.3f} us")
    return rows


def _smoke(device):
    table, idx = make_inputs(device, 4096, (8, 128))
    return lambda: probe_gather(table, idx)


nvcc.register("probe_gather", _declare, _smoke)


if __name__ == "__main__":
    print(device_line())
    run()
    run_chained()
