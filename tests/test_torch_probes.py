"""PyTorch port, the card's measurement probes (probes/): each kernel's
plain PyTorch version against a numpy restatement of the lines of the TPU
probe it replaces. The scripts under exp/ run at import on a TPU and have
no interpret switch, so they are restated here, not imported. On CPU
tensors every wrapper runs its plain version and launches nothing; the
kernels themselves are held against these plain versions on the card
(chip_smoke.py, and the `cuda`-marked test below).
"""

import numpy as np
import pytest
import torch

from opengl_ray_tracing_framework_tpu_torch import probes
from opengl_ray_tracing_framework_tpu_torch.probes import (
    card_perf, gather, kernel_build, launch_overhead)


def test_copy_matches_grid_overhead():
    """exp/grid_overhead.py:26-28, 74-75, 90-91: out = best + rayfeat[:, :8]
    whatever the tile and with or without the span blocks."""
    rayfeat, best = launch_overhead.make_inputs("cpu", n_rows=1000, seed=3)
    want = best.numpy() + rayfeat.numpy()[:, :8]
    launches = launch_overhead.probe_copy.launches
    for tile in (128, 256, 1024, 8192):
        spans, tnear = launch_overhead.make_span_rows("cpu", 1000, tile, 37)
        assert spans.shape == (-(-1000 // tile), 37)
        assert spans.min() >= 0 and tnear.min() >= 0   # the kernel's guard
        for extra in ((), (spans, tnear)):
            got = launch_overhead.probe_copy(rayfeat, best, tile, *extra)
            np.testing.assert_array_equal(got.numpy(), want)
    assert launch_overhead.probe_copy.launches == launches


def test_copy_bytes():
    # 131,072 rows x (32 B rayfeat + 32 B best + 32 B out) + G x C x 8 B
    assert launch_overhead.copy_bytes(131072, 128, 0) == 131072 * 96
    assert launch_overhead.copy_bytes(131072, 128, 589) \
        == 131072 * 96 + 1024 * 589 * 8
    assert launch_overhead.copy_bytes(1000, 128, 10) == 96000 + 8 * 80


@pytest.mark.parametrize("tile", [*launch_overhead.TILES, 1, 3, 100, 600])
@pytest.mark.parametrize("n_rows", [131072, 131072 - 37, 1000])
def test_copy_plan_covers_every_row_once(tile, n_rows):
    """copy_plan's threads and pieces per thread, cut as the kernel cuts
    them (thread x takes piece k * threads + x of its tile, pieces past
    the tile's last row skipped), load each half of every row of every
    CTA once, the ragged last tile included; a CTA has at most 1,024
    threads and no thread without a piece where the tile fills it."""
    threads, per = launch_overhead.copy_plan(tile)
    assert 1 <= threads <= launch_overhead.COPY_THREADS
    assert threads * per >= 2 * tile > threads * (per - 1)
    n_ctas = -(-n_rows // tile)
    for rows in {min(tile, n_rows), n_rows - (n_ctas - 1) * tile}:
        j = (np.arange(per)[:, None] * threads
             + np.arange(threads)[None, :]).ravel()
        j = j[j < 2 * rows]
        seen = np.zeros((rows, 2), np.int32)
        np.add.at(seen, (j // 2, j % 2), 1)
        np.testing.assert_array_equal(seen, 1)
    with pytest.raises(ValueError):
        launch_overhead.copy_plan(0)


def test_copy_whole_rows_is_the_same_function():
    """whole_rows only makes the kernel load the half of each rayfeat row
    it does not use: on the CPU the same best + rayfeat[:, :8]."""
    rayfeat, best = launch_overhead.make_inputs("cpu", n_rows=300, seed=5)
    want = launch_overhead.probe_copy(rayfeat, best, 128)
    got = launch_overhead.probe_copy(rayfeat, best, 128, whole_rows=True)
    assert torch.equal(got, want)
    assert torch.equal(got, best + rayfeat[:, :8])


def test_launch_floor_is_the_cards():
    """The empty kernel times a launch: it has no plain version, and asked
    for the CPU it raises without counting a launch."""
    launches = card_perf.probe_floor.launches
    with pytest.raises(NotImplementedError):
        card_perf.probe_floor("cpu")
    assert card_perf.probe_floor.launches == launches


def test_gather_matches_gather_probe():
    """exp/pallas_gather_probe.py:40-43, 54-55: table = arange(N) * 2,
    idx (8, 128) random, out = table[idx]."""
    table, idx = gather.make_inputs("cpu", 4096, (8, 128), seed=0)
    np.testing.assert_array_equal(
        table.numpy(), np.arange(4096, dtype=np.float32) * 2.0)
    assert idx.dtype == torch.int32 and 0 <= idx.min() and idx.max() < 4096
    launches = gather.probe_gather.launches
    for staged in (False, True):
        got = gather.probe_gather(table, idx, staged=staged)
        assert got.shape == (8, 128) and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(),
                                      table.numpy()[idx.numpy()])
    assert gather.probe_gather.launches == launches


def _split_range(n, parts, i):
    """Part i of `parts` consecutive ranges of range(n), as the probe
    kernels cut their work: [i n / parts, (i + 1) n / parts)."""
    return i * n // parts, (i + 1) * n // parts


def _perf_probe_chains(tab, idx, s):
    """exp/pallas_perf_probe.py:57-64 restated: 8 dependent lookups
    acc = (int(tab[acc, j]) + 1) % S along axis 0, as float32."""
    acc = idx.copy()
    for _ in range(8):
        g = np.take_along_axis(tab, acc, axis=0)
        acc = (g.astype(np.int32) + 1) % s
    return acc.astype(np.float32)


@pytest.mark.parametrize("s", [512, 4096])
def test_chained_gather_matches_perf_probe(s):
    """exp/pallas_perf_probe.py:51-64: a lane-replicated (S, 128) table,
    8 dependent lookups acc = (int(tab[acc, j]) + 1) % S, the result as
    float32; the 1-D table gives the same values."""
    table, idx = gather.make_inputs("cpu", s, (s, 128), cols=128, seed=0)
    tab = np.tile(np.arange(s, dtype=np.float32)[:, None], (1, 128))
    np.testing.assert_array_equal(table.numpy(), tab)
    got = gather.probe_chained(table, idx, steps=8)
    np.testing.assert_array_equal(got.numpy(),
                                  _perf_probe_chains(tab, idx.numpy(), s))
    flat = gather.probe_chained(table[:, 0].contiguous(), idx.reshape(-1),
                                steps=8)
    np.testing.assert_array_equal(flat.numpy().reshape(s, 128), got.numpy())


@pytest.mark.parametrize("s,integer", [(512, True), (3000, True),
                                       (3000, False)])
def test_chained_gather_on_columns_that_differ(s, integer):
    """The same function on a table whose columns differ, table[i, j] =
    (7 i + 13 j) % S (or random floats in [0, S)), so that a lookup of
    the wrong column gives another chain; S = 3,000 is no power of two."""
    table, idx = gather.make_chained_inputs("cpu", s, seed=4,
                                            integer=integer)
    tab = table.numpy()
    if integer:
        i, j = np.meshgrid(np.arange(s), np.arange(128), indexing="ij")
        np.testing.assert_array_equal(tab, (7 * i + 13 * j) % s)
    assert (tab[:, 0] != tab[:, 1]).all() and tab.min() >= 0 \
        and tab.max() < s
    want = _perf_probe_chains(tab, idx.numpy(), s)
    launches = gather.probe_chained.launches
    got = gather.probe_chained(table, idx, steps=8)
    assert gather.probe_chained.launches == launches
    np.testing.assert_array_equal(got.numpy(), want)
    # the same chains on the lane-replicated table of column 0 differ
    rep = gather.probe_chained(table[:, :1].repeat(1, 128).contiguous(), idx)
    assert not np.array_equal(rep.numpy(), want)


@pytest.mark.parametrize("s,cols,rows,n_sms", [
    (4096, 128, 4096, 132), (512, 128, 512, 132), (3000, 128, 3000, 132),
    (4096, 1, 524288, 132), (4096, 6, 100, 132), (58112, 128, 64, 132),
    (300, 12, 37, 132), (2048, 128, 2048, 16)])
def test_chained_plan_covers_every_chain_once(s, cols, rows, n_sms):
    """chained_plan's column groups and row splits, cut as the kernel cuts
    them, cover every (row, column) of idx once; each staged slice fits
    the card's shared memory, c is a power of two up to one 32-byte
    sector, and the grid does not exceed the SMs unless one column group
    needs more (then one CTA a group)."""
    limit = probes.SMEM_OPTIN_BYTES
    c, splits = gather.chained_plan(s, cols, rows, n_sms, limit)
    assert s * c * 4 <= limit and c & (c - 1) == 0
    assert c <= gather.SECTOR_COLS and c <= cols and 1 <= splits <= rows
    groups = -(-cols // c)
    assert groups * splits <= max(n_sms, groups)
    seen = np.zeros((rows, cols), np.int32)
    for x in range(groups):
        for y in range(splits):
            r0, r1 = _split_range(rows, splits, y)
            seen[r0:r1, x * c:min(x * c + c, cols)] += 1
    np.testing.assert_array_equal(seen, 1)


def test_chained_plan_refuses_a_column_over_the_limit():
    limit = probes.SMEM_OPTIN_BYTES
    assert gather.chained_plan(limit // 4, 128, 8)[0] == 1
    with pytest.raises(ValueError, match=str(limit)):
        gather.chained_plan(limit // 4 + 1, 128, 8)
    with pytest.raises(ValueError, match="opt-in limit of 1024"):
        gather.chained_plan(512, 4, 8, limit=1024)


def test_smem_matches_a_scratch_row():
    """exp/pallas_perf_probe.py:33-35 writes one row of an (n, 128) scratch
    and reads rows back; the card's probe writes the LAST row, thread j the
    value j + KB, and reads it back mirrored."""
    for kb in card_perf.SMEM_SIZES_KB:
        n_bytes = kb * 1024
        scratch = np.full((n_bytes // 4 // 128, 128), np.nan, np.float32)
        scratch[-1, :] = np.arange(128, dtype=np.float32) + kb
        got = card_perf.probe_smem(n_bytes, "cpu")
        np.testing.assert_array_equal(got.numpy(), scratch[-1, ::-1])
    assert card_perf.SMEM_SIZES_KB[-2:] == (227, 228)   # the limit, and over
    for bad in (0, 100, 48 * 1024 + 4):
        with pytest.raises(ValueError):
            card_perf.probe_smem(bad, "cpu")


@pytest.mark.parametrize("integer", [True, False])
def test_stream_matches_dynslice_stream(integer):
    """exp/pallas_perf_probe.py:115-127: the sum over rows of 64 dynamic
    (128, 128) blocks of an (8192, 128) table. Exact for integer-valued
    floats, rtol 1e-5 for random ones (another order of float sums)."""
    table, starts = card_perf.make_stream_inputs("cpu", 3, seed=1,
                                                 integer=integer)
    assert table.shape == (8192, 128) and starts.shape == (3, 64)
    assert int(starts.max()) + 128 <= 8192 and (starts % 128 == 0).all()
    tab = table.numpy()
    want = np.zeros((3, 128), np.float32)
    for g in range(3):
        acc = np.zeros((1, 128), np.float32)
        for i in range(64):
            blk = tab[int(starts[g, i]):int(starts[g, i]) + 128, :]
            acc = acc + np.sum(blk, axis=0, keepdims=True)
        want[g] = acc
    launches = card_perf.probe_stream.launches
    got = card_perf.probe_stream(table, starts).numpy()
    assert card_perf.probe_stream.launches == launches
    if integer:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5)
    # unaligned starts: a dynamic slice may begin at any row
    odd = (starts + 5).clamp(max=8192 - 128)
    got = card_perf.probe_stream(table, odd).numpy()
    ref = np.stack([sum(tab[int(s):int(s) + 128].astype(np.float64)
                        for s in odd[g]).sum(axis=0) for g in range(3)])
    np.testing.assert_allclose(got, ref, rtol=1e-5)


@pytest.mark.parametrize("g,n_blocks", [(1, 64), (3, 64), (1, 37),
                                         (10, 37)])
def test_stream_rows_of_starts(g, n_blocks):
    """The TPU's one row of starts (G = 1), a few rows, and a block count
    that the kernel's split does not divide (G = 10: 37 x 128 rows over
    106 CTAs each),
    against the TPU probe's loop restated, with random floats."""
    table, starts = card_perf.make_stream_inputs(
        "cpu", g, seed=g + n_blocks, integer=False, n_blocks=n_blocks)
    assert starts.shape == (g, n_blocks)
    if (g, n_blocks) == (10, 37):   # 4,736 rows over 106 CTAs: ragged
        assert (n_blocks * 128) % card_perf.stream_plan(g, n_blocks)
    tab = table.numpy().astype(np.float64)
    want = np.stack([sum(tab[int(s):int(s) + 128].sum(axis=0)
                         for s in starts[r]) for r in range(g)])
    got = card_perf.probe_stream(table, starts).numpy()
    assert got.shape == (g, 128)
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("g,n_blocks,n_sms", [
    (1, 64, 132), (3, 64, 132), (132, 64, 132), (1, 37, 132), (10, 37, 132),
    (1, 1, 132), (1000, 64, 132), (2, 64, 16)])
def test_stream_plan_covers_every_row_once(g, n_blocks, n_sms):
    """stream_plan's P CTAs per row of starts, cut as the kernel cuts them,
    sum each of the row's n_blocks * 128 virtual rows once; the grid puts
    two CTAs on every SM where the rows allow one per warp, and no CTA has
    fewer rows than warps."""
    parts = card_perf.stream_plan(g, n_blocks, n_sms)
    rows = n_blocks * 128
    seen = np.zeros(rows, np.int32)
    for p in range(parts):
        v0, v1 = _split_range(rows, parts, p)
        seen[v0:v1] += 1
        assert v1 - v0 >= card_perf.STREAM_WARPS
    np.testing.assert_array_equal(seen, 1)
    assert g * parts >= 2 * n_sms or parts == rows // card_perf.STREAM_WARPS


def test_stream_and_gather_bytes():
    assert card_perf.stream_bytes(1) == 64 * (128 * 128 * 4 + 4) + 512
    assert card_perf.stream_bytes(132) == 132 * card_perf.stream_bytes(1)
    assert gather.gather_bytes(1 << 22) == 12 << 22
    # the bound counts each distinct table row once
    starts = torch.tensor([[0, 128, 0], [64, 0, 1024]], dtype=torch.int32)
    assert card_perf.stream_bound_bytes(starts) == \
        (256 + 128) * 512 + 6 * 4 + 2 * 512   # 64..191 lies in 0..255
    table, idx = gather.make_chained_inputs("cpu", 4096)
    assert gather.chained_bytes(table, idx) == 4096 * 128 * 12


def test_wrappers_check_their_tensors():
    """What a kernel does not take raises before any launch."""
    dev = torch.device("cpu")
    x = torch.zeros((4, 16))
    probes.check_tensor("f", "x", x, torch.float32, (4, 16), dev)
    for bad, dtype, shape in ((x, torch.int32, (4, 16)),
                              (x, torch.float32, (4, 8)),
                              (x.t(), torch.float32, (16, 4)),
                              (x.reshape(-1)[1:17].reshape(1, 16),
                               torch.float32, (1, 16))):
        with pytest.raises(ValueError):
            probes.check_tensor("f", "x", bad, dtype, shape, dev)
    with pytest.raises(ValueError):
        probes.check_tensor("f", "x", x, torch.float32, (4, 16),
                            torch.device("meta"))


def test_kernel_build_knows_every_source():
    """Every source of csrc/ is registered by its wrapper module, so the
    build probe compiles it and launches it through its wrapper (on the
    CPU: the plain versions); the probe reads ptxas' summary lines."""
    from opengl_ray_tracing_framework_tpu_torch.utils import nvcc
    assert kernel_build.run_builds is not None   # its import registers all
    assert sorted(nvcc.KERNELS) == sorted(
        p.stem for p in nvcc.CSRC.glob("*.cu"))
    for name, (declare, smoke) in nvcc.KERNELS.items():
        assert callable(declare), name
        launch = smoke(torch.device("cpu"))
        assert torch.isfinite(launch()).all(), name
        assert torch.equal(launch(), launch()), name   # inputs are kept
    log = ("ptxas info    : Used 60 registers, used 1 barriers, 16 bytes "
           "smem, 400 bytes cmem[0]\nptxas info    : Used 12 registers, "
           "380 bytes cmem[0]")
    assert kernel_build._ptxas_summary(log) == "60 regs 16 B smem, 12 regs"
    assert kernel_build._ptxas_summary("") == "no ptxas line"


@pytest.mark.cuda
def test_probe_kernels_on_the_card():
    """Every probe, kernels against plain versions included, as a user
    runs them on a machine with a card (pytest -m cuda)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the probe kernels are CUDA C++ "
                    "and have no interpreted mode")
    launch_overhead.run()
    gather.run()
    largest, refused, _ = card_perf.run()["smem"]
    assert (largest, refused) == (227, 228)
    kernel_build.run_builds()
