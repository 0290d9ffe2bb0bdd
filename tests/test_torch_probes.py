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


@pytest.mark.parametrize("s", [512, 4096])
def test_chained_gather_matches_perf_probe(s):
    """exp/pallas_perf_probe.py:51-64: a lane-replicated (S, 128) table,
    8 dependent lookups acc = (int(tab[acc, j]) + 1) % S, the result as
    float32; the 1-D table gives the same values."""
    table, idx = gather.make_inputs("cpu", s, (s, 128), cols=128, seed=0)
    tab = np.tile(np.arange(s, dtype=np.float32)[:, None], (1, 128))
    np.testing.assert_array_equal(table.numpy(), tab)
    acc = idx.numpy().copy()
    for _ in range(8):
        g = np.take_along_axis(tab, acc, axis=0)
        acc = (g.astype(np.int32) + 1) % s
    got = gather.probe_gather(table, idx, steps=8)
    np.testing.assert_array_equal(got.numpy(), acc.astype(np.float32))
    flat = gather.probe_gather(table[:, 0].contiguous(), idx.reshape(-1),
                               steps=8)
    np.testing.assert_array_equal(flat.numpy().reshape(s, 128), got.numpy())


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


def test_stream_and_gather_bytes():
    assert card_perf.stream_bytes(1) == 64 * (128 * 128 * 4 + 4) + 512
    assert card_perf.stream_bytes(132) == 132 * card_perf.stream_bytes(1)
    assert gather.gather_bytes(1 << 22) == 12 << 22


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
