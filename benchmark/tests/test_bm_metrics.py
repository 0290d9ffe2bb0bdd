"""The benchmark's arithmetic on hand-made intervals, counts and events."""

import pytest
import torch

from benchmark import arith, cell as cells, trace

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Ev:
    """The fields of a profiler event that trace.reduce_events reads."""

    def __init__(self, name, dev, start, dur, corr=0, linked=0):
        self._v = (name, dev, start, dur, corr, linked)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return False


def test_union_and_runs():
    assert arith.union_length([], []) == 0.0
    assert arith.union_length([0, 1, 5, 6], [2, 3, 7, 6.5]) == 5.0
    s, e = arith.busy_runs([5, 0, 1], [7, 2, 3])
    assert s.tolist() == [0, 5] and e.tolist() == [3, 7]
    # nested and touching intervals
    assert arith.union_length([0, 1, 4], [10, 2, 10]) == 10.0


def test_ray_accounting():
    assert arith.rays_per_pass(1024, 512, 1, 8) == 8_912_896
    assert arith.rays_per_pass(512, 512, 1, 4) == 2_359_296


def test_span_bound_picks_the_larger():
    # one span of an 8-triangle cluster: its bytes outweigh 128 * 8 * 80
    # operations; a thousand spans of 256 triangles do not
    bound, by = arith.span_bound(1, 1, 8, 128, 0)
    bytes_s = (41 * 8 * 4 + 128 * 32 * 4) / 3.35e12
    assert by == "bytes" and bound == pytest.approx(bytes_s)
    ops_s = 128 * 256 * 80 / 67e12
    bound, by = arith.span_bound(1000, 1, 256, 128, 0)
    assert by == "operations" and bound == pytest.approx(1000 * ops_s)


def _events():
    """Two requests: the first launches a cast kernel, a shading kernel and
    an accounting kernel; the second a backward kernel; times in ns. Each
    device operation shares its correlation id with its runtime call."""
    return [
        Ev("bm.request", CPU, 0, 1000, corr=1),
        Ev("bm.cast", CPU, 100, 200, corr=2),
        Ev("cudaLaunchKernelExC", CPU, 150, 10, corr=31),
        Ev("bm.account", CPU, 260, 20, corr=4),
        Ev("aten::sum", CPU, 265, 5, corr=5),
        Ev("cudaLaunchKernel", CPU, 266, 2, corr=32, linked=5),
        Ev("aten::mul", CPU, 500, 10, corr=6),
        Ev("cudaLaunchKernel", CPU, 501, 2, corr=33, linked=6),
        Ev("cudaMemcpyAsync", CPU, 505, 2, corr=34, linked=6),
        Ev("bm.request", CPU, 1000, 1000, corr=7),
        Ev("bm.backward", CPU, 1100, 500, corr=8),
        Ev("cudaLaunchKernel", CPU, 1200, 10, corr=35, linked=9),
        Ev("void sweep_kernel<1>(float*)", CUDA, 200, 100, corr=31),
        Ev("sum_kernel", CUDA, 300, 50, corr=32, linked=5),
        Ev("elementwise_kernel", CUDA, 550, 150, corr=33, linked=6),
        Ev("Memcpy DtoH (Device -> Pinned)", CUDA, 700, 100, corr=34,
           linked=6),
        Ev("mul_backward_kernel", CUDA, 1300, 200, corr=35, linked=9),
    ]


def test_reduce_events_by_layer():
    k1 = trace.K1Count()
    got = trace.reduce_events(_events(), 2, 2e-6, k1)
    assert got["kernels"] == 3            # memcpy and accounting left out
    assert got["cast_kernels"] == 1 and got["cast_s"] == pytest.approx(1e-7)
    assert got["k1_launches"] == 1 and got["k1_s"] == pytest.approx(1e-7)
    assert got["backward_kernels"] == 1
    assert got["backward_s"] == pytest.approx(2e-7)
    # shading: the elementwise kernel and the memcpy, outside the casts
    assert got["shade_s"] == pytest.approx(2.5e-7)
    # busy: [200,300) [550,800) [1300,1500): the accounting kernel is not
    assert got["busy_s"] == pytest.approx(5.5e-7)
    assert got["account_s"] == pytest.approx(2e-8)
    assert got["window_s"] == pytest.approx(2e-6 - 2e-8)
    # idle: [0,200) in the cast, [300,550) [800,1300) [1500,2000) in the
    # requests outside any cast or backward
    gaps = sorted((round(s * 1e9), name) for name, s in got["idle_gaps"])
    assert gaps == [(200, "cast"), (250, "shading and host"),
                    (500, "shading and host"), (500, "shading and host")]
    assert got["device_ops"][0][0] == "mul_backward_kernel"


def test_readers_over_a_window():
    readers = {m.name: m for m in cells.metrics()}
    run = {"kind": "fwd", "requests": 30, "window_s": 27.5,
           "rays_per_request": 8_912_896, "setup_s": 20.0,
           "peak_bytes": 3 * 2**29, "trace": None}
    rate = readers["fwd_rays_per_s"].read(run)
    assert rate == pytest.approx(30 * 8_912_896 / 27.5)
    assert readers["grad_rays_per_s"].read(run) is None
    assert readers["setup_s"].read(run) == 20.0
    tr = trace.reduce_events(_events(), 2, 2e-6, None)
    tr["k1_bound_s"] = 2.5e-8
    traced = dict(run, trace=tr, requests=2)
    assert readers["setup_s"].read(traced) is None
    assert readers["k1_roofline.fwd"].read(traced) == pytest.approx(25.0)
    # the window leaves out the 20 ns of the benchmark's own accounting
    assert readers["device_idle_pct.fwd"].read(traced) == \
        pytest.approx(100 * (1 - 5.5e-7 / (2e-6 - 2e-8)))
    assert readers["launches_per_pass.fwd"].read(traced) == 1.5
    assert readers["peak_gib.fwd"].read(traced) == 1.5
    assert readers["launches_per_step.grad"].read(traced) is None


def test_roofline_reader_is_silent_without_k1():
    readers = {m.name: m for m in cells.metrics()}
    tr = trace.reduce_events(_events()[:-5] + _events()[-4:], 2, 2e-6, None)
    run = {"kind": "fwd", "requests": 2, "trace": tr}
    assert tr["k1_launches"] == 0
    assert readers["k1_roofline.fwd"].read(run) is None


def test_k1_count_lower_bound():
    """Two tiles of 128 rays: tile 0 has 3 spans and its final threshold
    lies between the second and third entry distance; tile 1 has none."""
    k1 = trace.K1Count()
    nspan = torch.tensor([3, 0], dtype=torch.int32)
    spans = torch.tensor([[4, 1, 2], [0, 0, 0]], dtype=torch.int32)
    tile_sorted = torch.tensor([[0.0, 1.0, 5.0], [0.0, 0.0, 0.0]])
    best = torch.zeros((256, 8))
    best[:, 0] = 3.0        # every ray's best t
    best[:, 3] = 114514.0   # no cap
    best[:, 1] = 7.0        # a hit
    trifeat = torch.zeros((5, 16, 4 * 8))
    k1.add(nspan, spans, tile_sorted, best, trifeat)
    visits, clusters, t_blk, n_rays, g = k1.launches[0]
    assert int(visits) == 2 and int(clusters) == 2
    assert (t_blk, n_rays, g) == (8, 256, 2)
    assert k1.bound_s() == pytest.approx(
        arith.span_bound(2, 2, 8, 256, 2 * 4 + 2 * 2 * 4)[0])
