"""spans.py's reduction by the port's rt.* ranges on hand-made events, and
its silence where the events hold none (a port without the spans)."""

import pytest
import torch

from benchmark import spans, trace
from benchmark.tests.test_bm_metrics import CPU, CUDA, Ev


def _events(with_spans=True):
    """One request of 1,000 ns: a cast whose K1 launch the benchmark
    accounts for inside rt.cast.k1, a bounce whose BSDF launches one
    kernel, a sync; the device busy [200, 300) and [550, 700)."""
    rt = [
        Ev("rt.pass", CPU, 10, 980), Ev("rt.batch", CPU, 20, 960),
        Ev("rt.cast", CPU, 100, 200), Ev("rt.cast.k1", CPU, 140, 150),
        Ev("rt.bounce", CPU, 400, 400), Ev("rt.shade.bsdf", CPU, 450, 150),
        Ev("rt.sync", CPU, 910, 40),
        Ev("rt.cast", CUDA, 100, 200),   # the profiler's device annotation
    ]
    return (rt if with_spans else []) + [
        Ev("bm.request", CPU, 0, 1000),
        Ev("cudaLaunchKernelExC", CPU, 150, 10, corr=31),
        Ev("bm.account", CPU, 260, 20),
        Ev("cudaLaunchKernel", CPU, 266, 2, corr=32),
        Ev("cudaLaunchKernel", CPU, 500, 2, corr=33),
        Ev("void sweep_kernel<1>(float*)", CUDA, 200, 100, corr=31),
        Ev("sum_kernel", CUDA, 300, 50, corr=32),
        Ev("elementwise_kernel", CUDA, 550, 150, corr=33),
    ]


COUNTERS = {"casts": 1, "cast_lanes": 256, "cast_live_rays": 192,
            "k1_spans_walked": 6, "bounces": 1, "bounce_lanes": 100,
            "syncs": 1}


def _needed(n):
    k1 = trace.K1Count()
    k1.launches.append((torch.tensor(n), torch.tensor(1), 8, 128, 1))
    return k1


def test_reduce_spans_by_innermost_range():
    got = spans.reduce_spans(_events(), 1, COUNTERS, _needed(4), "fwd")
    ms = 1e-6
    want = {"rt.pass": [960, 20], "rt.batch": [940, 320],
            "rt.cast": [180, 50], "rt.cast.k1": [130, 130],
            "rt.bounce": [400, 250], "rt.shade.bsdf": [150, 150],
            "rt.sync": [40, 40]}
    assert got["host_by_span"] == {
        n: [pytest.approx(a * ms), pytest.approx(b * ms)]
        for n, (a, b) in want.items()}
    # the accounting kernel counts nowhere
    assert got["launches_by_span"] == {"rt.cast.k1": 1, "rt.shade.bsdf": 1}
    # gaps [0,200) in the cast, [300,550) in the bounce, [700,1000) with
    # rt.batch innermost at its midpoint
    assert got["idle_by_span"] == {"rt.cast": pytest.approx(2e-7),
                                   "rt.bounce": pytest.approx(2.5e-7),
                                   "rt.batch": pytest.approx(3e-7)}
    assert got["idle_in_requests_s"] == pytest.approx(7.5e-7)
    assert got["idle_explained_share"] == pytest.approx(0.6)
    assert got["counters"] == COUNTERS
    assert got["readings"] == {
        "cast_host_ms.fwd": pytest.approx(180 * ms),
        "shade_host_ms.fwd": pytest.approx(400 * ms),
        "sync_wait_ms.fwd": pytest.approx(40 * ms),
        "cast_live_pct.fwd": 75.0,
        "k1_walk_excess.fwd": 1.5,
    }


def test_per_request_and_grad_readings():
    got = spans.reduce_spans(_events(), 2, COUNTERS, None, "grad")
    assert got["host_by_span"]["rt.cast"][0] == pytest.approx(90e-6)
    assert got["launches_by_span"]["rt.shade.bsdf"] == 0.5
    assert got["readings"] == {"bwd_host_ms.grad": None}   # no rt.backward
    got = spans.reduce_spans(_events(), 1, {}, None, "fwd")
    assert got["readings"]["cast_live_pct.fwd"] is None
    assert got["readings"]["k1_walk_excess.fwd"] is None


def test_silent_without_the_ports_spans():
    """The parent's port has no rt.* range: nothing to reduce."""
    assert spans.reduce_spans(_events(False), 1, COUNTERS, _needed(4),
                              "fwd") is None
