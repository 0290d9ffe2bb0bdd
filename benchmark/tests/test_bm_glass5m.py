"""The cells glass5m.fwd and jade5k.grad on the CPU at a tiny size: each
passes run.main and fails under the bfloat16 control; the reader of
k1a_device_ms.fwd reads the preparation kernels' device time a pass, and
nothing where the trace's device_ops lists none of them; the reference's
BlockCaster loads nothing of the program or of JAX."""

import json

import pytest
import torch

from benchmark import cell as cells, run
from benchmark.tests.tiny import tiny

SEED = "3000000031"


@pytest.mark.parametrize("workload,metrics", [
    ("glass5m.fwd", {"fwd_rays_per_s", "setup_s"}),
    ("jade5k.grad", {"grad_rays_per_s", "setup_s"}),
])
def test_result_line(capsys, workload, metrics):
    rc = run.main(["--workload", workload, "--seed", SEED, "--seconds",
                   "0.5", "--trace", "0"], device="cpu", overrides=tiny)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and line["correct"] is True
    assert set(line["metrics"]) == metrics
    assert set(line["check"]) == set(cells.load(workload).workload["limits"])


@pytest.mark.parametrize("workload", ["glass5m.fwd", "jade5k.grad"])
def test_control_fails(workload):
    cell = cells.load(workload)
    tiny(cell)
    [got] = run.readings(cell, 0.3, [], [3000000039], torch.device("cpu"))
    assert got["control"]
    assert not run.verdict(got["found"], cell.workload["limits"])


def test_k1a_reader():
    read = {m.name: m for m in cells.metrics()}["k1a_device_ms.fwd"].read
    ops = [["void_at::native::index_elementwise_kernel", 0.5],
           ["_anonymous_namespace_::sweep_runs_kernel_float_const", 0.25],
           ["_anonymous_namespace_::sweep_key_kernel_float_const", 0.125],
           ["_anonymous_namespace_::sweep_spans_kernel_float_const", 0.0625]]
    run_ = {"kind": "fwd", "trace": {"requests": 3, "device_ops": ops}}
    assert read(run_) == pytest.approx(1e3 * 0.4375 / 3)
    for partial in (ops[:1], ops[:2], ops[:1] + ops[2:3]):
        run_["trace"]["device_ops"] = partial     # never a partial sum
        assert read(run_) is None
    run_["trace"]["device_ops"] = ops[2:]
    assert read(run_) == pytest.approx(1e3 * 0.1875 / 3)
    assert read({"kind": "fwd", "trace": None}) is None
    assert read({"kind": "grad", "trace": {"requests": 1,
                                           "device_ops": ops}}) is None


def test_block_caster_loads_nothing_of_the_program():
    from benchmark.tests.test_bm_imports import JAX, PORT, _top_level
    mods = _top_level("import benchmark.reference.cast_blocks, "
                      "benchmark.reference.render")
    assert PORT not in mods and not mods & JAX


def _per_node_build(p1, p2, p3, leaf_size=1, method="sah"):
    """A stand-in for a build of a Python call a node."""
    def node(lo, hi):
        if hi - lo > leaf_size:
            mid = (lo + hi) // 2
            node(lo, mid)
            node(mid, hi)
    node(0, p1.shape[0])


def test_dense_traffic_refuses_a_build_of_a_call_a_node():
    from types import SimpleNamespace

    from benchmark import program
    dense = cells.load("glass5m.fwd").entry
    assert 4 * dense.build_calls(program.port("models.bvh")) \
        < dense.PROBE_TRIANGLES
    per_node = SimpleNamespace(__file__=__file__, build_bvh=_per_node_build)
    with pytest.raises(SystemExit, match="one a node"):
        dense.require_level_build(per_node)
