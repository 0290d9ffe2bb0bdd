"""The control of each cell's comparison: the plain reference computed in
bfloat16 and put in the program's place has to come out as not correct
(at a tiny size here; at the cells' own sizes on the card, see PERF.md)."""

import pytest
import torch

from benchmark import cell as cells, run
from benchmark.tests.tiny import tiny


@pytest.mark.parametrize("workload", ["glass82k.fwd", "glass82k.grad",
                                      "jade5k.fwd"])
def test_control_fails(workload):
    cell = cells.load(workload)
    tiny(cell)
    [got] = run.readings(cell, 0.3, [], [3000000009], torch.device("cpu"))
    assert got["control"]
    assert not run.verdict(got["found"], cell.workload["limits"])
