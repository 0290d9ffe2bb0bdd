"""Cells, configurations, traffic mixes and metrics, found by name.

  workloads/<cell>.json    config, traffic, chips, why, limits
  configs/<config>.json    the scene, frame, settings, source, reduced
  traffic/<traffic>.json   the parameters of one traffic mix; its `entry`
                           names the kind of request it sends
  traffic/<entry>.py       one kind of request: KIND (the suffix of the
                           metrics its runs report, "fwd" or "grad"),
                           draw(traffic, config, seed, device), the
                           Requests(setup, draws) the window drives,
                           numbers(setup, draws, outputs, seed) against
                           the reference, and control(setup, draws,
                           outputs), the outputs of the reference in
                           bfloat16 put in the program's place
  metrics/<metric>.py      one metric's reader: UNIT, BETTER, KIND
                           ("end_to_end" or "per_layer") and read(run),
                           which returns the number, or None where the
                           run has nothing it reads

A new cell, configuration, traffic mix, kind of request or metric is a
new file; nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def _json(kind: str, name: str) -> dict:
    path = ROOT / kind / f"{name}.json"
    if not path.is_file():
        known = sorted(p.stem for p in (ROOT / kind).glob("*.json"))
        raise SystemExit(f"no {kind[:-1]} named {name!r} (known: {known})")
    return json.loads(path.read_text())


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    entry: object   # the module of its traffic's kind of request


def _module(kind: str, name: str):
    path = ROOT / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod   # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


def load(name: str) -> Cell:
    workload = _json("workloads", name)
    traffic = _json("traffic", workload["traffic"])
    return Cell(name=name, workload=workload,
                config=_json("configs", workload["config"]),
                traffic=traffic, entry=_module("traffic", traffic["entry"]))


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    better: str
    kind: str
    read: object


def metrics() -> list:
    """Every reader under metrics/, by file name."""
    out = []
    for path in sorted((ROOT / "metrics").glob("*.py")):
        mod = _module("metrics", path.stem)
        out.append(Metric(path.stem, mod.UNIT, mod.BETTER, mod.KIND,
                          mod.read))
    return out
