"""The harness on the CPU at a tiny size: its result line, its refusal
without a card, cells found by name, and `correct` failing under faults
planted beneath the timed path."""

import json
import shutil
from pathlib import Path

import pytest
import torch

from benchmark import cell as cells, run
from benchmark.program import port
from benchmark.tests.tiny import tiny

REPO = Path(__file__).resolve().parents[2]
SEED = "3000000007"


def _run(capsys, workload, trace="0", overrides=tiny):
    rc = run.main(["--workload", workload, "--seed", SEED, "--seconds",
                   "0.5", "--trace", trace], device="cpu",
                  overrides=overrides)
    out = capsys.readouterr().out.strip().splitlines()
    return rc, json.loads(out[-1])


@pytest.mark.parametrize("workload,metrics", [
    ("glass82k.fwd", {"fwd_rays_per_s", "setup_s"}),
    ("glass82k.grad", {"grad_rays_per_s", "setup_s"}),
    ("jade5k.fwd", {"fwd_rays_per_s", "setup_s"}),
])
def test_result_line(capsys, workload, metrics):
    rc, line = _run(capsys, workload)
    assert rc == 0
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "check"]
    assert line["correct"] is True and line["attempted"] >= 1
    assert set(line["metrics"]) == metrics
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    limits = cells.load(workload).workload["limits"]
    assert set(line["check"]) == set(limits)


def test_no_card_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "glass82k.fwd", "--seed", SEED,
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_found_by_name(capsys, monkeypatch, tmp_path):
    """A new configuration, kind of request, traffic mix, cell and metric
    are new files: the harness runs the cell, checks it with the new
    kind's own comparison and reports the metric, with no file edited."""
    root = tmp_path / "bm"
    for kind in ("configs", "traffic", "workloads", "metrics"):
        shutil.copytree(cells.ROOT / kind, root / kind)
    config = json.loads((root / "configs" / "jade5k.json").read_text())
    config["name"] = "jade5k_copper"
    config["materials"]["jade"]["metallic"] = 1.0
    (root / "configs" / "jade5k_copper.json").write_text(json.dumps(config))
    # a kind of request of its own: passes of a render started afresh
    source = (root / "traffic" / "render_pass.py").read_text()
    fresh = source.replace(
        "accum=torch.rand((h, w, 3), generator=gen, device=device)",
        "accum=torch.zeros((h, w, 3), device=device)").replace(
        'start_index=int(rng.integers(0, traffic["start_index_max"]))',
        "start_index=0")
    assert fresh.count("zeros((h, w, 3)") == 1
    (root / "traffic" / "fresh_pass.py").write_text(fresh)
    traffic = json.loads((root / "traffic" / "progressive.json").read_text())
    traffic["entry"] = "fresh_pass"
    (root / "traffic" / "fresh.json").write_text(json.dumps(traffic))
    (root / "workloads" / "jade5k_copper.fresh.json").write_text(json.dumps(
        {"config": "jade5k_copper", "traffic": "fresh", "chips": 1,
         "why": "a test cell", "limits": {"values_off": 0.05,
                                          "mean_gap": 0.01}}))
    (root / "metrics" / "requests_done.py").write_text(
        'UNIT, BETTER, KIND = "requests", "higher", "end_to_end"\n\n\n'
        'def read(run):\n    return float(run["requests"])\n')
    before = {p: p.read_bytes() for p in cells.ROOT.rglob("*")
              if p.is_file() and "__pycache__" not in p.parts}
    monkeypatch.setattr(cells, "ROOT", root)
    cell = cells.load("jade5k_copper.fresh")
    assert cell.entry.__file__ == str(root / "traffic" / "fresh_pass.py")
    rc, line = _run(capsys, "jade5k_copper.fresh")
    assert rc == 0 and line["correct"] is True
    assert set(line["metrics"]) >= {"fwd_rays_per_s", "setup_s"}
    assert line["metrics"]["requests_done"]["value"] == line["attempted"]
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_benchmark_json_matches_the_files():
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    assert spec["paths"] == ["benchmark"]
    for w in spec["workloads"]:
        cell = cells.load(w["name"])
        assert {k: cell.workload[k] for k in ("config", "traffic", "chips",
                                              "why")} == \
            {k: w[k] for k in ("config", "traffic", "chips", "why")}
    readers = {m.name: m for m in cells.metrics()}
    for m in spec["end_to_end"] + spec["per_layer"]:
        r = readers[m["name"]]
        assert (r.unit, r.better) == (m["unit"], m["better"])
        assert r.kind == ("per_layer" if m in spec["per_layer"]
                          else "end_to_end")
    assert set(readers) == {m["name"] for m in spec["end_to_end"]
                            + spec["per_layer"]}
    for c in spec["configs"]:
        config = json.loads((REPO / c["file"]).read_text())
        assert (config["name"], config["source"], config["reduced"]) == \
            (c["name"], c["source"], c["reduced"])


# Faults beneath the timed path: each has to make `correct` false.

def _unchanged(real):
    return lambda scene, camera, state, config, tile: state


def _half_left_out(real):
    def render_pass(scene, camera, state, config, tile):
        new = real(scene, camera, state, config, tile)
        keep = torch.zeros_like(state.accum, dtype=torch.bool)
        keep[:, ::2] = True   # every other column's samples are dropped
        return type(new)(torch.where(keep, state.accum, new.accum),
                         new.n_samples)
    return render_pass


def _altered(real):
    def render_pass(scene, camera, state, config, tile):
        new = real(scene, camera, state, config, tile)
        return type(new)(new.accum + 0.05 * (new.accum - state.accum),
                         new.n_samples)
    return render_pass


@pytest.mark.parametrize("fault", [_unchanged, _half_left_out, _altered])
def test_fwd_fault_fails(capsys, monkeypatch, fault):
    render = port("render")
    monkeypatch.setattr(render, "render_pass", fault(render.render_pass))
    rc, line = _run(capsys, "glass82k.fwd")
    assert rc == 0 and line["correct"] is False


def _grad_unchanged(real):
    def material_grad(scene, camera, target, config, spp, rays_per_tile):
        loss, grads = real(scene, camera, target, config, spp=spp,
                           rays_per_tile=rays_per_tile)
        zero = [None if g is None else torch.zeros_like(g)
                for g in grads.mat]
        return loss, type(grads)(mat=type(grads.mat)(*zero))
    return material_grad


def _grad_half(real):
    autodiff = port("parallel.autodiff")

    def material_grad(scene, camera, target, config, spp, rays_per_tile):
        half = config.height // 2   # the lower half left out, the rest x2
        loss, grads = autodiff.param_grad(
            scene, camera, target[:half], config, "material", spp,
            rays_per_tile, 0, half)
        return 2 * loss, type(grads)(mat=type(grads.mat)(*(
            None if g is None else 2 * g for g in grads.mat)))
    return material_grad


def _grad_altered(real):
    def material_grad(scene, camera, target, config, spp, rays_per_tile):
        loss, grads = real(scene, camera, target, config, spp=spp,
                           rays_per_tile=rays_per_tile)
        mat = grads.mat._replace(base_color=grads.mat.base_color * 1.05)
        return loss, type(grads)(mat=mat)
    return material_grad


@pytest.mark.parametrize("fault", [_grad_unchanged, _grad_half,
                                   _grad_altered])
def test_grad_fault_fails(capsys, monkeypatch, fault):
    autodiff = port("parallel.autodiff")
    monkeypatch.setattr(autodiff, "material_grad",
                        fault(autodiff.material_grad))
    rc, line = _run(capsys, "glass82k.grad")
    assert rc == 0 and line["correct"] is False
