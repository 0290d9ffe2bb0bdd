"""The cell glass21m.fwd on the CPU: its configuration is the glass5m
frame with the sphere at 10 subdivisions (20,971,522 triangles, past 2^24
cluster slots in blocks of 256) and the binned SAH build, its cuts are
stated, and at a tiny size its traffic passes run.main against the plain
reference."""

import json

from benchmark import cell as cells, run
from benchmark.tests.tiny import tiny

SEED = "3000024031"


def test_config_is_the_glass5m_frame_at_21m_triangles():
    cell = cells.load("glass21m.fwd")
    config, base = cell.config, cells.load("glass5m.fwd").config
    assert cell.workload["config"] == config["name"] == "glass21m"
    assert cell.workload["traffic"] == "progressive_dense"
    assert cell.workload["limits"] == {"values_off": 0.03, "mean_gap": 0.004}
    sphere = [o for o in config["objects"] if o["mesh"] == "icosphere"]
    assert [o["subdiv"] for o in sphere] == [10]
    triangles = 2 + 20 * 4 ** 10
    assert triangles == 20971522
    # more slots than a float32's value names exactly, in blocks of 256
    assert triangles > 256 * (1 << 16)
    # the exact sweep's build, in bins
    assert config["scene_build"] == dict(base["scene_build"],
                                         bvh_method="sah_binned")
    for key in ("frame", "environment", "camera", "render", "rays_per_tile",
                "materials"):
        assert config[key] == base[key], key
    assert config["reduced"] == ["objects", "environment", "scene_build"]
    for key in config["reduced"]:
        assert config["assumed"][key]
    assert "Lucy" in config["source"] and "28,055,742" in config["source"]


def test_result_line(capsys):
    rc = run.main(["--workload", "glass21m.fwd", "--seed", SEED, "--seconds",
                   "0.5", "--trace", "0"], device="cpu", overrides=tiny)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and line["correct"] is True
    assert set(line["metrics"]) == {"fwd_rays_per_s", "setup_s"}
    assert set(line["check"]) == {"values_off", "mean_gap"}
