"""PyTorch port, the command line and checkpoints: cli.py against the JAX
CLI's parser and against the port's own render API, checkpoint / resume
equal to a continuous render, every --tracer, a reference scene read from
OBJ files in a subprocess, and checkpoints that cross between the two
packages."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from opengl_ray_tracing_framework_tpu_torch import (
    Camera, RenderConfig, RenderState, build_test_scene, finalize,
    init_render_state, load_render_state, render, render_passes,
    save_render_state)
from opengl_ray_tracing_framework_tpu_torch import cli
from opengl_ray_tracing_framework_tpu_torch.models import mesh as tmesh
from opengl_ray_tracing_framework_tpu_torch.utils.image import (
    read_png, save_render)

ROOT = Path(__file__).resolve().parents[1]
SIZE, BOUNCES = 32, 2
BASE = ["--device", "cpu", "--width", str(SIZE), "--height", str(SIZE),
        "--max-bounce", str(BOUNCES), "--rays-per-tile", "512"]


def run_cli(capsys, *argv):
    """cli.main in-process -> its JSON result line (run_cli.err keeps what
    it wrote to stderr)."""
    cli.main([*BASE, *argv])
    out, run_cli.err = capsys.readouterr()
    return json.loads(out.strip().splitlines()[-1])


def test_parser_matches_jax():
    """Every option of the JAX CLI, with its default, choices and arity,
    plus --device (default: the card)."""
    from opengl_ray_tracing_framework_tpu.cli import build_parser as jparser

    def options(parser):
        return {a.dest: (a.option_strings, a.default, a.choices, a.nargs)
                for a in parser._actions if a.dest != "help"}

    port, ref = options(cli.build_parser()), options(jparser())
    assert port.pop("device") == (["--device"], "cuda", None, None)
    assert port == ref


def test_cli_equals_render_api(tmp_path, capsys):
    """main writes the PNG that render + save_render give, and its result
    line counts bench.py's rays."""
    out = tmp_path / "cli.png"
    res = run_cli(capsys, "--spp", "2", "--out", str(out),
                  "--progress-every", "1")
    assert res["out"] == str(out) and res["spp"] == 2
    assert "pass 2/2 (2 spp" in run_cli.err
    assert res["seconds"] >= 0 and res["rays_per_sec"] > 0
    _, scene = build_test_scene(device="cpu")
    cam = Camera.make(position=(0.0, 0.5, -2.0), yaw=90.0, pitch=-8.0,
                      zoom=30.0, aspect=1.0, device="cpu")
    ref = tmp_path / "api.png"
    save_render(str(ref), render(
        scene, cam, RenderConfig(width=SIZE, height=SIZE,
                                 max_bounce=BOUNCES),
        spp=2, rays_per_tile=512).numpy())
    assert np.array_equal(read_png(str(out)), read_png(str(ref)))


def test_resume_equals_continuous(tmp_path, capsys):
    """--save-state after 2 spp, --resume adding 1: the accumulator is the
    continuous 3-spp render's, exactly (same frames, same batches)."""
    first, second = tmp_path / "a.npz", tmp_path / "b.npz"
    run_cli(capsys, "--spp", "2", "--out", str(tmp_path / "a.png"),
            "--save-state", str(first))
    res = run_cli(capsys, "--spp", "1", "--out", str(tmp_path / "b.png"),
                  "--resume", str(first), "--save-state", str(second))
    assert res["spp"] == 3
    got = load_render_state(str(second), device="cpu")
    _, scene = build_test_scene(device="cpu")
    cam = Camera.make(position=(0.0, 0.5, -2.0), yaw=90.0, pitch=-8.0,
                      zoom=30.0, aspect=1.0, device="cpu")
    config = RenderConfig(width=SIZE, height=SIZE, max_bounce=BOUNCES)
    want = render_passes(scene, cam, init_render_state(config, "cpu"),
                         config, 3, rays_per_tile=512)
    assert got.n_samples == 3
    assert torch.equal(got.accum, want.accum)


@pytest.mark.parametrize("tracer", ["sweep", "scheduled", "whileloop",
                                    "brute"])
def test_every_tracer_renders(tmp_path, capsys, tracer):
    out = tmp_path / "t.png"
    res = run_cli(capsys, "--spp", "1", "--tracer", tracer, "--width", "16",
                  "--height", "16", "--out", str(out))
    img = read_png(str(out))
    assert res["spp"] == 1 and img.shape == (16, 16, 3) and img.mean() > 0


def test_render_scale_and_preview(tmp_path, capsys):
    """--render-scale folds into the size; --preview-every writes the image
    before the last pass."""
    out = tmp_path / "p.png"
    res = run_cli(capsys, "--render-scale", "0.25", "--spp", "2",
                  "--preview-every", "1", "--out", str(out))
    assert f"preview written to {out} at 1 spp" in run_cli.err
    assert read_png(str(out)).shape == (SIZE // 4, SIZE // 4, 3)
    assert res["spp"] == 2


def test_unknown_scene_exits(capsys):
    with pytest.raises(SystemExit, match="unknown scene object"):
        cli.main(["--device", "cpu", "--scene", "bunny,teapot"])


def test_reference_scene_from_obj_files(tmp_path):
    """`--scene sphere --material brown_glass` as a user runs it, in a
    subprocess with ORTF_ASSETS naming a directory of OBJ files written by
    save_obj (the reference's assets are not in the repository): OBJ
    ingestion, the reference transforms, --env-intensity and the ABSORB
    glass path."""
    (tmp_path / "objects").mkdir()
    tmesh.save_obj(str(tmp_path / "objects" / "floor.obj"), tmesh.make_quad())
    tmesh.save_obj(str(tmp_path / "objects" / "sphere.obj"),
                   tmesh.make_icosphere(2))
    out = tmp_path / "s.png"
    proc = subprocess.run(
        [sys.executable, "-m", "opengl_ray_tracing_framework_tpu_torch.cli",
         *BASE, "--scene", "sphere", "--material", "brown_glass", "--spp",
         "1", "--width", "16", "--height", "16", "--env-intensity", "0.5",
         "--out", str(out)],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env={**os.environ, "ORTF_ASSETS": str(tmp_path)})
    assert proc.returncode == 0, proc.stderr
    assert "scene: 322 triangles" in proc.stderr
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["spp"] == 1 and read_png(str(out)).mean() > 0


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    from opengl_ray_tracing_framework_tpu.render import (
        RenderState as JState)
    from opengl_ray_tracing_framework_tpu.utils import checkpoint as jckpt
    import jax.numpy as jnp
    accum = np.random.default_rng(7).random((8, 16, 3), dtype=np.float32)
    path = str(tmp_path / "jax.npz")
    jckpt.save_render_state(path, JState(accum=jnp.asarray(accum),
                                         n_samples=jnp.int32(5)))
    state = load_render_state(path, device="cpu")
    assert isinstance(state.n_samples, int) and state.n_samples == 5
    assert state.accum.dtype == torch.float32
    assert np.array_equal(state.accum.numpy(), accum)


def test_port_checkpoint_resumes_in_jax(tmp_path):
    from opengl_ray_tracing_framework_tpu.utils import checkpoint as jckpt
    import jax.numpy as jnp
    accum = np.random.default_rng(8).random((8, 16, 3), dtype=np.float32)
    path = str(tmp_path / "port.npz")
    save_render_state(path, RenderState(accum=torch.tensor(accum),
                                        n_samples=4))
    with np.load(path) as z:
        assert z["accum"].dtype == np.float32 and z["accum"].shape == (8, 16, 3)
        assert z["n_samples"].dtype == np.int32 and z["n_samples"].shape == ()
    state = jckpt.load_render_state(path)
    assert state.n_samples.dtype == jnp.int32 and int(state.n_samples) == 4
    assert np.array_equal(np.asarray(state.accum), accum)
    assert np.array_equal(load_render_state(path, "cpu").accum.numpy(),
                          accum)


def test_finalized_checkpoint_is_the_image(tmp_path, capsys):
    """The checkpoint of a run finalizes to the PNG the run wrote."""
    out, ckpt = tmp_path / "f.png", tmp_path / "f.npz"
    run_cli(capsys, "--spp", "1", "--width", "16", "--height", "16",
            "--out", str(out), "--save-state", str(ckpt))
    again = tmp_path / "g.png"
    save_render(str(again), finalize(
        load_render_state(str(ckpt), "cpu"),
        RenderConfig(width=16, height=16)).numpy())
    assert np.array_equal(read_png(str(out)), read_png(str(again)))


def test_live_edit_loop(tmp_path, capsys):
    """examples/live_edit.py: the edited frame is a fresh render of the
    scene with the sphere's slot set to `golden`, and differs from the
    first frame."""
    from opengl_ray_tracing_framework_tpu_torch.examples import live_edit
    from opengl_ray_tracing_framework_tpu_torch.models.material import (
        preset_materials)
    from opengl_ray_tracing_framework_tpu_torch.render import render_radiance
    out = live_edit.main(["--device", "cpu", "--size", "16", "--spp", "1",
                          "--max-bounce", "2", "--out-dir", str(tmp_path)])
    assert (tmp_path / "live_edit_before.png").exists()
    assert (tmp_path / "live_edit_after.png").exists()
    assert "after: 1 spp" in capsys.readouterr().out
    _, scene = build_test_scene(2, material=preset_materials()["golden"],
                                device="cpu")
    want = render_radiance(scene, Camera.make(
        position=(0.0, 0.5, -2.0), yaw=90.0, pitch=-8.0, zoom=30.0,
        aspect=1.0, device="cpu"), RenderConfig(width=16, height=16,
                                                max_bounce=2), spp=1,
        rays_per_tile=256)
    assert torch.equal(out["after"], want)
    assert not torch.equal(out["before"], out["after"])


def distributed_cli_rank(argv):
    """One rank of `cli --distributed` (spawned): its stdout."""
    import contextlib
    import io
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(argv)
    return out.getvalue()


def test_distributed_cli_equals_one_process(tmp_path, capsys):
    """`--distributed` on a gloo group of 2 CPU ranks: each renders 16 of
    the 32 rows; rank 0 alone writes the result line, the image and a
    checkpoint equal to one process's."""
    from opengl_ray_tracing_framework_tpu_torch.parallel import sharding
    argv = [*BASE, "--spp", "2", "--distributed", "--out",
            str(tmp_path / "d.png"), "--save-state", str(tmp_path / "d.npz")]
    outs = sharding.spawn_ranks(distributed_cli_rank, 2, argv,
                                device="cpu", timeout_s=120.0)
    assert outs[1] == "" and json.loads(outs[0])["spp"] == 2
    run_cli(capsys, "--spp", "2", "--out", str(tmp_path / "s.png"),
            "--save-state", str(tmp_path / "s.npz"))
    got = load_render_state(str(tmp_path / "d.npz"), "cpu")
    want = load_render_state(str(tmp_path / "s.npz"), "cpu")
    assert got.n_samples == want.n_samples == 2
    torch.testing.assert_close(got.accum, want.accum, rtol=2e-5, atol=1e-6)
    assert np.abs(read_png(str(tmp_path / "d.png")).astype(int)
                  - read_png(str(tmp_path / "s.png"))).max() <= 1
