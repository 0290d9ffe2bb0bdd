"""Headless command-line renderer (PyTorch port of
opengl_ray_tracing_framework_tpu.cli).

The batch-mode replacement for the reference's interactive app
(src/sources/main.cpp): scene presets, progressive sampling, tone mapping
toggles and PNG export (the `Save Image` button, main.cpp:475-477). Live
parameter editing becomes flags; each invocation renders from a fresh
state unless it resumes a checkpoint. The flags and defaults are the JAX
CLI's, plus --device (default: the card).

    python -m opengl_ray_tracing_framework_tpu_torch.cli \\
        --scene loong --spp 256 --out loong.png
    torchrun --nproc_per_node 4 -m opengl_ray_tracing_framework_tpu_torch.cli \\
        --distributed --scene loong --spp 256 --out loong.png

With --distributed every rank traces a block of rows
(parallel/sharding.py) and rank 0 writes the image, the checkpoint and the
result line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

# --tracer -> RenderConfig fields
_TRACERS = {
    "sweep": dict(cast_backend="sweep"),
    "scheduled": dict(cast_backend="schedule"),
    "whileloop": dict(cast_backend="bvh"),
    "brute": dict(use_bvh=False),
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="path tracer (PyTorch + CUDA)")
    p.add_argument("--scene", default="test",
                   help="test | bunny | loong | sphere | comma list of "
                        "reference objects. The reference's Scene.h also "
                        "lists 'panther', whose asset "
                        "(panther_100000.obj) the reference does not ship: "
                        "requesting it fails with a clear error; use "
                        "--scene loong --material brown_glass for the same "
                        "physics (ABSORB medium + refraction)")
    p.add_argument("--material", default="tear_glass",
                   help="preset for the focus object (Scene.h:53-109)")
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--render-scale", type=float, default=1.0,
                   help="resolution multiplier on width/height "
                        "(RENDER_SCALE, RenderSettings.h:11)")
    p.add_argument("--spp", type=int, default=64,
                   help="samples per pixel (maxIterations analogue)")
    p.add_argument("--spp-per-pass", type=int, default=1)
    p.add_argument("--max-bounce", type=int, default=8)
    p.add_argument("--no-env", action="store_true")
    p.add_argument("--no-mis", action="store_true")
    p.add_argument("--brdf", action="store_true",
                   help="legacy BRDF mode (enableBSDF=false)")
    p.add_argument("--no-tonemap", action="store_true")
    p.add_argument("--no-gamma", action="store_true")
    p.add_argument("--env-intensity", type=float, default=1.0)
    p.add_argument("--env-angle", type=float, default=0.0)
    p.add_argument("--camera", type=float, nargs=5,
                   metavar=("X", "Y", "Z", "YAW", "PITCH"),
                   default=[0.0, 0.0, 7.0, -87.78, -14.0])
    p.add_argument("--zoom", type=float, default=30.0)
    p.add_argument("--out", default="render.png")
    p.add_argument("--save-state", default=None,
                   help="write the accumulator checkpoint (npz)")
    p.add_argument("--resume", default=None,
                   help="resume from an accumulator checkpoint (either "
                        "package's); --spp more samples are added")
    p.add_argument("--rays-per-tile", type=int, default=131072)
    p.add_argument("--progress-every", type=int, default=0,
                   help="print a progress line every N passes")
    p.add_argument("--preview-every", type=int, default=0,
                   help="write the current image to --out every N passes "
                        "(the live-preview analogue of the ImGui loop)")
    p.add_argument("--tracer", default="sweep",
                   choices=("sweep", "scheduled", "whileloop", "brute"),
                   help="closest-hit backend: sweep (the span-sweep "
                        "kernel), scheduled (the vote tracer and its "
                        "cluster-intersect kernel), whileloop (batched BVH "
                        "traversal), brute (every triangle)")
    p.add_argument("--timing", action="store_true",
                   help="print the host ms a pass of each span of the "
                        "program (rt.pass, rt.batch, rt.cast, rt.bounce, "
                        "rt.shade.*, rt.sync ...; total and self) over 3 "
                        "traced passes, the pass's wall ms and, on the "
                        "card, its device ms, before rendering: the FPS/ms "
                        "readout analogue (main.cpp:366-372)")
    p.add_argument("--distributed", action="store_true",
                   help="join the torch.distributed group that torchrun's "
                        "environment names and split the rows over its "
                        "ranks")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (cuda, cpu)")
    return p


def _fence(state) -> None:
    float(state.accum.reshape(-1)[0])   # a host copy: the pass has finished


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.render_scale != 1.0:
        # main.cpp:84,107: the render target is width*RENDER_SCALE x
        # height*RENDER_SCALE; folded in here so every later use (aspect,
        # ray accounting, RenderConfig) sees the final size
        args.width = max(1, int(round(args.width * args.render_scale)))
        args.height = max(1, int(round(args.height * args.render_scale)))

    import torch

    from . import RenderConfig
    from .models.camera import Camera
    from .models.scene import build_reference_scene, build_test_scene
    from .render import (
        RenderState, finalize, init_render_state, render_pass)
    from .utils import checkpoint as ckpt
    from .utils.image import save_render

    device = torch.device(args.device)
    mesh = None
    if args.distributed:
        from .parallel import sharding
        sharding.init_distributed(device=device)
        mesh = sharding.make_mesh()
    lead = mesh is None or mesh.rank == 0

    def say(msg):
        if lead:
            print(msg, file=sys.stderr)

    t0 = time.time()
    if args.scene == "test":
        _, scene = build_test_scene(device=device)
        cam = Camera.make(position=(0.0, 0.5, -2.0), yaw=90.0, pitch=-8.0,
                          zoom=args.zoom, aspect=args.width / args.height,
                          device=device)
    else:
        from .models.scene import _OBJ_FILES
        requested = [s for s in args.scene.split(",") if s]
        unknown = [s for s in requested if s not in _OBJ_FILES]
        if unknown:
            sys.exit(f"error: unknown scene object(s) {unknown}; choose from "
                     f"test, {', '.join(_OBJ_FILES)}")
        objects = tuple(
            ["floor"] + [s for s in requested if s != "floor"])
        _, scene = build_reference_scene(
            objects=objects, current_material=args.material, device=device)
        scene = dataclasses.replace(
            scene,
            env_intensity=torch.tensor(args.env_intensity,
                                       dtype=torch.float32, device=device),
            env_angle=torch.tensor(args.env_angle, dtype=torch.float32,
                                   device=device))
        x, y, z, yaw, pitch = args.camera
        cam = Camera.make(position=(x, y, z), yaw=yaw, pitch=pitch,
                          zoom=args.zoom, aspect=args.width / args.height,
                          device=device)
    if mesh is not None:
        scene = sharding.replicate_scene(scene, mesh)
    say(f"scene: {scene.n_triangles} triangles, {scene.n_nodes} BVH nodes "
        f"({time.time() - t0:.1f}s)")

    config = RenderConfig(
        width=args.width, height=args.height, max_bounce=args.max_bounce,
        spp_per_pass=args.spp_per_pass,
        enable_env_map=not args.no_env,
        enable_mis=not args.no_mis,
        enable_bsdf=not args.brdf,
        enable_tone_mapping=not args.no_tonemap,
        enable_gamma_correction=not args.no_gamma,
        **_TRACERS[args.tracer],
    ).validate()

    if args.timing and lead:
        from .utils.timing import format_breakdown, pass_breakdown
        times = pass_breakdown(scene, cam, config,
                               rays_per_tile=args.rays_per_tile)
        say(format_breakdown(times))

    state = init_render_state(config, device)
    if args.resume:
        state = ckpt.load_render_state(args.resume, device)
        say(f"resumed at {state.n_samples} spp")
    start_spp = state.n_samples

    if mesh is None:
        def step(state):
            return render_pass(scene, cam, state, config,
                               rays_per_tile=args.rays_per_tile)

        def whole(state):
            return state
    else:
        def step(state):
            return sharding.render_pass_sharded(
                scene, cam, state, config, mesh,
                rays_per_tile=args.rays_per_tile)

        def whole(state):
            if state.accum.shape[0] == config.height:   # no pass ran
                return state
            return RenderState(accum=sharding.gather_image(state, mesh),
                               n_samples=state.n_samples)

    n_passes = -(-args.spp // config.spp_per_pass)
    t0 = time.time()
    for done in range(1, n_passes + 1):
        state = step(state)
        if args.progress_every and done % args.progress_every == 0:
            _fence(state)
            dt = time.time() - t0
            say(f"pass {done}/{n_passes} ({state.n_samples} spp, "
                f"{dt:.1f}s, {done / dt:.2f} passes/s)")
        if args.preview_every and done % args.preview_every == 0 \
                and done < n_passes:
            preview = whole(state)
            if lead:
                save_render(args.out, finalize(preview, config).cpu().numpy())
                say(f"preview written to {args.out} at "
                    f"{state.n_samples} spp")
    _fence(state)
    elapsed = time.time() - t0

    state = whole(state)
    if not lead:
        return
    save_render(args.out, finalize(state, config).cpu().numpy())
    if args.save_state:
        ckpt.save_render_state(args.save_state, state)

    # bench.py:104's accounting over the samples this run rendered
    rays = args.width * args.height * (state.n_samples - start_spp) \
        * (1 + 2 * args.max_bounce)
    print(json.dumps({
        "out": args.out,
        "spp": state.n_samples,
        "seconds": round(elapsed, 2),
        "rays_per_sec": round(rays / max(elapsed, 1e-9), 1),
    }))


if __name__ == "__main__":
    main()
