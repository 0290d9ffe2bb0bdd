"""Live material edit -> invalidate -> re-render (PyTorch port of
examples/live_edit.py).

The reference's signature interactive loop: drag an ImGui slider, the app
marks the accumulator dirty and restarts progressive rendering with the
edited material (main.cpp:324-327 slider -> camera.LoopNum = 0 ->
RefreshTriangleMaterial + TBO re-upload, Triangle.h:133-151). Here:

  1. render the scene a few progressive samples,
  2. edit one material slot (MaterialTable.replace_material returns a new
     table; SceneData.with_materials swaps it in, nothing is re-uploaded),
  3. invalidate by starting a fresh RenderState (the LoopNum = 0 analogue),
  4. re-render and save both frames.

    python -m opengl_ray_tracing_framework_tpu_torch.examples.live_edit \\
        [--device cpu] [--size 128] [--spp 16] [--out-dir .]

writes live_edit_before.png and live_edit_after.png. LIVE_EDIT_SPP sets
the default of --spp, as in the JAX example.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> dict:
    """Run the loop; returns the two linear-radiance images and the
    edited scene, for callers that check them."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--spp", type=int,
                   default=int(os.environ.get("LIVE_EDIT_SPP", "16")))
    p.add_argument("--max-bounce", type=int, default=4)
    p.add_argument("--out-dir", default=".")
    args = p.parse_args(argv)

    from .. import Camera, RenderConfig, build_test_scene
    from ..models.material import preset_materials
    from ..render import finalize, init_render_state, render_pass
    from ..utils.image import save_render

    scene_builder, scene = build_test_scene(n_sphere_subdiv=2,
                                            device=args.device)
    camera = Camera.make(position=(0.0, 0.5, -2.0), yaw=90.0, pitch=-8.0,
                         zoom=30.0, aspect=1.0, device=args.device)
    config = RenderConfig(width=args.size, height=args.size,
                          max_bounce=args.max_bounce, spp_per_pass=args.spp)
    rays = args.size * args.size
    out = {}

    def frame(label, scene):
        # 3. a fresh accumulator: the edit invalidates every sample so far
        state = render_pass(scene, camera, init_render_state(
            config, args.device), config, rays_per_tile=rays)
        path = os.path.join(args.out_dir, f"live_edit_{label}.png")
        save_render(path, finalize(state, config).cpu().numpy())
        print(f"{label}: {args.spp} spp, mean={float(state.accum.mean()):.4f}"
              f" -> {path}")
        out[label] = state.accum

    # 1. the first render
    frame("before", scene)
    # 2. the "slider drag": the sphere's material slot (the last object the
    # test scene adds) becomes golden metal
    slot = scene_builder.objects[-1].material_slot
    scene = scene.with_materials(scene.materials.replace_material(
        slot, preset_materials()["golden"]))
    # 4. the re-render with the edited table
    frame("after", scene)
    out["scene"] = scene
    return out


if __name__ == "__main__":
    main()
