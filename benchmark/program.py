"""The system under test: the PyTorch and CUDA port, reached only through
its public API (models/scene.py's Scene builder, render.py's render_pass,
parallel/autodiff.py's material_grad).

The port is imported here, on first use, from the checkout's root; the
reference under reference/ never imports this module.
"""

from __future__ import annotations

import importlib

import numpy as np

PACKAGE = "opengl_ray_tracing_framework_tpu_torch"


def port(module: str = ""):
    """The port's package, or one of its modules."""
    return importlib.import_module(PACKAGE + (f".{module}" if module else ""))


def build_scene(raw, config: dict, device):
    """The port's SceneData from the raw inputs, through its Scene builder:
    each object's triangle soup as a mesh with its vertex normals, placed
    as it is (identity transform, no rescale); the builder derives the BVH,
    the clusters, the environment tables."""
    scene_mod = port("models.scene")
    mesh_mod = port("models.mesh")
    Material = port("models.material").Material
    scene = scene_mod.Scene()
    slots = [scene.add_material(Material.make(**m)) for m in raw.materials]
    for name, first, count, slot in raw.objects:
        sl = slice(first, first + count)
        pos = np.stack([raw.p1[sl], raw.p2[sl], raw.p3[sl]], 1).reshape(-1, 3)
        nrm = np.stack([raw.n1[sl], raw.n2[sl], raw.n3[sl]], 1).reshape(-1, 3)
        mesh = mesh_mod.MeshData(
            positions=pos, normals=nrm,
            faces=np.arange(3 * count, dtype=np.int32).reshape(count, 3))
        scene.add_object(mesh, slots[slot], np.eye(4, dtype=np.float32),
                         smooth_normal=True, normalize=False, name=name)
    scene.set_environment(raw.hdr)
    build = config["scene_build"]
    return scene.build(leaf_size=build["leaf_size"],
                       bvh_method=build["bvh_method"],
                       cluster_size=build["cluster_size"],
                       env_intensity=raw.env_intensity,
                       env_angle=raw.env_angle, device=device)


def render_config(config: dict):
    """The port's RenderConfig of the configuration's frame and settings."""
    frame = config["frame"]
    return port("utils.config").RenderConfig(
        width=frame["width"], height=frame["height"],
        max_bounce=frame["max_bounce"], spp_per_pass=frame["spp_per_pass"],
        **config["render"]).validate()


def camera(cam: dict, device):
    return port("models.camera").Camera.make(
        position=cam["position"], yaw=cam["yaw"], pitch=cam["pitch"],
        zoom=cam["zoom"], aspect=cam["aspect"], device=device)
