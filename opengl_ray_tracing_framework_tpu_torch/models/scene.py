"""Scene assembly: meshes + materials + BVH + environment -> device tensors
(PyTorch port of opengl_ray_tracing_framework_tpu.models.scene).

The host pipeline (mesh transforms, SAH BVH, treelet clusters, HDR cache)
is the JAX package's numpy code, copied into this package's models/; its
arrays become the tensors of a SceneData on one device. The field names,
shapes and layouts are the JAX SceneData's, so a scene crosses between
the two packages as a dict of numpy arrays (scene_from_numpy).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Mapping, NamedTuple

import numpy as np
import torch

from . import mesh as mesh_lib
from .bvh import build_bvh
from .camera import Camera
from .clusters import build_clusters
from .hdr import build_env_fetch, build_hdr_cache, load_hdr, make_gradient_hdr
from .material import Material, MaterialTable, preset_materials
from ..utils import timing
from ..utils.config import resolve_device

DEFAULT_ASSETS_DIR = os.environ.get("ORTF_ASSETS", "resources")


@dataclasses.dataclass
class SceneData:
    """Scene tensors on one device. Layouts as the JAX SceneData."""

    p1: torch.Tensor             # (N, 3) f32, leaf-ordered triangles
    p2: torch.Tensor
    p3: torch.Tensor
    n1: torch.Tensor             # (N, 3) f32 vertex normals
    n2: torch.Tensor
    n3: torch.Tensor
    mat_idx: torch.Tensor        # (N,) int32 -> materials
    materials: MaterialTable
    bvh_left: torch.Tensor       # (B,) int32
    bvh_right: torch.Tensor
    bvh_count: torch.Tensor
    bvh_first: torch.Tensor
    bvh_min: torch.Tensor        # (B, 3) f32
    bvh_max: torch.Tensor
    hdr_map: torch.Tensor        # (H, W, 3) f32
    env_intensity: torch.Tensor  # scalar f32 (RenderSettings.h:86)
    env_angle: torch.Tensor      # scalar f32 (RenderSettings.h:87)
    cl_aabb_min: torch.Tensor    # (C, 3) f32 cluster bounds
    cl_aabb_max: torch.Tensor
    cl_trifeat: torch.Tensor     # (C, 16, 4T) f32, models/clusters.py
    cl_slot2tri: torch.Tensor    # (C*T,) int32 padded slot -> tri id
    tri_attr: torch.Tensor       # (20, N) f32 [p1 p2 p3 n1 n2 n3 mat_idx pad]
    env_fetch: torch.Tensor      # (H*W, 16) f32, hdr.build_env_fetch
    hdr_cache: torch.Tensor      # (H, W, 3) f32, hdr.build_hdr_cache

    @property
    def device(self) -> torch.device:
        return self.p1.device

    @property
    def n_triangles(self) -> int:
        return self.p1.shape[0]

    @property
    def n_nodes(self) -> int:
        return self.bvh_left.shape[0]

    def triangle_vertices(self, tri_idx: torch.Tensor):
        """(p1, p2, p3) of triangle ids, clamped to the scene (callers
        mask)."""
        safe = torch.clamp(tri_idx, 0, self.n_triangles - 1).long()
        return self.p1[safe], self.p2[safe], self.p3[safe]

    def triangle_normals(self, tri_idx: torch.Tensor):
        """(n1, n2, n3) of triangle ids, clamped as triangle_vertices."""
        safe = torch.clamp(tri_idx, 0, self.n_triangles - 1).long()
        return self.n1[safe], self.n2[safe], self.n3[safe]

    def to(self, device) -> "SceneData":
        return SceneData(**{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)})

    def with_materials(self, materials: MaterialTable) -> "SceneData":
        """The same scene with another material table (a live material
        edit; the differentiable parameter of material_grad)."""
        return dataclasses.replace(self, materials=materials)

    def material_ids(self, tri_idx: torch.Tensor) -> torch.Tensor:
        """int32 material slots of triangle ids, both clamped as
        material_of clamps them: what csrc/shade.cu's kernels read a
        lane's material by."""
        safe = torch.clamp(tri_idx, 0, self.n_triangles - 1).long()
        return torch.clamp(self.tri_attr[18, safe].long(), 0,
                           self.materials.count - 1).to(torch.int32)

    def material_of(self, tri_idx: torch.Tensor) -> Material:
        safe = torch.clamp(tri_idx, 0, self.n_triangles - 1).long()
        return self.materials.gather(self.tri_attr[18, safe].long())


def scene_from_numpy(arrays: Mapping, device=None) -> SceneData:
    """SceneData from numpy arrays named as the SceneData fields.

    arrays["materials"] maps each Material field name to its (M, ...)
    array. This is how a scene built by the JAX package (its SceneData
    fields and MaterialTable.mat fields, as numpy) crosses into the port.
    device=None is the card (utils.config.default_device).
    """
    device = resolve_device(device)
    mats = arrays["materials"]
    table = MaterialTable(mat=Material(*(
        torch.tensor(np.asarray(mats[f]), device=device)
        for f in Material._fields)))
    return SceneData(materials=table, **{
        f.name: torch.tensor(np.asarray(arrays[f.name]), device=device)
        for f in dataclasses.fields(SceneData) if f.name != "materials"})


def camera_from_numpy(arrays: Mapping, device=None) -> Camera:
    """Camera from numpy arrays named as the Camera fields, on the card
    unless a device is named."""
    device = resolve_device(device)
    return Camera(*(
        torch.tensor(np.asarray(arrays[f], np.float32), device=device)
        for f in Camera._fields))


class SceneObject(NamedTuple):
    name: str
    material_slot: int
    n_triangles: int


class Scene:
    """Host-side scene builder (the analogue of InitScene, Scene.h:35-51)."""

    def __init__(self):
        self._tris: list = []          # per-object (p1, p2, p3, n1, n2, n3)
        self._materials: list = []     # Material per slot
        self._mat_slots: list = []     # per-object slot
        self.objects: list[SceneObject] = []
        self._hdr: np.ndarray | None = None

    def add_material(self, material: Material) -> int:
        self._materials.append(material)
        return len(self._materials) - 1

    def add_object(self, mesh: mesh_lib.MeshData, material, transform=None,
                   smooth_normal: bool = False, normalize: bool = True,
                   name: str = "") -> SceneObject:
        """material: a Material (new slot) or an int slot (shared).
        Returns the object, which is also appended to `objects`."""
        if transform is None:
            transform = np.eye(4, dtype=np.float32)
        slot = (material if isinstance(material, int)
                else self.add_material(material))
        tris = mesh_lib.mesh_to_triangles(
            mesh, transform, smooth_normal=smooth_normal, normalize=normalize)
        self._tris.append(tris)
        self._mat_slots.append(slot)
        obj = SceneObject(name=name or f"object{len(self.objects)}",
                          material_slot=slot, n_triangles=tris[0].shape[0])
        self.objects.append(obj)
        return obj

    def set_environment(self, hdr: np.ndarray) -> None:
        self._hdr = np.asarray(hdr, np.float32)

    def load_environment(self, path: str) -> None:
        self.set_environment(load_hdr(path))

    def build(self, leaf_size: int = 8, bvh_method: str = "sah",
              env_intensity: float = 1.0, env_angle: float = 0.0,
              cluster_size: int = 256, device=None) -> SceneData:
        if not self._tris:
            raise ValueError("scene has no objects")
        with timing.span("rt.build"):
            return self._build(leaf_size, bvh_method, env_intensity,
                               env_angle, cluster_size, device)

    def _build(self, leaf_size, bvh_method, env_intensity, env_angle,
               cluster_size, device) -> SceneData:
        parts = [np.concatenate([t[k] for t in self._tris])
                 for k in range(6)]
        p1, p2, p3, n1, n2, n3 = parts
        mat_idx = np.concatenate([
            np.full(t[0].shape[0], slot, np.int32)
            for t, slot in zip(self._tris, self._mat_slots)])

        with timing.span("rt.build.bvh"):
            bvh = build_bvh(p1, p2, p3, leaf_size=leaf_size,
                            method=bvh_method, device=resolve_device(device))
            perm = bvh.perm
            p1, p2, p3 = p1[perm], p2[perm], p3[perm]
            n1, n2, n3 = n1[perm], n2[perm], n3[perm]
            mat_idx = mat_idx[perm]

        with timing.span("rt.build.clusters"):
            clusters = build_clusters(bvh, p1, p2, p3,
                                      max_tris=cluster_size)

        tri_attr = np.zeros((20, p1.shape[0]), np.float32)
        for row, a in zip(range(0, 18, 3), (p1, p2, p3, n1, n2, n3)):
            tri_attr[row:row + 3] = a.T
        tri_attr[18] = mat_idx.astype(np.float32)

        with timing.span("rt.build.env"):
            hdr = self._hdr if self._hdr is not None else make_gradient_hdr()
            cache = build_hdr_cache(hdr)
            env_fetch = build_env_fetch(hdr, cache)
        with timing.span("rt.build.upload"):
            return scene_from_numpy(dict(
                p1=p1, p2=p2, p3=p3, n1=n1, n2=n2, n3=n3, mat_idx=mat_idx,
                materials={f: np.stack([np.asarray(getattr(m, f))
                                        for m in self._materials])
                           for f in Material._fields},
                bvh_left=bvh.left, bvh_right=bvh.right,
                bvh_count=bvh.count, bvh_first=bvh.first,
                bvh_min=bvh.aabb_min, bvh_max=bvh.aabb_max,
                hdr_map=hdr,
                env_intensity=np.float32(env_intensity),
                env_angle=np.float32(env_angle),
                cl_aabb_min=clusters.aabb_min, cl_aabb_max=clusters.aabb_max,
                cl_trifeat=clusters.trifeat, cl_slot2tri=clusters.slot2tri,
                tri_attr=tri_attr,
                env_fetch=env_fetch,
                hdr_cache=cache,
            ), device=device)


# Reference scene presets (InitMesh, Scene.h:111-162)

_OBJ_FILES = {
    "floor": "objects/floor.obj",
    "bunny": "objects/bunny_4000.obj",
    "sphere": "objects/sphere.obj",
    "loong": "objects/loong_100000.obj",
    "panther": "objects/panther_100000.obj",
}

# (rotate_deg, translate, scale, smooth) straight from Scene.h:113-158.
_OBJ_TRANSFORMS = {
    "floor": ((0, 0, 0), (2.2, -2.0, 3.0), (14.0, 7.0, 7.0), False),
    "bunny": ((0, 0, 0), (2.2, -2.5, 3.0), (2.0, 2.0, 2.0), False),
    "sphere": ((0, 90, 0), (1.8, -1.0, 3.0), (2.0, 2.0, 2.0), True),
    "loong": ((0, 0, 0), (2.0, -2.0, 3.0), (3.5, 3.5, 3.5), True),
    "panther": ((0, -30, 0), (0.8, -2.2, 5.0), (4.5, 4.5, 4.5), True),
}

DEFAULT_HDR = "textures/hdr/peppermint_powerplant_1k.hdr"


def build_reference_scene(objects=("floor", "loong"),
                          current_material: str = "tear_glass",
                          assets_dir: str = DEFAULT_ASSETS_DIR,
                          hdr_name: str = DEFAULT_HDR,
                          leaf_size: int = 8,
                          device=None) -> tuple[Scene, SceneData]:
    """The reference's built-in scene: floor gets the `plane` preset, every
    other object shares the `current_material` slot (Scene.h:111-162).
    Raises FileNotFoundError when an object's file is missing."""
    presets = preset_materials()
    scene = Scene()
    shared_slot = None
    for name in objects:
        path = os.path.join(assets_dir, _OBJ_FILES[name])
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"scene object '{name}': {path} does not exist"
                + (" (the reference repo does not ship this asset; use "
                   "loong with material='brown_glass' for the same physics)"
                   if name == "panther" else ""))
        mesh = mesh_lib.load_obj(path)
        rot, trans, scale, smooth = _OBJ_TRANSFORMS[name]
        tm = mesh_lib.transform_matrix(rot, trans, scale)
        if name == "floor":
            scene.add_object(mesh, presets["plane"], tm, smooth_normal=smooth,
                             name=name)
        else:
            if shared_slot is None:
                shared_slot = scene.add_material(presets[current_material])
            scene.add_object(mesh, shared_slot, tm, smooth_normal=smooth,
                             name=name)
    hdr_path = os.path.join(assets_dir, hdr_name)
    if os.path.exists(hdr_path):
        scene.load_environment(hdr_path)
    return scene, scene.build(leaf_size=leaf_size, device=device)


def build_test_scene(n_sphere_subdiv: int = 1,
                     material: Material | None = None,
                     env: np.ndarray | None = None,
                     device=None) -> tuple[Scene, SceneData]:
    """Procedural scene (floor quad + icosphere); no external assets.
    n_sphere_subdiv=6 gives 81,922 triangles, the loong-100k scale."""
    presets = preset_materials()
    scene = Scene()
    floor_tm = mesh_lib.transform_matrix((0, 0, 0), (0.0, -1.0, 3.0),
                                         (10.0, 1.0, 10.0))
    scene.add_object(mesh_lib.make_quad(), presets["white"], floor_tm,
                     smooth_normal=False, normalize=False, name="floor")
    sphere_tm = mesh_lib.transform_matrix((0, 0, 0), (0.0, 0.0, 3.0),
                                          (1.0, 1.0, 1.0))
    scene.add_object(mesh_lib.make_icosphere(n_sphere_subdiv),
                     material if material is not None else presets["white"],
                     sphere_tm, smooth_normal=True, normalize=False,
                     name="sphere")
    scene.set_environment(env if env is not None else make_gradient_hdr())
    return scene, scene.build(device=device)
