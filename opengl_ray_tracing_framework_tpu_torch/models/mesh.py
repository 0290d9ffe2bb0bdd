"""Mesh loading and host-side geometry processing.

A numpy copy of opengl_ray_tracing_framework_tpu/models/mesh.py, equal
in what it computes (tests/test_torch_host.py checks the arrays byte for
byte): the JAX package cannot be imported without importing jax.

Replaces the reference's assimp import path (src/core/Model.h:27-189) and
triangle-soup construction (src/core/Triangle.h:41-131) with a dependency-
free OBJ parser + numpy transforms:

- OBJ v/vn/f parsing with fan triangulation (assimp aiProcess_Triangulate).
- Smooth vertex-normal generation when the file has none
  (aiProcess_GenSmoothNormals, Model.h:51).
- Unit-scale AABB normalization: divide positions by the longest AABB axis
  (Triangle.h:72-82). The reference's extent computation compares y/z
  against the x running max (Triangle.h:60-64, a transcription bug); we
  compute the true AABB — intended semantics, not the defect.
- TRS transform translate * rotX * rotY * rotZ * scale with degree angles
  (getTransformMatrix, Model.h:250-266); normals are transformed with w=0
  and renormalized (Triangle.h:91-95).
- Flat vs. smooth per-object shading baked into per-vertex normals
  (Triangle.h:109-120).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


@dataclass
class MeshData:
    """Host triangle mesh: positions (V, 3) f32, normals (V, 3) f32 or None,
    triangle indices (F, 3) i32."""

    positions: np.ndarray
    normals: np.ndarray | None
    faces: np.ndarray


def load_obj(path: str) -> MeshData:
    """Minimal OBJ reader: v, vn, f (v | v/vt | v//vn | v/vt/vn), polygons
    fan-triangulated. Ignores materials/groups/uvs."""
    positions: list = []
    normals: list = []
    face_pos: list = []
    face_nrm: list = []
    has_nrm_idx = False

    with open(path, "r", errors="replace") as fh:
        for line in fh:
            if line.startswith("v "):
                parts = line.split()
                positions.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif line.startswith("vn "):
                parts = line.split()
                normals.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif line.startswith("f "):
                verts = line.split()[1:]
                idx = []
                nidx = []
                for v in verts:
                    comps = v.split("/")
                    idx.append(int(comps[0]))
                    if len(comps) >= 3 and comps[2]:
                        nidx.append(int(comps[2]))
                        has_nrm_idx = True
                    else:
                        nidx.append(0)
                for k in range(1, len(idx) - 1):  # fan triangulation
                    face_pos.append((idx[0], idx[k], idx[k + 1]))
                    face_nrm.append((nidx[0], nidx[k], nidx[k + 1]))

    pos = np.asarray(positions, np.float32)
    nv = pos.shape[0]

    def resolve(i, n):
        return i - 1 if i > 0 else n + i

    fp = np.asarray(
        [[resolve(i, nv) for i in f] for f in face_pos], np.int32)

    nrm_per_vertex = None
    if has_nrm_idx and normals:
        nrm = np.asarray(normals, np.float32)
        fn = np.asarray(
            [[resolve(i, len(normals)) if i != 0 else 0 for i in f]
             for f in face_nrm], np.int32)
        # Re-index normals onto position vertices (last write wins; OBJ
        # files here use matching v/vn indexing).
        nrm_per_vertex = np.zeros_like(pos)
        nrm_per_vertex[fp.reshape(-1)] = nrm[fn.reshape(-1)]
    return MeshData(positions=pos, normals=nrm_per_vertex, faces=fp)


def compute_smooth_normals(positions: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Average of normalized face normals per vertex (the behavior of
    assimp's GenSmoothNormals with the default all-angles threshold)."""
    p1 = positions[faces[:, 0]]
    p2 = positions[faces[:, 1]]
    p3 = positions[faces[:, 2]]
    fn = np.cross(p2 - p1, p3 - p1)
    lens = np.linalg.norm(fn, axis=1, keepdims=True)
    fn = fn / np.maximum(lens, 1e-20)
    vn = np.zeros_like(positions)
    for k in range(3):
        np.add.at(vn, faces[:, k], fn)
    vn /= np.maximum(np.linalg.norm(vn, axis=1, keepdims=True), 1e-20)
    return vn.astype(np.float32)


def transform_matrix(rotate_deg=(0.0, 0.0, 0.0), translate=(0.0, 0.0, 0.0),
                     scale=(1.0, 1.0, 1.0)) -> np.ndarray:
    """translate * rotX * rotY * rotZ * scale, angles in degrees
    (getTransformMatrix, Model.h:250-266)."""
    rx, ry, rz = (math.radians(a) for a in rotate_deg)

    def rot(axis, a):
        c, s = math.cos(a), math.sin(a)
        m = np.eye(4, dtype=np.float64)
        i, j = [(1, 2), (0, 2), (0, 1)][axis]
        m[i, i] = c
        m[j, j] = c
        if axis == 1:
            m[i, j] = s
            m[j, i] = -s
        else:
            m[i, j] = -s
            m[j, i] = s
        return m

    t = np.eye(4)
    t[:3, 3] = translate
    s = np.diag([scale[0], scale[1], scale[2], 1.0])
    r = rot(0, rx) @ rot(1, ry) @ rot(2, rz)
    return (t @ r @ s).astype(np.float32)


def mesh_to_triangles(mesh: MeshData, trans: np.ndarray,
                      smooth_normal: bool = False, normalize: bool = True):
    """World-space triangle soup from a mesh (getTriangle, Triangle.h:41-131).

    Returns (p1, p2, p3, n1, n2, n3), each (F, 3) float32.
    - normalize: scale positions so the longest AABB axis has extent 1
      (no recentering), matching Triangle.h:72-82.
    - smooth_normal False: flat face normal normalize(cross(p2-p1, p3-p1))
      for all three vertices (Triangle.h:110-114).
    """
    pos = mesh.positions.astype(np.float64)
    if normalize:
        ext = pos.max(axis=0) - pos.min(axis=0)
        pos = pos / max(float(ext.max()), 1e-20)

    # positions: w = 1
    hom = np.concatenate([pos, np.ones((pos.shape[0], 1))], axis=1)
    pos_w = (hom @ trans.astype(np.float64).T)[:, :3]

    f = mesh.faces
    p1 = pos_w[f[:, 0]].astype(np.float32)
    p2 = pos_w[f[:, 1]].astype(np.float32)
    p3 = pos_w[f[:, 2]].astype(np.float32)

    if not smooth_normal:
        n = np.cross(p2 - p1, p3 - p1)
        n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-20)
        n = n.astype(np.float32)
        return p1, p2, p3, n.copy(), n.copy(), n.copy()

    nrm = mesh.normals
    if nrm is None:
        nrm = compute_smooth_normals(mesh.positions, mesh.faces)
    # normals: w = 0, then renormalize (Triangle.h:91-95, 116-119)
    nrm_w = nrm.astype(np.float64) @ trans.astype(np.float64)[:3, :3].T
    nrm_w /= np.maximum(np.linalg.norm(nrm_w, axis=1, keepdims=True), 1e-20)
    nrm_w = nrm_w.astype(np.float32)
    n1 = nrm_w[f[:, 0]]
    n2 = nrm_w[f[:, 1]]
    n3 = nrm_w[f[:, 2]]
    return p1, p2, p3, n1, n2, n3


# ---------------------------------------------------------------------------
# Procedural meshes for tests / demos (no external assets required)
# ---------------------------------------------------------------------------


def save_obj(path: str, mesh: MeshData) -> None:
    """Write a mesh as OBJ text that load_obj reads back: v lines, vn
    lines when it has normals, f lines with 1-based indices."""
    faces = mesh.faces.astype(np.int64) + 1
    with open(path, "w") as fh:
        np.savetxt(fh, mesh.positions, fmt="v %.9g %.9g %.9g")
        if mesh.normals is None:
            np.savetxt(fh, faces, fmt="f %d %d %d")
        else:
            np.savetxt(fh, mesh.normals, fmt="vn %.9g %.9g %.9g")
            np.savetxt(fh, np.repeat(faces, 2, axis=1),
                       fmt="f %d//%d %d//%d %d//%d")


def make_quad(size: float = 1.0) -> MeshData:
    """Unit quad in the xz plane facing +y."""
    s = size
    pos = np.array(
        [[-s, 0.0, s], [s, 0.0, s], [-s, 0.0, -s], [s, 0.0, -s]], np.float32)
    faces = np.array([[0, 1, 2], [2, 1, 3]], np.int32)
    return MeshData(positions=pos, normals=None, faces=faces)


def make_tetrahedron() -> MeshData:
    pos = np.array(
        [[1, 1, 1], [1, -1, -1], [-1, 1, -1], [-1, -1, 1]], np.float32)
    faces = np.array(
        [[0, 2, 1], [0, 1, 3], [0, 3, 2], [1, 2, 3]], np.int32)
    return MeshData(positions=pos, normals=None, faces=faces)


def make_icosphere(subdiv: int = 2) -> MeshData:
    """Icosahedron subdivided and projected to the unit sphere."""
    t = (1.0 + math.sqrt(5.0)) / 2.0
    verts = [
        (-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0),
        (0, -1, t), (0, 1, t), (0, -1, -t), (0, 1, -t),
        (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1),
    ]
    faces = [
        (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
        (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
        (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
        (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
    ]
    verts = [np.array(v, np.float64) for v in verts]
    verts = [v / np.linalg.norm(v) for v in verts]

    cache: dict = {}

    def midpoint(i, j):
        key = (min(i, j), max(i, j))
        if key not in cache:
            m = verts[i] + verts[j]
            m /= np.linalg.norm(m)
            verts.append(m)
            cache[key] = len(verts) - 1
        return cache[key]

    for _ in range(subdiv):
        new_faces = []
        for (a, b, c) in faces:
            ab = midpoint(a, b)
            bc = midpoint(b, c)
            ca = midpoint(c, a)
            new_faces += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = new_faces

    pos = np.asarray(verts, np.float32)
    return MeshData(positions=pos, normals=pos.copy(),
                    faces=np.asarray(faces, np.int32))
