"""The benchmark's raw inputs, made here and handed alike to the program
and to the plain reference.

From a configuration (configs/<name>.json): the triangle soup of each
object in world space with its vertex normals (a floor quad, an
icosphere), the material values, the gradient HDR image and the camera.
What the seed draws for a traffic mix (never a size, a material or the
camera) is its kind of request's: traffic/<entry>.py::draw.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass
class RawScene:
    p1: np.ndarray          # (N, 3) float32 world-space vertices
    p2: np.ndarray
    p3: np.ndarray
    n1: np.ndarray          # (N, 3) float32 vertex normals
    n2: np.ndarray
    n3: np.ndarray
    mat_idx: np.ndarray     # (N,) int32 slot into `materials`
    materials: list         # dicts of the Material fields, one a slot
    hdr: np.ndarray         # (H, W, 3) float32 radiance
    env_intensity: float
    env_angle: float
    objects: list           # (name, first triangle, triangle count, slot)


def quad_mesh():
    """Unit quad in the xz plane facing +y: (positions, faces)."""
    pos = np.array([[-1.0, 0.0, 1.0], [1.0, 0.0, 1.0], [-1.0, 0.0, -1.0],
                    [1.0, 0.0, -1.0]])
    return pos, np.array([[0, 1, 2], [2, 1, 3]])


def icosphere_mesh(subdiv: int):
    """Icosahedron subdivided `subdiv` times and projected to the unit
    sphere (20 * 4**subdiv faces): (positions, faces)."""
    t = (1.0 + math.sqrt(5.0)) / 2.0
    verts = [np.array(v, np.float64) for v in (
        (-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0), (0, -1, t),
        (0, 1, t), (0, -1, -t), (0, 1, -t), (t, 0, -1), (t, 0, 1),
        (-t, 0, -1), (-t, 0, 1))]
    verts = [v / np.linalg.norm(v) for v in verts]
    faces = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
             (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
             (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
             (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    cache: dict = {}

    def midpoint(i, j):
        key = (min(i, j), max(i, j))
        if key not in cache:
            m = verts[i] + verts[j]
            verts.append(m / np.linalg.norm(m))
            cache[key] = len(verts) - 1
        return cache[key]

    for _ in range(subdiv):
        new = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = new
    return (np.asarray(verts, np.float32).astype(np.float64),
            np.asarray(faces))


MESHES = {"quad": lambda obj: quad_mesh(),
          "icosphere": lambda obj: icosphere_mesh(int(obj["subdiv"]))}


def trs(rotate_deg, translate, scale) -> np.ndarray:
    """translate * rotX * rotY * rotZ * scale, angles in degrees
    (getTransformMatrix, Model.h:250-266)."""
    def rot(axis, deg):
        c, s = math.cos(math.radians(deg)), math.sin(math.radians(deg))
        m = np.eye(4)
        i, j = [(1, 2), (0, 2), (0, 1)][axis]
        m[i, i] = m[j, j] = c
        sign = 1.0 if axis == 1 else -1.0
        m[i, j], m[j, i] = sign * s, -sign * s
        return m

    t = np.eye(4)
    t[:3, 3] = translate
    r = rot(0, rotate_deg[0]) @ rot(1, rotate_deg[1]) @ rot(2, rotate_deg[2])
    return t @ r @ np.diag([*scale, 1.0])


def object_soup(obj: dict):
    """World-space (p1, p2, p3, n1, n2, n3) float32 of one object: flat
    face normals, or for a smooth object the unit sphere's vertex normals
    carried by the transform (w = 0) and renormalized."""
    pos, faces = MESHES[obj["mesh"]](obj)
    m = trs(obj.get("rotate", (0, 0, 0)), obj["translate"], obj["scale"])
    pw = (np.concatenate([pos, np.ones((len(pos), 1))], 1) @ m.T)[:, :3]
    p = [pw[faces[:, k]].astype(np.float32) for k in range(3)]
    if obj["smooth"]:
        nw = pos @ m[:3, :3].T
        nw /= np.maximum(np.linalg.norm(nw, axis=1, keepdims=True), 1e-20)
        n = [nw[faces[:, k]].astype(np.float32) for k in range(3)]
    else:
        fn = np.cross(p[1] - p[0], p[2] - p[0]).astype(np.float64)
        fn /= np.maximum(np.linalg.norm(fn, axis=1, keepdims=True), 1e-20)
        n = [fn.astype(np.float32)] * 3
    return p + n


def gradient_hdr(width: int, height: int, bright_dir) -> np.ndarray:
    """Procedural environment: a smooth gradient with a bright pole
    (H, W, 3) float32."""
    us = (np.arange(width) + 0.5) / width
    vs = (np.arange(height) + 0.5) / height
    u, v = np.meshgrid(us, vs)
    phi = 2.0 * np.pi * (u - 0.5)
    theta = np.pi * (0.5 - v)
    d = np.stack([np.cos(theta) * np.cos(phi), np.sin(theta),
                  np.cos(theta) * np.sin(phi)], axis=-1)
    b = np.asarray(bright_dir, np.float64)
    b /= np.linalg.norm(b)
    base = 0.2 + 2.0 * np.clip((d @ b + 1.0) * 0.5, 0.0, 1.0) ** 4
    return np.stack([base, base * 0.9 + 0.05, base * 0.8 + 0.1],
                    axis=-1).astype(np.float32)


def make_raw(config: dict) -> RawScene:
    """The configuration's scene as raw arrays."""
    names = list(config["materials"])
    parts, slots, objects, first = [], [], [], 0
    for obj in config["objects"]:
        soup = object_soup(obj)
        slot = names.index(obj["material"])
        parts.append(soup)
        slots.append(np.full(len(soup[0]), slot, np.int32))
        objects.append((obj["name"], first, len(soup[0]), slot))
        first += len(soup[0])
    cat = [np.concatenate([p[k] for p in parts]) for k in range(6)]
    env = config["environment"]
    return RawScene(*cat, mat_idx=np.concatenate(slots),
                    materials=[config["materials"][k] for k in names],
                    hdr=gradient_hdr(env["width"], env["height"],
                                     env["bright_dir"]),
                    env_intensity=float(env["intensity"]),
                    env_angle=float(env["angle"]), objects=objects)


def camera(config: dict) -> dict:
    """The camera pose; aspect is the frame's width over its height."""
    frame = config["frame"]
    return dict(config["camera"], aspect=frame["width"] / frame["height"])
