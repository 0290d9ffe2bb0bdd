"""Pinhole camera (PyTorch port of
opengl_ray_tracing_framework_tpu.models.camera).

The reference's FPS camera (src/core/Camera.h:26-175) minus the input
handling: pose is (position, yaw, pitch) plus a zoom half-angle, and the
ray-generation basis is derived from the pose tensors on every call.

Reference conventions reproduced:
- front = (cos(yaw)cos(pitch), sin(pitch), sin(yaw)cos(pitch)), right/up via
  world up (0,1,0) (updateCameraVectors, Camera.h:160-171),
- halfH = tan(radians(zoom)), halfW = halfH * aspect, leftBottomCorner =
  front - halfW*right - halfH*up (Camera.h:171-173),
- ray(u, v) = normalize(lbc + 2u*halfW*right + 2v*halfH*up) (glsl:1525-1527),
- defaults: position (0,0,7), rotation (-87.78, -14), zoom 30
  (RenderSettings.h:18-20, Camera.h:23).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.config import resolve_device


def _norm(x):
    return torch.sqrt(torch.sum(x * x, dim=-1))


class Camera(NamedTuple):
    position: torch.Tensor   # (3,) float32
    yaw: torch.Tensor        # degrees, scalar float32 (Rotation.x)
    pitch: torch.Tensor      # degrees, scalar float32 (Rotation.y)
    zoom: torch.Tensor       # degrees, scalar float32
    aspect: torch.Tensor     # width / height, scalar float32

    @staticmethod
    def make(position=(0.0, 0.0, 7.0), yaw=-87.78, pitch=-14.0, zoom=30.0,
             aspect=2.0, device=None) -> "Camera":
        """A camera on the card unless a device is named."""
        device = resolve_device(device)
        f = lambda x: torch.as_tensor(x, dtype=torch.float32, device=device)
        return Camera(position=f(position), yaw=f(yaw), pitch=f(pitch),
                      zoom=f(zoom), aspect=f(aspect))

    def to(self, device) -> "Camera":
        return Camera(*(x.to(device) for x in self))

    def basis(self):
        """(front, right, up, half_w, half_h) — Camera.h:160-173."""
        yaw = torch.deg2rad(self.yaw)
        pitch = torch.deg2rad(self.pitch)
        cp = torch.cos(pitch)
        front = torch.stack(
            [torch.cos(yaw) * cp, torch.sin(pitch), torch.sin(yaw) * cp])
        front = front / _norm(front)
        world_up = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32,
                                device=front.device)
        right = torch.linalg.cross(front, world_up)
        right = right / torch.clamp(_norm(right), min=1e-12)
        up = torch.linalg.cross(right, front)
        up = up / torch.clamp(_norm(up), min=1e-12)
        half_h = torch.tan(torch.deg2rad(self.zoom))
        half_w = half_h * self.aspect
        return front, right, up, half_w, half_h

    def generate_rays(self, u, v):
        """Primary rays through film coords u, v in [0, 1] (glsl:1525-1527).

        u/v: (...,) tensors. Returns (origin (..., 3), direction (..., 3)).
        """
        front, right, up, half_w, half_h = self.basis()
        lbc = front - half_w * right - half_h * up
        d = (lbc[None, :]
             + (2.0 * u * half_w)[..., None] * right
             + (2.0 * v * half_h)[..., None] * up)
        d = d / _norm(d)[..., None]
        origin = torch.broadcast_to(self.position, d.shape)
        return origin, d


def pixel_uv(width: int, height: int, jitter_u=None, jitter_v=None,
             device=None):
    """Film coordinates of every pixel, row-major ((H*W,) each), on the
    card unless a device is named.

    Pixel (x, y) with y=0 the *bottom* row (GL texture convention) maps to
    uv = ((x + .5)/W, (y + .5)/H), the rasterized fragment coordinate the
    reference shades. Optional jitter tensors replace the .5 offsets.
    """
    device = resolve_device(device)
    xs = torch.arange(width, dtype=torch.float32, device=device)
    ys = torch.arange(height, dtype=torch.float32, device=device)
    gx = xs.repeat(height)
    gy = ys.repeat_interleave(width)
    ju = 0.5 if jitter_u is None else jitter_u
    jv = 0.5 if jitter_v is None else jitter_v
    return (gx + ju) / width, (gy + jv) / height
