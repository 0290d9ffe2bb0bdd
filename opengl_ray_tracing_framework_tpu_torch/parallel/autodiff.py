"""Differentiable rendering: d(pixel loss)/d(material table, camera pose,
triangle vertices) by reverse-mode autograd (PyTorch port of
opengl_ray_tracing_framework_tpu.parallel.autodiff).

The capability the reference only has interactively (edit a material, see
the re-render: ImGui loop, main.cpp:329-480 + RefreshTriangleMaterial)
becomes a gradient of sum((render - target)^2).

The loss is a sum over pixels, so param_grad runs forward AND backward one
batch of rays_per_tile pixels at a time and adds the gradients: a batch's
graph is freed before the next is built, and peak memory is one batch's,
whatever the image size. That one structure stands where the JAX package
has its remat policy, flat 1-D AD boundaries and cast-only compaction.
Traversal is detached (ops/traverse.py): the casts run under no_grad, in
the forward only, and the backward launches no kernel of csrc/.

param_grad_sharded splits the rows over the ranks of a mesh
(parallel/sharding.py): each rank runs param_grad on its rows, and one
all_reduce of [its flat float gradients | its loss] sums them, the JAX
package's one-reduction discipline.

Documented biases, kept from the JAX package: no silhouette (visibility)
term, and the sampling decisions (lobe choice, light texel, scatter
distance draw) are detached.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..models.camera import Camera
from ..models.material import Material, MaterialTable
from ..render import pixel_order, trace_pixels
from ..utils import timing
from ..utils.config import RenderConfig


def _row_batches(scene, camera, config, row0, n_rows, spp, rays_per_tile):
    """Yield (pixel_id, mean radiance over spp samples) for each batch of
    rays_per_tile pixels of rows [row0, row0 + n_rows), in traced order.
    Each batch's radiance carries its own autograd graph."""
    camera = camera.to(scene.device)
    for pixel_id in pixel_order(config, int(row0), n_rows,
                                scene.device).split(rays_per_tile):
        acc = torch.zeros((pixel_id.shape[0], 3), dtype=torch.float32,
                          device=scene.device)
        for s in range(spp):
            sample = trace_pixels(scene, camera, pixel_id, s + 1, config)
            acc = acc + (sample - acc) / (s + 1)
        yield pixel_id, acc


def _batch_loss(pixel_id, radiance, target_rows, config, row0):
    """sum((radiance - target)^2) over one batch; target_rows is the
    (n_rows, W, 3) image of rows row0.., compared in image order."""
    want = target_rows.reshape(-1, 3)[pixel_id - config.width * int(row0)]
    return torch.sum((radiance - want) ** 2)


def render_rows_radiance(scene, camera, config, row0, n_rows, spp,
                         rays_per_tile=65536):
    """Mean radiance over spp samples for rows [row0, row0 + n_rows) ->
    (n_rows, W, 3), differentiable as a whole (one graph for all batches:
    for small images; param_grad is the memory-bounded gradient)."""
    ids, rads = zip(*_row_batches(scene, camera, config, row0, n_rows, spp,
                                  rays_per_tile))
    local = torch.cat(ids) - config.width * int(row0)   # a permutation
    image = torch.empty_like(torch.cat(rads)).index_copy(0, local,
                                                         torch.cat(rads))
    return image.reshape(n_rows, config.width, 3)


def material_loss(materials, scene, camera, target_rows, config, row0,
                  n_rows, spp, rays_per_tile):
    """sum((render - target)^2) of the scene with `materials`, as one
    differentiable scalar."""
    scene = scene.with_materials(materials)
    return sum(
        _batch_loss(pixel_id, rad, target_rows, config, row0)
        for pixel_id, rad in _row_batches(scene, camera, config, row0,
                                          n_rows, spp, rays_per_tile))


def _leaf(x):
    """A fresh leaf of x that requires grad, or x itself when it is not a
    floating tensor (medium_type: no gradient, reported as None)."""
    if not x.is_floating_point():
        return x
    return x.detach().clone().requires_grad_(True)


def _geometry_put(scene, camera, vertices):
    tri_attr = torch.cat([vertices.reshape(9, -1), scene.tri_attr[9:]])
    return dataclasses.replace(scene, tri_attr=tri_attr), camera


# Parameter groups: name -> (get, put, wrap). get(scene, camera) lists the
# group's tensors, put(scene, camera, leaves) re-applies them, and
# wrap(grads) shapes the gradients like the parameters. "geometry"
# differentiates the leaf-ordered triangle vertices through the fused
# tri_attr table (see geometry_grad for the detached-traversal semantics).
_PARAM_GROUPS = {
    "material": (
        lambda scene, camera: list(scene.materials.mat),
        lambda scene, camera, p: (
            scene.with_materials(MaterialTable(mat=Material(*p))), camera),
        lambda g: MaterialTable(mat=Material(*g)),
    ),
    "camera": (
        lambda scene, camera: list(camera.to(scene.device)),
        lambda scene, camera, p: (scene, Camera(*p)),
        lambda g: Camera(*g),
    ),
    "geometry": (
        lambda scene, camera: [scene.tri_attr[0:9].reshape(3, 3, -1)],
        lambda scene, camera, p: _geometry_put(scene, camera, p[0]),
        lambda g: g[0],
    ),
}


def _grads(scene, camera, target, config, param, spp, rays_per_tile, row0,
           n_rows):
    """(loss, gradient list in the group's order, wrap) of param_grad."""
    try:
        get, put, wrap = _PARAM_GROUPS[param]
    except KeyError:
        raise ValueError(f"unknown param group {param!r}; "
                         f"one of {sorted(_PARAM_GROUPS)}") from None
    leaves = [_leaf(x) for x in get(scene, camera)]
    wrt = [x for x in leaves if x.requires_grad]
    scene, camera = put(scene, camera, leaves)
    loss = torch.zeros((), dtype=torch.float32, device=scene.device)
    # forward and backward batch by batch: backward() frees the batch's
    # graph and adds into the leaves' .grad (spans rt.loss and rt.backward
    # under utils/timing.py's tracing())
    for pixel_id, rad in _row_batches(scene, camera, config, row0, n_rows,
                                      spp, rays_per_tile):
        with timing.span("rt.loss"):
            batch_loss = _batch_loss(pixel_id, rad, target, config, row0)
        if batch_loss.requires_grad:
            with timing.span("rt.backward"):
                batch_loss.backward(inputs=wrt)
        loss += batch_loss.detach()
    grads = [None if not x.requires_grad
             else torch.zeros_like(x) if x.grad is None else x.grad
             for x in leaves]
    return loss, grads, wrap


def param_grad(scene, camera: Camera, target, config: RenderConfig,
               param: str = "material", spp: int = 1,
               rays_per_tile: int = 65536, row0: int = 0,
               n_rows: int | None = None):
    """(loss, grads) of sum((render - target)^2) over rows [row0, row0 +
    n_rows) (default: the whole image) w.r.t. a named parameter group:
    "material" (grads: a MaterialTable), "camera" (a Camera) or "geometry"
    (leaf-ordered triangle vertices, (3, 3, N)). target is the (n_rows, W,
    3) image of those rows, on the scene's device. Integer parameters
    (medium_type) have no gradient: their entry is None, where the JAX
    package returns a float0 zero. A float parameter no pixel depends on
    gets zeros."""
    n_rows = config.height - row0 if n_rows is None else n_rows
    loss, grads, wrap = _grads(scene, camera, target, config, param, spp,
                               rays_per_tile, row0, n_rows)
    return loss, wrap(grads)


def param_grad_sharded(scene, camera: Camera, target, config: RenderConfig,
                       mesh, param: str = "material", spp: int = 1,
                       rays_per_tile: int = 65536):
    """(loss, grads) of param_grad over the whole (H, W, 3) target with the
    rows split over every rank of `mesh` (parallel/sharding.py): rank r
    takes rows [r*H/n, (r+1)*H/n). Each rank's float gradients and loss go
    into one flat vector and ONE all_reduce sums it (the JAX package's
    single reduction; no per-leaf collectives to order), then it is cut
    back into the group's shapes. Every rank returns the same sums.
    Integer leaves give None."""
    if config.height % mesh.size:
        raise ValueError(f"height {config.height} must divide the mesh size "
                         f"{mesh.size}")
    rows = config.height // mesh.size
    row0 = mesh.rank * rows
    loss, grads, wrap = _grads(scene, camera, target[row0:row0 + rows],
                               config, param, spp, rays_per_tile, row0, rows)
    flat = torch.cat([g.reshape(-1) for g in grads if g is not None]
                     + [loss.reshape(1)])
    if dist.is_initialized():
        dist.all_reduce(flat)
    out, off = [], 0
    for g in grads:
        if g is not None:
            out.append(flat[off:off + g.numel()].reshape(g.shape))
            off += g.numel()
        else:
            out.append(None)
    return flat[-1], wrap(out)


def material_grad_sharded(scene, camera: Camera, target,
                          config: RenderConfig, mesh, spp: int = 1,
                          rays_per_tile: int = 65536):
    """(loss, grads) w.r.t. the material table, rows split over the mesh
    and gradients all-reduced."""
    return param_grad_sharded(scene, camera, target, config, mesh,
                              "material", spp, rays_per_tile)


def material_grad(scene, camera: Camera, target, config: RenderConfig,
                  spp: int = 1, rays_per_tile: int = 65536):
    """(loss, grads) w.r.t. the material table."""
    return param_grad(scene, camera, target, config, "material", spp,
                      rays_per_tile)


def camera_grad(scene, camera: Camera, target, config: RenderConfig,
                spp: int = 1, rays_per_tile: int = 65536):
    """(loss, grads) w.r.t. the camera pose."""
    return param_grad(scene, camera, target, config, "camera", spp,
                      rays_per_tile)


def geometry_grad(scene, camera: Camera, target, config: RenderConfig,
                  spp: int = 1, rays_per_tile: int = 65536):
    """(loss, vertex_grads) w.r.t. the triangle vertices.

    Shading recomputes the hit distance and normal from the fused tri_attr
    table (ops.intersect.surface_attributes), so reverse-mode gradients
    w.r.t. vertex positions flow through the hit point, the shading normal
    and every downstream BSDF term. Traversal stays detached: silhouette
    (visibility) gradients are the documented bias of detached sampling.

    Returns (loss, grads) with grads shaped (3, 3, N): d loss / d p_k[axis]
    for vertex k of every leaf-ordered triangle.
    """
    return param_grad(scene, camera, target, config, "geometry", spp,
                      rays_per_tile)
