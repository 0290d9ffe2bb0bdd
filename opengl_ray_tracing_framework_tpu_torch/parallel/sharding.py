"""Multi-device rendering on torch.distributed (PyTorch port of
opengl_ray_tracing_framework_tpu.parallel.sharding).

The reference's only parallelism is fragment-shader SIMT on one GPU
(glsl:1518, one invocation per pixel). Here, as in the JAX package:

- the image is split into row blocks, one per rank of the "tiles" axis;
  each rank traces its rows and keeps its rows' accumulator,
- the scene is replicated: every rank holds all of it (replicate_scene
  broadcasts rank 0's tensors),
- on a 2-D mesh ("tiles", "spp") the ranks of one tile render the same
  rows at different progressive frames and merge their means with one
  all_reduce per pass, the only collective of the hot loop; gather_image
  assembles the whole image when it is wanted.

Where the JAX package has a device mesh and shard_map, the port has one
process per rank and a Mesh that records where this rank sits. Every
collective here is an all_reduce or a broadcast, the two that gloo offers
for CUDA tensors, so the same code runs on NCCL, on gloo on the CPU and
on gloo on the card (two ranks sharing one card, which NCCL refuses).
A single process (no group) is a mesh of one and calls no collective.
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import os
import tempfile
import time
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist

from ..models.material import Material, MaterialTable
from ..models.scene import SceneData
from ..render import RenderState, _trace_rows
from ..utils.config import RenderConfig, resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place on an (n_tiles, n_spp) grid of ranks, laid out as
    the JAX package's devices.reshape(n_tiles, n_spp): rank = tile * n_spp
    + spp_id. spp_group is the process group of this rank's tile on a 2-D
    mesh (None on a 1-D mesh, and for a single process)."""

    n_tiles: int
    n_spp: int
    tile: int
    spp_id: int
    axis_names: tuple = ("tiles",)
    spp_group: object = None

    @property
    def size(self) -> int:
        return self.n_tiles * self.n_spp

    @property
    def rank(self) -> int:
        return self.tile * self.n_spp + self.spp_id


def _world() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def init_distributed(backend: str | None = None, device=None,
                     init_method: str = "env://",
                     timeout_s: float = 600.0) -> int:
    """Join the process group that torch's environment names (RANK,
    WORLD_SIZE, MASTER_ADDR / MASTER_PORT for env://, LOCAL_RANK: what
    torchrun sets) and return the world size. A process whose environment
    names no world (a plain `python` run) is a world of one: nothing is
    initialised. The backend is NCCL for the card (the default device) and
    gloo for the CPU unless one is named; on the card the rank takes
    LOCAL_RANK's card as its current device."""
    if dist.is_initialized():
        return dist.get_world_size()
    if "WORLD_SIZE" not in os.environ:
        return 1
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(
        backend or ("nccl" if device.type == "cuda" else "gloo"),
        init_method=init_method, rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]),
        timeout=timedelta(seconds=timeout_s))
    return dist.get_world_size()


def make_mesh() -> Mesh:
    """1-D mesh: every rank of the world is a tile of rows."""
    rank, n = _world()
    return Mesh(n_tiles=n, n_spp=1, tile=rank, spp_id=0)


def make_mesh_2d(n_tiles: int | None = None) -> Mesh:
    """2-D mesh ("tiles", "spp"): pixel rows x samples per pixel. The spp
    axis shards the temporal accumulation (SURVEY.md section 2.4 item 2):
    each tile's ranks render its rows at different progressive frames and
    all_reduce their means. Default n_tiles: half the ranks when their
    number is even and above one, else all of them."""
    rank, n = _world()
    if n_tiles is None:
        n_tiles = n // 2 if n % 2 == 0 and n > 1 else n
    if n % n_tiles:
        raise ValueError(f"{n} devices not divisible into {n_tiles} tiles")
    n_spp = n // n_tiles
    group = None
    if dist.is_initialized():
        # every rank creates every tile's group, in the same order
        for tile in range(n_tiles):
            g = dist.new_group(list(range(tile * n_spp, (tile + 1) * n_spp)))
            if tile == rank // n_spp:
                group = g
    return Mesh(n_tiles=n_tiles, n_spp=n_spp, tile=rank // n_spp,
                spp_id=rank % n_spp, axis_names=("tiles", "spp"),
                spp_group=group)


def replicate_scene(scene: SceneData, mesh: Mesh) -> SceneData:
    """Every tensor of the scene broadcast from rank 0 to every rank of the
    mesh (in place; each rank passes a scene of the same shapes, as built
    by the same call). Raises ValueError on every rank when a rank's shapes
    differ from rank 0's."""
    if not dist.is_initialized():
        return scene
    fields = {f.name: getattr(scene, f.name).contiguous()
              for f in dataclasses.fields(scene) if f.name != "materials"}
    mats = [x.contiguous() for x in scene.materials.mat]
    tensors = list(fields.values()) + mats
    shapes = torch.tensor([d for t in tensors for d in (t.dim(), *t.shape)],
                          dtype=torch.int64, device=scene.device)
    root = shapes.clone()
    dist.broadcast(root, 0)
    bad = torch.tensor([int(not torch.equal(root, shapes))],
                       dtype=torch.int64, device=scene.device)
    dist.all_reduce(bad)
    if bad.item():
        raise ValueError(f"{bad.item()} rank(s) of {mesh.size} hold a scene "
                         "of other shapes than rank 0's")
    for t in tensors:
        dist.broadcast(t, 0)
    return SceneData(materials=MaterialTable(mat=Material(*mats)), **fields)


@torch.no_grad()
def render_pass_sharded(scene: SceneData, camera, state: RenderState,
                        config: RenderConfig, mesh: Mesh,
                        rays_per_tile: int = 65536) -> RenderState:
    """One pass (spp_per_pass samples) of this rank's row block. Returns
    the block's state: accum (H / n_tiles, W, 3) and the whole image's
    sample count. A whole-image state (init_render_state, or a loaded
    checkpoint) is cut to this rank's rows.

    1-D mesh: frames n+1 .. n+spp_per_pass, accumulated as render_pass
    does. 2-D mesh: the ranks of a tile each trace spp_per_pass / n_spp
    frames (rank j of the tile: n + j*L + 1 .. n + j*L + L), average them,
    and one all_reduce over the tile's group gives the pass's mean, folded
    in as accum + (mean - accum) * spp / (n + spp)."""
    if config.height % mesh.n_tiles:
        raise ValueError(
            f"height {config.height} not divisible by {mesh.n_tiles} tiles")
    rows = config.height // mesh.n_tiles
    row0 = mesh.tile * rows
    accum, n = state.accum, int(state.n_samples)
    if accum.shape[0] != rows:
        accum = accum[row0:row0 + rows]
    spp = config.spp_per_pass

    def sample(frame):
        return _trace_rows(scene, camera, frame, config, row0, rows,
                           rays_per_tile)

    if "spp" not in mesh.axis_names:
        for s in range(spp):
            accum = accum + (sample(n + s + 1) - accum) / float(n + s + 1)
        return RenderState(accum=accum, n_samples=n + spp)

    if spp % mesh.n_spp:
        raise ValueError(f"spp_per_pass {spp} not divisible by the spp axis "
                         f"({mesh.n_spp})")
    local = spp // mesh.n_spp
    base = n + mesh.spp_id * local
    mean = torch.zeros_like(accum)
    for s in range(local):
        mean = mean + (sample(base + s + 1) - mean) / (s + 1)
    if mesh.spp_group is not None:
        dist.all_reduce(mean, group=mesh.spp_group)
    mean = mean / mesh.n_spp
    accum = accum + (mean - accum) * (spp / float(n + spp))
    return RenderState(accum=accum, n_samples=n + spp)


def gather_image(state: RenderState, mesh: Mesh) -> torch.Tensor:
    """The whole (H, W, 3) accumulator on every rank, from the row blocks
    of render_pass_sharded: one all_reduce of a zero image that holds this
    rank's rows (the first rank of each tile contributes them). The
    counterpart of fetching a sharded JAX array."""
    if not dist.is_initialized():
        return state.accum
    rows = state.accum.shape[0]
    full = state.accum.new_zeros((rows * mesh.n_tiles,)
                                 + tuple(state.accum.shape[1:]))
    if mesh.spp_id == 0:
        full[mesh.tile * rows:(mesh.tile + 1) * rows] = state.accum
    dist.all_reduce(full)
    return full


# ---------------------------------------------------------------------------
# Ranks of one machine as processes
# ---------------------------------------------------------------------------


def _rank_main(fn, args, rank, world_size, init_method, backend, device,
               timeout_s, out):
    """Body of a process of spawn_ranks: join the group, run fn(*args),
    save its result (or the traceback) to `out`."""
    device = resolve_device(device)
    local = rank % torch.cuda.device_count() if device.type == "cuda" \
        else rank
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world_size),
                      LOCAL_RANK=str(local))
    if device.type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    try:
        init_distributed(backend, device, init_method=init_method,
                         timeout_s=timeout_s)
        result = fn(*args)
        dist.barrier()
    except Exception:
        torch.save({"error": traceback.format_exc()}, out)
        os._exit(1)   # a peer may hold a collective open: do not wait on it
    torch.save({"result": result}, out)
    dist.destroy_process_group()


def spawn_ranks(fn, world_size: int, *args, backend: str | None = None,
                device=None, timeout_s: float = 600.0) -> list:
    """Run fn(*args) in world_size new processes (the spawn start method)
    joined in one process group through a file store, and return what each
    rank's fn returned, in rank order. fn must be importable (a module's
    top-level function). The ranks take the cards in turn (two ranks share
    a card when there is one; NCCL refuses that, gloo does not). A rank
    that raises, or a run longer than timeout_s, kills every rank and
    raises RuntimeError with the failing rank's traceback."""
    device = resolve_device(device)
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        init_method = "file://" + os.path.join(tmp, "store")
        outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(world_size)]
        procs = [ctx.Process(target=_rank_main, args=(
            fn, args, r, world_size, init_method, backend, str(device),
            timeout_s, outs[r])) for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            while any(p.is_alive() for p in procs):
                if time.monotonic() > deadline or any(
                        p.exitcode not in (None, 0) for p in procs):
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        saved = [torch.load(o, map_location="cpu", weights_only=False)
                 if os.path.exists(o) else {} for o in outs]
    errors = [f"rank {r}: {s['error']}" for r, s in enumerate(saved)
              if "error" in s]
    if errors or any(p.exitcode != 0 for p in procs):
        codes = [p.exitcode for p in procs]
        raise RuntimeError(
            f"spawn_ranks: exit codes {codes}"
            + ("" if errors else f" (no traceback: killed after "
               f"{timeout_s:g} s or by a signal)") + "\n" + "\n".join(errors))
    return [s["result"] for s in saved]
