"""PyTorch + CUDA port of the progressive Monte-Carlo path tracer.

A second package beside opengl_ray_tracing_framework_tpu (the JAX/Pallas
reference it is held against), for NVIDIA Hopper. It imports torch and
never jax. Layout mirrors the JAX package: models/ (host scene pipeline,
materials, camera), ops/ (shading math, environment, traversal,
integrator), render.py (the progressive render API), parallel/ (the
gradients), probes/ (measurement probes of the card), utils/ (config,
image export, the nvcc build of csrc/).

The forward render runs end to end for every value of the JAX package's
forward configuration: BSDF and legacy BRDF integrators, and four tracers
chosen by RenderConfig: the span sweep (cast_backend="sweep", the default,
kernel csrc/sweep.cu via ops/sweep.py), the vote tracer
(cast_backend="schedule", kernel csrc/cluster_intersect.cu via
ops/cluster_intersect.py and ops/schedule.py), the batched BVH traversal
(cast_backend="bvh") and the brute-force oracle (use_bvh=False). A kernel
runs on CUDA tensors; a CPU tensor gets its plain PyTorch version.

Gradients of sum((render - target)^2) with respect to the material table,
the camera pose and the triangle vertices come from torch autograd
(parallel/autodiff.py: material_grad, camera_grad, geometry_grad,
param_grad; imported from there, as in the JAX package): forward and
backward run one ray batch at a time, traversal is detached, and the
backward launches no kernel. probes/ holds the card's counterparts of the
TPU cost probes under exp/ (kernels csrc/probe_copy.cu, probe_gather.cu,
probe_smem.cu, probe_stream.cu), each runnable as
`python -m opengl_ray_tracing_framework_tpu_torch.probes.<name>`.

The entry points of the JAX package have their counterparts: cli.py (the
headless renderer, `python -m opengl_ray_tracing_framework_tpu_torch.cli`,
with checkpoint / resume through utils/checkpoint.py, whose npz files
cross between the packages, and the --timing breakdown of
utils/timing.py), bench.py (the headline rays/s bench, fwd and fwd+bwd,
run as bench_torch.py at the repository root), parallel/sharding.py (row-sharded rendering on
torch.distributed: init_distributed, make_mesh / make_mesh_2d,
replicate_scene, render_pass_sharded, gather_image) with
parallel/autodiff.py's param_grad_sharded / material_grad_sharded, and
examples/live_edit.py (edit a material, invalidate, re-render).

Constructors and entry points put their tensors on the card unless the
caller names a device (device="cpu", as the tests do).
"""

__version__ = "0.1.0"

from .models.camera import Camera, pixel_uv
from .models.material import (
    MEDIUM_ABSORB,
    MEDIUM_EMISSIVE,
    MEDIUM_NONE,
    MEDIUM_SCATTER,
    Material,
    MaterialTable,
)
from .models.scene import (
    Scene,
    SceneData,
    build_reference_scene,
    build_test_scene,
    camera_from_numpy,
    scene_from_numpy,
)
from .render import (
    RenderState,
    finalize,
    init_render_state,
    render,
    render_pass,
    render_passes,
    render_progressive,
    render_radiance,
)
from .utils.checkpoint import load_render_state, save_render_state
from .utils.config import RenderConfig

__all__ = [
    "Camera",
    "Material",
    "MaterialTable",
    "MEDIUM_NONE",
    "MEDIUM_ABSORB",
    "MEDIUM_SCATTER",
    "MEDIUM_EMISSIVE",
    "RenderConfig",
    "RenderState",
    "Scene",
    "SceneData",
    "build_reference_scene",
    "build_test_scene",
    "camera_from_numpy",
    "finalize",
    "init_render_state",
    "load_render_state",
    "pixel_uv",
    "render",
    "render_pass",
    "render_passes",
    "render_progressive",
    "render_radiance",
    "save_render_state",
    "scene_from_numpy",
    "__version__",
]
