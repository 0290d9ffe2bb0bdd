"""PyTorch port, host layer: the port's scene pipeline builds the same
arrays as the JAX package's, a JAX scene crosses into the port intact, and
the port never imports jax."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from opengl_ray_tracing_framework_tpu.models import scene as jscene
from opengl_ray_tracing_framework_tpu_torch.models import scene as tscene
from opengl_ray_tracing_framework_tpu_torch.models.material import Material

FIELDS = ("p1", "p2", "p3", "n1", "n2", "n3", "mat_idx", "tri_attr",
          "bvh_left", "bvh_right", "bvh_count", "bvh_first", "bvh_min",
          "bvh_max", "cl_aabb_min", "cl_aabb_max", "cl_trifeat",
          "cl_slot2tri", "hdr_map", "env_fetch", "hdr_cache",
          "env_intensity", "env_angle")


def jax_scene_arrays(data) -> dict:
    """A JAX SceneData as the numpy dict scene_from_numpy takes."""
    arrays = {k: np.asarray(v) for k, v in data._asdict().items()
              if k != "materials"}
    arrays["materials"] = {k: np.asarray(v) for k, v
                           in data.materials.mat._asdict().items()}
    return arrays


def jax_camera_arrays(cam) -> dict:
    return {k: np.asarray(v) for k, v in cam._asdict().items()}


def assert_same_scene(port, ref):
    for f in FIELDS:
        a = getattr(port, f).cpu().numpy()
        b = np.asarray(ref[f])
        assert a.dtype == b.dtype, (f, a.dtype, b.dtype)
        assert np.array_equal(a, b), f
    for f in Material._fields:
        a = getattr(port.materials.mat, f).cpu().numpy()
        assert np.array_equal(a, ref["materials"][f]), f


@pytest.mark.parametrize("cluster_size", [256, 8, 512, 1024, 302])
def test_scene_build_matches_jax(cluster_size):
    jsc, _ = jscene.build_test_scene(n_sphere_subdiv=2)
    tsc, _ = tscene.build_test_scene(n_sphere_subdiv=2, device="cpu")
    ref = jax_scene_arrays(jsc.build(cluster_size=cluster_size))
    port = tsc.build(cluster_size=cluster_size, device="cpu")
    assert_same_scene(port, ref)


def test_hdr_tables_match_jax():
    """A non-default environment: the 2:1 gradient map at 128x64."""
    from opengl_ray_tracing_framework_tpu.models.hdr import make_gradient_hdr
    env = make_gradient_hdr(128, 64, bright_dir=(0.3, 0.8, 0.2))
    _, jdata = jscene.build_test_scene(1, env=env)
    _, tdata = tscene.build_test_scene(1, env=env, device="cpu")
    assert_same_scene(tdata, jax_scene_arrays(jdata))


def test_scene_from_numpy_roundtrip():
    from opengl_ray_tracing_framework_tpu.models.material import (
        preset_materials as jpresets)
    from opengl_ray_tracing_framework_tpu_torch.models.material import (
        preset_materials as tpresets)
    _, jdata = jscene.build_test_scene(2, material=jpresets()["tear_glass"])
    _, tdata = tscene.build_test_scene(2, material=tpresets()["tear_glass"],
                                       device="cpu")
    ref = jax_scene_arrays(jdata)
    crossed = tscene.scene_from_numpy(ref, device="cpu")
    assert_same_scene(crossed, ref)
    assert_same_scene(tdata, ref)
    assert crossed.materials.mat.medium_type.dtype == torch.int32


def test_camera_from_numpy_rays():
    from opengl_ray_tracing_framework_tpu.models.camera import Camera as JCam
    jcam = JCam.make(position=(0.3, 0.5, -2.0), yaw=80.0, pitch=-8.0,
                     zoom=25.0, aspect=2.0)
    tcam = tscene.camera_from_numpy(jax_camera_arrays(jcam), device="cpu")
    rng = np.random.default_rng(3)
    u = rng.random(257, dtype=np.float32)
    v = rng.random(257, dtype=np.float32)
    jo, jd = jcam.generate_rays(u, v)
    to, td = tcam.generate_rays(torch.as_tensor(u), torch.as_tensor(v))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6,
                               atol=1e-6)


def test_reference_scene_missing_assets(tmp_path):
    with pytest.raises(FileNotFoundError):
        tscene.build_reference_scene(assets_dir=str(tmp_path), device="cpu")


def test_port_never_imports_jax():
    """Every module of the port (walked, so parallel/ and probes/ and
    whatever comes later are covered) and chip_smoke.py import neither jax
    nor the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import opengl_ray_tracing_framework_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "for want in ('parallel.autodiff', 'probes.launch_overhead', "
        "'probes.gather', 'probes.card_perf', 'probes.kernel_build', "
        "'cli', 'parallel.sharding', 'utils.checkpoint', 'utils.timing', "
        "'examples.live_edit'):\n"
        "    assert p.__name__ + '.' + want in names, want\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'opengl_ray_tracing_framework_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok', len(names))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[0] == "ok"


def test_entry_points_default_to_the_card():
    """Every constructor and entry point takes device=None and resolves it
    to the card; nothing tests for a GPU and carries on on the CPU."""
    import inspect

    from opengl_ray_tracing_framework_tpu_torch import (
        Camera, cli, init_render_state, load_render_state, pixel_uv)
    from opengl_ray_tracing_framework_tpu_torch.parallel import sharding
    from opengl_ray_tracing_framework_tpu_torch.utils import config

    assert config.default_device() == torch.device("cuda")
    assert config.resolve_device(None) == torch.device("cuda")
    assert config.resolve_device("cpu") == torch.device("cpu")
    assert "is_available" not in inspect.getsource(config)
    for fn in (tscene.scene_from_numpy, tscene.camera_from_numpy,
               tscene.Scene.build, tscene.build_test_scene,
               tscene.build_reference_scene, Camera.make,
               init_render_state, load_render_state, pixel_uv,
               sharding.init_distributed, sharding.spawn_ranks):
        assert inspect.signature(fn).parameters["device"].default is None, fn
    assert cli.build_parser().parse_args([]).device == "cuda"


@pytest.mark.parametrize("kw", [
    dict(enable_bsdf=False), dict(use_bvh=False), dict(cast_backend="bvh"),
    dict(cast_backend="schedule")], ids=lambda kw: "-".join(
        f"{k}={v}" for k, v in kw.items()))
def test_every_forward_config_renders(kw):
    from opengl_ray_tracing_framework_tpu_torch import Camera, RenderConfig
    from opengl_ray_tracing_framework_tpu_torch.render import render_radiance
    _, data = tscene.build_test_scene(1, device="cpu")
    cam = Camera.make(aspect=1.0, device="cpu")
    img = render_radiance(data, cam, RenderConfig(
        width=8, height=8, max_bounce=2, **kw), spp=1)
    assert img.shape == (8, 8, 3) and img.dtype == torch.float32
    assert torch.isfinite(img).all() and img.mean() > 0


def test_bad_cast_backend_is_refused():
    from opengl_ray_tracing_framework_tpu_torch import RenderConfig
    for bad in (dict(cast_backend="pallas"), dict(sched_topk=0)):
        with pytest.raises(ValueError):
            RenderConfig(**bad).validate()


def test_pixel_uv_matches_jax():
    from opengl_ray_tracing_framework_tpu.models.camera import (
        pixel_uv as jpixel_uv)
    from opengl_ray_tracing_framework_tpu_torch import pixel_uv
    for jitter in (None, np.random.default_rng(4).random(35, np.float32)):
        args = () if jitter is None else (jitter, 1.0 - jitter)
        ju, jv = jpixel_uv(7, 5, *args)
        tu, tv = pixel_uv(7, 5, *(torch.tensor(a) for a in args),
                          device="cpu")
        assert tu.dtype == torch.float32 and tu.shape == (35,)
        np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_replace_material_and_n_nodes_match_jax():
    """MaterialTable.replace_material returns a new table equal to the JAX
    one's and leaves the old one as it was; SceneData.n_nodes counts the
    BVH nodes as the JAX SceneData does."""
    from opengl_ray_tracing_framework_tpu.models.material import (
        preset_materials as jpresets)
    from opengl_ray_tracing_framework_tpu_torch.models.material import (
        preset_materials as tpresets)
    _, jdata = jscene.build_test_scene(1)
    _, tdata = tscene.build_test_scene(1, device="cpu")
    assert tdata.n_nodes == jdata.n_nodes == tdata.bvh_min.shape[0]
    before = [x.clone() for x in tdata.materials.mat]
    jnew = jdata.materials.replace_material(1, jpresets()["brown_glass"])
    tnew = tdata.materials.replace_material(1, tpresets()["brown_glass"])
    for f, a, b, old in zip(Material._fields, tnew.mat, before,
                            tdata.materials.mat):
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a.numpy(),
                                      np.asarray(getattr(jnew.mat, f)), f)
        assert torch.equal(old, b), f
    assert int(tnew.mat.medium_type[1]) == 1   # MEDIUM_ABSORB


def test_scene_objects_match_jax():
    """Scene.add_object returns a SceneObject(name, material_slot,
    n_triangles) and keeps it in Scene.objects, default names included;
    the test scene's and a hand-built scene's objects equal those of the
    JAX Scene."""
    from opengl_ray_tracing_framework_tpu.models import mesh as jmesh
    from opengl_ray_tracing_framework_tpu.models.material import (
        preset_materials as jpresets)
    from opengl_ray_tracing_framework_tpu_torch.models import mesh as tmesh
    from opengl_ray_tracing_framework_tpu_torch.models.material import (
        preset_materials as tpresets)
    jsc, _ = jscene.build_test_scene(n_sphere_subdiv=1)
    tsc, _ = tscene.build_test_scene(n_sphere_subdiv=1, device="cpu")
    assert [tuple(o) for o in tsc.objects] == [tuple(o) for o in jsc.objects]
    assert [o.name for o in tsc.objects] == ["floor", "sphere"]

    def build(scene_cls, mesh, presets):
        scene = scene_cls()
        objs = [scene.add_object(mesh.make_quad(), presets["white"]),
                scene.add_object(mesh.make_icosphere(1), presets["golden"],
                                 name="ball"),
                scene.add_object(mesh.make_icosphere(0), 1)]
        return scene, objs

    jb, jobjs = build(jscene.Scene, jmesh, jpresets())
    tb, tobjs = build(tscene.Scene, tmesh, tpresets())
    assert isinstance(tobjs[0], tscene.SceneObject)
    assert tobjs == tb.objects
    assert [tuple(o) for o in tobjs] == [tuple(o) for o in jobjs]
    assert [o.name for o in tobjs] == ["object0", "ball", "object2"]
    assert tobjs[2].material_slot == 1 and tobjs[2].n_triangles == 20


def test_triangle_gathers_match_jax():
    """SceneData.triangle_vertices / triangle_normals gather (p1, p2, p3)
    and (n1, n2, n3) of triangle ids clamped into the scene, as the JAX
    SceneData does (misses are -1, ids past the end clamp to the last)."""
    import jax.numpy as jnp
    _, jdata = jscene.build_test_scene(n_sphere_subdiv=2)
    _, tdata = tscene.build_test_scene(n_sphere_subdiv=2, device="cpu")
    n = tdata.n_triangles
    ids = np.array([-1, 0, 3, n - 1, n, n + 7, -5], np.int32)
    for name in ("triangle_vertices", "triangle_normals"):
        got = getattr(tdata, name)(torch.tensor(ids))
        want = getattr(jdata, name)(jnp.asarray(ids))
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            assert a.shape == (len(ids), 3)
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
