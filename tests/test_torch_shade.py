"""PyTorch port, the forward bounce's shading at its three sites
(ops/shade.py): which path _bounce takes, and on the card csrc/shade.cu's
three kernels against the plain versions.

CPU: use_kernels takes the kernels only for a CUDA device with autograd
recording nothing; _bounce takes them only where it also holds and the env
map is sampled at its nearest texels, so a CPU render, a material gradient
(even as if on a card), env_bilinear and a render without the env map run
the plain code (the counters shade_light_lanes / shade_fused_lanes /
shade_env_lanes 0, no launch); told of a card, a forward render takes the
kernels' branch at every bounce, whose wrappers on CPU tensors give the
plain image bit for bit; the wrappers equal the plain versions on CPU
tensors; the packed material table holds every field of MaterialTable,
follows a replace_material edit, and a lane's material read by its id
(SceneData.material_ids) is material_of's; the argument blocks have the
sizes of csrc/shade.cu's structures and _declare refuses a library whose
blocks or material columns differ; the random lanes of the card tests
reach every lobe and medium; probes/shade_kernels.py's agreement, which
chip_smoke.py fails on, passes the plain versions against themselves and
fails a NEE without its MIS weight or a throughput off by 1e-3; `shade` is
a registered kernel built with -fmad=false.

Card (marked `cuda`, skipped without one): shade_light, shade_bsdf and
shade_env against shade_light_plain (surface_attributes + light_sample),
shade_bsdf_plain and shade_env_plain (shade_nee_plain + env_pickup, MIS on
and off, on miss, hit and phase-sampled lanes) on probes/shade_kernels.py's
random lanes (hits on random triangles, random materials read by id, a
random environment) at R = 0, 1, 129 and 131,072 lanes: shade_bsdf's
in-kernel uniforms bit-equal to rand01; the decisions (facing, the
material id and the light sample's texel; the lobe pick, alive and
med_sampled; the miss texel) equal on at least 99.99% of the lanes, and on
those lanes every value within close_ill_conditioned
(tests/test_torch_sampling.py: 1e-5, all but 0.2% of the values; the rest
1e-4); whole render_pass calls of small frames, kernels against the plain
code on the card, within the benchmark's `correct` limits, with each
kernel's lanes equal to bounce_lanes and one launch of each a bounce; a
material gradient on the card that launches none of them.
This file imports nothing of the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_shade.py
"""

import ctypes
import types

import numpy as np
import pytest
import torch

from opengl_ray_tracing_framework_tpu_torch import (
    Camera, RenderConfig, build_test_scene)
from opengl_ray_tracing_framework_tpu_torch.models.hdr import (
    make_gradient_hdr)
from opengl_ray_tracing_framework_tpu_torch.models.material import (
    MEDIUM_ABSORB, MEDIUM_EMISSIVE, MEDIUM_SCATTER, PACKED_COLUMNS,
    PACKED_WIDTH, Material, MaterialTable, preset_materials)
from opengl_ray_tracing_framework_tpu_torch.ops import integrator, shade
from opengl_ray_tracing_framework_tpu_torch.ops.sampling import rand01
from opengl_ray_tracing_framework_tpu_torch.parallel.autodiff import (
    material_grad)
from opengl_ray_tracing_framework_tpu_torch.probes.shade_kernels import (
    agreement, bsdf_args, bsdf_plain_args, env_args, light_args,
    light_texels, miss_texels, plain_lobes, random_lanes)
from opengl_ray_tracing_framework_tpu_torch.render import (
    init_render_state, render_pass)
from opengl_ray_tracing_framework_tpu_torch.utils import nvcc, timing

LANES = [0, 1, 129, 131072]
ATOL = RTOL = 1e-5
DECIDED = 0.9999
# bounce, frame: bounce 5 takes Sobol dimensions (10, 11) mod 8
CASES = [(0, 1), (5, 1000003)]
KERNELS = ("shade_light", "shade_bsdf", "shade_env")
COUNTERS = ("shade_light_lanes", "shade_fused_lanes", "shade_env_lanes")
SCATTER_GLASS = Material.make(
    base_color=(1.0, 1.0, 1.0), medium_type=MEDIUM_SCATTER,
    medium_color=(0.8, 0.5, 0.3), medium_density=1.5, medium_anisotropy=0.3,
    specular=1.0, transmission=0.9, ior=1.45, roughness=0.1)


def close_ill_conditioned(got, want, share=2e-3, rtol_tail=1e-4):
    """tests/test_torch_sampling.py's: within 1e-5 on all but `share` of
    the elements, those within rtol_tail."""
    got, want = got.cpu().numpy(), want.cpu().numpy()
    off = ~np.isclose(got, want, rtol=RTOL, atol=ATOL)
    assert off.sum() <= share * off.size, f"{off.sum()} of {off.size} off"
    np.testing.assert_allclose(got, want, rtol=rtol_tail, atol=ATOL)


def _nee_args(x, lo, mis):
    return (x["mat"], x["v"], x["n"], x["l_dir"], x["light_pdf"],
            x["light_fr"], x["facing"], x["shadow_hit"], x["history"], lo,
            mis)


def _launches():
    return tuple(getattr(shade, k).launches for k in KERNELS)


def _scene(material, device):
    _, scene = build_test_scene(2, material=material,
                                env=make_gradient_hdr(128, 64), device=device)
    cam = Camera.make(position=(0.0, 0.5, -2.0), yaw=90.0, pitch=-8.0,
                      zoom=30.0, aspect=2.0, device=device)
    return scene, cam


# CPU: the dispatch


def test_use_kernels_only_on_cuda_with_autograd_off():
    plain = torch.ones(4)
    leaf = torch.ones(4, requires_grad=True)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert not shade.use_kernels(cpu, (plain,))
    assert not shade.use_kernels("cpu", (plain,))
    assert shade.use_kernels(cuda, (plain, plain))
    assert shade.use_kernels("cuda:0", (plain,))
    assert not shade.use_kernels(cuda, (plain, leaf))
    assert not shade.use_kernels(cuda, (plain, leaf * 2.0))
    with torch.no_grad():
        assert shade.use_kernels(cuda, (plain, leaf))
        assert not shade.use_kernels(cpu, (plain, leaf))


def test_cpu_render_runs_the_plain_halves():
    scene, cam = _scene(preset_materials()["tear_glass"], "cpu")
    config = RenderConfig(width=32, height=16, max_bounce=3)
    launches = _launches()
    with timing.tracing("cpu") as rec:
        render_pass(scene, cam, init_render_state(config, "cpu"), config)
    assert rec.counters["bounce_lanes"] > 0
    assert all(rec.counters[k] == 0 for k in COUNTERS)
    assert _launches() == launches


def _as_if_on_a_card(monkeypatch, decide=False):
    """Record what use_kernels would answer if the lanes lay on a card;
    returns the list of those answers. With decide=False _bounce gets the
    answer for the lanes' own device (the plain code on CPU tensors); with
    decide=True it gets the card's, so it takes the kernels' branch, whose
    wrappers still run the plain versions on CPU tensors."""
    answers = []
    real = shade.use_kernels

    def spy(device, tensors):
        answers.append(real(torch.device("cuda"), tensors))
        return answers[-1] if decide else real(device, tensors)

    monkeypatch.setattr(shade, "use_kernels", spy)
    return answers


def _count_kernel_bounces(monkeypatch):
    """Count the bounces _bounce hands to its kernels' branch."""
    calls = []
    real = integrator._bounce_kernels

    def spy(*args):
        calls.append(1)
        return real(*args)

    monkeypatch.setattr(integrator, "_bounce_kernels", spy)
    return calls


def test_a_card_render_would_take_the_kernels(monkeypatch):
    """Told of a card, a forward pass takes the kernels' branch at every
    bounce, and on CPU tensors its wrappers give the plain image bit for
    bit."""
    scene, cam = _scene(preset_materials()["tear_glass_emissive"], "cpu")
    config = RenderConfig(width=32, height=16, max_bounce=3)
    want = render_pass(scene, cam, init_render_state(config, "cpu"),
                       config).accum
    answers = _as_if_on_a_card(monkeypatch, decide=True)
    calls = _count_kernel_bounces(monkeypatch)
    with timing.tracing("cpu") as rec:
        got = render_pass(scene, cam, init_render_state(config, "cpu"),
                          config).accum
    assert answers and all(answers)
    assert len(calls) == rec.counters["bounces"] > 0
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", ["cpu", "autograd", "env_bilinear",
                                  "no_env_map"])
def test_bounce_takes_the_plain_code(monkeypatch, case):
    """The plain code, not the kernels' branch: on the CPU; and even as if
    on a card, under autograd (a material gradient), with bilinear env
    fetches and without the env map."""
    scene, cam = _scene(preset_materials()["tear_glass"], "cpu")
    config = RenderConfig(width=16, height=8, max_bounce=2,
                          env_bilinear=case == "env_bilinear",
                          enable_env_map=case != "no_env_map")
    if case != "cpu":
        _as_if_on_a_card(monkeypatch, decide=True)
    calls = _count_kernel_bounces(monkeypatch)
    with timing.tracing("cpu") as rec:
        if case == "autograd":
            target = torch.rand((8, 16, 3),
                                generator=torch.Generator().manual_seed(2))
            material_grad(scene, cam, target, config)
        else:
            render_pass(scene, cam, init_render_state(config, "cpu"), config)
    assert rec.counters["bounces"] > 0
    assert calls == []


def test_material_grad_bypasses_the_kernels(monkeypatch):
    """The materials require grad: even as if on a card, every bounce runs
    the plain code, the kernels' counters stay 0 and the gradients are the
    ones the plain path gives."""
    scene, cam = _scene(preset_materials()["tear_glass"], "cpu")
    config = RenderConfig(width=16, height=8, max_bounce=2)
    target = torch.rand((8, 16, 3), generator=torch.Generator().manual_seed(5))
    loss0, grads0 = material_grad(scene, cam, target, config)
    answers = _as_if_on_a_card(monkeypatch, decide=True)
    with timing.tracing("cpu") as rec:
        loss, grads = material_grad(scene, cam, target, config)
    assert answers and not any(answers)
    assert rec.counters["bounce_lanes"] > 0
    assert all(rec.counters[k] == 0 for k in COUNTERS)
    assert torch.equal(loss, loss0)
    for g, g0 in zip(grads.mat, grads0.mat):
        assert (g is None and g0 is None) or torch.equal(g, g0)


def test_wrappers_run_the_plain_halves_on_cpu():
    x = random_lanes(512, 3, "cpu")
    for g, w in zip(shade.shade_light(*light_args(x, 2, 7)),
                    shade.shade_light_plain(*light_args(x, 2, 7))):
        assert torch.equal(g, w)
    want = shade.shade_bsdf_plain(*bsdf_plain_args(x, 2, 7))
    got = shade.shade_bsdf(*bsdf_args(x, 2, 7))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for mis in (True, False):
        config = x["config"].replace(enable_mis=mis)
        assert torch.equal(shade.shade_env(*env_args(x, config)),
                           shade.shade_env_plain(*env_args(x, config)))
    with pytest.raises(NotImplementedError):   # the probes are the kernel's
        shade.shade_bsdf(*bsdf_args(x, 2, 7), probes=True)
    with pytest.raises(NotImplementedError):
        shade.shade_env(*env_args(x), probes=True)


def test_packed_table_holds_every_field():
    """MaterialTable.packed: every field in PACKED_COLUMNS' columns,
    medium_type exact, packed once per table; replace_material's new
    table packs the edit and leaves the old one's as it was; a material
    read by SceneData.material_ids is material_of's, for hits, misses and
    ids past the table."""
    presets = list(preset_materials().values())
    table = MaterialTable.stack(presets)
    packed = table.packed
    assert packed.shape == (len(presets), PACKED_WIDTH)
    assert packed.dtype == torch.float32 and packed.is_contiguous()
    assert table.packed is packed
    stops = list(PACKED_COLUMNS.values())[1:] + [PACKED_WIDTH]
    for (name, lo), hi in zip(PACKED_COLUMNS.items(), stops):
        want = getattr(table.mat, name)
        got = packed[:, lo:hi].reshape(want.shape)
        if name == "medium_type":
            assert torch.equal(got.to(torch.int32), want)
            assert torch.equal(got, want.to(torch.float32))
        else:
            assert torch.equal(got, want), name
    assert set(table.mat.medium_type.tolist()) == {0, 1, 3}
    edited = table.replace_material(2, SCATTER_GLASS)
    col = PACKED_COLUMNS["medium_anisotropy"]
    assert float(edited.packed[2, col]) == pytest.approx(0.3)
    assert int(edited.packed[2, PACKED_COLUMNS["medium_type"]]) \
        == MEDIUM_SCATTER
    assert torch.equal(table.packed, packed)
    assert torch.equal(edited.packed[[0, 1, 3]], packed[[0, 1, 3]])

    scene, _ = _scene(preset_materials()["jade"], "cpu")
    tri = torch.tensor([-1, 0, 5, scene.n_triangles - 1, scene.n_triangles,
                        10**6], dtype=torch.int32)
    ids = scene.material_ids(tri)
    assert ids.dtype == torch.int32
    for g, w in zip(scene.materials.gather(ids), scene.material_of(tri)):
        assert torch.equal(g, w)
    past = scene.with_materials(MaterialTable.stack(presets[:1]))
    assert past.material_ids(tri).tolist() == [0] * len(tri)


def _fake_lib(sizes=None, cols=None, width=PACKED_WIDTH):
    """A stand-in for a loaded csrc/shade.cu: its argument blocks' sizes
    and its material columns as given (ops/shade.py's by default)."""
    sizes = dict({k: ctypes.sizeof(a) for k, a in shade._ARGS.items()},
                 **(sizes or {}))
    cols = list(PACKED_COLUMNS.values()) if cols is None else cols

    def columns(out):
        for k, c in enumerate(cols):
            out[k] = c
        return width

    lib = types.SimpleNamespace(shade_threads=lambda: 128,
                                shade_material_columns=columns)
    for k in shade._ARGS:
        setattr(lib, f"{k}_args_bytes", lambda n=sizes[k]: n)
        setattr(lib, f"{k}_launch", lambda *args: 0)
    return lib


def test_argument_blocks_match_shade_cu():
    """The ctypes blocks have csrc/shade.cu's layouts (SceneTabs: 5
    pointers, an int64 and 3 ints; LightArgs: it, 13 pointers, 3 ints;
    BsdfArgs: 19 pointers, 4 ints; EnvArgs: SceneTabs, 18 pointers, 2
    ints), and _declare refuses a library whose blocks or material columns
    differ."""
    assert ctypes.sizeof(shade._SceneTabs) == 64
    assert ctypes.sizeof(shade._LightArgs) == 64 + 13 * 8 + 3 * 4 + 4
    assert ctypes.sizeof(shade._BsdfArgs) == 19 * 8 + 4 * 4
    assert ctypes.sizeof(shade._EnvArgs) == 64 + 18 * 8 + 2 * 4
    lib = _fake_lib()
    assert shade._declare(lib) is lib
    for name in shade._ARGS:
        with pytest.raises(RuntimeError, match=name):
            shade._declare(_fake_lib(
                {name: ctypes.sizeof(shade._ARGS[name]) - 8}))
    cols = list(PACKED_COLUMNS.values())
    cols[3] += 1
    with pytest.raises(RuntimeError, match="columns"):
        shade._declare(_fake_lib(cols=cols))
    with pytest.raises(RuntimeError, match="columns"):
        shade._declare(_fake_lib(width=PACKED_WIDTH + 1))


def test_random_lanes_reach_every_lobe_and_medium():
    x = random_lanes(4096, 11, "cpu")
    b, frame = 0, 1
    half = shade.shade_bsdf_plain(*bsdf_plain_args(x, b, frame))
    lobes = plain_lobes(x, b, frame)
    assert set(lobes.tolist()) == {0, 1, 2, 3}
    refracted = half.alive & (lobes == 3)
    medium = x["mat"].medium_type
    for kind in (MEDIUM_ABSORB, MEDIUM_EMISSIVE, MEDIUM_SCATTER):
        assert (refracted & (medium == kind)).sum() > 10, kind
    assert 0 < half.med_sampled.sum() < (refracted & (medium == 2)).sum()
    assert 0 < (~half.alive).sum() < 0.2 * half.alive.numel()
    assert (x["mat"].roughness == 0).any() and (x["mat"].metallic == 1).any()
    h = x["half"]
    for lanes in (h.alive & (x["nxt_tri"] < 0), h.alive & (x["nxt_tri"] >= 0),
                  h.med_sampled & (x["nxt_tri"] < 0),
                  x["facing"] & ~x["shadow_hit"]):
        assert lanes.sum() > 100
    assert (x["mat"].emissive.sum(1) > 0).float().mean() > 0.2
    assert (x["tri"] < 0).any()


def test_agreement_fails_a_wrong_kernel():
    """The limits chip_smoke.py holds the kernels to at 131,072 lanes:
    the plain versions against themselves are within them and bit-equal; a
    NEE that drops its MIS weight, or a throughput off by 1e-3 on 1% of
    the lanes, is not; a NaN agrees only with a NaN."""
    x = random_lanes(4096, 5, "cpu")
    half = shade.shade_bsdf_plain(*bsdf_plain_args(x, 1, 9))
    every = torch.ones(4096, dtype=torch.bool)
    same = agreement([(g, g.clone()) for g in half
                      if g.dtype == torch.float32], every)
    assert same["values_off_share"] == same["values_off_tail"] == 0
    assert same["lanes_bit_equal"] == 1.0 and same["max_abs_err"] == 0.0
    nee = shade.shade_nee_plain(*_nee_args(x, half.lo, True))
    no_mis = shade.shade_nee_plain(*_nee_args(x, half.lo, False))
    dropped = agreement([(no_mis, nee)], every)
    assert dropped["values_off_tail"] > 0 and dropped["max_abs_err"] > 1e-3
    history = half.history.clone()
    history[::100] += 1e-3
    off = agreement([(history, half.history)], every)
    assert 0 < off["values_off_tail"] and off["lanes_bit_equal"] < 1.0
    assert abs(off["max_abs_err"] - 1e-3) < 1e-4
    nan = torch.tensor([[float("nan")], [1.0]])
    assert agreement([(nan, nan)], every[:2])["values_off_tail"] == 0
    assert agreement([(nan, nan.nan_to_num())],
                     every[:2])["values_off_tail"] == 1
    assert agreement([(nan, 2 * nan)], torch.tensor([True, False]))[
        "lanes_bit_equal"] == 0.5


def test_shade_kernel_is_registered():
    assert "shade" in nvcc.KERNELS
    assert nvcc.FLAGS["shade"] == ("-fmad=false",)
    assert nvcc.library_path("shade").name.startswith("shade_")
    launch = nvcc.KERNELS["shade"][1](torch.device("cpu"))
    lo = launch()
    assert lo.shape == (256, 3) and torch.isfinite(lo).all()


# The card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: csrc/shade.cu is CUDA C++ and has "
                    "no interpreted mode")
    return torch.device("cuda")


def _decided(same, r):
    if r:
        assert same.float().mean() >= DECIDED, same.float().mean()


@pytest.mark.cuda
@pytest.mark.parametrize("r", LANES)
def test_shade_light_equals_plain(card, r):
    for k, (b, frame) in enumerate(CASES):
        x = random_lanes(r, 300 * r + k, card)
        launches = shade.shade_light.launches
        got = shade.shade_light(*light_args(x, b, frame))
        want = shade.shade_light_plain(*light_args(x, b, frame))
        torch.cuda.synchronize()
        assert shade.shade_light.launches == launches + 1
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == w.dtype
        # the light sample's texel is rand01's: one texel, one radiance
        texel = light_texels(x, b, frame)
        assert torch.equal(got.light_fr, x["scene"].env_fetch[texel, 7:10]
                           * x["scene"].env_intensity)
        same = ((got.facing == want.facing) & (got.mat_id == want.mat_id)
                & (got.light_fr == want.light_fr).all(1))
        _decided(same, r)
        for name in ("hit_point", "n", "l_dir", "light_pdf", "light_fr"):
            close_ill_conditioned(getattr(got, name)[same],
                                  getattr(want, name)[same])


@pytest.mark.cuda
@pytest.mark.parametrize("r", LANES)
def test_shade_bsdf_equals_plain(card, r):
    for k, (b, frame) in enumerate(CASES):
        x = random_lanes(r, 100 * r + k, card)
        want = shade.shade_bsdf_plain(*bsdf_plain_args(x, b, frame))
        launches = shade.shade_bsdf.launches
        got, lobe, uniforms = shade.shade_bsdf(*bsdf_args(x, b, frame),
                                               probes=True)
        torch.cuda.synchronize()
        assert shade.shade_bsdf.launches == launches + 1
        for j, salt in enumerate((2, 3, 4)):
            assert torch.equal(uniforms[:, j].view(torch.int32), rand01(
                x["pid"], frame, 8 * b + salt).view(torch.int32))
        same = ((lobe == plain_lobes(x, b, frame))
                & (got.alive == want.alive)
                & (got.med_sampled == want.med_sampled))
        _decided(same, r)
        for name in ("lo", "history", "origin", "direction", "pdf_for_mis"):
            g, w = getattr(got, name), getattr(want, name)
            assert g.shape == w.shape and g.dtype == w.dtype, name
            close_ill_conditioned(g[same], w[same])


@pytest.mark.cuda
@pytest.mark.parametrize("r", LANES)
@pytest.mark.parametrize("mis", [True, False])
def test_shade_env_equals_plain(card, r, mis):
    x = random_lanes(r, 7 * r + mis, card)
    config = x["config"].replace(enable_mis=mis)
    launches = shade.shade_env.launches
    got, texel = shade.shade_env(*env_args(x, config), probes=True)
    want = shade.shade_env_plain(*env_args(x, config))
    torch.cuda.synchronize()
    assert shade.shade_env.launches == launches + 1
    assert got.shape == (r, 3)
    h = x["half"]
    miss = h.alive & (x["nxt_tri"] < 0)
    same = texel.long() == torch.where(
        miss, miss_texels(x["scene"], h.direction), -1)
    _decided(same, r)
    close_ill_conditioned(got[same], want[same])


def _gap(got, want):
    """benchmark/traffic/render_pass.py's values_off and mean_gap."""
    got, want = got.double(), want.double()
    bad = ~((got - want).abs() <= 1e-3 + 1e-3 * want.abs())
    return (float(bad.double().mean()),
            float((got - want).sum().abs() / want.abs().sum().clamp(
                min=1e-30)))


@pytest.mark.cuda
@pytest.mark.parametrize("material", ["tear_glass", "jade",
                                      "tear_glass_emissive", "scatter"])
def test_render_pass_fused_equals_plain(card, material, monkeypatch):
    mat = (SCATTER_GLASS if material == "scatter"
           else preset_materials()[material])
    scene, cam = _scene(mat, card)
    config = RenderConfig(width=128, height=64, max_bounce=8)
    launches = _launches()
    with timing.tracing(card) as rec:
        fused = render_pass(scene, cam, init_render_state(config, card),
                            config).accum
    assert rec.counters["bounce_lanes"] > 0
    for name, counter, before in zip(KERNELS, COUNTERS, launches):
        assert rec.counters[counter] == rec.counters["bounce_lanes"], name
        assert getattr(shade, name).launches - before \
            == rec.counters["bounces"], name
    monkeypatch.setattr(shade, "use_kernels", lambda *args: False)
    with timing.tracing(card) as rec:
        plain = render_pass(scene, cam, init_render_state(config, card),
                            config).accum
    assert all(rec.counters[k] == 0 for k in COUNTERS)
    values_off, mean_gap = _gap(fused, plain)
    assert values_off <= 0.03 and mean_gap <= 0.004, (values_off, mean_gap)


@pytest.mark.cuda
def test_material_grad_on_the_card_bypasses_the_kernels(card):
    scene, cam = _scene(preset_materials()["tear_glass"], card)
    config = RenderConfig(width=64, height=32, max_bounce=3)
    target = torch.rand((32, 64, 3), device=card)
    launches = _launches()
    with timing.tracing(card) as rec:
        loss, _ = material_grad(scene, cam, target, config)
    assert torch.isfinite(loss)
    assert rec.counters["bounce_lanes"] > 0
    assert all(rec.counters[k] == 0 for k in COUNTERS)
    assert _launches() == launches
