"""PyTorch port, the forward bounce's shading halves (ops/shade.py): which
path _bounce takes, and on the card csrc/shade.cu's two kernels against
the plain versions.

CPU: use_kernels takes the kernels only for a CUDA device with autograd
recording nothing; a CPU render and a material gradient run the plain
halves (shade_fused_lanes 0, no launch), and even on a card the gradient
would (the predicate given a CUDA device says no there, yes in a render,
whose image through the wrappers is unchanged); the wrappers equal the
plain halves on CPU tensors; the random lanes of the card tests reach
every lobe and medium; probes/shade_kernels.py's agreement, which
chip_smoke.py fails on, passes the plain halves against themselves and
fails a NEE without its MIS weight or a throughput off by 1e-3; `shade`
is a registered kernel built with -fmad=false.

Card (marked `cuda`, skipped without one): shade_bsdf and shade_nee
against shade_bsdf_plain and shade_nee_plain on random materials (every
lobe and medium, metallic and transmission at 0 / 1 / between, ior
1.0-2.4, roughness down to 0, anisotropic) at R = 0, 1, 129 and 131,072
lanes: the in-kernel uniforms bit-equal to rand01, the lobe pick, alive
and med_sampled equal on at least 99.99% of the lanes, and on those lanes
every value within close_ill_conditioned (tests/test_torch_sampling.py:
1e-5, all but 0.2% of the values; the rest 1e-4); whole render_pass calls
of small frames, kernels against the plain halves on the card, within the
benchmark's `correct` limits, with shade_fused_lanes equal to bounce_lanes;
a material gradient on the card that launches neither kernel.
This file imports nothing of the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_shade.py
"""

import numpy as np
import pytest
import torch

from opengl_ray_tracing_framework_tpu_torch import (
    Camera, RenderConfig, build_test_scene)
from opengl_ray_tracing_framework_tpu_torch.models.hdr import (
    make_gradient_hdr)
from opengl_ray_tracing_framework_tpu_torch.models.material import (
    MEDIUM_ABSORB, MEDIUM_EMISSIVE, MEDIUM_SCATTER, Material,
    preset_materials)
from opengl_ray_tracing_framework_tpu_torch.ops import disney
from opengl_ray_tracing_framework_tpu_torch.ops import shade
from opengl_ray_tracing_framework_tpu_torch.ops.microfacet import (
    disney_fresnel, spec_and_sheen_color)
from opengl_ray_tracing_framework_tpu_torch.ops.sampling import (
    _dot, cranley_patterson, onb, rand01, sample_ggx_vndf, sobol_all_dims,
    sobol_bounce_uv, to_local)
from opengl_ray_tracing_framework_tpu_torch.parallel.autodiff import (
    material_grad)
from opengl_ray_tracing_framework_tpu_torch.probes.shade_kernels import (
    agreement, random_lanes)
from opengl_ray_tracing_framework_tpu_torch.render import (
    init_render_state, render_pass)
from opengl_ray_tracing_framework_tpu_torch.utils import nvcc, timing

LANES = [0, 1, 129, 131072]
ATOL = RTOL = 1e-5
# bounce, frame: bounce 5 takes Sobol dimensions (10, 11) mod 8
CASES = [(0, 1), (5, 1000003)]
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


def _bsdf_args(x, b, frame, device):
    return (b, frame, sobol_all_dims(frame, device=device), x["pid"],
            x["mat"], x["v"], x["n"], x["hit_point"], x["direction"], x["t"],
            x["history"], x["lo"])


def _nee_args(x, lo, mis):
    return (x["mat"], x["v"], x["n"], x["l_dir"], x["light_pdf"],
            x["light_fr"], x["facing"], x["shadow_hit"], x["history"], lo,
            mis)


def plain_lobes(x, b, frame):
    """The lobe shade_bsdf_plain's disney_sample picks on each lane (0
    diffuse, 1 clearcoat, 2 reflection, 3 refraction), from its own
    functions."""
    mat, v_world, n, pid = x["mat"], x["v"], x["n"], x["pid"]
    u, vv = sobol_bounce_uv(sobol_all_dims(frame, device=n.device), b)
    r1 = cranley_patterson(u, rand01(pid, frame, 8 * b + 2))
    r2 = cranley_patterson(vv, rand01(pid, frame, 8 * b + 3))
    r3 = rand01(pid, frame, 8 * b + 4)
    eta = disney._eta_of(mat, v_world, n)
    t, bt = onb(n)
    v = to_local(t, bt, n, v_world)
    spec_col, _ = spec_and_sheen_color(mat.base_color, mat.specular_tint,
                                       mat.sheen_tint, mat.metallic, eta)
    fresnel = disney_fresnel(mat.metallic, eta, v[..., 2], v[..., 2])
    w_diff, _, _, w_coat = disney.lobe_weights(mat, eta, spec_col, fresnel)
    cdf1 = w_diff + w_coat
    r1_s = (r1 - cdf1) / torch.clamp(1.0 - cdf1, min=1e-6)
    ax, ay = mat.alpha_xy()
    h = sample_ggx_vndf(v, ax, ay, torch.clamp(r1_s, 0.0, 1.0), r2)
    h = torch.where((h[..., 2] < 0.0)[..., None], -h, h)
    vdoth = _dot(v, h)
    f_pick = 1.0 - ((1.0 - disney_fresnel(mat.metallic, eta, vdoth, vdoth))
                    * mat.transmission * (1.0 - mat.metallic))
    spec = torch.where(r3 < f_pick, 2, 3)
    return torch.where(r1 < w_diff, 0, torch.where(r1 < cdf1, 1, spec)) \
        .to(torch.int8)


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
    launches = shade.shade_bsdf.launches, shade.shade_nee.launches
    with timing.tracing("cpu") as rec:
        render_pass(scene, cam, init_render_state(config, "cpu"), config)
    assert rec.counters["bounce_lanes"] > 0
    assert rec.counters["shade_fused_lanes"] == 0
    assert (shade.shade_bsdf.launches, shade.shade_nee.launches) == launches


def _as_if_on_a_card(monkeypatch):
    """Record what the wrappers' use_kernels would answer if their lanes
    lay on a card; returns the list of those answers. The wrappers still
    get the answer for the lanes' own device, so on CPU tensors they run
    the plain halves."""
    answers = []
    real = shade.use_kernels

    def spy(device, tensors):
        answers.append(real(torch.device("cuda"), tensors))
        return real(device, tensors)

    monkeypatch.setattr(shade, "use_kernels", spy)
    return answers


def test_a_card_render_would_take_the_kernels(monkeypatch):
    """With the predicate told of a card, a forward pass takes the
    wrappers at every bounce, and on CPU tensors they give the plain
    image bit for bit."""
    scene, cam = _scene(preset_materials()["tear_glass_emissive"], "cpu")
    config = RenderConfig(width=32, height=16, max_bounce=3)
    want = render_pass(scene, cam, init_render_state(config, "cpu"),
                       config).accum
    answers = _as_if_on_a_card(monkeypatch)
    got = render_pass(scene, cam, init_render_state(config, "cpu"),
                      config).accum
    assert answers and all(answers)
    assert torch.equal(got, want)


def test_material_grad_bypasses_the_kernels(monkeypatch):
    """The materials require grad: even as if on a card, every bounce runs
    the plain halves, shade_fused_lanes stays 0 and the gradients are the
    ones the plain path gives."""
    scene, cam = _scene(preset_materials()["tear_glass"], "cpu")
    config = RenderConfig(width=16, height=8, max_bounce=2)
    target = torch.rand((8, 16, 3), generator=torch.Generator().manual_seed(5))
    loss0, grads0 = material_grad(scene, cam, target, config)
    answers = _as_if_on_a_card(monkeypatch)
    with timing.tracing("cpu") as rec:
        loss, grads = material_grad(scene, cam, target, config)
    assert answers and not any(answers)
    assert rec.counters["bounce_lanes"] > 0
    assert rec.counters["shade_fused_lanes"] == 0
    assert torch.equal(loss, loss0)
    for g, g0 in zip(grads.mat, grads0.mat):
        assert (g is None and g0 is None) or torch.equal(g, g0)


def test_wrappers_run_the_plain_halves_on_cpu():
    x = random_lanes(512, 3, "cpu")
    want = shade.shade_bsdf_plain(*_bsdf_args(x, 2, 7, "cpu"))
    got = shade.shade_bsdf(*_bsdf_args(x, 2, 7, "cpu"))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for mis in (True, False):
        assert torch.equal(shade.shade_nee(*_nee_args(x, want.lo, mis)),
                           shade.shade_nee_plain(*_nee_args(x, want.lo, mis)))
    with pytest.raises(NotImplementedError):   # the probes are the kernel's
        shade.shade_bsdf(*_bsdf_args(x, 2, 7, "cpu"), probes=True)


def test_random_lanes_reach_every_lobe_and_medium():
    x = random_lanes(4096, 11, "cpu")
    b, frame = 0, 1
    half = shade.shade_bsdf_plain(*_bsdf_args(x, b, frame, "cpu"))
    lobes = plain_lobes(x, b, frame)
    assert set(lobes.tolist()) == {0, 1, 2, 3}
    refracted = half.alive & (lobes == 3)
    medium = x["mat"].medium_type
    for kind in (MEDIUM_ABSORB, MEDIUM_EMISSIVE, MEDIUM_SCATTER):
        assert (refracted & (medium == kind)).sum() > 10, kind
    assert 0 < half.med_sampled.sum() < (refracted & (medium == 2)).sum()
    assert 0 < (~half.alive).sum() < 0.2 * half.alive.numel()
    assert (x["mat"].roughness == 0).any() and (x["mat"].metallic == 1).any()


def test_agreement_fails_a_wrong_kernel():
    """The limits chip_smoke.py holds the kernels to at 131,072 lanes:
    the plain halves against themselves are within them and bit-equal; a
    NEE that drops its MIS weight, or a throughput off by 1e-3 on 1% of
    the lanes, is not; a NaN agrees only with a NaN."""
    x = random_lanes(4096, 5, "cpu")
    half = shade.shade_bsdf_plain(*_bsdf_args(x, 1, 9, "cpu"))
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


@pytest.mark.cuda
@pytest.mark.parametrize("r", LANES)
def test_shade_bsdf_equals_plain(card, r):
    for k, (b, frame) in enumerate(CASES):
        x = random_lanes(r, 100 * r + k, card)
        args = _bsdf_args(x, b, frame, card)
        want = shade.shade_bsdf_plain(*args)
        launches = shade.shade_bsdf.launches
        got, lobe, uniforms = shade.shade_bsdf(*args, probes=True)
        torch.cuda.synchronize()
        assert shade.shade_bsdf.launches == launches + 1
        for j, salt in enumerate((2, 3, 4)):
            assert torch.equal(uniforms[:, j].view(torch.int32), rand01(
                x["pid"], frame, 8 * b + salt).view(torch.int32))
        same = ((lobe == plain_lobes(x, b, frame))
                & (got.alive == want.alive)
                & (got.med_sampled == want.med_sampled))
        if r:
            assert same.float().mean() >= 0.9999, same.float().mean()
        for name in ("lo", "history", "origin", "direction", "pdf_for_mis"):
            g, w = getattr(got, name), getattr(want, name)
            assert g.shape == w.shape and g.dtype == w.dtype, name
            close_ill_conditioned(g[same], w[same])


@pytest.mark.cuda
@pytest.mark.parametrize("r", LANES)
@pytest.mark.parametrize("mis", [True, False])
def test_shade_nee_equals_plain(card, r, mis):
    x = random_lanes(r, 7 * r + mis, card)
    launches = shade.shade_nee.launches
    got = shade.shade_nee(*_nee_args(x, x["lo"], mis))
    want = shade.shade_nee_plain(*_nee_args(x, x["lo"], mis))
    torch.cuda.synchronize()
    assert shade.shade_nee.launches == launches + 1
    assert got.shape == (r, 3)
    close_ill_conditioned(got, want)


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
    launches = shade.shade_bsdf.launches, shade.shade_nee.launches
    with timing.tracing(card) as rec:
        fused = render_pass(scene, cam, init_render_state(config, card),
                            config).accum
    assert rec.counters["shade_fused_lanes"] == rec.counters["bounce_lanes"]
    assert rec.counters["bounce_lanes"] > 0
    assert shade.shade_bsdf.launches - launches[0] == rec.counters["bounces"]
    assert shade.shade_nee.launches - launches[1] == rec.counters["bounces"]
    monkeypatch.setattr(shade, "use_kernels", lambda *args: False)
    with timing.tracing(card) as rec:
        plain = render_pass(scene, cam, init_render_state(config, card),
                            config).accum
    assert rec.counters["shade_fused_lanes"] == 0
    values_off, mean_gap = _gap(fused, plain)
    assert values_off <= 0.03 and mean_gap <= 0.004, (values_off, mean_gap)


@pytest.mark.cuda
def test_material_grad_on_the_card_bypasses_the_kernels(card):
    scene, cam = _scene(preset_materials()["tear_glass"], card)
    config = RenderConfig(width=64, height=32, max_bounce=3)
    target = torch.rand((32, 64, 3), device=card)
    launches = shade.shade_bsdf.launches, shade.shade_nee.launches
    with timing.tracing(card) as rec:
        loss, _ = material_grad(scene, cam, target, config)
    assert torch.isfinite(loss)
    assert rec.counters["bounce_lanes"] > 0
    assert rec.counters["shade_fused_lanes"] == 0
    assert (shade.shade_bsdf.launches, shade.shade_nee.launches) == launches
