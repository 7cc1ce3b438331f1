"""The slice as a whole: the port's render against the JAX package's, per
pixel, on the five opaque reference scenes, and against the frozen goldens.

Both renderers draw the same uniforms (bit-identical RNG), so the images
agree pixel by pixel up to float rounding: rtol 1e-3, atol 1e-4 (the
golden tolerance of tests/test_golden.py).

Sphere scenes are compared with the JAX package run op by op
(``jax.disable_jit``). Rays leave a surface 1e-5 off it, and on a sphere
whether such a ray re-hits its own sphere turns on the last bit of the
quadratic. XLA's CPU jit contracts multiply-adds into FMAs, which flips
that decision on 2.6% (``spheres``) and 3.6% (``white_furnace_indirect``)
of the values of its own op-by-op run at this size, and adds 3.35% energy
against the scalar oracle on the ``spheres`` oracle case; the port rounds
every operation, like the op-by-op run and like the oracle. Against the
op-by-op run the port still differs where XLA's and ATen's float32
tan/acos/sin/cos differ by an ulp and push such a ray across: at most
0.5% of the values may fall outside the tolerance (measured: 1 and 3 of
2,304). For the same reason the frozen goldens of the two sphere scenes,
rendered by the jit, are not a per-pixel reference for the port; the
scalar-oracle gate holds the port there (``chip_smoke.py`` phase 5).
"""
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

GOLDEN_DIR = Path(__file__).parent / "goldens"
REPO = Path(__file__).resolve().parents[1]
W, H, SPP, BOUNCES = 32, 24, 2, 2
SPHERE_SCENES = {"spheres", "white_furnace_indirect"}
MAX_SPHERE_FLIPS = 0.005


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _port(root, name, w, h, spp, bounces):
    from path_tracer_torch.models.integrator import IntegratorSpec
    from path_tracer_torch.models.renderer import render_pixel_sums
    from path_tracer_torch.scene import load_scene

    scene = load_scene(root / name / "scene.isf", device="cpu")
    acc = render_pixel_sums(scene, w, h, 1, spp, IntegratorSpec(bounces=bounces))
    return acc / spp


def _jax(root, name, w, h, spp, bounces):
    from path_tracer_tpu.models.integrator import IntegratorSpec
    from path_tracer_tpu.models.renderer import render_pixel_sums
    from path_tracer_tpu.scene import load_scene

    scene = load_scene(root / name / "scene.isf")
    spec = IntegratorSpec(bounces=bounces, differentiable=False)
    return np.asarray(render_pixel_sums(scene, w, h, 1, spp, spec)) / spp


def _jax_op_by_op(root, name, w, h, spp, bounces):
    """The JAX integrator run op by op, summing samples in order (the
    radiance of a pixel depends on nothing but its id and sample)."""
    import jax.numpy as jnp

    from path_tracer_tpu.models.integrator import (
        IntegratorSpec,
        render_wavefront,
    )
    from path_tracer_tpu.scene import load_scene

    scene = load_scene(root / name / "scene.isf")
    spec = IntegratorSpec(bounces=bounces, differentiable=False)
    pix = jnp.arange(w * h, dtype=jnp.int32)
    acc = jnp.zeros((w * h, 3), jnp.float32)
    with jax.disable_jit():
        for sample in range(1, spp + 1):
            acc = acc + render_wavefront(scene, pix, w, h, jnp.int32(sample),
                                         spec)
    return np.asarray(acc) / spp


def _outside(got, want):
    return np.abs(got - want) > 1e-4 + 1e-3 * np.abs(want)


def _port_bvh(scene, bounces):
    from path_tracer_torch.models.integrator import IntegratorSpec
    from path_tracer_torch.models.renderer import render_pixel_sums

    return render_pixel_sums(scene, W, H, 1, SPP,
                             IntegratorSpec(bounces=bounces)) / SPP


@pytest.mark.parametrize("name", ["cube", "reflection"])
def test_bvh_render_matches_jax(reference_scenes, name):
    """The triangle scenes forced onto the BVH (the port's flat walk, in
    its Baldwin-Weber form with exact-t_max shadows, against the JAX CPU
    BVH path: MT with nearest-hit range checks): at least 99% of values
    within the golden tolerance (measured: all of them)."""
    from path_tracer_torch.scene import load_scene
    from path_tracer_tpu.models.integrator import IntegratorSpec
    from path_tracer_tpu.models.renderer import render_pixel_sums
    from path_tracer_tpu.scene import isf
    from path_tracer_tpu.scene.device_scene import build_device_scene

    path = reference_scenes / name / "scene.isf"
    scene = load_scene(path, "cpu", use_bvh=True)
    assert scene.use_bvh
    got = _port_bvh(scene, BOUNCES)
    js = build_device_scene(isf.load(path), path.parent, use_bvh=True)
    spec = IntegratorSpec(bounces=BOUNCES, differentiable=False)
    want = np.asarray(render_pixel_sums(js, W, H, 1, SPP, spec)) / SPP
    assert np.isfinite(got).all() and got.std() > 0
    assert _outside(got, want).mean() <= 0.01


@pytest.fixture(scope="module")
def showcase48():
    """The plain showcase at grid 48 (4,608 triangles in 31 blocks of 256,
    48 spheres, 3 lights): the port's scene (flat walk) and the JAX
    package's (brute force: the same image as its BVH path, which op by op
    would take minutes)."""
    from path_tracer_torch.scene import build_scene
    from path_tracer_torch.scene.showcase import showcase_scene
    from path_tracer_tpu.scene.device_scene import build_device_scene
    from path_tracer_tpu.scene.showcase import showcase_scene as jax_showcase

    port = build_scene(showcase_scene(48), ".", "cpu", use_bvh=True,
                       sl_block=256)
    js = build_device_scene(jax_showcase(48), ".", use_bvh=False,
                            sl_block=256)
    return port, js


@pytest.fixture(scope="module")
def showcase_bvh(showcase48):
    """The port's showcase render through the flat walk at 32x24, 2 spp,
    3 bounces."""
    return _port_bvh(showcase48[0], 3)


def _jax_showcase(js, bounces):
    """The JAX package's showcase render, run op by op (its sphere rule;
    the jit's FMA contraction flips 7.7% of the values here)."""
    import jax.numpy as jnp

    from path_tracer_tpu.models.integrator import (
        IntegratorSpec,
        render_wavefront,
    )

    spec = IntegratorSpec(bounces=bounces, differentiable=False)
    pix = jnp.arange(W * H, dtype=jnp.int32)
    acc = jnp.zeros((W * H, 3), jnp.float32)
    with jax.disable_jit():
        for sample in range(1, SPP + 1):
            acc = acc + render_wavefront(js, pix, W, H, jnp.int32(sample),
                                         spec)
    return np.asarray(acc) / SPP


def _cast_jax_camera_rays(monkeypatch, js):
    """Make the port's integrator start from the JAX package's camera rays
    (generated op by op) instead of its own."""
    import jax.numpy as jnp

    import path_tracer_torch.ops.camera as port_camera
    from path_tracer_tpu.ops.camera import generate_rays

    def rays(pixel_ids, width, height, scene, sample_id, seed):
        with jax.disable_jit():
            o, d = generate_rays(jnp.asarray(pixel_ids.numpy()), width, height,
                                 js, jnp.int32(sample_id), seed)
        return torch.from_numpy(np.array(o)), torch.from_numpy(np.array(d))

    monkeypatch.setattr(port_camera, "generate_rays", rays)


def test_showcase_direct_light_matches_jax(showcase48, monkeypatch):
    """Where the showcase's gap to JAX comes from, at bounce 0 (camera
    cast, emission and direct light): the two packages' camera rays differ
    by at most an ulp (measured 1.8e-7), and 27 of 2,304 values (1.2%)
    fall outside the golden tolerance. Started from the JAX package's
    camera rays, the port's render matches on every value (measured:
    all). The camera sits 30 units from the spheres, where the sphere
    quadratic cancels: an ulp of camera direction (ATen's against XLA's
    float32 tan) moves a first sphere hit by up to 1.6e-4 along the ray,
    16 times the 1e-5 shadow-ray bias, and whether the shadow ray re-hits
    its own sphere flips."""
    from path_tracer_torch.ops.camera import generate_rays as port_rays
    from path_tracer_tpu.ops.camera import generate_rays as jax_rays

    port, js = showcase48
    pix = np.arange(W * H, dtype=np.int32)
    _, d = port_rays(torch.from_numpy(pix), W, H, port, 1, 0)
    with jax.disable_jit():
        _, jd = jax_rays(jax.numpy.asarray(pix), W, H, js,
                         jax.numpy.int32(1), 0)
    assert np.abs(d.numpy() - np.asarray(jd)).max() <= 1e-6

    want = _jax_showcase(js, 0)
    own_camera = _port_bvh(port, 0)
    assert _outside(own_camera, want).mean() <= 0.025
    _cast_jax_camera_rays(monkeypatch, js)
    assert not _outside(_port_bvh(port, 0), want).any()


def test_showcase_render_matches_jax(showcase48, showcase_bvh, monkeypatch):
    """The whole showcase render (3 bounces) against the JAX package run
    op by op. Started from the JAX package's camera rays (the cause of the
    gap, previous test), at least 99% of values lie within the golden
    tolerance: measured 99.35% (15 of 2,304 outside; later bounces add
    ATen's against XLA's float32 transcendentals in the BRDF sampling, as
    on the sphere scenes). With its own camera rays the port keeps 97.5%:
    measured 98.26% (40 values, 13 pixels). On the CPU, scene seed 11
    gave 99.22% / 97.44% and 48x36 pixels 99.40% / 97.47%."""
    port, js = showcase48
    want = _jax_showcase(js, 3)
    assert np.isfinite(showcase_bvh).all() and showcase_bvh.std() > 0
    assert _outside(showcase_bvh, want).mean() <= 0.025
    _cast_jax_camera_rays(monkeypatch, js)
    assert _outside(_port_bvh(port, 3), want).mean() <= 0.01


def test_showcase_bvh_matches_brute(showcase_bvh):
    """The port against itself at the same seed: the flat walk (Baldwin-
    Weber, exact-t_max any-hit) against brute-force MT with nearest-hit
    shadows. At least 99% of values within the golden tolerance; measured
    99.70% (7 of 2,304 values outside: the two triangle tests round
    differently, and a ray that starts 1e-5 off a surface can flip)."""
    from path_tracer_torch.scene import build_scene
    from path_tracer_torch.scene.showcase import showcase_scene

    brute = build_scene(showcase_scene(48), ".", "cpu", use_bvh=False,
                        sl_block=256)
    want = _port_bvh(brute, 3)
    assert _outside(showcase_bvh, want).mean() <= 0.01


@pytest.mark.parametrize("name", ["cube", "spheres", "reflection",
                                  "white_furnace_direct",
                                  "white_furnace_indirect"])
def test_render_matches_jax_per_pixel(reference_scenes, name):
    got = _port(reference_scenes, name, W, H, SPP, BOUNCES)
    assert np.isfinite(got).all() and got.std() > 0
    if name in SPHERE_SCENES:
        want = _jax_op_by_op(reference_scenes, name, W, H, SPP, BOUNCES)
        frac = _outside(got, want).mean()
        assert frac <= MAX_SPHERE_FLIPS, f"{name}: {frac:.4f} of values differ"
    else:
        want = _jax(reference_scenes, name, W, H, SPP, BOUNCES)
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("name", ["cube", "white_furnace_direct"])
def test_frozen_golden(reference_scenes, name):
    """tests/goldens at their 128x96, 4 spp, 2 bounces (reflection at that
    size costs over 20 s on one worker; it is held at 32x24 above)."""
    got = _port(reference_scenes, name, 128, 96, 4, 2).reshape(96, 128, 3)
    want = np.load(GOLDEN_DIR / f"{name}.npz")["radiance"]
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


def test_render_image_and_cli_png(reference_scenes, tmp_path):
    """``render`` → u8 image, and the CLI writes the same image as a PNG
    (decoded here with Pillow, which the port itself never imports)."""
    from PIL import Image

    from path_tracer_torch import cli
    from path_tracer_torch.config import Profile, Resolution
    from path_tracer_torch.models.renderer import render
    from path_tracer_torch.scene import load_scene

    prof = tmp_path / "p.yaml"
    prof.write_text("resolution: {width: 20, height: 14}\nsamples: 2\n"
                    "bounces: 1\n")
    out = tmp_path / "out.png"
    cli.main(["render", str(reference_scenes / "cube" / "scene.isf"), "-o",
              str(out), "-p", str(prof), "-q", "--device", "cpu"])
    png = np.asarray(Image.open(out).convert("RGB"))
    scene = load_scene(reference_scenes / "cube" / "scene.isf", device="cpu")
    img = render(scene, Profile(resolution=Resolution(20, 14), samples=2,
                                bounces=1))
    assert img.shape == (14, 20, 3) and img.dtype == np.uint8
    np.testing.assert_array_equal(png, img)
    assert img.std() > 0


@pytest.mark.parametrize("argv, message", [
    (["--device", "cuda"], "no CUDA device"),
    (["--viewer", "--device", "cpu"], "--viewer is not ported"),
])
def test_cli_errors_exit_2(reference_scenes, tmp_path, argv, message):
    """Without a card, --device cuda fails with one line and exit code 2;
    it never falls back to the CPU. Unported flags fail the same way."""
    if "cuda" in argv and torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run(
        [sys.executable, "-m", "path_tracer_torch.cli", "render",
         str(reference_scenes / "cube" / "scene.isf"), "-o",
         str(tmp_path / "x.png"), *argv],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2
    assert message in proc.stderr and len(proc.stderr.strip().splitlines()) == 1
    assert not (tmp_path / "x.png").exists()
