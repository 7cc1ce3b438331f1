"""The transparency slice as a whole: the port's renders of the scenes
with alpha against the JAX package's, per pixel, on the CPU.

Both renderers draw the same uniforms (bit-identical RNG, the same walk
site layout), so the images agree pixel by pixel up to float rounding:
rtol 1e-3, atol 1e-4 (the golden tolerance of tests/test_golden.py).

- ``alpha_transparency`` (stacked translucent quads, brute force, walk
  bound 55) and ``head`` (an opacity-textured mesh, every triangle
  certainly opaque): against JAX run op by op, at least 99% of values
  within the tolerance (measured: all of them; against the jit too).
- The textured showcase at grid 48 (5,210 triangles, 600 foliage card
  triangles in the transparent partition, 48 spheres, three lights),
  partitioned, through the walk kernels' path: against JAX's kernel path.
  The jit of that path equals JAX's brute-force walks value for value;
  the reference here is those walks run op by op, because the jit's FMA
  contraction flips sphere self-hits (tests/test_torch_render.py). At
  least 97.5% of values within the tolerance from the port's own camera
  rays (measured 98.57%), at least 99% from JAX's (measured 99.65%): the
  plain showcase's bounds (tests/test_torch_render.py), whose gap is an
  ulp of float32 tan in the camera moving far sphere hits past the
  shadow bias (ROADMAP Queue 3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

W, H, SPP, BOUNCES = 32, 24, 2, 2


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _outside(got, want):
    return np.abs(got - want) > 1e-4 + 1e-3 * np.abs(want)


def _jax_op_by_op(js, bounces):
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


def _port(scene, bounces):
    from path_tracer_torch.models.integrator import IntegratorSpec
    from path_tracer_torch.models.renderer import render_pixel_sums

    return render_pixel_sums(scene, W, H, 1, SPP,
                             IntegratorSpec(bounces=bounces)) / SPP


@pytest.mark.parametrize("name", ["alpha_transparency", "head"])
def test_alpha_render_matches_jax(reference_scenes, name):
    from path_tracer_torch.scene import load_scene
    from path_tracer_tpu.scene import load_scene as jax_load

    path = reference_scenes / name / "scene.isf"
    scene = load_scene(path, "cpu")
    assert not scene.all_opaque and not scene.use_bvh
    got = _port(scene, BOUNCES)
    assert np.isfinite(got).all() and got.std() > 0
    want = _jax_op_by_op(jax_load(path), BOUNCES)
    assert _outside(got, want).mean() <= 0.01


@pytest.fixture(scope="module")
def showcase_tex48():
    """(port scene, partitioned; JAX scene, brute force) of the textured
    showcase at grid 48 in 256-slot blocks."""
    from path_tracer_torch.scene.showcase import showcase_device_scene
    from path_tracer_tpu.scene.showcase import (
        showcase_device_scene as jax_showcase,
    )

    port = showcase_device_scene(48, "cpu", sl_block=256, textured=True)
    js = jax_showcase(48, use_bvh=False, sl_block=256, textured=True)
    return port, js


def _cast_jax_camera_rays(monkeypatch, js):
    """Make the port's integrator start from the JAX package's camera rays
    (generated op by op) instead of its own."""
    import path_tracer_torch.ops.camera as port_camera
    from path_tracer_tpu.ops.camera import generate_rays

    def rays(pixel_ids, width, height, scene, sample_id, seed):
        with jax.disable_jit():
            o, d = generate_rays(jnp.asarray(pixel_ids.numpy()), width, height,
                                 js, jnp.int32(sample_id), seed)
        return torch.from_numpy(np.array(o)), torch.from_numpy(np.array(d))

    monkeypatch.setattr(port_camera, "generate_rays", rays)


def test_jax_kernel_path_equals_its_brute_walks(showcase_tex48, monkeypatch):
    """The JAX package's textured showcase through its walk kernels
    (interpret mode, partitioned BVH scene) renders what its brute-force
    whole-scene walks render: the reference the next test uses."""
    from path_tracer_tpu.models import integrator as I
    from path_tracer_tpu.models.renderer import render_pixel_sums
    from path_tracer_tpu.scene.device_scene import partitioned
    from path_tracer_tpu.scene.showcase import (
        showcase_device_scene as jax_showcase,
    )

    _, brute = showcase_tex48
    monkeypatch.setenv("PT_TRWALK_INTERPRET", "1")
    bvh = jax_showcase(48, sl_block=256, textured=True)
    spec = I.IntegratorSpec(bounces=3, differentiable=False)
    assert I._use_tr_kernel(bvh, spec) and partitioned(bvh)
    assert not partitioned(brute)
    a = np.asarray(render_pixel_sums(bvh, W, H, 1, SPP, spec))
    b = np.asarray(render_pixel_sums(brute, W, H, 1, SPP, spec))
    assert not _outside(a, b).any()


def test_textured_showcase_matches_jax(showcase_tex48, monkeypatch):
    port, js = showcase_tex48
    assert port.tr_kernel_ok and port.tr_textured and port.use_bvh
    want = _jax_op_by_op(js, 3)
    got = _port(port, 3)
    assert np.isfinite(got).all() and got.std() > 0
    assert _outside(got, want).mean() <= 0.025
    _cast_jax_camera_rays(monkeypatch, js)
    assert _outside(_port(port, 3), want).mean() <= 0.01
