"""Scene-parameter gradients of the port against the JAX package's, on the
CPU, with the scene carried across by ``from_numpy``.

- Parity: for each of the 14 ``PARAM_FIELDS``, the port's autograd
  gradient of tests/test_gradients.py's weighted pixel sum (12x12) against
  ``jax.grad`` of the same loss on the same scene, at the bounces that file
  takes for the field: ``cornell_device_scene`` with a directional light
  added (as its ``dir_dir`` check adds one) for the eleven factor, light,
  background and camera fields, ``sphere_grid_device_scene(3)`` for the
  sphere centre and radius, ``alpha_transparency`` for the texture atlas.
  Tolerance: every entry within 1e-4 of the field's largest JAX entry.
  JAX runs jitted, except on the sphere grid, where XLA's CPU jit
  contracts multiply-adds into FMAs and so flips whether rays leaving a
  sphere re-hit it (ROADMAP Queue 3); there it runs op by op and the test
  prints how many radiance values of the forward pass still differ by more
  than the golden tolerance (the ulp-level sphere rounding that remains;
  measured 3.8e-5 of the largest gradient).
- The port's own central finite differences, with the eps and rtol of each
  check in tests/test_gradients.py (its three largest coordinates, at
  least two significant; one for the spheres).
- Russian roulette's ``p``: on a grey metallic Cornell box at 7 bounces
  every lane's throughput ties in all three channels; the gradient through
  ``p`` matches JAX's only when the reduction splits it among the tied
  channels (``torch.amax``, as ``jnp.max``) and not when ``Tensor.max(dim)``
  gives it all to one (measured: 2.1e-5 against 2.4e-3 of the largest
  entry).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_tracer_torch.scene import from_numpy
from path_tracer_torch.scene.device_scene import ARRAY_FIELDS, STATIC_FIELDS

W = H = 12
WGT = (np.arange(W * H * 3, dtype=np.float32) % 7 + 1.0).reshape(-1, 3)
REL = 1e-4  # of each field's largest gradient entry

# tests/test_gradients.py's bounces per field.
CORNELL_BOUNCES = {
    "mat_albedo_factor": 2, "mat_emissive_factor": 2, "point_color": 1,
    "background": 1, "mat_roughness_factor": 0, "mat_metalness_factor": 0,
    "point_pos": 0, "cam_to_world": 0, "cam_fov": 0, "dir_dir": 0,
    "dir_color": 0,
}
SPHERE_FIELDS = ("sph_center", "sph_radius")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _carry(js):
    return from_numpy({f: np.asarray(getattr(js, f)) for f in ARRAY_FIELDS},
                      {s: getattr(js, s) for s in STATIC_FIELDS}, "cpu")


def _cornell():
    from path_tracer_tpu.scene.procedural import cornell_device_scene

    return dataclasses.replace(
        cornell_device_scene(),
        dir_dir=jnp.asarray([[0.15, -0.4, -1.0]], jnp.float32),
        dir_color=jnp.asarray([[1.4, 1.3, 1.1]], jnp.float32))


def _port_render(ts, params, bounces, wgt=WGT):
    from path_tracer_torch.models.integrator import (
        IntegratorSpec,
        render_wavefront,
    )
    from path_tracer_torch.parallel.train import apply_params

    spec = IntegratorSpec(bounces=bounces, alpha_walk_steps=2,
                          shadow_walk_steps=2, differentiable=True)
    rad = render_wavefront(apply_params(ts, params),
                           torch.arange(W * H, dtype=torch.int32), W, H, 1,
                           spec)
    return rad, (rad * torch.from_numpy(wgt)).sum()


def _port_grads(ts, fields, bounces):
    leaves = {f: getattr(ts, f).clone().requires_grad_(True) for f in fields}
    _, loss = _port_render(ts, leaves, bounces)
    return dict(zip(fields, (g.numpy() for g in torch.autograd.grad(
        loss, list(leaves.values())))))


def _jax_loss(js, bounces):
    from path_tracer_tpu.models.integrator import (
        IntegratorSpec,
        render_wavefront,
    )
    from path_tracer_tpu.parallel.train import apply_params

    spec = IntegratorSpec(bounces=bounces, alpha_walk_steps=2,
                          shadow_walk_steps=2, tri_block=256)
    ids = jnp.arange(W * H, dtype=jnp.int32)

    def loss(params):
        rad = render_wavefront(apply_params(js, params), ids, W, H,
                               jnp.int32(1), spec)
        return jnp.sum(rad * WGT), rad

    return loss


def _jax_grads(js, fields, bounces, op_by_op=False):
    loss = _jax_loss(js, bounces)
    params = {f: getattr(js, f) for f in fields}
    grad = jax.grad(lambda p: loss(p)[0])
    if op_by_op:
        with jax.disable_jit():
            g = grad(params)
            rad = loss(params)[1]
    else:
        g = jax.jit(grad)(params)
        rad = loss(params)[1]
    return {f: np.asarray(g[f]) for f in fields}, np.asarray(rad)


@pytest.fixture(scope="module")
def grads(reference_scenes):
    """field -> (port gradient, JAX gradient)."""
    from path_tracer_tpu.scene import load_scene
    from path_tracer_tpu.scene.procedural import sphere_grid_device_scene

    out = {}
    js = _cornell()
    ts = _carry(js)
    for b in sorted(set(CORNELL_BOUNCES.values())):
        fields = [f for f, fb in CORNELL_BOUNCES.items() if fb == b]
        jg, _ = _jax_grads(js, fields, b)
        tg = _port_grads(ts, fields, b)
        out.update({f: (tg[f], jg[f]) for f in fields})
    js = sphere_grid_device_scene(3)
    ts = _carry(js)
    jg, rad = _jax_grads(js, SPHERE_FIELDS, 0, op_by_op=True)
    tg = _port_grads(ts, SPHERE_FIELDS, 0)
    port_rad = _port_render(ts, {}, 0)[0].detach().numpy()
    off = np.abs(port_rad - rad) > 1e-4 + 1e-3 * np.abs(rad)
    print(f"sphere grid: {int(off.sum())} of {off.size} forward radiance "
          "values beyond rtol 1e-3 / atol 1e-4 of JAX's")
    out.update({f: (tg[f], jg[f]) for f in SPHERE_FIELDS})
    js = load_scene(reference_scenes / "alpha_transparency" / "scene.isf")
    jg, _ = _jax_grads(js, ["tex_data"], 1)
    out["tex_data"] = (_port_grads(_carry(js), ["tex_data"], 1)["tex_data"],
                       jg["tex_data"])
    return out


def test_param_fields_are_the_jax_packages():
    from path_tracer_torch.parallel.train import PARAM_FIELDS
    from path_tracer_tpu.parallel.train import PARAM_FIELDS as JAX_FIELDS

    assert PARAM_FIELDS == JAX_FIELDS
    assert set(PARAM_FIELDS) == (set(CORNELL_BOUNCES) | set(SPHERE_FIELDS)
                                 | {"tex_data"})


@pytest.mark.parametrize("field", list(CORNELL_BOUNCES) + list(SPHERE_FIELDS)
                         + ["tex_data"])
def test_gradient_matches_jax(grads, field):
    got, want = grads[field]
    assert got.shape == want.shape and np.isfinite(got).all()
    scale = np.abs(want).max()
    assert scale > 0, f"{field}: JAX's gradient is zero"
    err = np.abs(got - want).max()
    assert err <= REL * scale, f"{field}: max error {err} of {scale}"


def _fd_check(ts, field, bounces, eps, rtol, wgt=WGT, min_grad=1e-3,
              n_coords=3, need=2):
    """tests/test_gradients.py's _fd_check on the port: the largest
    coordinates of the autograd gradient against central differences."""
    value = getattr(ts, field)
    leaf = value.clone().requires_grad_(True)
    _, loss = _port_render(ts, {field: leaf}, bounces, wgt)
    grad = torch.autograd.grad(loss, [leaf])[0].numpy().astype(np.float64)

    def at(v):
        with torch.no_grad():
            return float(_port_render(ts, {field: v}, bounces, wgt)[1])

    checked = 0
    for lin in np.argsort(np.abs(grad).ravel())[::-1][:n_coords]:
        idx = np.unravel_index(lin, grad.shape)
        if abs(grad[idx]) < min_grad:
            continue
        basis = torch.zeros_like(value)
        basis[idx] = 1.0
        fd = (at(value + eps * basis) - at(value - eps * basis)) / (2 * eps)
        assert fd == pytest.approx(grad[idx], rel=rtol), \
            f"{field}{idx}: autograd {grad[idx]} against FD {fd}"
        checked += 1
    assert checked >= need, f"too few significant coordinates for {field}"


def _center_weights(half: int):
    """tests/test_gradients.py's interior weights: a (2 half)^2 pixel square
    at the image centre."""
    wgt = np.zeros((H, W, 3), np.float32)
    n = 2 * half
    wgt[H // 2 - half:H // 2 + half, W // 2 - half:W // 2 + half] = \
        (np.arange(n * n * 3) % 5 + 1).reshape(n, n, 3)
    return wgt.reshape(-1, 3)


# (field, bounces, eps, rtol) of tests/test_gradients.py's checks.
FD_CASES = [
    ("mat_albedo_factor", 2, 2e-3, 3e-2),
    ("mat_emissive_factor", 2, 2e-3, 3e-2),
    ("point_color", 1, 5e-2, 3e-2),
    ("background", 1, 2e-3, 3e-2),
    ("mat_roughness_factor", 0, 2e-3, 5e-2),
    ("mat_metalness_factor", 0, 2e-3, 5e-2),
    ("point_pos", 0, 2e-3, 5e-2),
    ("dir_dir", 0, 2e-3, 5e-2),
]


@pytest.fixture(scope="module")
def cornell():
    return _carry(_cornell())


@pytest.mark.parametrize("field,bounces,eps,rtol", FD_CASES)
def test_port_gradient_matches_fd(cornell, field, bounces, eps, rtol):
    _fd_check(cornell, field, bounces, eps, rtol)


def test_port_camera_gradient_matches_fd(cornell):
    """cam_to_world on the back wall's interior pixels, eps 1e-3."""
    _fd_check(cornell, "cam_to_world", 0, 1e-3, 5e-2, _center_weights(2))


def test_port_fov_gradient_matches_fd(cornell):
    """cam_fov on the same pixels, eps 1e-4."""
    _fd_check(cornell, "cam_fov", 0, 1e-4, 5e-2, _center_weights(2),
              n_coords=1, need=1)


@pytest.mark.parametrize("field", SPHERE_FIELDS)
def test_port_sphere_gradient_matches_fd(field):
    """The centre sphere's interior pixels of the 3 x 3 sphere grid, eps
    1e-3 (the straight-through quadratic-root reparameterization)."""
    from path_tracer_tpu.scene.procedural import sphere_grid_device_scene

    _fd_check(_carry(sphere_grid_device_scene(3)), field, 0, 1e-3, 5e-2,
              _center_weights(1), need=1)


def test_port_texel_gradient_matches_fd(reference_scenes):
    """An albedo texel of alpha_transparency's checkerboard: the fetch's
    gather scatters its gradient into the atlas."""
    from path_tracer_torch.scene import load_scene

    ts = load_scene(reference_scenes / "alpha_transparency" / "scene.isf",
                    "cpu")
    assert not ts.no_textures
    _fd_check(ts, "tex_data", 1, 2e-3, 5e-2)


def test_rr_gradient_splits_ties_as_jax():
    """Russian roulette's p = max over channels keeps its gradient; grey
    metallic walls make the three channels tie on every lane, where only a
    reduction that splits the gradient (as jnp.max) matches JAX."""
    from path_tracer_tpu.models.integrator import (
        IntegratorSpec,
        render_wavefront,
    )

    js = _cornell()
    grey = jnp.full_like(js.mat_albedo_factor, 0.95)
    js = dataclasses.replace(
        js, mat_albedo_factor=grey,
        mat_metalness_factor=jnp.ones_like(js.mat_metalness_factor),
        mat_roughness_factor=jnp.full_like(js.mat_roughness_factor, 0.2),
        point_color=jnp.full_like(js.point_color, 120.0),
        dir_color=jnp.full_like(js.dir_color, 1.2))
    bounces = 7
    ids = jnp.arange(W * H, dtype=jnp.int32)
    spec = IntegratorSpec(bounces=bounces, alpha_walk_steps=2,
                          shadow_walk_steps=2)

    def loss(a):
        s = dataclasses.replace(js, mat_albedo_factor=a)
        return jnp.sum(render_wavefront(s, ids, W, H, jnp.int32(1), spec)
                       * WGT)

    want = np.asarray(jax.jit(jax.grad(loss))(grey))
    ts = _carry(js)
    leaf = ts.mat_albedo_factor.clone().requires_grad_(True)
    _, port_loss = _port_render(ts, {"mat_albedo_factor": leaf}, bounces)
    got = torch.autograd.grad(port_loss, [leaf])[0].numpy()
    err = np.abs(got - want).max()
    assert err <= REL * np.abs(want).max(), (err, np.abs(want).max())
