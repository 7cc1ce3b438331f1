"""The port's training path on the CPU: the live (training-mode) walks, the
fused route in training mode, and ``parallel/train.py``, against the JAX
package where it has a counterpart.

- Live walks, lane by lane: the port's plain walks on ``LiveTables``
  against JAX's Pallas walks with ``live_factor=True`` in interpret mode,
  after the updates tests/test_trwalk.py makes (``mat_opacity_factor`` x
  0.6; the first opacity page moved by +0.17, then -0.09, clipped to
  [0.05, 0.95]), on the textured showcase (grid 48) and the two-texture
  scene of tests/test_trwalk.py, carried across with ``from_numpy``; the
  mismatch bound of tests/test_torch_trwalk.py (1e-3 of lanes). On
  untouched tables the live walks equal the forward walks on every lane.
- Whole renders (tests/test_trwalk.py:115-330): the port's differentiable
  render of the updated two-texture scene against JAX's through its live
  kernels, at most 0.5% of pixels beyond 1e-3 and a mean difference below
  1e-5; on the textured showcase the port's live kernel route against its
  cast walks under the same bounds (its forward values part from JAX's on
  a few percent of pixels through the known camera and sphere rounding,
  ROADMAP Queue 3, so the showcase is held against the port's own exact
  walks, as tests/test_trwalk.py holds JAX's); the gradient through the
  kernel route against the cast route and against JAX's, within 2%;
  ``refresh_baked_textures`` against JAX's; the fused shadow route in
  training mode against the two launches (rtol 3e-7, atol 1e-7,
  tests/test_fused_shadow.py:49).
- ``parallel/train.py`` (tests/test_parallel.py:97-131, one device): the
  step lowers the loss, gradients are finite for every field, and a
  forward render after ``apply_params`` equals JAX's after its own.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_trwalk import (  # noqa: F401  (fixtures)
    R,
    _foliage_rays,
    _shadow_lanes,
    showcase48,
    two_tex,
)

from path_tracer_torch.scene import from_numpy
from path_tracer_torch.scene.device_scene import ARRAY_FIELDS, STATIC_FIELDS

MAX_MISMATCH = 1e-3
PIXEL_BOUND = 0.005  # share of pixels beyond 1e-3


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _carry(js):
    return from_numpy({f: np.asarray(getattr(js, f)) for f in ARRAY_FIELDS},
                      {s: getattr(js, s) for s in STATIC_FIELDS}, "cpu")


def _updated(js, factor=True, texture=True):
    """tests/test_trwalk.py's training updates of the JAX scene: the
    opacity factors x 0.6 and two steps on the first opacity page."""
    kw = {}
    if factor:
        kw["mat_opacity_factor"] = js.mat_opacity_factor * 0.6
    if texture:
        off, w, h, _ = js.tr_pages[0]
        td = js.tex_data
        for step in (0.17, -0.09):
            td = td.at[off:off + w * h].set(
                jnp.clip(td[off:off + w * h] + step, 0.05, 0.95))
        kw["tex_data"] = td
    return dataclasses.replace(js, **kw)


def _pair(name, showcase48, two_tex):
    return showcase48 if name == "showcase48" else two_tex


def _alpha_lanes(ts, seed):
    o, d, g = _foliage_rays(ts, seed, R)
    t_op = g.uniform(0.5, 40.0, R).astype(np.float32)
    t_op[::5] = np.inf
    t_op[::7] = -1.0  # dead lanes
    rnd = g.uniform(size=(8, R)).astype(np.float32)
    return o, d, t_op, rnd


TRANS_ORDER = ("o", "d", "pd", "is_pt", "surf_pos", "orig_uv", "orig_simple",
               "walking0")


@pytest.mark.parametrize("name", ["showcase48", "two_tex"])
def test_live_walks_match_pallas_live(showcase48, two_tex, name):
    from path_tracer_torch.ops.trwalk import (
        alpha_walk_plain,
        live_tables,
        trans_walk_plain,
    )
    from path_tracer_tpu.ops.pallas_trwalk import (
        alpha_walk_kernel,
        trans_walk_kernel,
    )

    js = _updated(_pair(name, showcase48, two_tex)[0])
    ts = _carry(js)
    live = live_tables(ts)
    o, d, t_op, rnd = _alpha_lanes(ts, 21)
    got = alpha_walk_plain(ts, *map(torch.from_numpy, (o, d, t_op, rnd)), 8,
                           live)
    (w_t, w_packed, _, _, _, w_seen, w_acc, w_still, w_tprev) = [
        np.asarray(x) for x in alpha_walk_kernel(
            js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_op),
            jnp.asarray(rnd), 8, interpret=True, live_factor=True)]
    col = got.col.numpy()
    packed = np.where(col >= 0, ts.tr_colmap.numpy()[np.maximum(col, 0)], -1)
    mism = ((packed != w_packed) | (got.seen.numpy() != w_seen)
            | (got.accepted.numpy() != w_acc) | (got.still.numpy() != w_still)
            | ~np.isclose(got.t_prev.numpy(), w_tprev, rtol=1e-5, atol=1e-6))
    assert mism.mean() <= MAX_MISMATCH, mism.sum()
    assert w_acc.any() and (w_seen & ~w_acc).any()
    # The forward walk reads the build-time tables: the update shows.
    fwd = alpha_walk_plain(ts, *map(torch.from_numpy, (o, d, t_op, rnd)), 8)
    assert (fwd.accepted != got.accepted).any()

    lanes = _shadow_lanes(ts, 22)
    args = [torch.from_numpy(np.ascontiguousarray(lanes[k]))
            for k in TRANS_ORDER]
    got = trans_walk_plain(ts, *args, 8, live)
    w_trans, w_tprev, w_still = [np.asarray(x) for x in trans_walk_kernel(
        js, *[jnp.asarray(lanes[k]) for k in TRANS_ORDER], 8,
        interpret=True, live_factor=True)]
    trans = got.trans.numpy()
    mism = ((got.still.numpy() != w_still)
            | ~np.isclose(got.t_prev.numpy(), w_tprev, rtol=1e-5, atol=1e-6)
            | (np.abs(trans - w_trans) > 1e-5))
    assert mism.mean() <= MAX_MISMATCH, mism.sum()
    assert 0.02 < (w_trans < 1.0).mean()
    assert (trans_walk_plain(ts, *args, 8).trans != got.trans).any()


@pytest.mark.parametrize("name", ["showcase48", "two_tex"])
def test_live_walks_equal_forward_on_untouched_tables(showcase48, two_tex,
                                                      name):
    """Before any update the live plane holds exactly tr_lut[tr_tex8] and
    the live rows tr_rows on every real column, so the live walks equal
    the forward walks on every lane."""
    from path_tracer_torch.ops.trwalk import (
        alpha_walk_plain,
        live_tables,
        trans_walk_plain,
    )

    ts = _pair(name, showcase48, two_tex)[1]
    live = live_tables(ts)
    lut_plane = ts.tr_lut[0][ts.tr_tex8.long()]
    for _, w, h, yb in ts.tr_pages:
        assert torch.equal(live.plane[yb:yb + h, :w],
                           lut_plane[yb:yb + h, :w])
    real = ts.tr_bw[0:3].abs().sum(0) > 0
    assert torch.equal(live.rows[:, real], ts.tr_rows[:, real])
    o, d, t_op, rnd = map(torch.from_numpy, _alpha_lanes(ts, 23))
    for a, b in zip(alpha_walk_plain(ts, o, d, t_op, rnd, 8, live),
                    alpha_walk_plain(ts, o, d, t_op, rnd, 8)):
        assert torch.equal(a, b)
    lanes = _shadow_lanes(ts, 24)
    args = [torch.from_numpy(np.ascontiguousarray(lanes[k]))
            for k in TRANS_ORDER]
    for a, b in zip(trans_walk_plain(ts, *args, 8, live),
                    trans_walk_plain(ts, *args, 8)):
        assert torch.equal(a, b)


def _port_render(ts, w, h, bounces, **spec):
    from path_tracer_torch.models.integrator import (
        IntegratorSpec,
        render_wavefront,
    )

    spec.setdefault("differentiable", True)
    return render_wavefront(
        ts, torch.arange(w * h, dtype=torch.int32), w, h, 1,
        IntegratorSpec(bounces=bounces, **spec))


def _assert_close_renders(a, b):
    d = np.abs(np.asarray(a) - np.asarray(b))
    assert (d.max(axis=-1) > 1e-3).mean() <= PIXEL_BOUND, d.max()
    assert d.mean() < 1e-5, d.mean()


def test_training_render_matches_jax_live_kernels(two_tex, monkeypatch):
    """The updated two-texture scene rendered differentiably: the port's
    live walks against JAX's live kernels (interpret mode), and each
    update visibly moves the image (the live tables were read)."""
    from path_tracer_tpu.models.integrator import (
        IntegratorSpec,
        render_wavefront,
    )

    js = _updated(two_tex[0])
    w, h = 32, 24
    monkeypatch.setenv("PT_TRWALK_INTERPRET", "1")
    want = render_wavefront(js, jnp.arange(w * h, dtype=jnp.int32), w, h,
                            jnp.int32(1), IntegratorSpec(bounces=2))
    ts = _carry(js)
    got = _port_render(ts, w, h, 2)
    _assert_close_renders(got, want)
    for kw in (dict(texture=False), dict(factor=False)):
        other = _port_render(_carry(_updated(two_tex[0], **kw)), w, h, 2)
        assert (got - other).abs().max() > 1e-3


def test_live_kernel_route_matches_cast_walks(showcase48):
    """The textured showcase after both updates (tests/test_trwalk.py:115):
    the live kernel route against the cast walks, which read the live
    tables through shading's own gathers."""
    ts = _carry(_updated(showcase48[0]))
    a = _port_render(ts, 32, 24, 2)
    b = _port_render(dataclasses.replace(ts, tr_kernel_ok=False), 32, 24, 2)
    _assert_close_renders(a, b)
    assert (a - _port_render(showcase48[1], 32, 24, 2)).abs().max() > 1e-3


def _albedo_scale_grad(ts, w, h):
    """d mean(render) / d f at f = 1, with mat_albedo_factor * f
    (tests/test_trwalk.py:141)."""
    from path_tracer_torch.models.integrator import (
        IntegratorSpec,
        render_wavefront,
    )

    f = torch.tensor(1.0, requires_grad=True)
    s = dataclasses.replace(ts, mat_albedo_factor=ts.mat_albedo_factor * f)
    spec = IntegratorSpec(bounces=1, alpha_walk_steps=3, shadow_walk_steps=3,
                          differentiable=True)
    out = render_wavefront(s, torch.arange(w * h, dtype=torch.int32), w, h,
                           1, spec).mean()
    return float(torch.autograd.grad(out, [f])[0])


def test_gradient_through_kernel_route(showcase48, two_tex, monkeypatch):
    """The shading gradient is the same through the live kernel walks as
    through the cast walks (textured showcase), and as JAX's through its
    live kernels (two-texture scene): within 2% + 1e-7."""
    from path_tracer_tpu.models.integrator import (
        IntegratorSpec,
        render_wavefront,
    )

    w, h = 24, 16
    ts = showcase48[1]
    g_kernel = _albedo_scale_grad(ts, w, h)
    g_cast = _albedo_scale_grad(dataclasses.replace(ts, tr_kernel_ok=False),
                                w, h)
    assert np.isfinite(g_kernel) and abs(g_cast) > 1e-9
    assert abs(g_kernel - g_cast) <= 0.02 * abs(g_cast) + 1e-7

    js = two_tex[0]
    spec = IntegratorSpec(bounces=1, alpha_walk_steps=3, shadow_walk_steps=3)

    def loss(f):
        s = dataclasses.replace(js, mat_albedo_factor=js.mat_albedo_factor * f)
        return jnp.mean(render_wavefront(s, jnp.arange(w * h, dtype=jnp.int32),
                                         w, h, jnp.int32(1), spec))

    monkeypatch.setenv("PT_TRWALK_INTERPRET", "1")
    g_jax = float(jax.grad(loss)(jnp.float32(1.0)))
    g_port = _albedo_scale_grad(_carry(js), w, h)
    assert abs(g_port - g_jax) <= 0.02 * abs(g_jax) + 1e-7, (g_port, g_jax)


def test_refresh_baked_textures(two_tex):
    """tests/test_trwalk.py:303 on the port: a u8-grid update of the first
    page (its texels inverted) re-quantizes tr_tex8 exactly as JAX's
    refresh does, and the forward kernel route then matches the cast walks;
    an off-grid update clears tr_kernel_ok in both."""
    from path_tracer_torch.parallel.train import refresh_baked_textures
    from path_tracer_tpu.parallel.train import (
        refresh_baked_textures as jax_refresh,
    )

    js = two_tex[0]
    off, w, h, yb = js.tr_pages[0]
    lut = np.asarray(js.tr_lut)[0]
    plane = np.asarray(js.tex_data[off:off + w * h, 0])
    inv_u8 = 255 - np.round(plane * 255).astype(np.int32)
    upd = jnp.asarray(np.repeat(lut[inv_u8][:, None], 3, axis=1))
    js2 = dataclasses.replace(js, tex_data=js.tex_data.at[off:off + w * h]
                              .set(upd))
    want = jax_refresh(js2)
    got = refresh_baked_textures(_carry(js2))
    assert got.tr_kernel_ok and want.tr_kernel_ok
    t8 = got.tr_tex8.numpy()
    assert np.array_equal(t8, np.asarray(want.tr_tex8, np.float32)
                          .astype(np.uint8))
    assert np.array_equal(t8[yb:yb + h, :w].astype(np.int32).reshape(-1),
                          inv_u8)
    spec = dict(differentiable=False)
    a = _port_render(got, 32, 24, 2, **spec)
    b = _port_render(dataclasses.replace(got, tr_kernel_ok=False), 32, 24, 2,
                     **spec)
    _assert_close_renders(a, b)
    off_grid = _updated(js, factor=False)
    assert not jax_refresh(off_grid).tr_kernel_ok
    assert not refresh_baked_textures(_carry(off_grid)).tr_kernel_ok


def test_fused_matches_two_launch_training_mode(showcase48, monkeypatch):
    """tests/test_fused_shadow.py:49 on the port: differentiable=True, the
    live tables ride the fused route as the two launches; the same
    radiance and the same albedo gradient."""
    ts = showcase48[1]

    def run():
        leaf = ts.mat_albedo_factor.clone().requires_grad_(True)
        rad = _port_render(dataclasses.replace(ts, mat_albedo_factor=leaf),
                           32, 24, 2)
        g = torch.autograd.grad(rad.sum(), [leaf])[0]
        return rad.detach(), g

    monkeypatch.setenv("PT_FUSED_SHADOW", "1")
    a, ga = run()
    monkeypatch.delenv("PT_FUSED_SHADOW")
    b, gb = run()
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=3e-7, atol=1e-7)
    np.testing.assert_allclose(ga.numpy(), gb.numpy(), rtol=3e-7, atol=1e-7)


@pytest.fixture(scope="module")
def cornell():
    from path_tracer_tpu.scene.procedural import cornell_device_scene

    js = cornell_device_scene()
    return js, _carry(js)


# tests/test_parallel.py's spec and size.
W, H = 8, 16


def _spec():
    from path_tracer_torch.models.integrator import IntegratorSpec

    return IntegratorSpec(bounces=2, alpha_walk_steps=2, shadow_walk_steps=2,
                          differentiable=True)


def test_train_step_reduces_loss(cornell):
    from path_tracer_torch.parallel import get_params, make_train_step

    ts = cornell[1]
    step = make_train_step(W, H, _spec(), n_samples=1, lr=1e-4)
    params = get_params(ts)
    ids = torch.arange(W * H, dtype=torch.int32)
    target = torch.zeros((W * H, 3))
    p1, loss1 = step(params, ts, ids, target, 1)
    p2, loss2 = step(p1, ts, ids, target, 1)
    assert torch.isfinite(loss1) and torch.isfinite(loss2)
    assert float(loss2) < float(loss1)
    assert not torch.allclose(p1["mat_albedo_factor"],
                              params["mat_albedo_factor"])


def test_grads_finite(cornell):
    from path_tracer_torch.parallel.train import (
        PARAM_FIELDS,
        get_params,
        value_and_grad,
    )

    ts = cornell[1]
    ids = torch.arange(64, dtype=torch.int32)
    loss, grads = value_and_grad(get_params(ts), ts, ids,
                                 torch.zeros((64, 3)), 1, 8, 8, _spec())
    assert torch.isfinite(loss)
    assert set(grads) == set(PARAM_FIELDS)
    for name, g in grads.items():
        assert torch.isfinite(g).all(), f"non-finite grad in {name}"


def test_step_needs_differentiable_spec(cornell):
    from path_tracer_torch.models.integrator import IntegratorSpec
    from path_tracer_torch.parallel import get_params, make_train_step

    step = make_train_step(W, H, IntegratorSpec(bounces=1))
    with pytest.raises(ValueError, match="differentiable"):
        step(get_params(cornell[1]), cornell[1],
             torch.arange(W * H, dtype=torch.int32), torch.zeros((W * H, 3)),
             1)


def test_forward_after_apply_params_matches_jax(two_tex, cornell):
    """Updated materials through apply_params, rendered forward: the
    port's kernel walks read the rebaked opacity row as JAX's walks read
    its rebaked rows (two-texture scene), and the repacked sphere table
    equals JAX's (Cornell box)."""
    from path_tracer_torch.parallel.train import apply_params
    from path_tracer_tpu.models.integrator import (
        IntegratorSpec,
        render_wavefront,
    )
    from path_tracer_tpu.parallel.train import apply_params as jax_apply

    js = two_tex[0]
    new = {"mat_albedo_factor": np.asarray(js.mat_albedo_factor) * 0.5,
           "mat_opacity_factor": np.asarray(js.mat_opacity_factor) * 0.6}
    w, h = 32, 24
    want = render_wavefront(
        jax_apply(js, {k: jnp.asarray(v) for k, v in new.items()}),
        jnp.arange(w * h, dtype=jnp.int32), w, h, jnp.int32(1),
        IntegratorSpec(bounces=2, differentiable=False))
    ts = _carry(js)
    port_new = {k: torch.from_numpy(v) for k, v in new.items()}
    got = _port_render(apply_params(ts, port_new), w, h, 2,
                       differentiable=False)
    _assert_close_renders(got, want)
    stale = _port_render(dataclasses.replace(ts, **port_new), w, h, 2,
                         differentiable=False)
    assert (got - stale).abs().max() > 1e-3  # the rebake mattered

    jc, tc = cornell
    sph = {"sph_center": np.asarray(jc.sph_center) + 0.05,
           "sph_radius": np.asarray(jc.sph_radius) * 0.9}
    want = jax_apply(jc, {k: jnp.asarray(v) for k, v in sph.items()})
    got = apply_params(tc, {k: torch.from_numpy(v) for k, v in sph.items()})
    assert np.array_equal(got.sph_packed_t.numpy(),
                          np.asarray(want.sph_packed_t))
