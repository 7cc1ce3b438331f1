"""The transparency slice against the JAX package, on the CPU: the opacity
partition and the walk tables, and the walks lane by lane.

- Tables: ``build_scene`` equals the JAX ``build_device_scene`` exactly on
  every field the port keeps (the partition statics, ``tr_prefilter``,
  the superleaf tables of both partitions and every ``tr_*`` table; the
  page plane as uint8 where JAX keeps bf16), on the textured showcase at
  grid 48 in 256- and 512-slot blocks, forced-BVH ``alpha_transparency``,
  ``deep_alpha`` and a scene whose transparent quads sample two opacity
  textures (two pages), built as tests/test_trwalk.py builds it.
- Walks: ``alpha_walk_plain`` and ``trans_walk_plain`` (what the CUDA
  wrappers run on CPU tensors) against the Pallas kernels in interpret
  mode on seeded rays. A lane mismatches when its selected column, its
  flags or its t_prev differ, or its transmittance differs by more than
  1e-5; at most 1e-3 of lanes may (the kernels' own divergence bound:
  the interpret kernels run under XLA, which contracts multiply-adds, so
  an ulp can flip a texel index or a near-tie; and the Pallas product
  multiplies in a butterfly order where the port multiplies in column
  order). On agreeing lanes t, u and v agree within rtol 1e-5 / atol 1e-6
  plus what a t that far off moves u and v (tests/test_torch_bvh.py).
- The residual past the kernels' step cap (cap 8 against cap 1), with the
  flip-rate bounds of tests/test_trwalk.py:68-112, and the kernel walks
  against the cast walks in a whole render with its 0.5% gate
  (tests/test_trwalk.py:44-65).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_tracer_torch.scene import from_numpy
from path_tracer_torch.scene.device_scene import ARRAY_FIELDS, STATIC_FIELDS

MAX_MISMATCH = 1e-3
R = 1024  # lanes per light set (a multiple of the Pallas 256-lane tile)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _carry(js):
    return from_numpy({f: np.asarray(getattr(js, f)) for f in ARRAY_FIELDS},
                      {s: getattr(js, s) for s in STATIC_FIELDS}, "cpu")


def _showcase(sl_block):
    from path_tracer_torch.scene.showcase import showcase_device_scene
    from path_tracer_tpu.scene.showcase import (
        showcase_device_scene as jax_showcase,
    )

    return (jax_showcase(48, sl_block=sl_block, textured=True),
            showcase_device_scene(48, "cpu", sl_block=sl_block,
                                  textured=True))


@pytest.fixture(scope="module")
def showcase48():
    """(JAX scene, port scene): the textured showcase at grid 48 in
    256-slot blocks, 5,210 triangles of which 600 possibly transparent."""
    return _showcase(256)


@pytest.fixture(scope="module")
def two_tex(tmp_path_factory):
    """An opaque floor and two stacks of transparent quads, each stack
    sampling its own opacity texture, and a factor-only quad between them
    (tests/test_trwalk.py's two_tex_scene, written as scene.isf)."""
    from PIL import Image

    from path_tracer_torch.scene import load_scene
    from path_tracer_tpu.scene import isf
    from path_tracer_tpu.scene.device_scene import build_device_scene
    from path_tracer_tpu.scene.procedural import _camera, _mat, _quad

    root = tmp_path_factory.mktemp("two_tex")
    rng = np.random.default_rng(7)
    for name, size in (("op_a.png", 32), ("op_b.png", 48)):
        Image.fromarray(rng.integers(0, 256, (size, size), dtype=np.uint8),
                        "L").save(root / name)

    def tex_mat(tex):
        m = _mat(albedo=(0.4, 0.6, 0.5))
        return isf.Material(
            albedo=m.albedo, emissive=m.emissive,
            opacity=isf.Channel1(factor=1.0, texture=tex),
            metalness=m.metalness, roughness=m.roughness)

    models = [isf.Mesh(
        triangles=_quad((-8, 0, 8), (8, 0, 8), (8, 0, -8), (-8, 0, -8),
                        (0, 1, 0)),
        material=_mat(albedo=(0.7, 0.7, 0.7)))]
    for x, tex in ((-2.0, "op_a.png"), (2.0, "op_b.png")):
        for k in range(3):
            z = -1.0 - 1.2 * k
            models.append(isf.Mesh(
                triangles=_quad((x - 1.5, 0.2, z), (x + 1.5, 0.2, z),
                                (x + 1.5, 2.6, z), (x - 1.5, 2.6, z),
                                (0, 0, 1)),
                material=tex_mat(tex)))
    models.append(isf.Mesh(
        triangles=_quad((-1.0, 0.2, -2.8), (1.0, 0.2, -2.8),
                        (1.0, 2.6, -2.8), (-1.0, 2.6, -2.8), (0, 0, 1)),
        material=_mat(albedo=(0.8, 0.3, 0.3), opacity=0.45)))
    scene = isf.Scene(
        models=models, camera=_camera(pos=(0.0, 2.0, 7.0), fov_deg=60.0),
        lights=[isf.DirectionalLight(direction=(0.3, -1.0, -0.4),
                                     color=(2.0, 2.0, 2.0)),
                isf.PointLight(position=(0.0, 6.0, 2.0),
                               color=(900.0, 900.0, 900.0))],
        background=(0.2, 0.3, 0.5))
    isf.save(scene, root / "scene.isf")
    return (build_device_scene(isf.load(root / "scene.isf"), root=str(root),
                               use_bvh=True),
            load_scene(root / "scene.isf", "cpu", use_bvh=True))


def _reference_pair(reference_scenes, name):
    from path_tracer_torch.scene import load_scene
    from path_tracer_tpu.scene import isf
    from path_tracer_tpu.scene.device_scene import build_device_scene

    use_bvh = True if name == "alpha_transparency" else None
    path = (reference_scenes.parent / "scenes_extra" / name / "scene.isf"
            if name == "deep_alpha"
            else reference_scenes / name / "scene.isf")
    return (build_device_scene(isf.load(path), path.parent, use_bvh=use_bvh),
            load_scene(path, "cpu", use_bvh=use_bvh))


@pytest.mark.parametrize("name", ["showcase48_256", "showcase48_512",
                                  "alpha_transparency", "deep_alpha",
                                  "two_tex"])
def test_partition_and_walk_tables_equal_jax(reference_scenes, showcase48,
                                             two_tex, name):
    if name == "showcase48_256":
        js, built = showcase48
    elif name == "showcase48_512":
        js, built = _showcase(512)
    elif name == "two_tex":
        js, built = two_tex
    else:
        js, built = _reference_pair(reference_scenes, name)
    carried = _carry(js)
    for f in ARRAY_FIELDS + ("tr_page_table",):
        a, b = getattr(built, f), getattr(carried, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=f)
    for s in STATIC_FIELDS:
        assert getattr(built, s) == getattr(carried, s), s
    assert np.array_equal(np.asarray(js.tr_tex8, np.float32),
                          built.tr_tex8.numpy().astype(np.float32))
    assert not built.all_opaque and built.tr_kernel_ok
    if name != "deep_alpha":  # deep_alpha is all transparent, brute force
        assert 0 < built.n_tris_opaque < built.num_real_triangles
        assert 0 < built.sl_n_blocks_opaque < built.sl_n_blocks
    if name == "two_tex":
        assert built.tr_textured and len(built.tr_pages) == 2


def _foliage_rays(sc, seed, r):
    """Rays from around the transparent triangles' bounds through them."""
    n_op = sc.n_tris_opaque if sc.n_tris_opaque < sc.num_real_triangles else 0
    v = sc.tri_v0[n_op:sc.num_real_triangles].numpy()
    g = np.random.default_rng(seed)
    o = g.uniform(v.min(0) - 2, v.max(0) + 2, (r, 3))
    d = g.uniform(v.min(0), v.max(0), (r, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32), g


def _pair(name, showcase48, two_tex):
    return showcase48 if name == "showcase48" else two_tex


def _uv_slack(ts, cols, d, t):
    """|Au.d| and |Av.d| times the t tolerance: what a t off by that much
    moves the Baldwin-Weber u and v."""
    bw = ts.tr_bw[:, torch.from_numpy(np.maximum(cols, 0)).long()]
    dt = 1e-5 * np.abs(np.where(np.isfinite(t), t, 0.0)) + 1e-6
    dd = torch.from_numpy(d)
    return [np.abs((bw[r0:r0 + 3].T * dd).sum(1).numpy()) * dt
            for r0 in (4, 8)]


@pytest.mark.parametrize("steps_cap", [8, 1])
@pytest.mark.parametrize("name", ["showcase48", "two_tex"])
def test_alpha_walk_plain_matches_pallas(showcase48, two_tex, name,
                                         steps_cap):
    from path_tracer_torch.ops.trwalk import alpha_walk_plain
    from path_tracer_tpu.ops.pallas_trwalk import alpha_walk_kernel

    js, ts = _pair(name, showcase48, two_tex)
    o, d, g = _foliage_rays(ts, 11, R)
    t_op = g.uniform(0.5, 40.0, R).astype(np.float32)
    t_op[::5] = np.inf
    t_op[::7] = -1.0  # dead lanes
    rnd = g.uniform(size=(steps_cap, R)).astype(np.float32)
    got = alpha_walk_plain(ts, *map(torch.from_numpy, (o, d, t_op, rnd)),
                           steps_cap)
    want = [np.asarray(x) for x in alpha_walk_kernel(
        js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_op),
        jnp.asarray(rnd), steps_cap, interpret=True)]
    (w_t, w_packed, w_u, w_v, w_bf, w_seen, w_acc, w_still, w_tprev) = want
    col = got.col.numpy()
    packed = np.where(col >= 0, ts.tr_colmap.numpy()[np.maximum(col, 0)], -1)
    t = got.t.numpy()
    mism = ((packed != w_packed) | (got.seen.numpy() != w_seen)
            | (got.accepted.numpy() != w_acc) | (got.still.numpy() != w_still)
            | ((got.dn.numpy() > 0) != w_bf))
    mism |= ~np.isclose(got.t_prev.numpy(), w_tprev, rtol=1e-5, atol=1e-6)
    assert mism.mean() <= MAX_MISMATCH, mism.sum()
    ok = ~mism & np.isfinite(w_t)
    np.testing.assert_allclose(t[ok], w_t[ok], rtol=1e-5, atol=1e-6)
    for f, w, slack in zip((got.u, got.v), (w_u, w_v),
                           _uv_slack(ts, col, d, t)):
        bad = ok & (np.abs(f.numpy() - w) > 1e-5 + 1e-4 * np.abs(w) + slack)
        assert not bad.any()
    assert 0.2 < w_seen.mean() and not got.seen.numpy()[::7].any()
    assert w_acc.any() and (w_seen & ~w_acc).any()


def _shadow_lanes(ts, seed):
    """Stacked shadow lanes: R per light (directional first, raw
    direction; then point lights), with sphere originals and idle lanes
    mixed in."""
    o, _, g = _foliage_rays(ts, seed, R)
    ds = [np.broadcast_to(-ts.dir_dir[k].numpy(), (R, 3))
          for k in range(ts.num_dir_lights)]
    pds = [np.full(R, np.inf, np.float32)] * ts.num_dir_lights
    for k in range(ts.num_point_lights):
        to = ts.point_pos[k].numpy() - o
        dist = np.linalg.norm(to, axis=1)
        ds.append(to / dist[:, None])
        pds.append(dist)
    n_l = len(ds)
    n = n_l * R
    return dict(
        o=np.tile(o, (n_l, 1)), d=np.concatenate(ds).astype(np.float32),
        pd=np.concatenate(pds).astype(np.float32),
        is_pt=np.arange(n) >= ts.num_dir_lights * R,
        surf_pos=np.tile(o, (n_l, 1)),
        orig_uv=g.uniform(-1.0, 2.0, (n, 2)).astype(np.float32),
        orig_simple=g.uniform(size=n) < 0.2,
        walking0=g.uniform(size=n) > 0.1)


@pytest.mark.parametrize("steps_cap", [8, 1])
@pytest.mark.parametrize("name", ["showcase48", "two_tex"])
def test_trans_walk_plain_matches_pallas(showcase48, two_tex, name,
                                         steps_cap):
    from path_tracer_torch.ops.trwalk import trans_walk_plain
    from path_tracer_tpu.ops.pallas_trwalk import trans_walk_kernel

    js, ts = _pair(name, showcase48, two_tex)
    lanes = _shadow_lanes(ts, 12)
    order = ("o", "d", "pd", "is_pt", "surf_pos", "orig_uv", "orig_simple",
             "walking0")
    got = trans_walk_plain(
        ts, *[torch.from_numpy(np.ascontiguousarray(lanes[k]))
              for k in order], steps_cap)
    w_trans, w_tprev, w_still = [np.asarray(x) for x in trans_walk_kernel(
        js, *[jnp.asarray(lanes[k]) for k in order], steps_cap,
        interpret=True)]
    trans = got.trans.numpy()
    mism = ((got.still.numpy() != w_still)
            | ~np.isclose(got.t_prev.numpy(), w_tprev, rtol=1e-5, atol=1e-6)
            | (np.abs(trans - w_trans) > 1e-5))
    assert mism.mean() <= MAX_MISMATCH, mism.sum()
    assert (trans[~lanes["walking0"]] == 1.0).all()
    assert 0.02 < (w_trans < 1.0).mean()
    if steps_cap == 1 and ts.tr_textured:
        assert w_still.any()  # directional lanes past the cap


def test_hits_transparent_bounds_matches_jax(showcase48):
    """Zero direction components invert to IEEE inf and a NaN slab bound
    counts as open, as in the JAX package."""
    from path_tracer_torch.ops.trwalk import hits_transparent_bounds
    from path_tracer_tpu.models.integrator import _hits_transparent_bounds

    js, ts = showcase48
    o, d, g = _foliage_rays(ts, 13, R)
    d[::9, 0] = 0.0
    d[::11, 2] = 0.0
    o[::13, 1] = ts.tr_prefilter[0, 1].item()  # on a slab plane: 0 * inf
    t_max = g.uniform(0.0, 30.0, R).astype(np.float32)
    t_max[::6] = np.inf
    got = hits_transparent_bounds(ts, torch.from_numpy(o), torch.from_numpy(d),
                                  torch.from_numpy(t_max)).numpy()
    want = np.asarray(_hits_transparent_bounds(
        js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max)))
    np.testing.assert_array_equal(got, want)
    assert 0.05 < got.mean() < 0.95


def test_kernel_walk_residual_past_cap(showcase48, monkeypatch):
    """A step cap of 1 sends nearly every multi-crossing lane through the
    cast residual, a cap of 0 every lane: the walks must end as the cap-8
    walks do (both are
    Baldwin-Weber here, so only near-ties may reorder: at most 1% of
    lanes, tests/test_trwalk.py's bound; a truncating walk would flip
    every multi-crossing lane)."""
    from path_tracer_torch.models import integrator as I
    from path_tracer_torch.ops import trwalk
    from path_tracer_torch.ops.intersect import occluded_multi
    from path_tracer_torch.scene.device_scene import opaque_view

    _, s = showcase48
    o, d, _ = _foliage_rays(s, 1, 512)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    pix = torch.arange(512, dtype=torch.int32)
    walking = torch.ones(512, dtype=torch.bool)
    steps = s.num_transparent_hits + 1
    spec = I.IntegratorSpec(bounces=2)

    def alpha(k):
        monkeypatch.setattr(trwalk, "TRWALK_K", k)
        return I._alpha_walk(s, o, d, walking, pix, 1, 0, spec, steps)

    a = alpha(8)
    for b in (alpha(1), alpha(0)):  # cap 0: every step in the residual
        assert (a[0].prim != b[0].prim).float().mean() <= 0.01
        assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
    assert (a[0].kind == 1).any()

    blocked = occluded_multi(o, [d], opaque_view(s), actives=[walking])

    def shadow(k):
        monkeypatch.setattr(trwalk, "TRWALK_K", k)
        return I._shadow_attenuation_multi(
            s, o, [d], [walking], [torch.ones(3)], steps, [None], o,
            torch.zeros(512, 2), torch.zeros(512, dtype=torch.bool),
            blocked)[0]

    x = shadow(8)
    for y in (shadow(1), shadow(0)):
        assert ((x - y).abs().amax(dim=-1) > 1e-5).float().mean() <= 0.01
    assert ((x > 0) & (x < 1)).any()


@pytest.mark.parametrize("name", ["showcase48", "two_tex"])
def test_kernel_walks_match_cast_walks(showcase48, two_tex, name):
    """A whole render through the walk kernels' path (their plain versions
    here) against the same scene with the kernels routed off (every step a
    cast over the transparent view), same seed: at most 0.5% of pixels
    beyond 1e-3 (tests/test_trwalk.py:44-65)."""
    from path_tracer_torch.models.integrator import IntegratorSpec
    from path_tracer_torch.models.renderer import render_pixel_sums

    _, s = _pair(name, showcase48, two_tex)
    spec = IntegratorSpec(bounces=3)
    a = render_pixel_sums(s, 48, 32, 1, 1, spec)
    b = render_pixel_sums(dataclasses.replace(s, tr_kernel_ok=False),
                          48, 32, 1, 1, spec)
    diff = np.abs(a - b)
    assert (diff.max(axis=-1) > 1e-3).mean() <= 0.005, diff.max()
    assert diff.mean() < 1e-5 and a.std() > 0
