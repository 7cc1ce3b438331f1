"""The port's flat BVH slice against the JAX package, on the CPU.

- Tables: ``build_scene(..., use_bvh=True, sl_block=256)`` equals the JAX
  ``build_device_scene`` exactly (superleaf tables, statics, triangles), on
  forced-BVH ``cube`` and ``reflection`` and the showcase at grid 48; the
  port's showcase and ISF writer equal the JAX package's.
- Casts: the plain flat closest hit and any-hit (what the CUDA wrappers
  run on CPU tensors) against the Pallas kernels in interpret mode and the
  jnp brute force. Tolerances, those of tests/test_pallas_flat.py:
  kind, prim and backface equal; t within rtol 1e-5, atol 1e-6 (the
  Baldwin-Weber form against MT, and the interpret kernel's own
  association, which XLA contracts into FMAs); u and v within rtol 1e-4,
  atol 1e-5, plus what that t difference moves them: the Baldwin-Weber u
  is Au.(o + t d) + au, so a t off by dt moves u by |Au.d| dt (at the
  showcase's 30-unit camera distance and 0.18-unit cells, 1e-6 of t is
  1.6e-4 of u; the JAX package's own flat-vs-brute test ran at unit
  scale, where this term is below 1e-5). Sphere lanes of the
  fused mode: t within rtol 1e-3 (test_pallas_spheres.py's bound: the TPU
  kernel multiplies by 1/(2a) where the port divides, and the quadratic
  cancels for rays far from a sphere). Any-hit: equal.
"""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_tracer_torch.scene import from_numpy
from path_tracer_torch.scene.device_scene import ARRAY_FIELDS, STATIC_FIELDS

R = 512


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _carry(js):
    return from_numpy({f: np.asarray(getattr(js, f)) for f in ARRAY_FIELDS},
                      {s: getattr(js, s) for s in STATIC_FIELDS}, "cpu")


@pytest.fixture(scope="module")
def showcase48():
    """(JAX scene, port scene) of the plain showcase at grid 48, 256-slot
    blocks: 4,608 triangles in 31 blocks, 48 spheres."""
    from path_tracer_torch.scene import build_scene
    from path_tracer_torch.scene.showcase import showcase_scene
    from path_tracer_tpu.scene.device_scene import build_device_scene
    from path_tracer_tpu.scene.showcase import showcase_scene as jax_showcase

    js = build_device_scene(jax_showcase(48), ".", use_bvh=True, sl_block=256)
    ts = build_scene(showcase_scene(48), ".", "cpu", use_bvh=True,
                     sl_block=256)
    return js, ts


@pytest.fixture(scope="module")
def head(reference_scenes):
    """The ``head`` mesh (2,434 triangles, 512-slot blocks) carried across
    from the JAX package: its tables serve the casts, its alpha does not."""
    from path_tracer_tpu.scene import load_scene

    js = load_scene(reference_scenes / "head" / "scene.isf")
    return js, _carry(js)


def _cast_scene(name, head, showcase48):
    return head if name == "head" else showcase48


def _rays(js, seed):
    """Rays from around the scene toward points inside its bounds, plus
    the showcase-like view from above (the camera of the JAX scene)."""
    g = np.random.default_rng(seed)
    v = np.asarray(js.tri_v0)[: js.num_real_triangles]
    lo, hi = v.min(0), v.max(0)
    o = g.uniform(lo - 0.3 * (hi - lo), hi + 0.3 * (hi - lo), (R, 3))
    o[: R // 2] = np.asarray(js.cam_to_world)[:3, 3]
    d = g.uniform(lo, hi, (R, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[::37, 1] = 0.0  # zero direction components (the 1e30 reciprocal)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _assert_hits(got, want, ts, d, sphere_lanes=None):
    for f in ("kind", "prim", "backface"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    gt, wt = got.t.numpy(), np.asarray(want.t)
    tri = np.ones(gt.shape, bool) if sphere_lanes is None else ~sphere_lanes
    np.testing.assert_allclose(gt[tri], wt[tri], rtol=1e-5, atol=1e-6)
    if sphere_lanes is not None:
        np.testing.assert_allclose(gt[sphere_lanes], wt[sphere_lanes],
                                   rtol=1e-3)
    hit = (got.kind == 1).numpy()
    slot = ts.sl_inv[got.prim.clamp(min=0).long()]
    dt = 1e-5 * np.abs(np.where(hit, gt, 0.0)) + 1e-6
    for f, row in (("u", 4), ("v", 8)):
        grad = (ts.sl_bw_t[row:row + 3, slot].T * torch.from_numpy(d)).sum(1)
        slack = np.where(hit, np.abs(grad.numpy()) * dt, 0.0)
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        bad = np.abs(a - b) > 1e-5 + 1e-4 * np.abs(b) + slack
        assert not bad.any(), (f, a[bad], b[bad], slack[bad])


@pytest.mark.parametrize("name", ["cube", "reflection", "showcase48"])
def test_bvh_tables_equal_jax(reference_scenes, showcase48, name):
    from path_tracer_torch.scene import load_scene
    from path_tracer_tpu.scene import isf as jisf
    from path_tracer_tpu.scene.device_scene import build_device_scene

    if name == "showcase48":
        js, built = showcase48
    else:
        path = reference_scenes / name / "scene.isf"
        js = build_device_scene(jisf.load(path), path.parent, use_bvh=True,
                                sl_block=256)
        built = load_scene(path, "cpu", use_bvh=True, sl_block=256)
    carried = _carry(js)
    for f in ARRAY_FIELDS:
        a, b = getattr(built, f), getattr(carried, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=f)
    for s in STATIC_FIELDS:
        assert getattr(built, s) == getattr(carried, s), s
    assert built.use_bvh and built.sl_block == 256 and built.sl_n_blocks > 0
    assert built.sph_row_base == built.sl_n_blocks * 256


def test_showcase_scene_equals_jax():
    from path_tracer_torch.scene import isf
    from path_tracer_torch.scene.showcase import showcase_scene
    from path_tracer_tpu.scene import isf as jisf
    from path_tracer_tpu.scene.showcase import showcase_scene as jax_showcase

    scene = showcase_scene(48)
    assert isf.to_dict(scene) == jisf.to_dict(jax_showcase(48))
    assert sum(len(m.triangles) for m in scene.models
               if isinstance(m, isf.Mesh)) == 2 * 48 * 48
    assert isf.to_dict(showcase_scene(48, textured=True)) == jisf.to_dict(
        jax_showcase(48, textured=True))


def test_isf_writer_round_trips(reference_scenes, tmp_path):
    """The port's ``save`` writes what the JAX package's writes, and both
    loaders read it back as the scene that was saved."""
    from path_tracer_torch.scene import isf
    from path_tracer_torch.scene.showcase import write_showcase_scene_dir
    from path_tracer_tpu.scene import isf as jisf

    for path in sorted(reference_scenes.glob("*/scene.isf")):
        scene = isf.load(path)
        out = tmp_path / f"{path.parent.name}.isf"
        isf.save(scene, out)
        assert json.loads(out.read_text()) == jisf.to_dict(jisf.load(path))
        assert isf.load(out) == scene
        assert dataclasses.asdict(jisf.load(out)) == dataclasses.asdict(scene)
    written = write_showcase_scene_dir(tmp_path / "showcase", grid=8)
    assert written == tmp_path / "showcase" / "scene.isf"
    assert dataclasses.asdict(isf.load(written)) == dataclasses.asdict(
        jisf.load(written))


@pytest.mark.parametrize("name", ["head", "showcase48"])
def test_flat_closest_hit_matches_jax(head, showcase48, name):
    from path_tracer_torch.ops.cuda_bvh import closest_hit_triangles_flat
    from path_tracer_tpu.ops.intersect import closest_hit_triangles
    from path_tracer_tpu.ops.pallas_bvh import (
        closest_hit_triangles_flat as jax_flat,
    )

    js, ts = _cast_scene(name, head, showcase48)
    o, d = _rays(js, 3)
    T, J = torch.from_numpy, jnp.asarray
    for t_prev in (-1.0, 0.5):
        tp = np.full(R, t_prev, np.float32)
        tp[::11] = np.inf  # dead lanes
        got = closest_hit_triangles_flat(T(o), T(d), T(tp), ts)  # CPU: plain
        assert 0.3 < float(got.valid.float().mean()) < 0.95
        assert not got.valid[::11].any()
        _assert_hits(got, jax_flat(J(o), J(d), J(tp), js, interpret=True),
                     ts, d)
        _assert_hits(got, closest_hit_triangles(J(o), J(d), J(tp), js),
                     ts, d)


def test_fused_spheres_match_jax(showcase48):
    """The fused sphere pass against the JAX fused interpret kernel, and
    against the flat walk, the dense sphere cast and the merge apart."""
    from path_tracer_torch.ops.cuda_bvh import closest_hit_triangles_flat
    from path_tracer_torch.ops.intersect import closest_hit_spheres
    from path_tracer_tpu.ops.pallas_bvh import (
        closest_hit_triangles_flat as jax_flat,
    )

    js, ts = showcase48
    o, d = _rays(js, 5)
    T, J = torch.from_numpy, jnp.asarray
    for t_prev in (-1.0, 0.5):
        tp = np.full(R, t_prev, np.float32)
        got = closest_hit_triangles_flat(T(o), T(d), T(tp), ts, spheres=True)
        kinds = set(np.unique(got.kind.numpy()))
        assert kinds == {0, 1, 2}, kinds
        _assert_hits(got, jax_flat(J(o), J(d), J(tp), js, interpret=True,
                                   spheres=True),
                     ts, d, sphere_lanes=got.kind.numpy() == 2)
        tri = closest_hit_triangles_flat(T(o), T(d), T(tp), ts)
        sph = closest_hit_spheres(T(o), T(d), T(tp), ts)
        sph_wins = sph.t < tri.t
        for f in got._fields:
            want = torch.where(sph_wins, getattr(sph, f), getattr(tri, f))
            assert torch.equal(getattr(got, f), want), f


@pytest.mark.parametrize("name", ["head", "showcase48"])
def test_flat_occluded_matches_jax(head, showcase48, name):
    """Single and multi-set any-hit against the interpret kernels: equal,
    with unbounded, bounded and dead-lane (t_max = -1) sets."""
    from path_tracer_torch.ops.cuda_bvh import (
        occluded_triangles_flat,
        occluded_triangles_flat_multi,
    )
    from path_tracer_tpu.ops.pallas_bvh import (
        occluded_triangles_flat as jax_occ,
        occluded_triangles_flat_multi as jax_occ_multi,
    )

    js, ts = _cast_scene(name, head, showcase48)
    o, d0 = _rays(js, 6)
    _, d1 = _rays(js, 7)
    g = np.random.default_rng(8)
    v = np.asarray(js.tri_v0)[: js.num_real_triangles]
    reach = np.linalg.norm(0.5 * (v.min(0) + v.max(0)) - o, axis=1)
    tm1 = (g.uniform(0.3, 1.5, R) * reach).astype(np.float32)
    tm2 = tm1.copy()
    tm2[::3] = -1.0
    ds, tms = [d0, d1, d0], [np.full(R, np.inf, np.float32), tm1, tm2]
    T, J = torch.from_numpy, jnp.asarray
    multi = occluded_triangles_flat_multi(T(o), [T(x) for x in ds],
                                          [T(x) for x in tms], ts)
    want = np.asarray(jax_occ_multi(J(o), [J(x) for x in ds],
                                    [J(x) for x in tms], js, interpret=True))
    np.testing.assert_array_equal(multi.numpy(), want)
    assert 0.1 < want[1].mean() < 0.9 and want[2][::3].all()
    single = occluded_triangles_flat(T(o), T(d1), T(tm1), ts)
    np.testing.assert_array_equal(
        single.numpy(), np.asarray(jax_occ(J(o), J(d1), J(tm1), js,
                                           interpret=True)))
