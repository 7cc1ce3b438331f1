"""The port's intersection (plain PyTorch versions, on the CPU) against the
JAX package: its jnp reference path and its Pallas kernels in interpret
mode, as tests/test_pallas_intersect.py and test_pallas_spheres.py run them.

Tolerances:
- triangles: kind, prim and backface equal; t within rtol 1e-6; u and v
  within rtol 1e-4, atol 2e-6 (the Pallas-vs-jnp bounds of
  test_pallas_intersect.py: component-expanded math may associate
  differently from jnp.cross, and XLA's jit contracts multiply-adds into
  FMAs where the port rounds each). t also gets atol 2e-7: it inherits the
  absolute rounding of o - v0, about an ulp of the coordinates (1.2e-7 at
  |x| ~ 1.5), which is more than 1e-6 of t for hits near the origin;
- the reference's 6,024 MT fixtures at 1e-5 (its own tolerance);
- spheres: kind, prim and backface equal, t within rtol 1e-3 (the bound of
  test_pallas_spheres.py; the TPU kernel multiplies by 1/(2a) where the
  jnp path and the port divide).
"""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_tracer_torch.scene import from_numpy
from path_tracer_torch.scene.device_scene import ARRAY_FIELDS, STATIC_FIELDS

FIXTURES = Path(__file__).parent / "fixtures" / "moller_trumbore"


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _scenes(root, name):
    from path_tracer_tpu.scene import load_scene

    js = load_scene(root / name / "scene.isf")
    ts = from_numpy({f: np.asarray(getattr(js, f)) for f in ARRAY_FIELDS},
                    {s: getattr(js, s) for s in STATIC_FIELDS}, "cpu")
    return js, ts


def _rays(seed, r, lo, hi):
    g = np.random.default_rng(seed)
    span = hi - lo
    o = g.uniform(lo - 0.5 * span, hi + 0.5 * span, (r, 3)).astype(np.float32)
    d = g.uniform(lo, hi, (r, 3)).astype(np.float32) - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d


def _assert_tri_equal(got, want):
    np.testing.assert_array_equal(got.kind.numpy(), np.asarray(want.kind))
    np.testing.assert_array_equal(got.prim.numpy(), np.asarray(want.prim))
    np.testing.assert_array_equal(got.backface.numpy(),
                                  np.asarray(want.backface))
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=1e-6,
                               atol=2e-7)
    np.testing.assert_allclose(got.u.numpy(), np.asarray(want.u), rtol=1e-4,
                               atol=2e-6)
    np.testing.assert_allclose(got.v.numpy(), np.asarray(want.v), rtol=1e-4,
                               atol=2e-6)


@pytest.mark.parametrize("name", ["cube", "reflection", "head"])
def test_triangles_match_jnp_and_pallas(reference_scenes, name):
    from path_tracer_torch.ops.cuda_intersect import closest_hit_triangles_cuda
    from path_tracer_tpu.ops.intersect import closest_hit_triangles
    from path_tracer_tpu.ops.pallas_intersect import (
        closest_hit_triangles_pallas,
    )

    js, ts = _scenes(reference_scenes, name)
    v = np.asarray(js.tri_v0)[: js.num_real_triangles]
    r = 300  # not a multiple of any tile
    o, d = _rays(11, r, v.min(0), v.max(0))
    T, J = torch.from_numpy, jnp.asarray
    tp = np.full(r, -1.0, np.float32)
    got = closest_hit_triangles_cuda(T(o), T(d), T(tp), ts)  # CPU: plain
    assert float(got.valid.float().mean()) > 0.3
    _assert_tri_equal(got, closest_hit_triangles(J(o), J(d), J(tp), js))
    _assert_tri_equal(got, closest_hit_triangles_pallas(J(o), J(d), J(tp), js,
                                                        interpret=True))
    # The re-cast pattern past the first hit, plus dead lanes (+inf). The
    # 1e-4 margin keeps an ulp-level difference in the first hit's t from
    # deciding whether that same triangle is found again.
    tp2 = np.where(np.isfinite(got.t.numpy()), got.t.numpy() + 1e-4, -1.0)
    tp2 = tp2.astype(np.float32)
    tp2[::5] = np.inf
    got2 = closest_hit_triangles_cuda(T(o), T(d), T(tp2), ts)
    _assert_tri_equal(got2, closest_hit_triangles(J(o), J(d), J(tp2), js))


def _fixture(name):
    z = np.load(FIXTURES / f"{name}.npz")
    return {k: z[k] for k in z.files}


def test_mt_fixtures_hits_and_misses():
    """The reference's 6,024 MT cases through the port's moller_trumbore,
    each ray against its own triangle (the diagonal of the [R,B] result)."""
    from path_tracer_torch.ops.intersect import moller_trumbore

    n_cases = 0
    for name in ("hit_tests", "miss_tests"):
        c = _fixture(name)
        T = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32))
        n = c["origin"].shape[0]
        hit = np.zeros(n, bool)
        t = np.zeros(n, np.float32)
        u = np.zeros(n, np.float32)
        v = np.zeros(n, np.float32)
        for a in range(0, n, 512):
            s = slice(a, min(n, a + 512))
            res = moller_trumbore(T(c["origin"][s]), T(c["dir"][s]),
                                  T(c["v0"][s]), T(c["v1"][s] - c["v0"][s]),
                                  T(c["v2"][s] - c["v0"][s]),
                                  torch.full((s.stop - a,), -1.0))
            tt, uu, vv, _, ok = (x.diagonal().numpy() for x in res)
            t[s], u[s], v[s], hit[s] = tt, uu, vv, ok
        if name == "hit_tests":
            assert hit.all(), f"{(~hit).sum()} of {n} hit cases missed"
            np.testing.assert_allclose(t, c["dist"], atol=1e-5, rtol=0)
            np.testing.assert_allclose(u, c["u"], atol=1e-5, rtol=0)
            np.testing.assert_allclose(v, c["v"], atol=1e-5, rtol=0)
        else:
            assert not hit.any(), f"{hit.sum()} of {n} miss cases hit"
        n_cases += n
    assert n_cases == 6024


@pytest.mark.parametrize("name", ["spheres", "white_furnace_indirect"])
def test_spheres_match_jnp_and_pallas(reference_scenes, name):
    from path_tracer_torch.ops.cuda_spheres import closest_hit_spheres_cuda
    from path_tracer_tpu.ops.intersect import closest_hit_spheres
    from path_tracer_tpu.ops.pallas_spheres import closest_hit_spheres_pallas

    js, ts = _scenes(reference_scenes, name)
    c = np.asarray(js.sph_center)[: js.num_real_spheres]
    r = 700
    o, d = _rays(4, r, c.min(0) - 1, c.max(0) + 1)
    T, J = torch.from_numpy, jnp.asarray
    for tpv in (-1.0, 1.0):
        tp = np.full(r, tpv, np.float32)
        got = closest_hit_spheres_cuda(T(o), T(d), T(tp), ts)  # CPU: plain
        assert float(got.valid.float().mean()) > 0.3
        for want in (closest_hit_spheres(J(o), J(d), J(tp), js),
                     closest_hit_spheres_pallas(J(o), J(d), J(tp), js,
                                                interpret=True)):
            np.testing.assert_array_equal(got.kind.numpy(), np.asarray(want.kind))
            np.testing.assert_array_equal(got.prim.numpy(), np.asarray(want.prim))
            np.testing.assert_array_equal(got.backface.numpy(),
                                          np.asarray(want.backface))
            np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t),
                                       rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("name", ["cube", "spheres"])
def test_occluded_matches_jax(reference_scenes, name):
    """Point-light style occlusion (range-limited) and unlimited, against
    the JAX package's any-hit, through the port's ``occluded_multi`` with
    one light (the port has no single-light form). The port takes the
    nearest triangle hit (the TPU path's form); equal by monotonicity of
    the distance in t."""
    from path_tracer_torch.ops.intersect import occluded_multi
    from path_tracer_tpu.ops.intersect import occluded as jocc

    js, ts = _scenes(reference_scenes, name)
    pts = (np.asarray(js.tri_v0)[: js.num_real_triangles]
           if js.num_real_triangles
           else np.asarray(js.sph_center)[: js.num_real_spheres])
    r = 500
    o, d = _rays(8, r, pts.min(0) - 1, pts.max(0) + 1)
    g = np.random.default_rng(9)
    surf = (o - 1e-3 * d).astype(np.float32)
    max_dist = g.uniform(0.1, 6.0, r).astype(np.float32)
    T, J = torch.from_numpy, jnp.asarray
    for kw_t, kw_j in (({}, {}),
                       (dict(surf_pos=T(surf), max_dists=[T(max_dist)]),
                        dict(surf_pos=J(surf), max_dist=J(max_dist)))):
        got = occluded_multi(T(o), [T(d)], ts, **kw_t)[0].numpy()
        want = np.asarray(jocc(J(o), J(d), js, **kw_j))
        np.testing.assert_array_equal(got, want)
        assert 0.05 < want.mean() < 0.95


def test_closest_hit_merges_kinds(reference_scenes):
    """closest_hit over a scene with both kinds: the JAX merge rule (a
    triangle wins ties) on the cornell box, which mixes both."""
    from path_tracer_torch.ops.intersect import closest_hit as tch
    from path_tracer_tpu.ops.intersect import closest_hit as jch
    from path_tracer_tpu.scene.procedural import cornell_device_scene

    js = cornell_device_scene()
    assert js.num_real_triangles and js.num_real_spheres
    ts = from_numpy({f: np.asarray(getattr(js, f)) for f in ARRAY_FIELDS},
                    {s: getattr(js, s) for s in STATIC_FIELDS}, "cpu")
    r = 400
    o, d = _rays(12, r, np.array([-1.5, 0.0, -1.5]), np.array([1.5, 3.0, 1.5]))
    tp = np.full(r, -1.0, np.float32)
    got = tch(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tp), ts)
    want = jch(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tp), js)
    for f in ("kind", "prim", "backface"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=1e-6)
    assert set(np.unique(got.kind.numpy())) >= {1, 2}
