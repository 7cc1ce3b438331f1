"""The dense sphere closest hit's merged record on the CPU, against the JAX
package. On the card one launch (``csrc/sphere_closest_hit.cu``) casts the
spheres and merges the triangle record; its plain version,
``cuda_spheres.closest_hit_spheres_merged_plain`` (the dense sphere cast,
then ``intersect.merge_hits``), is what it is held to, and the function
tested here. The rule is JAX's ``closest_hit`` merge: a sphere wins only on
a strictly smaller t, the triangle record on ties and double misses.

- The Cornell box (both kinds, brute force): the plain merge of the port's
  MT record against JAX's ``closest_hit`` at fresh, advanced and dead
  lanes. Tolerances, those of tests/test_torch_intersect.py: kind, prim
  and backface equal; t within rtol 1e-6, atol 2e-7; u, v within
  rtol 1e-4, atol 2e-6.
- The textured showcase at grid 48, its opaque view forced onto the flat2
  walk: the port's ``closest_hit`` (flat2, then the merged sphere cast)
  against JAX's flat2 kernel in interpret mode and its dense sphere cast,
  merged by JAX's rule, every field. Tolerances, those of
  tests/test_torch_bvh.py's fused-sphere test: triangle t within
  rtol 1e-5, atol 1e-6 (the interpret kernel runs under XLA, which
  contracts the Baldwin-Weber multiply-adds); sphere t within rtol 1e-3;
  u, v within rtol 1e-4, atol 1e-5 plus what that t moves them.
- Equal t: a triangle record at the sphere record's t wins every lane; one
  an ulp past it loses every lane the sphere hits.
- The launcher's checks of the triangle record (dtype, shape, layout,
  device) raise before any build or launch.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_tracer_torch.scene import from_numpy
from path_tracer_torch.scene.device_scene import ARRAY_FIELDS, STATIC_FIELDS

R = 256  # lanes of an interpret run (two 128-lane Pallas tiles)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cornell():
    """(JAX scene, port scene): the Cornell box, triangles and spheres."""
    from path_tracer_tpu.scene.procedural import cornell_device_scene

    js = cornell_device_scene()
    ts = from_numpy({f: np.asarray(getattr(js, f)) for f in ARRAY_FIELDS},
                    {s: getattr(js, s) for s in STATIC_FIELDS}, "cpu")
    assert js.num_real_triangles and js.num_real_spheres and not ts.use_bvh
    return js, ts


@pytest.fixture(scope="module")
def tex48_opaque():
    """(JAX view, port view): the textured showcase at grid 48 in 256-slot
    blocks (48 spheres), its opaque partition view."""
    from path_tracer_torch.scene.device_scene import opaque_view
    from path_tracer_torch.scene.showcase import showcase_device_scene
    from path_tracer_tpu.scene.device_scene import opaque_view as jax_view
    from path_tracer_tpu.scene.showcase import (
        showcase_device_scene as jax_showcase,
    )

    js = jax_showcase(48, sl_block=256, textured=True)
    ts = showcase_device_scene(48, "cpu", sl_block=256, textured=True)
    assert ts.num_real_spheres and not ts.sph_use_blocks
    return jax_view(js), opaque_view(ts)


def _rays(ts, seed, r=R):
    """Rays from around the scene (half from its camera, where it has one)
    toward points inside its bounds; every third aimed at a sphere."""
    g = np.random.default_rng(seed)
    v = ts.tri_v0[: ts.num_real_triangles].numpy()
    lo, hi = v.min(0), v.max(0)
    o = g.uniform(lo - 0.3 * (hi - lo), hi + 0.3 * (hi - lo), (r, 3))
    if ts.use_bvh:
        o[: r // 2] = ts.cam_to_world[:3, 3].numpy()
    tgt = g.uniform(lo, hi, (r, 3))
    c = ts.sph_center[: ts.num_real_spheres].numpy()
    tgt[::3] = c[g.integers(0, len(c), len(tgt[::3]))]
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _t_prev(kind, t_first, r=R):
    """Fresh lanes (-1), lanes advanced past a fraction of their first hit,
    or fresh lanes with every seventh dead (+inf)."""
    tp = np.full(r, -1.0, np.float32)
    if kind == "advanced":
        hit = np.isfinite(t_first)
        tp[hit] = (0.5 * t_first[hit]).astype(np.float32)
    elif kind == "dead":
        tp[::7] = np.inf
    return tp


@pytest.mark.parametrize("lanes", ["fresh", "advanced", "dead"])
def test_plain_merge_matches_jax_closest_hit(cornell, lanes):
    from path_tracer_torch.ops.cuda_spheres import (
        closest_hit_spheres_merged_plain,
    )
    from path_tracer_torch.ops.intersect import closest_hit_triangles
    from path_tracer_tpu.ops.intersect import closest_hit as jax_closest

    js, ts = cornell
    o, d = _rays(ts, 12, 400)
    T, J = torch.from_numpy, jnp.asarray
    first = np.asarray(jax_closest(J(o), J(d), J(np.full(400, -1.0,
                                                          np.float32)),
                                   js).t)
    tp = _t_prev(lanes, first, 400)
    tri = closest_hit_triangles(T(o), T(d), T(tp), ts)
    got = closest_hit_spheres_merged_plain(T(o), T(d), T(tp), ts, tri)
    want = jax_closest(J(o), J(d), J(tp), js)
    for f in ("kind", "prim", "backface"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=1e-6,
                               atol=2e-7)
    for f in ("u", "v"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-4,
                                   atol=2e-6, err_msg=f)
    assert {1, 2} <= set(np.unique(got.kind.numpy()))
    if lanes == "dead":
        assert not got.valid[::7].any()


def _assert_hits(got, want, ts, d):
    """tests/test_torch_bvh.py's tolerances, sphere lanes (kind 2) at
    rtol 1e-3 in t and u = v = 0."""
    for f in ("kind", "prim", "backface"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    gt, wt = got.t.numpy(), np.asarray(want.t)
    sph = got.kind.numpy() == 2
    np.testing.assert_allclose(gt[~sph], wt[~sph], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gt[sph], wt[sph], rtol=1e-3)
    hit = (got.kind == 1).numpy()
    slot = ts.sl_inv[got.prim.clamp(min=0).long()]
    dt = 1e-5 * np.abs(np.where(hit, gt, 0.0)) + 1e-6
    for f, row in (("u", 4), ("v", 8)):
        grad = (ts.sl_bw_t[row:row + 3, slot].T * torch.from_numpy(d)).sum(1)
        slack = np.where(hit, np.abs(grad.numpy()) * dt, 0.0)
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert not (np.abs(a - b) > 1e-5 + 1e-4 * np.abs(b) + slack).any(), f


@pytest.mark.parametrize("lanes", ["fresh", "advanced", "dead"])
def test_flat2_showcase_merge_matches_jax(tex48_opaque, lanes, monkeypatch):
    from path_tracer_torch.ops import cuda_bvh, intersect
    from path_tracer_tpu.ops.intersect import (
        closest_hit_spheres as jax_spheres,
    )
    from path_tracer_tpu.ops.pallas_bvh import (
        closest_hit_triangles_flat2 as jax_flat2,
    )

    js, ts = tex48_opaque
    monkeypatch.setattr(intersect, "FLAT_MAX_BLOCKS", 0)  # flat2 routes
    o, d = _rays(ts, 21)
    T, J = torch.from_numpy, jnp.asarray
    minus1 = np.full(R, -1.0, np.float32)
    first = intersect.closest_hit(T(o), T(d), T(minus1), ts).t.numpy()
    tp = _t_prev(lanes, first)
    calls = {"flat2": 0}
    walk2 = cuda_bvh.closest_hit_triangles_flat2

    def counted(*args):
        calls["flat2"] += 1
        return walk2(*args)

    monkeypatch.setattr(cuda_bvh, "closest_hit_triangles_flat2", counted)
    got = intersect.closest_hit(T(o), T(d), T(tp), ts)
    assert calls["flat2"] == 1
    tri = jax_flat2(J(o), J(d), J(tp), js, interpret=True)
    sph = jax_spheres(J(o), J(d), J(tp), js)
    tri_wins = np.asarray(tri.t) <= np.asarray(sph.t)
    want = type(got)(*[np.where(tri_wins, np.asarray(getattr(tri, f)),
                                np.asarray(getattr(sph, f)))
                       for f in got._fields])
    _assert_hits(got, want, ts, d)
    assert {1, 2} <= set(np.unique(got.kind.numpy()))


@pytest.mark.parametrize("scene", ["cornell", "tex48_opaque"])
def test_triangle_wins_equal_t(cornell, tex48_opaque, scene):
    """A triangle record at the sphere record's t keeps every field on
    every lane, misses included; an ulp past it, the sphere's record wins
    every lane the sphere hits."""
    from path_tracer_torch.ops.cuda_spheres import (
        closest_hit_spheres_merged_plain,
    )
    from path_tracer_torch.ops.intersect import (
        HitRecord,
        closest_hit_spheres,
    )

    _, ts = cornell if scene == "cornell" else tex48_opaque
    o, d = (torch.from_numpy(x) for x in _rays(ts, 31))
    tp = torch.full((R,), -1.0)
    tp[::9] = float("inf")
    sph = closest_hit_spheres(o, d, tp, ts)
    assert 0.1 < float(sph.valid.float().mean()) < 1.0
    g = torch.Generator().manual_seed(7)

    def tri_at(t):
        return HitRecord(
            t=t, kind=torch.where(torch.isfinite(t), 1, 0).to(torch.int32),
            prim=torch.randint(0, 1000, (R,), generator=g, dtype=torch.int32),
            u=torch.rand(R, generator=g), v=torch.rand(R, generator=g),
            backface=torch.rand(R, generator=g) < 0.5)

    tie = tri_at(sph.t.clone())
    got = closest_hit_spheres_merged_plain(o, d, tp, ts, tie)
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(tie, f)), f
    past = tri_at(torch.nextafter(sph.t, torch.tensor(float("inf"))))
    got = closest_hit_spheres_merged_plain(o, d, tp, ts, past)
    hit = sph.valid
    for f in got._fields:
        assert torch.equal(getattr(got, f)[hit], getattr(sph, f)[hit]), f
        assert torch.equal(getattr(got, f)[~hit], getattr(past, f)[~hit]), f


@pytest.mark.parametrize("fault", ["dtype", "shape", "layout", "device"])
def test_sphere_launch_checks_triangle_record(fault):
    """A triangle record the kernel cannot take raises ValueError before
    the kernels are built or launched."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from path_tracer_torch import native
    from path_tracer_torch.ops.intersect import HitRecord

    n = 64
    mode = FakeTensorMode()
    with mode:
        cuda = dict(device="cuda")
        o, d = (torch.empty((n, 3), **cuda) for _ in range(2))
        tp = torch.empty((n,), **cuda)
        sph = torch.empty((4, 128), **cuda)
        f32 = lambda: torch.empty((n,), **cuda)
        i32 = lambda: torch.empty((n,), dtype=torch.int32, **cuda)
        tri = HitRecord(t=f32(), kind=i32(), prim=i32(), u=f32(), v=f32(),
                        backface=torch.empty((n,), dtype=torch.bool, **cuda))
        if fault == "dtype":
            tri = tri._replace(kind=f32())
        elif fault == "shape":
            tri = tri._replace(t=torch.empty((n - 1,), **cuda))
        elif fault == "layout":
            tri = tri._replace(u=torch.empty_strided((n,), (2,), **cuda))
    if fault == "device":
        tri = tri._replace(prim=torch.zeros(n, dtype=torch.int32))
    with mode, pytest.raises(ValueError):
        native.launch_sphere_closest_hit(o, d, tp, sph, tri)
