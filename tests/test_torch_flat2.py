"""The two-level flat2 walk against the JAX package, on the CPU.

- Tables: ``sl_sbflat`` / ``sl_sbid`` (the superblock unions of 128 block
  columns) and both opacity-partition views' block and superblock slices
  equal the JAX builder's exactly, on the plain showcase at grid 96 in
  128-slot blocks (245 blocks, two superblocks), the textured showcase at
  grid 48 and ``alpha_transparency`` forced onto the BVH.
- Casts: ``closest_hit_triangles_flat2`` and
  ``occluded_triangles_flat2_multi`` on CPU tensors (their plain versions)
  against the Pallas kernels in interpret mode, on the grid-96 scene and
  the textured showcase's opaque view, with dead lanes. Tolerances, those
  of tests/test_torch_bvh.py: kind, prim and backface equal; t within
  rtol 1e-5, atol 1e-6 (the interpret kernel runs under XLA, which
  contracts the Baldwin-Weber multiply-adds into FMAs); u, v within
  rtol 1e-4, atol 1e-5 plus what that t moves them. Any-hit: equal.
- Flat2 equals flat: on the same tables the two walks give the same
  record (a block's box lies inside its superblock's and slab rounding is
  monotone, so both visit the same blocks), closest hit and any-hit; a
  whole render of the textured showcase forced onto flat2 by lowering
  ``FLAT_MAX_BLOCKS`` equals its flat render per pixel.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

R = 256  # lanes of an interpret run (two 128-lane Pallas tiles)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def grid96():
    """(JAX scene, port scene): the plain showcase at grid 96 in 128-slot
    blocks, 18,432 triangles in 245 blocks, two superblocks."""
    from path_tracer_torch.scene import build_scene
    from path_tracer_torch.scene.showcase import showcase_scene
    from path_tracer_tpu.scene.device_scene import build_device_scene
    from path_tracer_tpu.scene.showcase import showcase_scene as jax_showcase

    return (build_device_scene(jax_showcase(96), ".", use_bvh=True,
                               sl_block=128),
            build_scene(showcase_scene(96), ".", "cpu", use_bvh=True,
                        sl_block=128))


@pytest.fixture(scope="module")
def tex48():
    """(JAX scene, port scene): the textured showcase at grid 48 in 256-slot
    blocks (31 opaque blocks, 3 transparent)."""
    from path_tracer_torch.scene.showcase import showcase_device_scene
    from path_tracer_tpu.scene.showcase import (
        showcase_device_scene as jax_showcase,
    )

    return (jax_showcase(48, sl_block=256, textured=True),
            showcase_device_scene(48, "cpu", sl_block=256, textured=True))


def _pair(name, grid96, tex48, reference_scenes=None):
    if name == "grid96":
        return grid96
    if name == "tex48":
        return tex48
    from path_tracer_torch.scene import load_scene
    from path_tracer_tpu.scene import isf
    from path_tracer_tpu.scene.device_scene import build_device_scene

    path = reference_scenes / name / "scene.isf"
    return (build_device_scene(isf.load(path), path.parent, use_bvh=True),
            load_scene(path, "cpu", use_bvh=True))


def _cast_pair(name, grid96, tex48):
    """(JAX scene, port scene) a cast runs on: the grid-96 scene, or the
    textured showcase's opaque view (a partition view, as the integrator
    casts it)."""
    from path_tracer_torch.scene.device_scene import opaque_view
    from path_tracer_tpu.scene.device_scene import opaque_view as jax_view

    if name == "grid96":
        return grid96
    js, ts = tex48
    return jax_view(js), opaque_view(ts)


def _rays(ts, seed, r=R):
    """Rays from around the scene toward points inside its bounds, half of
    them from its camera; every 37th with a zero direction component."""
    g = np.random.default_rng(seed)
    v = ts.tri_v0[: ts.num_real_triangles].numpy()
    lo, hi = v.min(0), v.max(0)
    o = g.uniform(lo - 0.3 * (hi - lo), hi + 0.3 * (hi - lo), (r, 3))
    o[: r // 2] = ts.cam_to_world[:3, 3].numpy()
    d = g.uniform(lo, hi, (r, 3)) - o
    d[::37, 1] = 0.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _t_prev(r=R):
    """Fresh lanes, lanes past t = 0.5, and dead lanes (t_prev = +inf)."""
    tp = np.full(r, -1.0, np.float32)
    tp[1::3] = 0.5
    tp[::11] = np.inf
    return tp


@pytest.mark.parametrize("name", ["grid96", "tex48", "alpha_transparency"])
def test_superblock_tables_equal_jax(reference_scenes, grid96, tex48, name):
    from path_tracer_torch.scene.device_scene import partitioned

    js, ts = _pair(name, grid96, tex48, reference_scenes)
    if name == "grid96":
        assert int((ts.sl_sbid >= 0).sum()) == 2 and not partitioned(ts)
    else:
        assert partitioned(ts)
    assert_tables_equal(js, ts)


def assert_tables_equal(js, ts):
    """The superblock and block tables of the JAX scene ``js`` and the port
    scene ``ts``, and of both opacity-partition views when the scene is
    partitioned, are equal; every real superblock is the union of its
    group's real blocks."""
    from path_tracer_torch.scene.device_scene import (
        opaque_view,
        partitioned,
        transparent_view,
    )
    from path_tracer_tpu.scene.device_scene import (
        opaque_view as jax_opaque,
        transparent_view as jax_transparent,
    )

    pairs = [(js, ts)]
    if partitioned(ts):
        pairs += [(jax_opaque(js), opaque_view(ts)),
                  (jax_transparent(js), transparent_view(ts))]
    for jv, tv in pairs:
        for f in ("sl_sbflat", "sl_sbid", "sl_blkflat", "sl_blkid"):
            a, b = getattr(tv, f), np.asarray(getattr(jv, f))
            assert a.is_contiguous() and tuple(a.shape) == b.shape, f
            np.testing.assert_array_equal(a.numpy(), b, err_msg=f)
        assert tv.sl_n_blocks == jv.sl_n_blocks
    bf, ids = ts.sl_blkflat.numpy(), ts.sl_blkid.numpy()[0]
    for g in np.nonzero(ts.sl_sbid.numpy()[0] >= 0)[0]:
        cols = np.arange(128 * g, 128 * g + 128)
        cols = cols[ids[cols] >= 0]
        np.testing.assert_array_equal(ts.sl_sbflat[0:3, g].numpy(),
                                      bf[0:3, cols].min(1))
        np.testing.assert_array_equal(ts.sl_sbflat[3:6, g].numpy(),
                                      bf[3:6, cols].max(1))


def _assert_hits(got, want, ts, d):
    """The tolerances of tests/test_torch_bvh.py (module docstring)."""
    for f in ("kind", "prim", "backface"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    gt, wt = got.t.numpy(), np.asarray(want.t)
    np.testing.assert_allclose(gt, wt, rtol=1e-5, atol=1e-6)
    hit = got.valid.numpy()
    slot = ts.sl_inv[got.prim.clamp(min=0).long()]
    dt = 1e-5 * np.abs(np.where(hit, gt, 0.0)) + 1e-6
    for f, row in (("u", 4), ("v", 8)):
        grad = (ts.sl_bw_t[row:row + 3, slot].T * torch.from_numpy(d)).sum(1)
        slack = np.where(hit, np.abs(grad.numpy()) * dt, 0.0)
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert not (np.abs(a - b) > 1e-5 + 1e-4 * np.abs(b) + slack).any(), f


@pytest.mark.parametrize("name", ["grid96", "tex48"])
def test_flat2_closest_hit_matches_jax(grid96, tex48, name):
    from path_tracer_torch.ops.cuda_bvh import closest_hit_triangles_flat2
    from path_tracer_tpu.ops.pallas_bvh import (
        closest_hit_triangles_flat2 as jax_flat2,
    )

    js, ts = _cast_pair(name, grid96, tex48)
    o, d = _rays(ts, 3)
    tp = _t_prev()
    T, J = torch.from_numpy, jnp.asarray
    got = closest_hit_triangles_flat2(T(o), T(d), T(tp), ts)  # CPU: plain
    assert 0.3 < float(got.valid.float().mean()) < 0.95
    assert not got.valid[::11].any()
    _assert_hits(got, jax_flat2(J(o), J(d), J(tp), js, interpret=True), ts, d)


@pytest.mark.parametrize("name", ["grid96", "tex48"])
def test_flat2_occluded_matches_jax(grid96, tex48, name):
    """Three sets sharing one origin set: unbounded, bounded, and bounded
    with every third lane dead (t_max = -1, reported occluded)."""
    from path_tracer_torch.ops.cuda_bvh import occluded_triangles_flat2_multi
    from path_tracer_tpu.ops.pallas_bvh import (
        occluded_triangles_flat2_multi as jax_occ,
    )

    js, ts = _cast_pair(name, grid96, tex48)
    o, d0 = _rays(ts, 6)
    _, d1 = _rays(ts, 7)
    g = np.random.default_rng(8)
    v = ts.tri_v0[: ts.num_real_triangles].numpy()
    reach = np.linalg.norm(0.5 * (v.min(0) + v.max(0)) - o, axis=1)
    tm1 = (g.uniform(0.3, 1.5, R) * reach).astype(np.float32)
    tm2 = tm1.copy()
    tm2[::3] = -1.0
    ds, tms = [d0, d1, d0], [np.full(R, np.inf, np.float32), tm1, tm2]
    T, J = torch.from_numpy, jnp.asarray
    got = occluded_triangles_flat2_multi(T(o), [T(x) for x in ds],
                                         [T(x) for x in tms], ts)
    want = np.asarray(jax_occ(J(o), [J(x) for x in ds], [J(x) for x in tms],
                              js, interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.1 < want[1].mean() < 0.9 and want[2][::3].all()


@pytest.mark.parametrize("name", ["grid96", "tex48"])
def test_flat2_equals_flat(grid96, tex48, name):
    """Record for record on the same tables, on 2,048 lanes."""
    from path_tracer_torch.ops import cuda_bvh

    _, ts = _cast_pair(name, grid96, tex48)
    o, d = (torch.from_numpy(x) for x in _rays(ts, 9, 2048))
    tp = torch.from_numpy(_t_prev(2048))
    flat = cuda_bvh.closest_hit_triangles_flat(o, d, tp, ts)
    flat2 = cuda_bvh.closest_hit_triangles_flat2(o, d, tp, ts)
    for f in flat._fields:
        assert torch.equal(getattr(flat, f), getattr(flat2, f)), f
    assert flat.valid.float().mean() > 0.3
    tm = torch.where(flat.valid, flat.t * 1.01, 50.0)
    tm[::5] = -1.0
    sets = ([d, d, -d], [torch.full_like(tm, float("inf")), tm, tm])
    occ = cuda_bvh.occluded_triangles_flat_multi(o, *sets, ts)
    occ2 = cuda_bvh.occluded_triangles_flat2_multi(o, *sets, ts)
    assert torch.equal(occ, occ2) and 0.1 < occ[1].float().mean() < 0.95


def test_render_flat2_equals_flat(tex48, monkeypatch):
    """The textured showcase at 16x12, 2 spp, 3 bounces: forced onto the
    flat2 walks (every partition view and cast), it renders the flat
    walks' image value for value, and the flat2 walks did the casts."""
    from path_tracer_torch.models.integrator import IntegratorSpec
    from path_tracer_torch.models.renderer import render_pixel_sums
    from path_tracer_torch.ops import cuda_bvh, intersect

    _, ts = tex48
    spec = IntegratorSpec(bounces=3)
    flat = render_pixel_sums(ts, 16, 12, 1, 2, spec)
    calls = {"flat2": 0}
    walk2 = cuda_bvh.closest_hit_triangles_flat2

    def counted(*args):
        calls["flat2"] += 1
        return walk2(*args)

    monkeypatch.setattr(cuda_bvh, "closest_hit_triangles_flat2", counted)
    monkeypatch.setattr(intersect, "FLAT_MAX_BLOCKS", 0)
    flat2 = render_pixel_sums(ts, 16, 12, 1, 2, spec)
    assert calls["flat2"] > 0 and flat.std() > 0
    np.testing.assert_array_equal(flat2, flat)


def _compare_full_size(grid: int, sl_block: int, textured: bool) -> None:
    """Build the showcase with both builders on the CPU and hold the port's
    tables against JAX's: every array field, and the superblock tables of
    both views; print the counts and build times."""
    import time

    import jax

    jax.config.update("jax_platforms", "cpu")
    from path_tracer_torch.scene.device_scene import (
        ARRAY_FIELDS,
        opaque_view,
        partitioned,
    )
    from path_tracer_torch.scene.showcase import showcase_device_scene
    from path_tracer_tpu.scene.showcase import (
        showcase_device_scene as jax_showcase,
    )

    t0 = time.perf_counter()
    js = jax_showcase(grid, sl_block=sl_block, textured=textured)
    t1 = time.perf_counter()
    ts = showcase_device_scene(grid, "cpu", sl_block=sl_block,
                               textured=textured)
    t2 = time.perf_counter()
    assert_tables_equal(js, ts)
    for f in ARRAY_FIELDS:
        a, b = getattr(ts, f), np.asarray(getattr(js, f))
        assert tuple(a.shape) == b.shape, f
        np.testing.assert_array_equal(a.numpy(), b, err_msg=f)
    view = opaque_view(ts) if partitioned(ts) else ts
    print(f"showcase grid {grid}, textured {textured}, {sl_block}-slot "
          f"blocks: {ts.num_real_triangles} triangles, {ts.sl_n_blocks} "
          f"blocks ({view.sl_n_blocks} opaque) in "
          f"{int((view.sl_sbid >= 0).sum())} opaque superblocks, sl_bw_t "
          f"{tuple(ts.sl_bw_t.shape)} = {ts.sl_bw_t.nbytes / 1e6:.1f} MB; "
          f"every array field equals JAX's; built in {t1 - t0:.1f} s (JAX) "
          f"and {t2 - t1:.1f} s (port) on the CPU")


if __name__ == "__main__":
    # python tests/test_torch_flat2.py GRID SL_BLOCK [textured]
    import sys

    _compare_full_size(int(sys.argv[1]), int(sys.argv[2]),
                       sys.argv[3:] == ["textured"])
