"""Card tests of the port: each CUDA kernel against its plain PyTorch version
on the card, and a small render on the card against the same render on the
CPU. Marked ``gpu``; they skip where there is no CUDA device. This file
imports no JAX, so it runs on a machine without it::

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest.py configures JAX.)

Tolerances: the kernels are built -fmad=false and round every operation as
the plain versions do, so records must agree exactly, the flat and flat2
closest hits' included (like their plain versions they test every block a
lane's gates admit, with no cut at the lane's best t). The card render uses
the same kernels' results and ATen's CUDA elementwise ops, whose float32
rsqrt (not correctly rounded on the card) and transcendentals differ from
the CPU's by an ulp or two: rtol 1e-3, atol 1e-4 per pixel (the golden
tolerance) on the triangle scene. On the sphere scene such an ulp can flip
whether a ray leaving a sphere 1e-5 off its surface re-hits it (see
tests/test_torch_render.py): 3.0% of the values flipped at this size on an
H100, so the bound there is 5% of values and the mean radiance within 1%.
"""
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from path_tracer_torch.utils.telemetry import counters

pytestmark = pytest.mark.gpu

SCENES = Path(__file__).parent / "scenes"


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _rays(seed, r, lo, hi, device):
    g = np.random.default_rng(seed)
    span = hi - lo
    o = g.uniform(lo - 0.5 * span, hi + 0.5 * span, (r, 3))
    d = g.uniform(lo, hi, (r, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(device)
    return t(o), t(d)


def _assert_same(got, want):
    for f in got._fields:
        a, b = getattr(got, f), getattr(want, f)
        assert torch.equal(a, b), f


@pytest.mark.parametrize("name", ["cube", "reflection"])
def test_mt_kernel_equals_plain(cuda, name):
    from path_tracer_torch.ops import cuda_intersect, intersect
    from path_tracer_torch.scene import load_scene

    sc = load_scene(SCENES / name / "scene.isf", cuda)
    v = sc.tri_v0[: sc.num_real_triangles].cpu().numpy()
    o, d = _rays(1, 5003, v.min(0), v.max(0), cuda)
    tp = torch.full((5003,), -1.0, device=cuda)
    tp[::9] = float("inf")  # dead lanes
    before = counters["launch.mt_closest_hit"]
    got = cuda_intersect.closest_hit_triangles_cuda(o, d, tp, sc)
    assert counters["launch.mt_closest_hit"] == before + 1
    _assert_same(got, intersect.closest_hit_triangles(o, d, tp, sc))
    assert not got.valid[::9].any()


def _fake_tri(t, seed):
    """A triangle record of hits at t (kind 1 where finite), with random
    prim, u, v and backface."""
    from path_tracer_torch.ops.intersect import HitRecord

    g = torch.Generator(device=t.device).manual_seed(seed)
    m = t.shape[0]
    return HitRecord(
        t=t.contiguous(),
        kind=torch.where(torch.isfinite(t), 1, 0).to(torch.int32),
        prim=torch.randint(0, 1 << 20, (m,), generator=g, device=t.device,
                           dtype=torch.int32),
        u=torch.rand(m, generator=g, device=t.device),
        v=torch.rand(m, generator=g, device=t.device),
        backface=torch.rand(m, generator=g, device=t.device) < 0.5)


def test_sphere_kernel_equals_plain(cuda):
    """Row 2 alone and merged with a triangle record, field by field,
    against its plain version: fresh, advanced and dead lanes; a table past
    512 columns; triangle records at random t, at the sphere's t (the
    triangle wins every lane) and an ulp past it (the sphere wins every
    hitting lane)."""
    from path_tracer_torch.ops import cuda_spheres, intersect
    from path_tracer_torch.scene import load_scene
    from path_tracer_torch.scene.device_scene import _pack_spheres

    def check(o, d, tp, sc, tri=None):
        before = counters["launch.sphere_closest_hit"]
        got = cuda_spheres.closest_hit_spheres_cuda(o, d, tp, sc, tri=tri)
        assert counters["launch.sphere_closest_hit"] == before + 1
        _assert_same(got, cuda_spheres.closest_hit_spheres_merged_plain(
            o, d, tp, sc, tri))
        return got

    sc = load_scene(SCENES / "spheres" / "scene.isf", cuda)
    c = sc.sph_center[: sc.num_real_spheres].cpu().numpy()
    o, d = _rays(2, 5003, c.min(0) - 1, c.max(0) + 1, cuda)
    for tpv in (-1.0, 1.0):
        tp = torch.full((5003,), tpv, device=cuda)
        tp[::9] = float("inf")  # dead lanes
        got = check(o, d, tp, sc)
        _assert_same(got, intersect.closest_hit_spheres(o, d, tp, sc))
        assert not got.valid[::9].any() and got.valid.float().mean() > 0.2
        t_rand = torch.rand(5003, device=cuda) * 2.0 * got.t.nan_to_num(
            posinf=20.0)
        t_rand[::4] = float("inf")
        merged = check(o, d, tp, sc, _fake_tri(t_rand, 1))
        assert {1, 2} <= {int(k) for k in merged.kind.unique()}
        tie = _fake_tri(got.t, 2)
        _assert_same(check(o, d, tp, sc, tie), tie)  # the triangle wins
        past = check(o, d, tp, sc, _fake_tri(torch.nextafter(
            got.t, torch.tensor(float("inf"), device=cuda)), 3))
        assert bool((past.kind[got.valid] == 2).all())
    g = np.random.default_rng(3)
    centers = g.uniform(-5, 5, (600, 3)).astype(np.float32)  # past 512
    radii = g.uniform(0.05, 0.4, 600).astype(np.float32)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(cuda)
    big = SimpleNamespace(sph_center=t(centers), sph_radius=t(radii),
                          sph_packed_t=t(_pack_spheres(centers, radii)))
    o, d = _rays(4, 5003, np.full(3, -5.0), np.full(3, 5.0), cuda)
    tp = torch.full((5003,), -1.0, device=cuda)
    got = check(o, d, tp, big)
    _assert_same(got, intersect.closest_hit_spheres(o, d, tp, big))
    check(o, d, tp, big, _fake_tri(torch.flip(got.t, (0,)), 4))


@pytest.mark.parametrize("name", ["cube", "spheres"])
def test_card_render_matches_cpu(cuda, name):
    from path_tracer_torch.models.integrator import IntegratorSpec
    from path_tracer_torch.models.renderer import render_pixel_sums
    from path_tracer_torch.scene import load_scene

    spec = IntegratorSpec(bounces=2)
    path = SCENES / name / "scene.isf"
    before = (counters["launch.mt_closest_hit"]
              + counters["launch.sphere_closest_hit"])
    on_card = render_pixel_sums(load_scene(path, cuda), 32, 24, 1, 2, spec)
    assert (counters["launch.mt_closest_hit"]
            + counters["launch.sphere_closest_hit"]) > before
    on_cpu = render_pixel_sums(load_scene(path, "cpu"), 32, 24, 1, 2, spec)
    outside = np.abs(on_card - on_cpu) > 1e-4 + 1e-3 * np.abs(on_cpu)
    if name == "spheres":
        assert outside.mean() <= 0.05
        np.testing.assert_allclose(on_card.mean(), on_cpu.mean(), rtol=0.01)
    else:
        assert not outside.any()


def _flat_scenes(device):
    """Forced-BVH ``reflection`` (512-slot blocks) and the plain showcase
    at grid 48 (256-slot blocks), with rays from each scene's camera and
    from around its bounds."""
    from path_tracer_torch.scene import build_scene, load_scene
    from path_tracer_torch.scene.showcase import showcase_scene

    return {
        "reflection": load_scene(SCENES / "reflection" / "scene.isf", device,
                                 use_bvh=True),
        "showcase48": build_scene(showcase_scene(48), ".", device,
                                  use_bvh=True, sl_block=256),
    }


def _flat_rays(sc, seed, r, device):
    v = sc.tri_v0[: sc.num_real_triangles].cpu().numpy()
    o, d = _rays(seed, r, v.min(0), v.max(0), device)
    o[: r // 2] = sc.cam_to_world[:3, 3]
    tgt = torch.from_numpy(np.random.default_rng(seed + 1).uniform(
        v.min(0), v.max(0), (r // 2, 3)).astype(np.float32)).to(device)
    d[: r // 2] = torch.nn.functional.normalize(tgt - o[: r // 2], dim=1)
    return o, d


@pytest.mark.parametrize("name", ["reflection", "showcase48"])
def test_flat_closest_hit_equals_plain(cuda, name):
    from path_tracer_torch.ops import cuda_bvh

    sc = _flat_scenes(cuda)[name]
    r = 5003  # ragged: no multiple of the 128-ray CTA
    o, d = _flat_rays(sc, 5, r, cuda)
    for spheres in (False, True):
        for tpv in (-1.0, 0.5):
            tp = torch.full((r,), tpv, device=cuda)
            tp[::9] = float("inf")  # dead lanes
            before = counters["launch.flat_closest_hit"]
            got = cuda_bvh.closest_hit_triangles_flat(o, d, tp, sc, spheres)
            assert counters["launch.flat_closest_hit"] == before + 1
            want = cuda_bvh.closest_hit_triangles_flat_plain(o, d, tp, sc,
                                                             spheres)
            _assert_same(got, want)
            assert not got.valid[::9].any()
            assert got.valid.float().mean() > 0.3


@pytest.mark.parametrize("name", ["reflection", "showcase48"])
def test_flat_occluded_equals_plain(cuda, name):
    from path_tracer_torch.ops import cuda_bvh

    sc = _flat_scenes(cuda)[name]
    r = 5003
    o, d0 = _flat_rays(sc, 6, r, cuda)
    _, d1 = _flat_rays(sc, 7, r, cuda)
    g = np.random.default_rng(8)
    tm = torch.from_numpy(g.uniform(0.1, 40.0, r).astype(np.float32)).to(cuda)
    tm_dead = tm.clone()
    tm_dead[::3] = -1.0
    ds = [d0, d1, d0]
    tms = [torch.full((r,), float("inf"), device=cuda), tm, tm_dead]
    before = counters["launch.flat_occluded"]
    multi = cuda_bvh.occluded_triangles_flat_multi(o, ds, tms, sc)
    assert counters["launch.flat_occluded"] == before + 1
    for i in range(3):
        single = cuda_bvh.occluded_triangles_flat(o, ds[i], tms[i], sc)
        plain = cuda_bvh.occluded_triangles_flat_plain(o, ds[i], tms[i], sc)
        assert torch.equal(multi[i], single) and torch.equal(single, plain)
    assert multi[2][::3].all()
    assert 0.05 < multi[1].float().mean() < 0.95


def _flat2_scenes(device):
    """The plain showcase at grid 96 in 128-slot blocks (245 blocks, two
    superblocks) and the textured showcase's opaque partition view at grid
    48 in 256-slot blocks."""
    from path_tracer_torch.scene import build_scene
    from path_tracer_torch.scene.device_scene import opaque_view
    from path_tracer_torch.scene.showcase import (
        showcase_device_scene,
        showcase_scene,
    )

    return {
        "grid96": build_scene(showcase_scene(96), ".", device, use_bvh=True,
                              sl_block=128),
        "tex48_opaque": opaque_view(showcase_device_scene(
            48, device, sl_block=256, textured=True)),
    }


@pytest.mark.parametrize("name", ["grid96", "tex48_opaque"])
def test_flat2_kernels_equal_plain(cuda, name):
    """The flat2 closest hit against its plain version (fresh, advanced and
    dead lanes) and against the flat kernel on the same tables, on every
    field of every lane; the flat2 any-hit (three sets, dead lanes) against
    its plain version and the flat any-hit, a fourth set with whole and
    partly dead warps."""
    from path_tracer_torch.ops import cuda_bvh

    sc = _flat2_scenes(cuda)[name]
    r = 5003
    o, d = _flat_rays(sc, 13, r, cuda)
    for tpv in (-1.0, 0.5):
        tp = torch.full((r,), tpv, device=cuda)
        tp[::9] = float("inf")
        before = counters["launch.flat2_closest_hit"]
        got = cuda_bvh.closest_hit_triangles_flat2(o, d, tp, sc)
        assert counters["launch.flat2_closest_hit"] == before + 1
        for want in (cuda_bvh.closest_hit_triangles_flat2_plain(o, d, tp, sc),
                     cuda_bvh.closest_hit_triangles_flat(o, d, tp, sc)):
            _assert_same(got, want)
        assert not got.valid[::9].any() and got.valid.float().mean() > 0.3
    tm = torch.where(got.valid, got.t * 1.01, 40.0)
    tm_dead = tm.clone()
    tm_dead[::3] = -1.0
    ds, tms = [d, d, -d], [torch.full((r,), float("inf"), device=cuda), tm,
                           tm_dead]
    ds.append(d)
    tms.append(torch.where(torch.isinf(_dead_warps(tm)), -1.0, tm))
    before = counters["launch.flat2_occluded"]
    multi = cuda_bvh.occluded_triangles_flat2_multi(o, ds, tms, sc)
    assert counters["launch.flat2_occluded"] == before + 1
    assert torch.equal(multi, cuda_bvh.occluded_triangles_flat2_multi_plain(
        o, ds, tms, sc))
    assert torch.equal(multi, cuda_bvh.occluded_triangles_flat_multi(
        o, ds, tms, sc))
    assert multi[2][::3].all() and 0.05 < multi[1].float().mean() < 0.99
    assert multi[3][tms[3] < 0].all()


def test_sph_walk_kernel_equals_plain(cuda):
    """The sphere block walk on the 4,900-sphere grid against its plain
    version, exactly (fresh, advanced and dead lanes), and against the
    dense kernel within the flip-rate bound of tests/test_pallas_spheres.py
    (the two root forms round apart)."""
    from path_tracer_torch.ops import cuda_spheres, intersect
    from path_tracer_torch.scene.procedural import sphere_grid_device_scene

    sc = sphere_grid_device_scene(70, cuda)
    assert sc.sph_use_blocks
    o, d = _rays(14, 5003, np.full(3, -38.0), np.full(3, 38.0), cuda)
    for tpv in (-1.0, 5.0):
        tp = torch.full((5003,), tpv, device=cuda)
        tp[::9] = float("inf")
        before = counters["launch.sph_walk"]
        got = cuda_spheres.closest_hit_spheres_cuda(o, d, tp, sc)
        assert counters["launch.sph_walk"] == before + 1
        _assert_same(got, cuda_spheres.closest_hit_spheres_walk_plain(
            o, d, tp, sc))
        assert not got.valid[::9].any() and got.valid.float().mean() > 0.2
        dense = intersect.closest_hit_spheres(o, d, tp, sc)
        assert ((got.prim != dense.prim)
                | (got.kind != dense.kind)).float().mean() <= 0.01


def _held(got, want: dict):
    """Every field of every lane of ``got`` equals each record of
    ``want``."""
    for name, w in want.items():
        for f in got._fields:
            assert torch.equal(getattr(got, f), getattr(w, f)), (name, f)


def test_sph_walk_merged_record_equals_plain_and_cta(cuda):
    """Row 5 (the warp-packet sphere walk writing the merged record) on
    every field of every lane against its plain version (the CTA walk it
    replaced, once held here too, is no longer built): the 4,900-sphere
    grid's camera and random lanes, fresh, advanced past the first hit and
    with whole and partly dead warps on a ragged count; merged with
    triangle records at random t, at the sphere's t (the triangle wins)
    and an ulp past it (the sphere wins every hitting lane); and the
    duplicate-sphere tie scene, whose lanes keep the lowest slot, also
    with each sphere's later block grown so that the walk meets the
    higher-slot copy first; each in-block layout alone gives the mix's
    record."""
    from path_tracer_torch import native
    from path_tracer_torch.ops import cuda_spheres
    from path_tracer_torch.scene.procedural import (
        duplicate_sphere_device_scene,
        sphere_grid_device_scene,
        sphere_tie_rays,
    )

    def check(o, d, tp, sc, tri=None):
        before = counters["launch.sph_walk"]
        got = cuda_spheres.closest_hit_spheres_cuda(o, d, tp, sc, tri=tri)
        assert counters["launch.sph_walk"] == before + 1
        plain = cuda_spheres.closest_hit_spheres_walk_merged_plain
        _held(got, {"plain": plain(o, d, tp, sc, tri)})
        return got

    grid = sphere_grid_device_scene(70, cuda)
    r = 5003
    ro, rd = _rays(14, r, np.full(3, -38.0), np.full(3, 38.0), cuda)
    g = np.random.default_rng(33)
    co = torch.tensor([[0.0, 0.0, 7.0]], device=cuda).expand(r, 3)
    tgt = np.concatenate([g.uniform(-5, 5, (r, 2)), np.zeros((r, 1))], 1)
    cd = torch.from_numpy((tgt - [0.0, 0.0, 7.0]).astype(np.float32)).to(cuda)
    cd = (cd / cd.norm(dim=1, keepdim=True)).contiguous()
    for o, d in ((ro, rd), (co.contiguous(), cd)):
        fresh = torch.full((r,), -1.0, device=cuda)
        first = check(o, d, fresh, grid)
        assert first.valid.float().mean() > 0.2
        # Each in-block layout alone (lane per ray, the block over the
        # warp) gives the mix's record.
        tables = (grid.sph_blk, grid.sph_blkid, grid.sph_sorted_t,
                  grid.sph_smap)
        mix = native.launch_sph_walk(o, d, fresh, *tables)
        for lane_wise in (1, 33):
            one = native.launch_sph_walk(o, d, fresh, *tables,
                                         lane_wise=lane_wise)
            assert all(torch.equal(x, y) for x, y in zip(one, mix))
        adv = torch.where(first.valid, first.t, -1.0)
        far = check(o, d, adv, grid)
        assert far.backface.any()  # far roots of the first sphere
        dead = _dead_warps(fresh)
        got = check(o[:-37].contiguous(), d[:-37].contiguous(),
                    dead[:-37].contiguous(), grid)
        assert not got.valid[torch.isinf(dead[:-37])].any()
        t_rand = torch.rand(r, device=cuda) * 2.0 * first.t.nan_to_num(
            posinf=60.0)
        t_rand[::4] = float("inf")
        merged = check(o, d, fresh, grid, _fake_tri(t_rand, 5))
        assert {1, 2} <= {int(k) for k in merged.kind.unique()}
        tie = _fake_tri(first.t, 6)
        _held(check(o, d, fresh, grid, tie), {"triangle": tie})
        past = check(o, d, fresh, grid, _fake_tri(torch.nextafter(
            first.t, torch.tensor(float("inf"), device=cuda)), 7))
        assert bool((past.kind[first.valid] == 2).all())
    to, td = (torch.from_numpy(x).to(cuda) for x in sphere_tie_rays(8192, 5))
    tp = torch.full((8192,), -1.0, device=cuda)
    tp[::13] = float("inf")
    for margin in (0.0, 0.5):
        ties = duplicate_sphere_device_scene(cuda, margin)
        got = check(to, td, tp, ties)
        assert got.valid.float().mean() > 0.5
        # Each sphere's copies fill two blocks: the winner is the first slot
        # of the first.
        firsts = ties.sph_smap.view(-1, 128)[0::2, 0]
        assert bool(torch.isin(got.prim[got.valid], firsts).all())


def test_dense_sphere_any_hit_folds_prior(cuda, showcase_tex48):
    """Row 4 (one thread per ray over every set) on every lane of L = 1, 3
    and 8 sets against its plain version (the chunked kernel it replaced,
    once held here too, is no longer built): without prior, and with prior
    sets a random tenth occluded, dead lanes (every ninth) and whole and
    partly dead warps on a ragged count; a set whose prior is set comes
    out occluded, dead or not. More sets than the kernel takes raise."""
    from path_tracer_torch import native
    from path_tracer_torch.ops import cuda_spheres
    from path_tracer_torch.scene import load_scene

    for sc in (showcase_tex48, load_scene(SCENES / "spheres" / "scene.isf",
                                          cuda)):
        o, ds, tms = _sphere_shadow_sets(sc, 16, 5003, cuda)
        sets = [(ds, tms), (ds[:1], tms[:1])]
        sets.append(([ds[k % 2] * (1.0 if k < 4 else -1.0) for k in range(8)],
                     [tms[k % 2] for k in range(8)]))
        for dd, tt in sets:
            L = len(dd)
            g = torch.Generator(device=cuda).manual_seed(L)
            prior = torch.rand((L, 5003), generator=g, device=cuda) < 0.1
            for p in (None, prior):
                before = counters["launch.sph_occluded"]
                got = cuda_spheres.occluded_spheres_cuda(o, dd, tt, sc,
                                                         prior=p)
                assert counters["launch.sph_occluded"] == before + 1
                assert got.dtype == torch.bool and got.shape == (L, 5003)
                assert torch.equal(got, cuda_spheres.occluded_spheres_plain(
                    o, dd, tt, sc, p))
                if p is not None:
                    assert got[p].all()
            rr = 5003 - 37
            dead = torch.isinf(_dead_warps(torch.zeros(rr, device=cuda)))
            tw = [torch.where(dead, -1.0, x[:rr]) for x in tt]
            dw = [x[:rr] for x in dd]
            got = cuda_spheres.occluded_spheres_cuda(o[:rr], dw, tw, sc,
                                                     prior=prior[:, :rr])
            assert torch.equal(got, cuda_spheres.occluded_spheres_plain(
                o[:rr], dw, tw, sc, prior[:, :rr]))
        with pytest.raises(ValueError):
            native.launch_sph_occluded(
                o, torch.stack(ds * 5)[:9].contiguous(),
                torch.stack(tms * 5)[:9].contiguous(), sc.sph_packed_t,
                sc.num_real_spheres)


def test_occluded_multi_fold_equals_plain(cuda, showcase_tex48):
    """occluded_multi on the card (the flat any-hit's bool output handed to
    the dense sphere kernel as prior) against the same call on the CPU's
    plain versions, three lights with a tenth of each set dead."""
    from path_tracer_torch.ops import intersect

    sc = showcase_tex48
    o, ds, tms = _sphere_shadow_sets(sc, 17, 5003, cuda)
    g = torch.Generator(device=cuda).manual_seed(9)
    acts = [torch.rand(5003, generator=g, device=cuda) > 0.1
            for _ in range(3)]
    dirs = [ds[0], ds[1], -ds[0]]
    surf = o - 1e-3 * ds[0]
    dists = [None, torch.rand(5003, generator=g, device=cuda) * 8.0,
             torch.rand(5003, generator=g, device=cuda) * 3.0]
    before = counters["launch.sph_occluded"]
    got = intersect.occluded_multi(o, dirs, sc, surf_pos=surf,
                                   max_dists=dists, actives=acts)
    assert counters["launch.sph_occluded"] == before + 1
    cpu = lambda x: None if x is None else x.cpu()
    want = intersect.occluded_multi(
        o.cpu(), [x.cpu() for x in dirs], _scene_on_cpu(sc),
        surf_pos=surf.cpu(), max_dists=[cpu(x) for x in dists],
        actives=[x.cpu() for x in acts])
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    assert 0.05 < float(torch.stack(got).float().mean()) < 0.95


@pytest.mark.parametrize("n_sets", [9, 11, 17])
def test_dense_sphere_any_hit_chunks_sets(cuda, showcase_tex48, n_sets):
    """More sets than row 4's kernel holds per lane: the wrapper launches
    once per chunk of native.SPH_OCC_MAX_SETS and equals its plain version
    on every lane, with and without prior, as does occluded_multi with as
    many lights (the flat any-hit's output as prior, a tenth of each set
    dead)."""
    from path_tracer_torch import native
    from path_tracer_torch.ops import cuda_spheres, intersect

    sc = showcase_tex48
    o, ds, tms = _sphere_shadow_sets(sc, 18, 5003, cuda)
    dd = [ds[k % 2] * (1.0 if k % 4 < 2 else -1.0) for k in range(n_sets)]
    tt = [tms[k % 2] for k in range(n_sets)]
    chunks = -(-n_sets // native.SPH_OCC_MAX_SETS)
    g = torch.Generator(device=cuda).manual_seed(n_sets)
    prior = torch.rand((n_sets, 5003), generator=g, device=cuda) < 0.1
    for p in (None, prior):
        before = counters["launch.sph_occluded"]
        got = cuda_spheres.occluded_spheres_cuda(o, dd, tt, sc, prior=p)
        assert counters["launch.sph_occluded"] == before + chunks
        assert got.dtype == torch.bool and got.shape == (n_sets, 5003)
        assert torch.equal(got, cuda_spheres.occluded_spheres_plain(
            o, dd, tt, sc, p))
    acts = [torch.rand(5003, generator=g, device=cuda) > 0.1
            for _ in range(n_sets)]
    before = counters["launch.sph_occluded"]
    got = intersect.occluded_multi(o, dd, sc, actives=acts)
    assert counters["launch.sph_occluded"] == before + chunks
    want = intersect.occluded_multi(o.cpu(), [x.cpu() for x in dd],
                                    _scene_on_cpu(sc),
                                    actives=[x.cpu() for x in acts])
    assert len(got) == n_sets
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


def _scene_on_cpu(sc):
    """A DeviceScene's tensors moved to the CPU."""
    import dataclasses

    return dataclasses.replace(sc, **{
        f.name: getattr(sc, f.name).cpu() for f in dataclasses.fields(sc)
        if isinstance(getattr(sc, f.name), torch.Tensor)})


@pytest.fixture(scope="module")
def showcase_tex48(cuda):
    """The textured showcase at grid 48 in 256-slot blocks on the card."""
    from path_tracer_torch.scene.showcase import showcase_device_scene

    sc = showcase_device_scene(48, cuda, sl_block=256, textured=True)
    assert sc.tr_kernel_ok and sc.tr_textured
    return sc


def _foliage_rays(sc, seed, r, device):
    """Rays from around the transparent triangles' bounds through them."""
    v = sc.tri_v0[sc.n_tris_opaque: sc.num_real_triangles].cpu().numpy()
    g = np.random.default_rng(seed)
    o = g.uniform(v.min(0) - 2, v.max(0) + 2, (r, 3))
    d = g.uniform(v.min(0), v.max(0), (r, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(device)
    return t(o), t(d), g


@pytest.fixture(scope="module")
def tie_cards(cuda):
    """Twelve layers of duplicated transparent cards and a stack of 300
    copies on the card (equal t decide the walks' tie rule; 12 layers past
    the list of 8)."""
    from path_tracer_torch.scene.procedural import (
        duplicate_card_device_scene,
    )

    sc = duplicate_card_device_scene(cuda)
    assert sc.tr_kernel_ok and sc.tr_textured
    return sc


def _walk_rays(name, showcase_tex48, tie_cards, seed, r, device):
    """(scene, o, d, rng): foliage rays through the textured showcase, or
    tie rays from above through every layer of the card scene."""
    from path_tracer_torch.scene.procedural import tie_rays

    if name == "showcase_tex48":
        return (showcase_tex48,) + _foliage_rays(showcase_tex48, seed, r,
                                                 device)
    o, d = (torch.from_numpy(x).to(device) for x in tie_rays(r, seed=seed))
    return tie_cards, o, d, np.random.default_rng(seed)


@pytest.mark.parametrize("steps_cap", [8, 1, 0, 12])
@pytest.mark.parametrize("name", ["showcase_tex48", "tie_cards"])
def test_alpha_walk_kernel_equals_plain(cuda, showcase_tex48, tie_cards,
                                        name, steps_cap):
    """The resident walk equals its plain version on every field of every
    lane; the tie rays' copies at equal t and cap 12 (a refill of the list
    of 8) included."""
    from path_tracer_torch.ops import cuda_trwalk, trwalk

    r = 5003
    sc, o, d, g = _walk_rays(name, showcase_tex48, tie_cards, 11, r, cuda)
    t_op = g.uniform(0.5, 60.0, r).astype(np.float32)
    t_op[::5] = np.inf
    t_op[::7] = -1.0  # dead lanes
    t_op = torch.from_numpy(t_op).to(cuda)
    rnd = torch.from_numpy(g.uniform(size=(steps_cap, r)).astype(
        np.float32)).to(cuda)
    rnd[:, ::2] = 0.95  # above every tie card's opacity: no accept
    before = counters["launch.alpha_walk"]
    got = cuda_trwalk.alpha_walk(sc, o, d, t_op, rnd, steps_cap)
    assert counters["launch.alpha_walk"] == before + 1
    want = trwalk.alpha_walk_plain(sc, o, d, t_op, rnd, steps_cap)
    _assert_same(got, want)
    if steps_cap:
        assert got.seen.float().mean() > 0.2 and not got.seen[::7].any()


@pytest.mark.parametrize("steps_cap", [8, 1, 0, 12])
@pytest.mark.parametrize("name", ["showcase_tex48", "tie_cards"])
def test_trans_walk_kernel_equals_plain(cuda, showcase_tex48, tie_cards,
                                        name, steps_cap):
    """Stacked lanes of a directional and two point lights, one light per
    run of lanes, with dead lanes and sphere originals mixed in; the
    resident walk against its plain version on every lane."""
    from path_tracer_torch.ops import cuda_trwalk, trwalk

    r = 2048
    sc, o, _, g = _walk_rays(name, showcase_tex48, tie_cards, 12, r, cuda)
    sp = o.clone()
    if name == "showcase_tex48":
        ds = [(-sc.dir_dir[0] / sc.dir_dir[0].norm()).expand(r, 3)]
        pds = [torch.full((r,), float("inf"), device=cuda)]
        for k in range(sc.num_point_lights):
            to = sc.point_pos[k] - o
            dist = to.norm(dim=1)
            ds.append(to / dist[:, None])
            pds.append(dist)
    else:  # the tie rays, as a directional and two point lanes each
        d = _walk_rays(name, showcase_tex48, tie_cards, 12, r, cuda)[2]
        ds = [d] * 3
        pds = [torch.full((r,), float("inf"), device=cuda)] + [
            torch.from_numpy(g.uniform(0.5, 9.0, r).astype(np.float32)).to(
                cuda) for _ in range(2)]
    n = len(ds) * r
    o3, sp3 = o.repeat(len(ds), 1), sp.repeat(len(ds), 1)
    d3 = torch.cat(ds).contiguous()
    pd3 = torch.cat(pds)
    is_pt = torch.arange(n, device=cuda) >= r
    t = lambda x, dt=np.float32: torch.from_numpy(np.asarray(x, dt)).to(cuda)
    ouv = t(g.uniform(-1.0, 2.0, (n, 2)))
    osimple = t(g.uniform(size=n) < 0.2, bool)
    walking0 = t(g.uniform(size=n) > 0.1, bool)
    args = (o3, d3, pd3, is_pt, sp3, ouv, osimple, walking0, steps_cap)
    before = counters["launch.trans_walk"]
    got = cuda_trwalk.trans_walk(sc, *args)
    assert counters["launch.trans_walk"] == before + 1
    _assert_same(got, trwalk.trans_walk_plain(sc, *args))
    assert (got.trans < 1.0).float().mean() > 0.02
    assert bool((got.trans[~walking0] == 1.0).all())


def _prefilter_lanes(sc, seed, r, device):
    """(o, d, t_max, rng): foliage rays through the textured showcase with
    the prefilter's edge cases: zero direction components (one, two and
    all three), origins on a box's slab planes with a zero component along
    that axis (0 * inf: a NaN slab bound), t_max +inf, negative and
    NaN."""
    o, d, g = _foliage_rays(sc, seed, r, device)
    box = sc.tr_prefilter
    d[::9, 0] = 0.0
    d[::11, 2] = 0.0
    d[::101] = 0.0
    o[::13, 1] = box[0, 1]
    d[::26, 1] = 0.0
    o[::17, 0] = box[1, 3]
    d[::34, 0] = 0.0
    t_max = torch.from_numpy(g.uniform(0.0, 30.0, r).astype(np.float32)).to(
        device)
    t_max[::6] = float("inf")
    t_max[::7] = -0.5
    t_max[::19] = float("nan")
    return o, d, t_max, g


def _prefilter_plain(sc, o, d, t_max, active):
    """The plain version ANDed with the mask, on the card and on the CPU."""
    from path_tracer_torch.ops.trwalk import hits_transparent_bounds

    cpu = SimpleNamespace(tr_prefilter=sc.tr_prefilter.cpu())
    want = [hits_transparent_bounds(sc, o, d, t_max).cpu(),
            hits_transparent_bounds(cpu, o.cpu(), d.cpu(), t_max.cpu())]
    if active is not None:
        want = [w & active.cpu() for w in want]
    return want


@pytest.mark.parametrize("n", [2**18 + 37, 0])
@pytest.mark.parametrize("active", [None, "mask"])
def test_prefilter_kernel_equals_plain(cuda, showcase_tex48, active, n):
    """The segment prefilter kernel equals the plain version (on the card
    and on the CPU) on every lane, the edge cases of ``_prefilter_lanes``
    included, with no mask and with a random 28% live mask (lanes off it
    false); one launch a call, none for no lanes."""
    from path_tracer_torch.ops import cuda_trwalk

    sc = showcase_tex48
    o, d, t_max, g = _prefilter_lanes(sc, 5, n, cuda)
    mask = (torch.from_numpy(g.uniform(size=n) < 0.28).to(cuda) if active
            else None)
    before = counters["launch.tr_prefilter"]
    got = cuda_trwalk.prefilter(sc, o, d, t_max, mask)
    torch.cuda.synchronize()
    assert counters["launch.tr_prefilter"] == before + (1 if n else 0)
    assert got.dtype == torch.bool and got.shape == (n,)
    for want in _prefilter_plain(sc, o, d, t_max, mask):
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    if n:
        live = got if mask is None else got[mask]
        assert 0.05 < live.float().mean().item() < 0.95


def test_prefilter_kernel_stacked_lights(cuda, showcase_tex48):
    """Three lights' stacked lanes (3 x (2^18 + 37)), as the shadow phase
    calls it, with a random live mask; and one directional light's
    expanded (stride 0) direction, as the fused shadow route passes it."""
    from path_tracer_torch.ops import cuda_trwalk

    sc = showcase_tex48
    r = 2**18 + 37
    o, d, t_max, g = _prefilter_lanes(sc, 6, r, cuda)
    ds = [d, -d, (-sc.dir_dir[0] / sc.dir_dir[0].norm()).expand(r, 3)]
    o3, d3 = o.repeat(3, 1), torch.cat(ds)
    tm3 = torch.cat([t_max, t_max * 0.5, torch.full_like(t_max, 1e3)])
    mask = torch.from_numpy(g.uniform(size=3 * r) < 0.28).to(cuda)
    before = counters["launch.tr_prefilter"]
    got = cuda_trwalk.prefilter(sc, o3, d3, tm3, mask)
    got1 = cuda_trwalk.prefilter(sc, o, ds[2], tm3[2 * r:])
    torch.cuda.synchronize()
    assert counters["launch.tr_prefilter"] == before + 2
    for want in _prefilter_plain(sc, o3, d3, tm3, mask):
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    for want in _prefilter_plain(sc, o, ds[2], tm3[2 * r:], None):
        np.testing.assert_array_equal(got1.cpu().numpy(), want.numpy())
    assert 0.05 < got[mask].float().mean().item() < 0.95


def _sphere_shadow_sets(sc, seed, r, device):
    """Origins among the spheres (half 1e-5 off a sphere's surface) and
    two sets toward random points: t_max infinite, and the distance to
    the point with every 3rd lane dead (t_max = -1)."""
    n = sc.num_real_spheres
    c = sc.sph_center[:n].cpu().numpy()
    rad = sc.sph_radius[:n].cpu().numpy()
    lo, hi = (c - rad[:, None]).min(0), (c + rad[:, None]).max(0)
    g = np.random.default_rng(seed)
    o = g.uniform(lo, hi, (r, 3))
    k = g.integers(0, n, r // 2)
    nrm = g.normal(size=(r // 2, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    o[: r // 2] = c[k] + (rad[k, None] + 1e-5) * nrm
    to = g.uniform(lo, hi, (r, 3)) - o
    dist = np.linalg.norm(to, axis=1)
    t = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(device)
    fin = t(dist)
    fin[::3] = -1.0
    return t(o), [t(to / dist[:, None])] * 2, [
        torch.full((r,), float("inf"), device=device), fin]


@pytest.mark.parametrize("name", ["spheres", "grid70"])
def test_sphere_any_hit_kernels_equal_plain(cuda, name):
    """The dense any-hit (25 spheres, and the 4,900-sphere grid forced
    dense) and the any-hit walk (the grid) against their plain versions,
    exactly, one launch for both sets; dead lanes are not occluded."""
    import dataclasses

    from path_tracer_torch.ops import cuda_spheres
    from path_tracer_torch.scene import load_scene
    from path_tracer_torch.scene.procedural import sphere_grid_device_scene

    if name == "spheres":
        scenes = [load_scene(SCENES / "spheres" / "scene.isf", cuda)]
    else:
        grid = sphere_grid_device_scene(70, cuda)
        scenes = [grid, dataclasses.replace(grid, sph_use_blocks=False)]
    for sc in scenes:
        o, ds, tms = _sphere_shadow_sets(sc, 15, 5003, cuda)
        walk = sc.sph_use_blocks
        before = (counters["launch.sph_occluded"],
                  counters["launch.sph_occ_walk"])
        got = cuda_spheres.occluded_spheres_cuda(o, ds, tms, sc)
        assert (counters["launch.sph_occluded"],
                counters["launch.sph_occ_walk"]) == (
                    before[0] + (not walk), before[1] + walk)
        assert torch.equal(got, cuda_spheres.occluded_spheres_plain(
            o, ds, tms, sc))
        assert not got[1][::3].any()
        assert 0.05 < got[1].float().mean() < 0.95


def _row6_held(o, ds, tms, sc, prior=None):
    """Row 6 through its wrapper (one bool launch) equals its plain version
    on every lane, and each in-block layout alone gives the same result.
    Returns it."""
    from path_tracer_torch import native
    from path_tracer_torch.ops import cuda_spheres

    tables = (sc.sph_blk, sc.sph_blkid, sc.sph_sorted_t)
    before = counters["launch.sph_occ_walk"]
    got = cuda_spheres.occluded_spheres_cuda(o, ds, tms, sc, prior=prior)
    assert counters["launch.sph_occ_walk"] == before + 1
    assert got.dtype == torch.bool
    assert torch.equal(got, cuda_spheres.occluded_spheres_plain(
        o, ds, tms, sc, prior))
    for lane_wise in (1, 33):
        assert torch.equal(got, native.launch_sph_occ_walk(
            o, torch.stack(list(ds)), torch.stack(list(tms)), *tables,
            prior, lane_wise=lane_wise))
    return got


def test_sphere_any_hit_walk_folds_prior(cuda):
    """Row 6 on the 4,900-sphere grid: both sets of
    _sphere_shadow_sets (every 3rd lane of one dead) with whole and partly
    dead warps on a ragged count, without prior and with a random tenth;
    a dead lane writes its prior, a lane whose prior is set writes 1."""
    from path_tracer_torch.scene.procedural import sphere_grid_device_scene

    grid = sphere_grid_device_scene(70, cuda)
    r = 5003
    o, ds, tms = _sphere_shadow_sets(grid, 19, r, cuda)
    tms = [tms[0], _dead_warps(tms[1]).nan_to_num(posinf=-1.0)]
    g = torch.Generator(device=cuda).manual_seed(4)
    prior = torch.rand((2, r), generator=g, device=cuda) < 0.1
    alone = _row6_held(o, ds, tms, grid)
    got = _row6_held(o, ds, tms, grid, prior)
    assert torch.equal(got, alone | prior)
    dead = torch.stack(tms) < 0.0
    assert not alone[dead].any() and torch.equal(got[dead], prior[dead])
    assert 0.05 < alone[1].float().mean() < 0.95


def test_sphere_any_hit_walk_keeps_occluders_at_box_faces(cuda):
    """Row 6 on the duplicate-sphere tie rays at t_max the first-hit t of
    the closest-hit walk run ungated (every block box at +-1e30): 0 lanes
    off its plain version, the ungated walk and the dense any-hit; row 5 on the same rays equals its ungated plain version
    from t_prev = -1 and from the hit."""
    import dataclasses

    from path_tracer_torch.ops import cuda_spheres
    from path_tracer_torch.scene.procedural import (
        duplicate_sphere_device_scene,
        sphere_tie_rays,
    )

    ties = duplicate_sphere_device_scene(cuda)
    blk = ties.sph_blk.clone()
    blk[0:3], blk[3:6] = -1e30, 1e30
    ungated = dataclasses.replace(ties, sph_blk=blk)
    r = 8192
    for seed in (0, 1):
        o, d = (torch.from_numpy(x).to(cuda) for x in sphere_tie_rays(r, seed))
        tp = torch.full((r,), -1.0, device=cuda)
        t = cuda_spheres._sph_walk_plain(o, d, tp, ungated)[0]
        got = _row6_held(o, [d], [t], ties)[0]
        assert torch.equal(got, cuda_spheres._occluded_walk_plain(
            o, d, t, ungated))
        assert torch.equal(got, cuda_spheres._occluded_dense_plain(
            o, d, t, ties))
        assert got.float().mean() > 0.95
        for _ in range(2):
            rec = cuda_spheres.closest_hit_spheres_cuda(o, d, tp, ties)
            _held(rec, {"ungated": cuda_spheres.closest_hit_spheres_walk_plain(
                o, d, tp, ungated)})
            tp = torch.where(rec.valid, rec.t, -1.0)


def _fused_lanes(sc, seed, r, device):
    """The fused kernel's arguments for r lanes around the foliage toward
    the scene's lights: t_max +inf or the point light's distance (every
    9th lane dead), walk windows pd closed on 10% of the lanes, random
    original uvs and sphere flags."""
    o, _, g = _foliage_rays(sc, seed, r, device)
    ds, tms, pds, is_pt = [], [], [], []
    for k in range(sc.num_dir_lights):
        ds.append((-sc.dir_dir[k]).expand(r, 3).contiguous())
        tms.append(torch.full((r,), float("inf"), device=device))
        is_pt.append(False)
    for k in range(sc.num_point_lights):
        to = sc.point_pos[k] - o
        dist = to.norm(dim=1)
        ds.append((to / dist[:, None]).contiguous())
        tms.append(dist)
        is_pt.append(True)
    t = lambda x, dt=np.float32: torch.from_numpy(np.asarray(x, dt)).to(
        device)
    pds = [torch.where(t(g.uniform(size=r) < 0.1, bool), -1.0, tm)
           for tm in tms]
    tms = [tm.clone() for tm in tms]
    for tm in tms:
        tm[::9] = -1.0
    return (o, ds, tms, pds, is_pt, o.clone(), t(g.uniform(-1.0, 2.0, (r, 2))),
            t(g.uniform(size=r) < 0.2, bool))


@pytest.mark.parametrize("steps_cap", [8, 1])
def test_fused_shadow_kernel_equals_plain_and_two_launches(
        cuda, showcase_tex48, steps_cap):
    """The fused kernel (the warp any-hit, then the resident walk) against
    its plain version and against flat_occluded + trans_walk launched
    apart, on every lane."""
    from path_tracer_torch.ops import cuda_bvh, cuda_shadow, cuda_trwalk
    from path_tracer_torch.scene.device_scene import opaque_view

    sc = showcase_tex48
    r = 2048
    o, ds, tms, pds, is_pt, sp, ouv, osimple = _fused_lanes(sc, 16, r, cuda)
    before = counters["launch.fused_shadow"]
    got = cuda_shadow.fused_shadow(sc, o, ds, tms, pds, is_pt, sp, ouv,
                                   osimple, steps_cap)
    assert counters["launch.fused_shadow"] == before + 1
    want = cuda_shadow.fused_shadow_plain(sc, o, ds, tms, pds, is_pt, sp, ouv,
                                          osimple, steps_cap)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    occ = cuda_bvh.occluded_triangles_flat_multi(o, ds, tms, opaque_view(sc))
    n_l = len(ds)
    pd3 = torch.where(occ, -1.0, torch.stack(pds)).reshape(-1)
    is_pt3 = torch.cat([torch.full((r,), pt, device=cuda) for pt in is_pt])
    w = cuda_trwalk.trans_walk(sc, o.repeat(n_l, 1), torch.cat(ds), pd3,
                               is_pt3, sp.repeat(n_l, 1), ouv.repeat(n_l, 1),
                               osimple.repeat(n_l), torch.ones_like(is_pt3),
                               steps_cap)
    assert torch.equal(got[0], torch.where(occ, 0.0, w.trans.view(n_l, r)))
    assert torch.equal(got[1], w.t_prev.view(n_l, r))
    assert torch.equal(got[2], w.still.view(n_l, r))
    assert (got[0] == 0.0).float().mean() > 0.02
    assert ((got[0] > 0.0) & (got[0] < 1.0)).any()


def _training_updates(sc):
    """The scene after the training updates of tests/test_trwalk.py:
    opacity factors x 0.6, the first opacity page moved by +0.17, then
    -0.09, clipped to [0.05, 0.95]."""
    import dataclasses

    off, w, h, _ = sc.tr_pages[0]
    td = sc.tex_data.clone()
    for step in (0.17, -0.09):
        td[off:off + w * h] = (td[off:off + w * h] + step).clamp(0.05, 0.95)
    return dataclasses.replace(sc, tex_data=td,
                               mat_opacity_factor=sc.mat_opacity_factor * 0.6)


@pytest.mark.parametrize("updated", [True, False])
def test_live_walk_kernels_equal_plain(cuda, showcase_tex48, updated):
    """The live variants of the alpha walk, the transmittance walk and the
    fused shadow kernel against their plain live versions on every lane,
    after the training updates; on untouched tables they also equal the
    forward kernels (the live plane then holds tr_lut[tr_tex8])."""
    from path_tracer_torch.ops import cuda_shadow, cuda_trwalk, trwalk

    sc = _training_updates(showcase_tex48) if updated else showcase_tex48
    live = trwalk.live_tables(sc)
    r = 5003
    o, d, g = _foliage_rays(sc, 17, r, cuda)
    t_op = g.uniform(0.5, 60.0, r).astype(np.float32)
    t_op[::7] = -1.0
    t_op = torch.from_numpy(t_op).to(cuda)
    rnd = torch.from_numpy(g.uniform(size=(8, r)).astype(np.float32)).to(cuda)
    counts = (counters["launch.alpha_walk_live"],
              counters["launch.alpha_walk"])
    got = cuda_trwalk.alpha_walk(sc, o, d, t_op, rnd, 8, live=live)
    assert (counters["launch.alpha_walk_live"],
            counters["launch.alpha_walk"]) == (counts[0] + 1, counts[1])
    _assert_same(got, trwalk.alpha_walk_plain(sc, o, d, t_op, rnd, 8, live))
    fwd = cuda_trwalk.alpha_walk(sc, o, d, t_op, rnd, 8)
    if updated:
        assert (fwd.accepted != got.accepted).any()
    else:
        _assert_same(got, fwd)

    o, ds, tms, pds, is_pt, sp, ouv, osimple = _fused_lanes(sc, 18, 2048,
                                                            cuda)
    n_l = len(ds)
    is_pt3 = torch.cat([torch.full((2048,), pt, device=cuda) for pt in is_pt])
    walk = (sc, o.repeat(n_l, 1), torch.cat(ds), torch.cat(pds), is_pt3,
            sp.repeat(n_l, 1), ouv.repeat(n_l, 1), osimple.repeat(n_l),
            torch.ones_like(is_pt3), 8)
    before = counters["launch.trans_walk_live"]
    got = cuda_trwalk.trans_walk(*walk, live=live)
    assert counters["launch.trans_walk_live"] == before + 1
    _assert_same(got, trwalk.trans_walk_plain(*walk, live))
    if not updated:
        _assert_same(got, cuda_trwalk.trans_walk(*walk))
    fused = (sc, o, ds, tms, pds, is_pt, sp, ouv, osimple, 8)
    before = counters["launch.fused_shadow_live"]
    got = cuda_shadow.fused_shadow(*fused, live=live)
    assert counters["launch.fused_shadow_live"] == before + 1
    for a, b in zip(got, cuda_shadow.fused_shadow_plain(*fused, live=live)):
        assert torch.equal(a, b)
    if not updated:
        for a, b in zip(got, cuda_shadow.fused_shadow(*fused)):
            assert torch.equal(a, b)


def test_train_step_on_card(cuda, showcase_tex48):
    """One make_train_step step on the card over every parameter field of
    the updated textured showcase: the live walk kernels run (the forward
    ones do not), the loss and the new parameters are finite, and the loss
    is the CPU's within 5%. The card and the CPU part on the sphere re-hit
    flips described above (up to 5% of values); the sum of squares weighs
    the bright lanes such a flip moves (measured 1.6% apart on an H100)."""
    from path_tracer_torch.models.integrator import IntegratorSpec
    from path_tracer_torch.parallel import get_params, make_train_step
    from path_tracer_torch.scene.showcase import showcase_device_scene

    w, h = 64, 48
    spec = IntegratorSpec(bounces=2, differentiable=True)
    step = make_train_step(w, h, spec, lr=1e-4)
    results = []
    for sc in (_training_updates(showcase_tex48),
               _training_updates(showcase_device_scene(
                   48, "cpu", sl_block=256, textured=True))):
        ids = torch.arange(w * h, dtype=torch.int32, device=sc.device)
        counts = (counters["launch.alpha_walk"], counters["launch.trans_walk"],
                  counters["launch.alpha_walk_live"],
                  counters["launch.trans_walk_live"])
        params = get_params(sc)
        new, loss = step(params, sc, ids, torch.zeros((w * h, 3),
                                                      device=sc.device), 1)
        after = (counters["launch.alpha_walk"], counters["launch.trans_walk"],
                 counters["launch.alpha_walk_live"],
                 counters["launch.trans_walk_live"])
        if sc.device.type == "cuda":
            assert after[:2] == counts[:2]
            assert after[2] > counts[2] and after[3] > counts[3]
        assert torch.isfinite(loss)
        for k, v in new.items():
            assert torch.isfinite(v).all(), k
        assert not torch.equal(new["mat_albedo_factor"],
                               params["mat_albedo_factor"])
        results.append(float(loss))
    assert results[0] == pytest.approx(results[1], rel=5e-2)


@pytest.mark.parametrize("k", [1, 6, 8])
def test_khit_kernel_equals_plain(cuda, showcase_tex48, k):
    """Row 3 against its plain version on every lane: foliage rays with
    random t_max, inactive and +inf-t_max lanes, a ragged ray count."""
    from path_tracer_torch.ops import cuda_khit

    sc = showcase_tex48
    r = 5003
    o, d, g = _foliage_rays(sc, 21, r, cuda)
    t_max = g.uniform(0.5, 60.0, r).astype(np.float32)
    t_max[::5] = np.inf
    t_max = torch.from_numpy(t_max).to(cuda)
    active = torch.from_numpy(g.uniform(size=r) > 0.1).to(cuda)
    before = counters["launch.k_nearest_tr_hits"]
    ts, pos = cuda_khit.k_nearest_tr_hits(o, d, active, sc, k, t_max=t_max)
    assert counters["launch.k_nearest_tr_hits"] == before + 1
    tris, gbox, sbox = sc.khit_tris, sc.khit_gbox, sc.khit_sbox
    enc = torch.where(active, t_max, -1.0)
    want_ts, want_pos = cuda_khit.k_nearest_tr_hits_plain(
        o, d, enc, tris, gbox, k, sbox)
    assert torch.equal(ts, want_ts) and torch.equal(pos, want_pos)
    assert torch.isfinite(ts[0]).float().mean() > 0.2
    assert not torch.isfinite(ts[:, ~active]).any()


@pytest.mark.parametrize("k", [1, 6])
def test_khit_kernel_keeps_every_hit_within_t_max(cuda, tie_cards, k):
    """Row 3 on the duplicate-card scene loses, within t_max, no entry of
    its ungated plain version (every group box at +-1e30 and no sub-group
    gate: brute-force MT)
    on tie rays through the layered copies and on rays aimed at the
    cards' vertices and edges, at t_max +inf, the first hit and an ulp
    below and above it; and equals its plain version on every lane."""
    from path_tracer_torch.ops import cuda_khit
    from path_tracer_torch.scene.procedural import tie_rays

    sc, r = tie_cards, 4096
    o, d = (torch.from_numpy(x).to(cuda) for x in tie_rays(r, seed=11))
    v = sc.tri_v0[sc.n_tris_opaque: sc.num_real_triangles].cpu().numpy()
    e1 = sc.tri_e1[sc.n_tris_opaque: sc.num_real_triangles].cpu().numpy()
    g = np.random.default_rng(12)
    tri = g.integers(0, len(v), r)
    tgt = v[tri] + g.uniform(size=(r, 1)) * e1[tri]  # edge points
    tgt[::2] = v[tri][::2]  # vertices
    ao = tgt + g.uniform(-1.0, 1.0, (r, 3)) * (v.max(0) - v.min(0))
    ad = (tgt - ao) / np.linalg.norm(tgt - ao, axis=1, keepdims=True)
    t = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(cuda)
    everywhere = sc.khit_gbox.clone()
    everywhere[0:3], everywhere[3:6] = -1e30, 1e30
    inf = torch.full((r,), float("inf"), device=cuda)
    act = torch.ones((r,), dtype=torch.bool, device=cuda)
    for ro, rd in ((o, d), (t(ao), t(ad))):
        want_t, want_c = cuda_khit.k_nearest_tr_hits_plain(
            ro, rd, inf, sc.khit_tris, everywhere, k)
        first = want_t[0]
        assert torch.isfinite(first).float().mean() > 0.3
        for tm in (inf, first, torch.nextafter(first, -inf),
                   torch.nextafter(first, inf)):
            got_t, got_c = cuda_khit.k_nearest_tr_hits(ro, rd, act, sc, k,
                                                       t_max=tm)
            p_t, p_c = cuda_khit.k_nearest_tr_hits_plain(
                ro, rd, tm, sc.khit_tris, sc.khit_gbox, k, sc.khit_sbox)
            assert torch.equal(got_t, p_t) and torch.equal(got_c, p_c)
            w_in, g_in = want_t <= tm, got_t <= tm
            assert torch.equal(w_in, g_in)
            assert torch.equal(torch.where(w_in, got_t, 0.0),
                               torch.where(w_in, want_t, 0.0))
            assert torch.equal(torch.where(w_in, got_c, 0),
                               torch.where(w_in, want_c, 0))


def _tree_case(device, name):
    """(scene, rays o, d) of a tree-walk card check, 5003 rays: forced-BVH
    ``reflection`` (512-slot blocks), the grid-48 showcase in 256- and
    512-slot blocks, or tie rays on the duplicate-triangle grid in 128-slot
    blocks (pairs of copies in one leaf, a stack of 300 split over
    several)."""
    from path_tracer_torch.scene import build_scene
    from path_tracer_torch.scene.procedural import (
        duplicate_grid_scene,
        tie_rays,
    )
    from path_tracer_torch.scene.showcase import showcase_scene

    r = 5003
    if name == "ties":
        sc = build_scene(duplicate_grid_scene(), ".", device, use_bvh=True,
                         sl_block=128)
        o, d = (torch.from_numpy(x).to(device) for x in tie_rays(r))
        return sc, o, d
    if name == "showcase48_512":
        sc = build_scene(showcase_scene(48), ".", device, use_bvh=True,
                         sl_block=512)
    else:
        sc = _flat_scenes(device)[name]
    return (sc, *_flat_rays(sc, 23, r, device))


@pytest.mark.parametrize("name", ["reflection", "showcase48",
                                  "showcase48_512", "ties"])
def test_tree_kernels_equal_plain(cuda, name, monkeypatch):
    """Rows 7 and 8 against their plain versions on every lane: fresh,
    advanced and dead lanes, and whole and partly dead warps on a ragged
    count (no multiple of 32 or 128); t_max above and below the hit and
    dead lanes, in one launch for L = 1, 3 and 9 sets sharing the origins.
    Each in-leaf layout alone (lane per ray, the leaf over the warp) gives
    the mix's results."""
    from path_tracer_torch import native
    from path_tracer_torch.ops import cuda_bvh

    sc, o, d = _tree_case(cuda, name)
    r = o.shape[0]
    tables = (sc.sl_nodes6, sc.sl_meta6, sc.sl_tris_t, sc.sl_n_nodes,
              sc.sl_block)
    for tpv in (-1.0, 0.5):
        tp = torch.full((r,), tpv, device=cuda)
        tp[::9] = float("inf")
        before = counters["launch.tree_closest_hit"]
        got = cuda_bvh.closest_hit_triangles_tree(o, d, tp, sc)
        assert counters["launch.tree_closest_hit"] == before + 1
        _assert_same(got, cuda_bvh.closest_hit_triangles_tree_plain(o, d, tp,
                                                                    sc))
        assert not got.valid[::9].any() and got.valid.float().mean() > 0.3
        mix = native.launch_tree_closest_hit(o, d, tp, *tables)
        for lane_wise in (1, 33):
            with monkeypatch.context() as m:
                m.setattr(native, "TREE_WALK_LANE_WISE", lane_wise)
                one = native.launch_tree_closest_hit(o, d, tp, *tables)
            assert all(torch.equal(x, y) for x, y in zip(one, mix))
    rr = r - 37
    dead = _dead_warps(torch.full((rr,), -1.0, device=cuda))
    ragged = cuda_bvh.closest_hit_triangles_tree(
        o[:rr].contiguous(), d[:rr].contiguous(), dead, sc)
    _assert_same(ragged, cuda_bvh.closest_hit_triangles_tree_plain(
        o[:rr], d[:rr], dead, sc))
    assert not ragged.valid[torch.isinf(dead)].any()
    for n_sets in (1, 3, 9):
        ds = [d if k % 2 == 0 else -d for k in range(n_sets)]
        tms = []
        for k in range(n_sets):
            tm = torch.where(got.valid, got.t * (1.01 if k % 3 else 0.99),
                             40.0)
            tm[k % 3::3] = -1.0
            tms.append(tm)
        before = counters["launch.tree_occluded"]
        occ = cuda_bvh.occluded_triangles_tree_multi(o, ds, tms, sc)
        assert counters["launch.tree_occluded"] == before + 1
        assert occ.dtype == torch.bool and occ.shape == (n_sets, r)
        assert torch.equal(occ, cuda_bvh.occluded_triangles_tree_multi_plain(
            o, ds, tms, sc))
        assert all(bool(x[t < 0].all()) for x, t in zip(occ, tms))
        stacked = (torch.stack(ds).contiguous(), torch.stack(tms))
        for lane_wise in (1, 33):
            with monkeypatch.context() as m:
                m.setattr(native, "TREE_WALK_LANE_WISE", lane_wise)
                assert torch.equal(occ, native.launch_tree_occluded(
                    o, *stacked, *tables))
    tw = torch.where(torch.isinf(dead), -1.0, 40.0)
    occ = cuda_bvh.occluded_triangles_tree(o[:rr].contiguous(),
                                           d[:rr].contiguous(), tw, sc)
    assert torch.equal(occ, cuda_bvh.occluded_triangles_tree_plain(
        o[:rr], d[:rr], tw, sc))


def test_dense_route_launches_khit(cuda, showcase_tex48, monkeypatch):
    """``PT_NO_TRWALK_KERNEL=1 PT_DENSE_TR=1`` renders the textured
    showcase through row 3 (no walk kernel), the same image as the walk
    kernels' route up to the dense walk's per-column u, v recompute."""
    from path_tracer_torch.models.integrator import IntegratorSpec
    from path_tracer_torch.models.renderer import render_pixel_sums
    spec = IntegratorSpec(bounces=3)
    want = render_pixel_sums(showcase_tex48, 32, 24, 1, 2, spec)
    monkeypatch.setenv("PT_NO_TRWALK_KERNEL", "1")
    monkeypatch.setenv("PT_DENSE_TR", "1")
    before = (counters["launch.k_nearest_tr_hits"],
              counters["launch.alpha_walk"], counters["launch.trans_walk"])
    got = render_pixel_sums(showcase_tex48, 32, 24, 1, 2, spec)
    assert counters["launch.k_nearest_tr_hits"] > before[0]
    assert (counters["launch.alpha_walk"], counters["launch.trans_walk"]) \
        == before[1:]
    diff = np.abs(got - want)
    assert (diff > 1e-3).mean() <= 0.005


def test_tree_route_launches_tree_kernels(cuda, monkeypatch):
    """``PT_BVH_KERNEL=tree`` renders the plain showcase through rows 7
    and 8 and no flat-family kernel, the flat route's image within the
    BVH-against-brute gate (99% of values within rtol 1e-3 / atol 1e-4);
    each any-hit call (the three lights) is one row 8 launch, and there
    are as many as row 7 launches."""
    from path_tracer_torch.models.integrator import IntegratorSpec
    from path_tracer_torch.models.renderer import render_pixel_sums
    from path_tracer_torch.ops import cuda_bvh

    sc = _flat_scenes(cuda)["showcase48"]
    spec = IntegratorSpec(bounces=3)
    want = render_pixel_sums(sc, 32, 24, 1, 2, spec)
    monkeypatch.setenv("PT_BVH_KERNEL", "tree")
    calls = []
    multi = cuda_bvh.occluded_triangles_tree_multi
    monkeypatch.setattr(cuda_bvh, "occluded_triangles_tree_multi",
                        lambda *a: calls.append(len(a[1])) or multi(*a))
    counts = lambda: (counters["launch.tree_closest_hit"],
                      counters["launch.tree_occluded"],
                      counters["launch.flat_closest_hit"],
                      counters["launch.flat_occluded"])
    before = counts()
    got = render_pixel_sums(sc, 32, 24, 1, 2, spec)
    after = counts()
    assert after[0] > before[0] and after[1] > before[1]
    assert after[2:] == before[2:]
    assert after[1] - before[1] == len(calls) == after[0] - before[0]
    assert set(calls) == {3}  # the showcase's three lights a call
    within = np.abs(got - want) <= 1e-4 + 1e-3 * np.abs(want)
    assert within.mean() >= 0.99


def _dead_warps(tp):
    """Whole warps dead (every fifth) and partly dead ones (every third lane
    of the warps two after them)."""
    lane = torch.arange(tp.shape[0], device=tp.device)
    warp = lane // 32
    dead = (warp % 5 == 2) | ((warp % 5 == 4) & (lane % 3 == 0))
    return torch.where(dead, float("inf"), tp)


def _redesign_case(device, rays):
    """(plain-version scene, rays o, d, t_prev) of one check of the
    redesigned rows 9 and 1: tie rays on the duplicate-triangle grid, or
    rays around the grid-48 showcase, 5003 of them (no multiple of 32, 128
    or 256), with whole-dead and partly dead warps."""
    from path_tracer_torch.scene import build_scene
    from path_tracer_torch.scene.procedural import (
        duplicate_grid_scene,
        tie_rays,
    )
    from path_tracer_torch.scene.showcase import showcase_scene

    r = 5003
    if rays == "ties":
        spec, block = duplicate_grid_scene(), 128
        o, d = (torch.from_numpy(x).to(device) for x in tie_rays(r))
    else:
        spec, block = showcase_scene(48), 256
    sc = build_scene(spec, ".", device, use_bvh=True, sl_block=block)
    if rays != "ties":
        o, d = _flat_rays(sc, 7, r, device)
    tp = _dead_warps(torch.full((r,), -1.0, device=device))
    return sc, o, d, tp


@pytest.mark.parametrize("rays", ["ties", "showcase48"])
def test_warp_flat_walk_equals_plain_and_cta_walk(cuda, rays):
    """Row 9's warp walk equals its plain version on every field of every
    lane, with and without the sphere pass. (The CTA walk it replaced, off
    its plain version on tie rays, is no longer built.)"""
    from path_tracer_torch.ops import cuda_bvh

    sc, o, d, tp = _redesign_case(cuda, rays)
    for spheres in (False, True):
        got = cuda_bvh.closest_hit_triangles_flat(o, d, tp, sc, spheres)
        _assert_same(got, cuda_bvh.closest_hit_triangles_flat_plain(
            o, d, tp, sc, spheres))
        assert not got.valid[torch.isinf(tp)].any()
        assert got.valid.float().mean() > 0.3


@pytest.mark.parametrize("rays", ["ties", "showcase48"])
def test_resident_mt_equals_plain_and_chunked(cuda, rays):
    """Row 1's resident-table kernel equals its plain version on every
    field of every lane. (The chunked design it replaced, equal to it
    everywhere, is no longer built.)"""
    from path_tracer_torch.ops import cuda_intersect, intersect

    sc, o, d, tp = _redesign_case(cuda, rays)
    got = cuda_intersect.closest_hit_triangles_cuda(o, d, tp, sc)
    _assert_same(got, intersect.closest_hit_triangles(o, d, tp, sc))
    assert not got.valid[torch.isinf(tp)].any()
    assert got.valid.float().mean() > 0.3


@pytest.mark.parametrize("rays", ["ties", "showcase48"])
def test_warp_flat_any_hit_equals_plain_and_cta(cuda, rays):
    """Row 10's warp any-hit equals its plain version on every lane of
    three sets: t_max well past and well short of each lane's hit, and
    infinite, with whole and partly dead warps."""
    from path_tracer_torch.ops import cuda_bvh

    sc, o, d, tp = _redesign_case(cuda, rays)
    t = cuda_bvh.closest_hit_triangles_flat_plain(o, d, tp, sc).t
    hit = torch.isfinite(t)
    dead = torch.isinf(tp)
    tms = [torch.where(dead, -1.0, torch.where(hit, t * k, 5.0))
           for k in (1.5, 0.5)]
    tms.append(torch.where(dead, -1.0, float("inf")))
    ds = [d, d, -d]
    before = counters["launch.flat_occluded"]
    got = cuda_bvh.occluded_triangles_flat_multi(o, ds, tms, sc)
    assert counters["launch.flat_occluded"] == before + 1
    assert torch.equal(got, cuda_bvh.occluded_triangles_flat_multi_plain(
        o, ds, tms, sc))
    assert got[:, dead].all()
    assert got[0][hit & ~dead].all() and not got[1][hit & ~dead].any()


def _flat2_tie_scene(device):
    """The tie scene whose 8,400 stacked copies sit in the blocks of two
    superblocks (132 blocks of 128), and 5003 tie rays with whole and
    partly dead warps."""
    from path_tracer_torch.scene import build_scene
    from path_tracer_torch.scene.procedural import (
        duplicate_grid_scene,
        tie_rays,
    )

    sc = build_scene(duplicate_grid_scene(8, 8400), ".", device,
                     use_bvh=True, sl_block=128)
    o, d = (torch.from_numpy(x).to(device) for x in tie_rays(5003))
    return sc, o, d, _dead_warps(torch.full((5003,), -1.0, device=device))


@pytest.mark.parametrize("name", ["ties2sb", "grid96"])
def test_warp_flat2_equals_plain_and_cta(cuda, name):
    """Row 11's two-level warp walk equals its plain version on every field
    of every lane (fresh and advanced lanes, whole and partly dead warps),
    and the tie rule's copy wins."""
    from path_tracer_torch.ops import cuda_bvh
    from path_tracer_torch.scene.procedural import tie_winners

    if name == "ties2sb":
        sc, o, d, tp = _flat2_tie_scene(cuda)
    else:
        sc = _flat2_scenes(cuda)["grid96"]
        o, d = _flat_rays(sc, 17, 5003, cuda)
        tp = _dead_warps(torch.full((5003,), -1.0, device=cuda))
    for step in range(2):
        before = counters["launch.flat2_closest_hit"]
        got = cuda_bvh.closest_hit_triangles_flat2(o, d, tp, sc)
        assert counters["launch.flat2_closest_hit"] == before + 1
        want = cuda_bvh.closest_hit_triangles_flat2_plain(o, d, tp, sc)
        _assert_same(got, want)
        assert not got.valid[torch.isinf(tp)].any()
        assert got.valid.float().mean() > 0.3
        if name == "ties2sb" and step == 0:
            prim = got.prim[got.valid].long().cpu().numpy()
            np.testing.assert_array_equal(tie_winners(sc)[1][prim], prim)
        tp = torch.where(torch.isinf(tp), tp,
                         torch.where(got.valid, got.t * 0.999, -1.0))


@pytest.mark.parametrize("name", ["ties2sb", "grid96"])
def test_warp_flat2_any_hit_equals_plain_and_cta(cuda, name):
    """Row 12's two-level warp any-hit equals its plain version on every
    lane of three sets: t_max well past and well short of each lane's hit,
    and infinite, with whole and partly dead warps, on tie rays whose
    copies sit in two superblocks and around the grid-96 showcase. (Its
    name keeps the CTA walk it was once also held to; that design is
    gone.)"""
    from path_tracer_torch.ops import cuda_bvh

    if name == "ties2sb":
        sc, o, d, tp = _flat2_tie_scene(cuda)
    else:
        sc = _flat2_scenes(cuda)["grid96"]
        o, d = _flat_rays(sc, 19, 5003, cuda)
        tp = _dead_warps(torch.full((5003,), -1.0, device=cuda))
    t = cuda_bvh.closest_hit_triangles_flat2_plain(o, d, tp, sc).t
    hit = torch.isfinite(t)
    dead = torch.isinf(tp)
    tms = [torch.where(dead, -1.0, torch.where(hit, t * k, 5.0))
           for k in (1.5, 0.5)]
    tms.append(torch.where(dead, -1.0, float("inf")))
    ds = [d, d, -d]
    before = counters["launch.flat2_occluded"]
    got = cuda_bvh.occluded_triangles_flat2_multi(o, ds, tms, sc)
    assert counters["launch.flat2_occluded"] == before + 1
    assert torch.equal(got, cuda_bvh.occluded_triangles_flat2_multi_plain(
        o, ds, tms, sc))
    assert got[:, dead].all()
    assert got[0][hit & ~dead].all() and not got[1][hit & ~dead].any()


def _ungated(sc):
    """The scene with every real block and superblock box at +-1e30: the
    flat and flat2 walks' ungated form."""
    import dataclasses

    def opened(boxes, ids):
        boxes = boxes.clone()
        real = ids[0] >= 0
        boxes[0:3, real] = -1e30
        boxes[3:6, real] = 1e30
        return boxes

    return dataclasses.replace(
        sc, sl_blkflat=opened(sc.sl_blkflat, sc.sl_blkid),
        sl_sbflat=opened(sc.sl_sbflat, sc.sl_sbid))


@pytest.mark.parametrize("origin", ["near", "far"])
def test_flat_kernels_keep_ungated_hits(cuda, origin):
    """Rows 9-12 (the flat and flat2 kernels, whose gates widen the block
    and superblock boxes and each lane's interval) on tie rays through
    shared edges and vertices of the duplicate-triangle grid, from 3 units
    above or 800 to 8,000 units back: their closest hits (from t_prev -1
    and from an ulp before the ungated hit) and any-hits (t_max the
    ungated hit's t, misses at 5) equal the ungated plain walks' in
    hit/miss and t on every lane."""
    from path_tracer_torch.ops import cuda_bvh
    from path_tracer_torch.scene import build_scene
    from path_tracer_torch.scene.procedural import (
        duplicate_grid_scene,
        tie_rays,
    )

    sc = build_scene(duplicate_grid_scene(), ".", cuda, use_bvh=True,
                     sl_block=128)
    brute = _ungated(sc)
    o, d = tie_rays(5003, seed=3)
    if origin == "far":
        g = np.random.default_rng(4)
        aim = o + 3.0 / -d[:, 1:2] * d
        o = (aim - d * 8.0 * 10.0 ** g.uniform(2.0, 3.0, (len(o), 1))
             ).astype(np.float32)
    o, d = (torch.from_numpy(x).to(cuda) for x in (o, d))
    tp = _dead_warps(torch.full((5003,), -1.0, device=cuda))
    off = lambda a, b: int(((a.valid != b.valid)
                            | (b.valid & (a.t != b.t))).sum())
    for walk in ("flat", "flat2"):
        closest = getattr(cuda_bvh, f"closest_hit_triangles_{walk}")
        plain = getattr(cuda_bvh, f"closest_hit_triangles_{walk}_plain")
        want = plain(o, d, tp, brute)
        assert off(closest(o, d, tp, sc), want) == 0, walk
        before = torch.where(want.valid, torch.nextafter(
            want.t, torch.tensor(-1.0, device=cuda)), tp)
        assert off(closest(o, d, before, sc), plain(o, d, before, brute)) \
            == 0, walk
        dead = torch.isinf(tp)
        tm = torch.where(dead, -1.0, torch.where(want.valid, want.t, 5.0))
        any_hit = getattr(cuda_bvh, f"occluded_triangles_{walk}_multi")
        any_plain = getattr(cuda_bvh,
                            f"occluded_triangles_{walk}_multi_plain")
        assert torch.equal(any_hit(o, [d], [tm], sc),
                           any_plain(o, [d], [tm], brute)), walk


def test_spw_on_card_matches_unpacked(cuda, showcase_tex48):
    """The textured showcase at 128x96, 2 spp, through the card's kernels
    with samples per wavefront 2 (4,096-lane tiles of 2,048 pixels)
    against the same render unpacked: within the packing tolerance (rtol
    2e-5, atol 2e-6), the walk and flat kernels launched by both."""
    from path_tracer_torch.models.integrator import IntegratorSpec
    from path_tracer_torch.models.renderer import render_pixel_sums
    spec = IntegratorSpec(bounces=3)
    want = render_pixel_sums(showcase_tex48, 128, 96, 1, 2, spec,
                             tile_rays=4096)
    before = (counters["launch.flat_closest_hit"],
              counters["launch.alpha_walk"])
    got = render_pixel_sums(showcase_tex48, 128, 96, 1, 2, spec,
                            tile_rays=4096, samples_per_launch=2,
                            samples_per_wavefront=2)
    assert counters["launch.flat_closest_hit"] > before[0]
    assert counters["launch.alpha_walk"] > before[1]
    assert want.std() > 0
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("name", ["showcase_tex48", "spheres"])
def test_compact_on_card_equals_uncompacted(cuda, showcase_tex48, name):
    """Live-ray compaction on the card (the textured showcase through rows
    9, 10, 13, 14, 2 and 4; ``spheres`` through rows 1 and 2) equals the
    uncompacted render bit for bit: each kernel's result on a lane does
    not depend on the lanes beside it."""
    from path_tracer_torch.models.integrator import IntegratorSpec
    from path_tracer_torch.models.renderer import render_pixel_sums
    from path_tracer_torch.scene import load_scene

    sc = (showcase_tex48 if name == "showcase_tex48"
          else load_scene(SCENES / "spheres" / "scene.isf", cuda))
    want = render_pixel_sums(sc, 96, 72, 1, 2, IntegratorSpec(bounces=5))
    got = render_pixel_sums(sc, 96, 72, 1, 2,
                            IntegratorSpec(bounces=5, compact=True))
    assert want.std() > 0
    np.testing.assert_array_equal(got, want)


def test_wide_rows_equal_the_tables_on_card(cuda, showcase_tex48):
    """The textured showcase at 96x72, 5 bounces, 2 spp on the card,
    shading from the wide rows (sl_attr, tex_wide) and from the per-model
    tables (``integrator._uses_rows`` answering False, the route the
    differentiable path takes): equal on every value, through the same
    kernels."""
    from unittest import mock

    from path_tracer_torch.models import integrator
    from path_tracer_torch.models.renderer import render_pixel_sums
    spec = integrator.IntegratorSpec(bounces=5)
    assert integrator._uses_rows(showcase_tex48, spec)
    before = (counters["launch.flat_closest_hit"],
              counters["launch.alpha_walk"])
    got = render_pixel_sums(showcase_tex48, 96, 72, 1, 2, spec)
    assert counters["launch.flat_closest_hit"] > before[0]
    assert counters["launch.alpha_walk"] > before[1]
    with mock.patch.object(integrator, "_uses_rows",
                           lambda scene, spec: False):
        want = render_pixel_sums(showcase_tex48, 96, 72, 1, 2, spec)
    assert want.std() > 0
    np.testing.assert_array_equal(got, want)


def test_converted_glb_renders_on_card(cuda, tmp_path):
    """The port's glb generator, ``path-tracer-torch convert``, then a
    64x48, 2-spp render on the card through the flat and walk kernels,
    against the same render on the CPU: at most 5% of values beyond rtol
    1e-3 / atol 1e-4 (an ulp of ATen's CUDA transcendentals can flip an
    alpha draw, as on the sphere scene above) and the mean within 1%."""
    import importlib.util

    from path_tracer_torch import cli
    from path_tracer_torch.models.integrator import IntegratorSpec
    from path_tracer_torch.models.renderer import render_pixel_sums
    from path_tracer_torch.scene import load_scene

    spec = importlib.util.spec_from_file_location(
        "torch_gen_test_glb",
        Path(__file__).parent / "tools" / "torch_gen_test_glb.py")
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    gen.write_glb(tmp_path / "scene.glb")
    cli.main(["convert", str(tmp_path / "scene.glb"), str(tmp_path / "isf")])
    path = tmp_path / "isf" / "scene.isf"
    sc = load_scene(path, cuda)
    assert sc.use_bvh and not sc.all_opaque
    spec = IntegratorSpec(bounces=4)
    before = (counters["launch.flat_closest_hit"],
              counters["launch.trans_walk"])
    got = render_pixel_sums(sc, 64, 48, 1, 2, spec)
    assert counters["launch.flat_closest_hit"] > before[0]
    assert counters["launch.trans_walk"] > before[1]
    want = render_pixel_sums(load_scene(path, "cpu"), 64, 48, 1, 2, spec)
    assert np.isfinite(got).all() and want.std() > 0
    outside = np.abs(got - want) > 1e-4 + 1e-3 * np.abs(want)
    assert outside.mean() <= 0.05
    assert abs(got.mean() - want.mean()) <= 0.01 * want.mean()


@pytest.mark.parametrize("backend, world", [("gloo", 2), ("nccl", 1)])
def test_parallel_paths_on_card(cuda, tmp_path, backend, world):
    """The multi-device paths on the card (tests/test_torch_parallel.py's
    invariants at its size, on the port's own Cornell box): a world of two
    gloo ranks sharing cuda:0, and a world of one NCCL rank (NCCL refuses
    two ranks on one device), launched through
    tests/tools/torch_parallel_worker.py. The sharded render is bit-equal
    to the one-process render on the card, rebalanced or not; the exchange
    loses no lane and leaves each rank within one live lane of the mean;
    the live counts are each shard's own; the sharded step's loss is the
    same on every rank and within rtol 1e-5 of the one-process step's;
    render_multihost and the driver's multi-rank route give the
    one-process image; every collective takes the CUDA tensors as they
    are, under gloo as under NCCL."""
    import os
    import subprocess
    import sys

    from path_tracer_torch.models.integrator import (
        IntegratorSpec,
        render_wavefront,
    )
    from path_tracer_torch.models.renderer import render
    from path_tracer_torch.parallel.train import get_params, make_train_step
    from path_tracer_torch.scene import load_scene
    from path_tracer_torch.scene.procedural import cornell_device_scene

    tools = Path(__file__).parent / "tools"
    sys.path.insert(0, str(tools))
    import torch_parallel_worker as worker

    repo = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(repo) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, str(tools / "torch_parallel_worker.py"), str(r),
         str(world), str(tmp_path / "rdzv"), "cornell",
         str(SCENES / "cube" / "scene.isf"), str(tmp_path), "cuda:0",
         backend], cwd=repo, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n---\n".join(logs)
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(world)]

    w, h = worker.W, worker.H
    sc = cornell_device_scene(cuda)
    ids = torch.arange(w * h, dtype=torch.int32, device=cuda)
    one = render_wavefront(sc, ids, w, h, 1, worker._spec()).cpu().numpy()
    assert one.std() > 0
    np.testing.assert_array_equal(
        np.concatenate([z["sharded1"] for z in ranks]), one)
    for z in ranks:
        np.testing.assert_array_equal(z["rebalanced2"], z["sharded2"])
    lanes = np.concatenate([z["ex5"] for z in ranks])
    assert sorted(lanes.tolist()) == list(range(8 * world))
    live = np.array([z["ex4"].sum() for z in ranks])
    assert np.abs(live - live.mean()).max() <= 1

    cube = load_scene(SCENES / "cube" / "scene.isf", cuda)
    cper = 32 * 24 // world
    want = [render_wavefront(
        cube, torch.arange(r * cper, (r + 1) * cper, dtype=torch.int32,
                           device=cuda), 32, 24, 3,
        IntegratorSpec(bounces=5), collect_live_counts=True)[1]
        .cpu().numpy() for r in range(world)]
    for z in ranks:
        np.testing.assert_array_equal(z["live"], np.stack(want))

    step = make_train_step(w, h, worker._spec(differentiable=True),
                           n_samples=1, lr=1e-4)
    p1, loss1 = step(get_params(sc), sc, ids,
                     torch.zeros((w * h, 3), device=cuda), 1)
    for z in ranks:
        np.testing.assert_array_equal(z["loss1"], ranks[0]["loss1"])
        np.testing.assert_array_equal(z["albedo1"], ranks[0]["albedo1"])
    np.testing.assert_allclose(ranks[0]["loss1"], loss1.cpu().numpy(),
                               rtol=1e-5)
    np.testing.assert_allclose(ranks[0]["albedo1"],
                               p1["mat_albedo_factor"].cpu().numpy(),
                               rtol=1e-5)
    assert float(ranks[0]["loss2"]) < float(ranks[0]["loss1"])

    img = render(sc, worker.profile())
    for z in ranks:
        np.testing.assert_array_equal(z["multihost"], img)
        np.testing.assert_array_equal(z["render_route"], img)
        ran = {f"all_gather_into_tensor:{backend}:cuda",
               f"all_reduce:{backend}:cuda"}
        if world > 1:
            ran.add(f"all_to_all_single:{backend}:cuda")
        assert set(z["transports"]) == ran
