"""The sphere block walk's merged record and the dense sphere any-hit's fold
of the triangle result, on the CPU, against the JAX package.

On the card the sphere walk (``csrc/sph_walk.cu``) writes the whole hit
record and merges the triangle record in its launch; its plain version is
``cuda_spheres.closest_hit_spheres_walk_merged_plain`` (the plain walk,
then ``intersect.merge_hits``). The dense any-hit (``csrc/sph_occ.cu``)
takes the triangle any-hit's [L,R] result as ``prior`` and writes
prior | spheres; ``occluded_multi`` stacks the sets once and hands the
triangle launch's output to it.

- The merged walk record on ``sphere_grid_scene(23)`` (529 spheres) over a
  floor quad (brute-force triangles), at fresh, advanced and dead lanes,
  against JAX's ``_sph_walk_kernel`` in interpret mode merged with JAX's
  triangle record by JAX's rule (``intersect.py:604``, the triangle wins
  ties). The interpret kernel runs in a fresh interpreter with XLA's CPU
  code generation held to SSE4.2, as tests/test_torch_sph_walk.py runs it
  (with FMA, XLA contracts b^2 - 4ac). Sphere lanes exactly (slots may
  differ only at an exact equal-t tie of distinct spheres, as there);
  triangle lanes to tests/test_torch_sph_merge.py's brute-force bounds:
  t within rtol 1e-6, atol 2e-7, u and v within rtol 1e-4, atol 2e-6.
- The duplicate-sphere tie scene (``duplicate_sphere_scene``: four
  spheres, each's 150 copies in two blocks of one AABB) on
  ``sphere_tie_rays`` (centres, silhouettes, block-face touching points):
  the plain walk's lowest-slot winner equals JAX's interpret walk on every
  lane, t, backface and slot. Also with each sphere's later block grown by
  half a unit (``duplicate_sphere_device_scene(margin=0.5)``), so its slab
  entry comes first along every ray, and some lanes' root rounds before
  the earlier block's tight entry: the case a cut of whole blocks at the
  lane's best t must still serve (the card's walk widens its cut for it).
  There t and backface equal JAX's; the slot is the lowest, where JAX's
  walk keeps the first block it visits (a strict ``<`` in nearest-entry
  order), the later copy of the same sphere.
- ``occluded_multi`` with the fold, L = 3 (two point lights and one
  directional), a tenth of each set dead through ``actives``, against
  JAX's ``occluded_multi`` on the CPU (its elementwise distance test)
  masked by the same actives: the Cornell box (brute force, both kinds)
  and the textured showcase at grid 48 (the flat any-hit, then the dense
  spheres). Exact, or at most 1e-4 of point-light lanes at the range
  boundary (tests/test_torch_sph_occ.py's bound); the fold equals the
  triangle any-hit OR the sphere any-hit set by set.
- The launchers' new checks (the walk's triangle record and slot map, the
  any-hit's ``prior`` shape and dtype, more sets than the kernel takes)
  raise ValueError before any build or launch.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
R = 512  # lanes of a walk (four 128-lane Pallas tiles)
OCC_LANES = 4096


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _floored_grid():
    """``sphere_grid_scene(23)`` over a floor quad just behind the spheres,
    which cuts through the back of every sphere. The quad's shared edge
    runs along y = x + 1, off the grid's diagonals, so no ray aimed from
    the camera at a sphere centre crosses the floor on it (on the edge the
    two MT roundings, XLA's contracted one and the port's, may split a hit
    from a miss)."""
    from path_tracer_torch.scene import isf
    from path_tracer_torch.scene.procedural import _mat, sphere_grid_scene

    sc = sphere_grid_scene(23)
    fl = [isf.Vertex(position=(x, y, -0.2), normal=(0.0, 0.0, 1.0),
                     tex_coords=(0.0, 0.0))
          for x, y in ((-14.0, -13.0), (15.0, -14.0), (14.0, 15.0),
                       (-13.0, 14.0))]
    floor = isf.Mesh(triangles=[(fl[0], fl[1], fl[2]), (fl[0], fl[2], fl[3])],
                     material=_mat(albedo=(0.6, 0.6, 0.6)))
    return isf.Scene(models=sc.models + [floor], camera=sc.camera,
                     lights=sc.lights, background=sc.background)


@pytest.fixture(scope="module")
def grid23_floor(tmp_path_factory):
    """(JAX scene, port scene) of the floored grid, the JAX one loaded from
    the ISF file the port writes."""
    from path_tracer_torch.scene import build_scene, isf
    from path_tracer_tpu.scene import load_scene

    root = tmp_path_factory.mktemp("grid23_floor")
    scene = _floored_grid()
    isf.save(scene, root / "scene.isf")
    ts = build_scene(scene, root, "cpu")
    js = load_scene(root / "scene.isf")
    assert ts.sph_use_blocks and js.sph_use_blocks
    assert ts.num_real_triangles == js.num_real_triangles == 2
    np.testing.assert_array_equal(ts.sph_sorted_t.numpy(),
                                  np.asarray(js.sph_sorted_t))
    np.testing.assert_array_equal(ts.sph_smap.numpy(),
                                  np.asarray(js.sph_smap))
    return js, ts


@pytest.fixture(scope="module")
def ties():
    from path_tracer_torch.scene import build_scene
    from path_tracer_torch.scene.procedural import duplicate_sphere_scene

    ts = build_scene(duplicate_sphere_scene(), ".", "cpu")
    assert ts.sph_use_blocks and ts.num_real_spheres == 600
    return ts


@pytest.fixture(scope="module")
def tie_scenes(ties):
    """name -> the tie scene: its tables as built, and with each sphere's
    later block grown by 0.5."""
    from path_tracer_torch.scene.procedural import (
        duplicate_sphere_device_scene,
    )

    return {"ties": ties,
            "ties_grown": duplicate_sphere_device_scene("cpu", 0.5)}


def _grid_rays(seed):
    """Rays from in front of the grid (a third from its camera) toward
    points across it, every third aimed at a sphere centre."""
    g = np.random.default_rng(seed)
    o = g.uniform((-15, -15, 4), (15, 15, 20), (R, 3))
    o[: R // 3] = (0.0, 0.0, 7.0)
    tgt = g.uniform((-13, -13, -1), (13, 13, 0.5), (R, 3))
    k = g.integers(0, 23, (R, 2))
    tgt[::3] = np.stack([1.1 * (k[:, 0] - 11), 1.1 * (k[:, 1] - 11),
                         np.zeros(R)], 1)[::3]
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _t_prevs(t_first):
    """Rows of t_prev: fresh (-1), advanced to the first hit (the near root
    no longer counts: far roots, backface hits and the floor behind), and
    fresh with every seventh lane dead (+inf)."""
    fresh = np.full(R, -1.0, np.float32)
    adv = fresh.copy()
    hit = np.isfinite(t_first)
    adv[hit] = t_first[hit]
    dead = fresh.copy()
    dead[::7] = np.inf
    return np.stack([fresh, adv, dead])


# Runs _sph_walk_launch in interpret mode for each (o, d, tables, t_prev
# rows) set of argv[1] into argv[2].
_WALKS_IN_FRESH_INTERPRETER = """
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from path_tracer_tpu.ops.pallas_spheres import _sph_walk_launch
z = np.load(sys.argv[1])
out = {}
for name in sorted({k.rsplit("_", 1)[0] for k in z.files}):
    res = [_sph_walk_launch(jnp.asarray(z[name + "_o"]).T,
                            jnp.asarray(z[name + "_d"]).T,
                            jnp.asarray(tp)[None], jnp.asarray(z[name + "_blk"]),
                            jnp.asarray(z[name + "_blkid"]),
                            jnp.asarray(z[name + "_sph"]),
                            z[name + "_blk"].shape[1], interpret=True)
           for tp in z[name + "_tp"]]
    out[name + "_fout"] = np.stack([np.asarray(f) for f, _ in res])
    out[name + "_iout"] = np.stack([np.asarray(i)[0] for _, i in res])
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def jax_walks(grid23_floor, tie_scenes, tmp_path_factory):
    """name -> (o, d, t_prev rows, JAX's t, backface, sorted slot), the
    Pallas walk in interpret mode without FMA, on the floored grid and the
    tie scenes."""
    from path_tracer_torch.ops.cuda_spheres import _sph_walk_plain
    from path_tracer_torch.scene.procedural import sphere_tie_rays

    _, gs = grid23_floor
    T = torch.from_numpy
    sets = {}
    for name, sc, (o, d) in (
            ("grid", gs, _grid_rays(3)),
            *((k, v, sphere_tie_rays(R, 4)) for k, v in tie_scenes.items())):
        first = _sph_walk_plain(T(o), T(d), torch.full((R,), -1.0), sc)[0]
        sets[name] = (sc, o, d, _t_prevs(first.numpy()))
    tmp = tmp_path_factory.mktemp("sph_rows")
    arrays = {}
    for name, (sc, o, d, tp) in sets.items():
        arrays.update({name + "_o": o, name + "_d": d, name + "_tp": tp,
                       name + "_blk": sc.sph_blk.numpy(),
                       name + "_blkid": sc.sph_blkid.numpy(),
                       name + "_sph": sc.sph_sorted_t.numpy()})
    np.savez(tmp / "in.npz", **arrays)
    env = dict(os.environ, XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                                      + " --xla_cpu_max_isa=SSE4_2").strip())
    proc = subprocess.run(
        [sys.executable, "-c", _WALKS_IN_FRESH_INTERPRETER,
         str(tmp / "in.npz"), str(tmp / "out.npz")], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    out = np.load(tmp / "out.npz")
    res = {}
    for name, (_, o, d, tp) in sets.items():
        wt = out[name + "_fout"][:, 0]
        res[name] = (o, d, tp, wt, out[name + "_fout"][:, 1] != 0.0,
                     np.where(np.isfinite(wt), out[name + "_iout"], -1))
    return res


@pytest.mark.parametrize("row", [0, 1, 2], ids=["fresh", "advanced", "dead"])
def test_walk_merged_record_matches_jax(grid23_floor, jax_walks, row):
    from path_tracer_torch.ops.cuda_spheres import (
        closest_hit_spheres_cuda,
        closest_hit_spheres_walk_merged_plain,
    )
    from path_tracer_torch.ops.intersect import closest_hit_triangles
    from path_tracer_tpu.ops.intersect import (
        closest_hit_triangles as jax_triangles,
    )

    js, ts = grid23_floor
    o, d, tps, wts, wbs, wslots = jax_walks["grid"]
    tp, wt, wb, wslot = tps[row], wts[row], wbs[row], wslots[row]
    T, J = torch.from_numpy, jnp.asarray
    tri = closest_hit_triangles(T(o), T(d), T(tp), ts)
    got = closest_hit_spheres_walk_merged_plain(T(o), T(d), T(tp), ts, tri)
    # The wrapper on CPU tensors is the plain version.
    on_cpu = closest_hit_spheres_cuda(T(o), T(d), T(tp), ts, tri=tri)
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(on_cpu, f)), f
    # JAX's record: its triangles, its walk mapped as
    # closest_hit_spheres_pallas maps it, merged by its closest_hit rule.
    jt = jax_triangles(J(o), J(d), J(tp), js)
    smap = np.asarray(js.sph_smap)
    sph_hit = np.isfinite(wt)
    sph = dict(t=wt, kind=np.where(sph_hit, 2, 0),
               prim=np.where(sph_hit, smap[np.maximum(wslot, 0)], 0),
               u=np.zeros(R, np.float32), v=np.zeros(R, np.float32),
               backface=wb)
    tri_wins = np.asarray(jt.t) <= wt
    want = {f: np.where(tri_wins, np.asarray(getattr(jt, f)), sph[f])
            for f in got._fields}
    kind = got.kind.numpy()
    # Slots may part only at an exact equal-t tie of distinct spheres.
    tie = (kind == 2) & (got.prim.numpy() != want["prim"]) \
        & (got.t.numpy() == want["t"])
    np.testing.assert_array_equal(kind, want["kind"])
    for f in ("prim", "backface"):
        np.testing.assert_array_equal(getattr(got, f).numpy()[~tie],
                                      want[f][~tie], err_msg=f)
    on_sph = kind == 2
    np.testing.assert_array_equal(got.t.numpy()[on_sph], want["t"][on_sph])
    np.testing.assert_allclose(got.t.numpy()[~on_sph], want["t"][~on_sph],
                               rtol=1e-6, atol=2e-7)
    for f in ("u", "v"):
        np.testing.assert_allclose(getattr(got, f).numpy(), want[f],
                                   rtol=1e-4, atol=2e-6, err_msg=f)
    assert {1, 2} <= set(np.unique(kind)) and tie.mean() < 0.01
    if row == 2:
        assert not got.valid[::7].any()


def _tie_walk(tie_scenes, jax_walks, row, name):
    """The plain walk on the tie scene ``name`` at t_prev row ``row``
    against JAX's interpret walk: t and backface equal on every lane, the
    winner the first slot of the first of a sphere's two blocks. Returns
    (o, d, t, slot, JAX's slot)."""
    from path_tracer_torch.ops.cuda_spheres import _sph_walk_plain

    o, d, tps, wts, wbs, wslots = jax_walks[name]
    T = torch.from_numpy
    t, back, slot = (x.numpy() for x in _sph_walk_plain(
        T(o), T(d), T(tps[row]), tie_scenes[name]))
    np.testing.assert_array_equal(t, wts[row])
    np.testing.assert_array_equal(back, wbs[row])
    hit = np.isfinite(t)
    assert hit.mean() > 0.5
    assert ((slot[hit] // 128) % 2 == 0).all() and (slot[hit] % 128 == 0).all()
    if row == 1:
        assert back[hit].all()  # far roots alone
    return o, d, t, slot, wslots[row]


@pytest.mark.parametrize("row", [0, 1, 2], ids=["fresh", "advanced", "dead"])
def test_tie_scene_lowest_slot_matches_jax(tie_scenes, jax_walks, row):
    """Every copy of a sphere gives one t; the walk keeps the lowest sorted
    slot, which lies in the first of its two blocks, as JAX's does."""
    *_, slot, wslot = _tie_walk(tie_scenes, jax_walks, row, "ties")
    np.testing.assert_array_equal(slot, wslot)


@pytest.mark.parametrize("row", [0, 1, 2], ids=["fresh", "advanced", "dead"])
def test_grown_tie_scene_lowest_slot(tie_scenes, jax_walks, row):
    """With each sphere's later block grown, its entry comes first on every
    hit lane, and on some fresh lanes the root lies before the earlier
    block's entry. The walk still keeps the lowest slot; JAX's walk, which
    keeps the first block it visits, names the copy of the same sphere in
    the later block."""
    from path_tracer_torch.ops import slab
    from path_tracer_torch.scene.procedural import DUPLICATE_SPHERE_COPIES

    sc = tie_scenes["ties_grown"]
    o, d, t, slot, wslot = _tie_walk(tie_scenes, jax_walks, row,
                                     "ties_grown")
    hit = np.isfinite(t)
    np.testing.assert_array_equal(slot[~hit], wslot[~hit])
    np.testing.assert_array_equal(wslot[hit], slot[hit] + 128)
    smap = sc.sph_smap.numpy() // DUPLICATE_SPHERE_COPIES
    np.testing.assert_array_equal(smap[wslot[hit]], smap[slot[hit]])
    if row == 0:
        T = torch.from_numpy
        tn = slab.slab(T(o), slab.safe_inv(T(d)), sc.sph_blk)[0].numpy()
        lanes = np.nonzero(hit)[0]
        first = tn[lanes, slot[hit] // 128]
        assert (tn[lanes, slot[hit] // 128 + 1] < first).all()
        assert (t[hit] < first).sum() >= 5


@pytest.fixture(scope="module")
def occ_scenes():
    """name -> (JAX scene, port scene): the Cornell box (brute force, both
    kinds) and the textured showcase at grid 48 (flat walk, 48 spheres)."""
    from path_tracer_torch.scene import from_numpy
    from path_tracer_torch.scene.device_scene import (
        ARRAY_FIELDS,
        STATIC_FIELDS,
    )
    from path_tracer_torch.scene.showcase import showcase_device_scene
    from path_tracer_tpu.scene.procedural import cornell_device_scene
    from path_tracer_tpu.scene.showcase import (
        showcase_device_scene as jax_showcase,
    )

    jc = cornell_device_scene()
    tc = from_numpy({f: np.asarray(getattr(jc, f)) for f in ARRAY_FIELDS},
                    {s: getattr(jc, s) for s in STATIC_FIELDS}, "cpu")
    jt = jax_showcase(48, sl_block=256, textured=True)
    tt = showcase_device_scene(48, "cpu", sl_block=256, textured=True)
    assert not tc.use_bvh and tt.use_bvh and not tt.sph_use_blocks
    return {"cornell": (jc, tc), "showcase48": (jt, tt)}


def _shadow_lanes(ts, seed):
    """(o, [d x 3], surf_pos, [max_dist, max_dist, None], [active x 3]):
    origins in the scene's box 1e-3 off their surface points (every third
    near a sphere's surface), toward two point lights at random distances
    and one directional light; a tenth of each set dead."""
    g = np.random.default_rng(seed)
    n = OCC_LANES
    v = ts.tri_v0[: ts.num_real_triangles].numpy()
    lo, hi = v.min(0), v.max(0)
    p = g.uniform(lo, hi, (n, 3))
    c = ts.sph_center[: ts.num_real_spheres].numpy()
    rad = ts.sph_radius[: ts.num_real_spheres].numpy()
    k = g.integers(0, len(c), n)
    nrm = g.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    p[::3] = (c[k] + (rad[k, None] + 1e-3) * nrm)[::3]
    dirs, dists = [], []
    for _ in range(2):
        light = g.uniform(lo - 0.2 * (hi - lo), hi + 0.2 * (hi - lo), (n, 3))
        to = light - p
        dist = np.linalg.norm(to, axis=1)
        dirs.append(to / dist[:, None])
        dists.append(dist)
    sun = g.normal(size=3)
    sun[1] = abs(sun[1]) + 0.5
    dirs.append(np.broadcast_to(sun / np.linalg.norm(sun), (n, 3)))
    dists.append(None)
    o = p + 1e-3 * dirs[0]
    acts = [g.uniform(size=n) > 0.1 for _ in range(3)]
    f32 = lambda x: np.ascontiguousarray(x, np.float32)
    return (f32(o), [f32(x) for x in dirs], f32(p),
            [None if x is None else f32(x) for x in dists], acts)


@pytest.mark.parametrize("name", ["cornell", "showcase48"])
def test_occluded_multi_fold_matches_jax(occ_scenes, name):
    from path_tracer_torch.ops import cuda_spheres, intersect
    from path_tracer_tpu.ops.intersect import occluded_multi as jax_multi

    js, ts = occ_scenes[name]
    o, dirs, p, dists, acts = _shadow_lanes(ts, 61)
    T, J = torch.from_numpy, jnp.asarray
    got = intersect.occluded_multi(
        T(o), [T(x) for x in dirs], ts, surf_pos=T(p),
        max_dists=[None if x is None else T(x) for x in dists],
        actives=[T(a) for a in acts])
    want = jax_multi(J(o), [J(x) for x in dirs], js, surf_pos=J(p),
                     max_dists=[None if x is None else J(x) for x in dists],
                     actives=[J(a) for a in acts])
    point_lanes, flips = 0, 0
    for k, (g_, w, a, md) in enumerate(zip(got, want, acts, dists)):
        g_, w = g_.numpy(), np.asarray(w) & a
        assert not g_[~a].any()
        n_off = int((g_ != w).sum())
        if md is None:
            assert n_off == 0, f"directional set {k}: {n_off} lanes off"
        else:
            point_lanes += len(g_)
            flips += n_off
        if md is not None:  # the box is closed: no sun reaches inside
            assert 0.05 < w[a].mean() < 0.95, (k, w[a].mean())
    assert flips <= 1e-4 * point_lanes, flips
    # The fold equals the two any-hits ORed set by set.
    tms = [intersect.shadow_t_max(T(o), T(x), T(p),
                                  None if md is None else T(md))
           for x, md in zip(dirs, dists)]
    tms = [torch.where(T(a), tm, -1.0) for tm, a in zip(tms, acts)]
    sph = cuda_spheres.occluded_spheres_plain(T(o), [T(x) for x in dirs], tms,
                                              ts)
    tri = intersect.occluded_multi(
        T(o), [T(x) for x in dirs], _no_spheres(ts), surf_pos=T(p),
        max_dists=[None if x is None else T(x) for x in dists],
        actives=[T(a) for a in acts])
    for g_, s, t_, a in zip(got, sph, tri, acts):
        assert torch.equal(g_, (s | t_) & T(a))


def _no_spheres(ts):
    import dataclasses

    return dataclasses.replace(ts, num_real_spheres=0)


def test_occluded_spheres_prior_is_folded(occ_scenes):
    """prior | spheres on every lane: a set whose prior is set is occluded,
    dead lanes included; without prior the spheres' result alone."""
    from path_tracer_torch.ops.cuda_spheres import occluded_spheres_cuda

    _, ts = occ_scenes["showcase48"]
    o, dirs, p, dists, _ = _shadow_lanes(ts, 62)
    T = torch.from_numpy
    ds = torch.stack([T(x) for x in dirs])
    tms = torch.stack([torch.full((OCC_LANES,), float("inf")),
                       T(dists[0]), T(dists[1])])
    tms[:, ::11] = -1.0
    g = torch.Generator().manual_seed(3)
    prior = torch.rand((3, OCC_LANES), generator=g) < 0.1
    alone = occluded_spheres_cuda(T(o), ds, tms, ts)
    got = occluded_spheres_cuda(T(o), ds, tms, ts, prior=prior)
    assert torch.equal(got, alone | prior)
    assert not alone[:, ::11].any() and got[prior].all()
    assert 0.02 < float(alone.float().mean()) < 0.9


def _fake_operands(n):
    from torch._subclasses.fake_tensor import FakeTensorMode

    mode = FakeTensorMode()
    with mode:
        cuda = dict(device="cuda")
        ops = dict(
            o=torch.empty((n, 3), **cuda), d=torch.empty((n, 3), **cuda),
            tp=torch.empty((n,), **cuda),
            blk=torch.empty((8, 128), **cuda),
            blkid=torch.empty((1, 128), dtype=torch.int32, **cuda),
            sorted=torch.empty((4, 256), **cuda),
            smap=torch.empty((256,), dtype=torch.int32, **cuda),
            table=torch.empty((4, 128), **cuda))
    return mode, ops


@pytest.mark.parametrize("fault", ["tri dtype", "tri shape", "tri layout",
                                   "tri device", "smap dtype",
                                   "smap shape", "lane_wise 0",
                                   "lane_wise 34"])
def test_sph_walk_launch_checks_record_and_map(fault, monkeypatch):
    from path_tracer_torch import native
    from path_tracer_torch.ops.intersect import HitRecord

    def _no_build():
        raise AssertionError("built before its checks")

    monkeypatch.setattr(native, "kernels", _no_build)
    n = 64
    mode, x = _fake_operands(n)
    smap = x["smap"]
    with mode:
        cuda = dict(device="cuda")
        f32 = lambda: torch.empty((n,), **cuda)
        i32 = lambda: torch.empty((n,), dtype=torch.int32, **cuda)
        tri = HitRecord(t=f32(), kind=i32(), prim=i32(), u=f32(), v=f32(),
                        backface=torch.empty((n,), dtype=torch.bool, **cuda))
        if fault == "tri dtype":
            tri = tri._replace(prim=f32())
        elif fault == "tri shape":
            tri = tri._replace(v=torch.empty((n + 1,), **cuda))
        elif fault == "tri layout":
            tri = tri._replace(t=torch.empty_strided((n,), (2,), **cuda))
        elif fault == "smap dtype":
            smap = torch.empty((256,), **cuda)
        elif fault == "smap shape":
            smap = torch.empty((128,), dtype=torch.int32, **cuda)
    if fault == "tri device":
        tri = tri._replace(backface=torch.zeros(n, dtype=torch.bool))
    lane_wise = (int(fault.split()[1]) if fault.startswith("lane_wise")
                 else native.SPH_WALK_LANE_WISE)
    with mode, pytest.raises(ValueError):
        native.launch_sph_walk(x["o"], x["d"], x["tp"], x["blk"], x["blkid"],
                               x["sorted"], smap, tri, lane_wise=lane_wise)


@pytest.mark.parametrize("fault", ["prior dtype", "prior shape",
                                   "prior device", "too many sets"])
def test_sph_occluded_launch_checks_prior_and_sets(fault, monkeypatch):
    from path_tracer_torch import native

    def _no_build():
        raise AssertionError("built before its checks")

    monkeypatch.setattr(native, "kernels", _no_build)
    n = 64
    mode, x = _fake_operands(n)
    sets = 9 if fault == "too many sets" else 3
    with mode:
        cuda = dict(device="cuda")
        ds = torch.empty((sets, n, 3), **cuda)
        tms = torch.empty((sets, n), **cuda)
        prior = torch.empty((sets, n), dtype=torch.bool, **cuda)
        if fault == "prior dtype":
            prior = torch.empty((sets, n), **cuda)  # the f32 of old
        elif fault == "prior shape":
            prior = torch.empty((sets - 1, n), dtype=torch.bool, **cuda)
    if fault == "prior device":
        prior = torch.zeros((sets, n), dtype=torch.bool)
    assert native.SPH_OCC_MAX_SETS == 8
    with mode, pytest.raises(ValueError):
        native.launch_sph_occluded(x["o"], ds, tms, x["table"], 100, prior)
