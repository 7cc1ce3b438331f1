"""Tie and edge rays: the port's plain flat and flat2 walks (closest hit and
any-hit) and plain brute-force MT against the JAX package's Pallas kernels
in interpret mode, on the CPU.

The scene (``scene.procedural.duplicate_grid_scene``) lists every triangle
of an 8 x 8 grid twice, then 300 more copies of its first triangle, in
128-slot blocks. Identical rows give bit-identical t, so only the tie rule
decides between copies: the lowest packed slot (block walks) or the lowest
index (brute force). A pair shares one centroid and the BVH keeps it in one
block; the stack outgrows a block and is split across several, with the
pair it duplicates.

Rays (``tie_rays``), 128 of each kind, every 11th dead: at random
triangles' centroids and at the stacked triangle's centroid, where prim and
kind must be exactly equal and be the copy the tie rule picks; at shared
edges and at interior vertices, where two triangles meet at one point.

JAX runs in a fresh interpreter held to SSE4.2, as in
tests/test_torch_sph_walk.py: XLA's CPU jit otherwise contracts
multiply-adds into FMAs, and that ulp flips edge and vertex rays between
hit and miss (ROADMAP Queue 3). Without FMA the brute force agrees exactly
on every lane. The flat walk agrees on every kind; on edge and vertex rays
the interpret kernel's Baldwin-Weber sums associate differently, so a ray
through a shared edge may take the other of the two triangles that meet
there, at a t within the tolerance of tests/test_torch_bvh.py. Elsewhere
the tolerances of tests/test_torch_bvh.py and tests/test_torch_intersect.py
hold. The flat2 walk and the tree walk (JAX's packet kernel: plain MT,
the copy of the first leaf visited winning unless a later leaf holds a
strictly nearer hit) keep the flat walk's rules against JAX's flat2 and
packet kernels, and the any-hits (t_max well past or well short of each
lane's hit, dead lanes) agree exactly.

A second scene, without JAX, stacks 8,400 copies so that they sit in the
blocks of two superblocks (132 blocks of 128): there the plain flat2 walk
equals the plain flat walk on every field of every lane, the tie rule's
copy winning, whatever superblock a copy sits in.

Without JAX, each walk that gates a lane by its own slab test is held to
an ungated judge on 4,096 tie rays near and far (closest hit, from an ulp
before the judge's hit, any-hit at the hit's t): the tree walks to
brute-force MT, the flat and flat2 walks to themselves with every block
and superblock box at +-1e30. No lane may differ. On the exact boxes both
lose hits (the mutation tests), which is why the boxes and the slab
intervals are widened (``ops/slab.py``).
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_bvh import _assert_hits
from test_torch_intersect import _assert_tri_equal

REPO = Path(__file__).resolve().parents[1]
N_GRID, STACK, BLOCK = 8, 300, 128
R = 512
GROUPS = {"centroids": slice(0, 128), "stack": slice(128, 256),
          "edges": slice(256, 384), "vertices": slice(384, 512)}
EXACT = ("centroids", "stack")
FIELDS = ("t", "kind", "prim", "u", "v", "backface")

# The second scene: copies in the blocks of two superblocks.
N_GRID_2SB, STACK_2SB = 8, 8400

# Builds the scene of argv[1] with and without the BVH and casts the rays
# of argv[2] through JAX's flat, flat2 and tree (packet) kernels, Pallas MT
# kernel (all interpret mode) and jnp brute force, and its flat, flat2 and
# tree any-hits (interpret mode) up to t_max, into argv[3].
_JAX_IN_FRESH_INTERPRETER = """
import sys
from pathlib import Path
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from path_tracer_tpu.ops.intersect import closest_hit_triangles
from path_tracer_tpu.ops.pallas_bvh import (
    closest_hit_triangles_flat, closest_hit_triangles_flat2,
    closest_hit_triangles_packet, occluded_triangles_flat,
    occluded_triangles_flat2, occluded_triangles_packet)
from path_tracer_tpu.ops.pallas_intersect import closest_hit_triangles_pallas
from path_tracer_tpu.scene import isf
from path_tracer_tpu.scene.device_scene import build_device_scene
path, z = Path(sys.argv[1]), np.load(sys.argv[2])
o, d, tp, tm = (jnp.asarray(z[k]) for k in ("o", "d", "tp", "tm"))
scene = {b: build_device_scene(isf.load(path), path.parent, use_bvh=b,
                               sl_block=int(z["block"])) for b in (0, 1)}
out = {"flat": closest_hit_triangles_flat(o, d, tp, scene[1],
                                          interpret=True),
       "flat2": closest_hit_triangles_flat2(o, d, tp, scene[1],
                                            interpret=True),
       "tree": closest_hit_triangles_packet(o, d, tp, scene[1],
                                            interpret=True),
       "pallas": closest_hit_triangles_pallas(o, d, tp, scene[0],
                                              interpret=True),
       "jnp": closest_hit_triangles(o, d, tp, scene[0])}
occ = {f"occ_{k}": np.asarray(f(o, d, tm, scene[1], interpret=True))
       for k, f in (("flat", occluded_triangles_flat),
                    ("flat2", occluded_triangles_flat2),
                    ("tree", occluded_triangles_packet))}
np.savez(sys.argv[3], **occ,
         **{f"{k}_{f}": np.asarray(getattr(h, f))
            for k, h in out.items()
            for f in ("t", "kind", "prim", "u", "v", "backface")})
"""


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _any_hit_t_max(t_hit, tp):
    """t_max of the any-hit checks: well past the lane's hit (1.5 t) on
    even lanes, well short of it (0.5 t) on odd ones, 5 on a miss, -1 on
    the dead lanes (t_prev = +inf)."""
    r = t_hit.shape[0]
    scale = np.where(np.arange(r) % 2 == 0, 1.5, 0.5).astype(np.float32)
    tm = np.where(np.isfinite(t_hit), t_hit * scale, np.float32(5.0))
    return np.where(np.isfinite(tp), tm, np.float32(-1.0)).astype(np.float32)


@pytest.fixture(scope="module")
def ties(tmp_path_factory):
    """The scene written once as ISF and built by the port with and without
    the BVH, the rays (t_prev and the any-hit's t_max), and JAX's records
    ({route: SimpleNamespace}, and "occ_flat", "occ_flat2": [R] bool)."""
    from types import SimpleNamespace

    from path_tracer_torch.ops.cuda_bvh import closest_hit_triangles_flat
    from path_tracer_torch.scene import isf, load_scene
    from path_tracer_torch.scene.procedural import (
        duplicate_grid_scene,
        tie_rays,
    )

    tmp = tmp_path_factory.mktemp("ties")
    path = tmp / "scene.isf"
    isf.save(duplicate_grid_scene(N_GRID, STACK), path)
    scenes = {b: load_scene(path, "cpu", use_bvh=b, sl_block=BLOCK)
              for b in (True, False)}
    o, d = tie_rays(R, N_GRID)
    tp = np.full(R, -1.0, np.float32)
    tp[::11] = np.inf
    T = torch.from_numpy
    t_hit = closest_hit_triangles_flat(T(o), T(d), T(tp), scenes[True]).t
    tm = _any_hit_t_max(t_hit.numpy(), tp)
    np.savez(tmp / "in.npz", o=o, d=d, tp=tp, tm=tm, block=BLOCK)
    env = dict(os.environ, XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                                      + " --xla_cpu_max_isa=SSE4_2").strip())
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_IN_FRESH_INTERPRETER, str(path),
         str(tmp / "in.npz"), str(tmp / "out.npz")], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    z = np.load(tmp / "out.npz")
    jax = {k: SimpleNamespace(**{f: z[f"{k}_{f}"] for f in FIELDS})
           for k in ("flat", "flat2", "tree", "pallas", "jnp")}
    jax.update({f"occ_{k}": z[f"occ_{k}"] for k in ("flat", "flat2", "tree")})
    return scenes, o, d, tp, tm, jax


def _group(rec, rs):
    from types import SimpleNamespace

    return SimpleNamespace(**{f: np.asarray(getattr(rec, f))[rs]
                              for f in FIELDS})


def _block_of_copies(ts):
    """Per set of identical triangles (more than one), the blocks its copies
    sit in."""
    n = ts.num_real_triangles
    rows = torch.cat([ts.tri_v0[:n], ts.tri_e1[:n], ts.tri_e2[:n]], 1)
    inv = np.unique(rows.numpy(), axis=0, return_inverse=True)[1].ravel()
    block = (ts.sl_inv[:n] // BLOCK).numpy()
    sets = {}
    for k, b in zip(inv, block):
        sets.setdefault(int(k), []).append(int(b))
    return [v for v in sets.values() if len(v) > 1]


def test_copies_within_and_across_blocks(ties):
    scenes = ties[0]
    sets = _block_of_copies(scenes[True])
    assert len(sets) == 2 * N_GRID * N_GRID
    pairs = [b for b in sets if len(b) == 2]
    assert sum(b[0] == b[1] for b in pairs) > 100  # pairs in one block
    stack = max(sets, key=len)
    assert len(stack) == STACK + 2 and len(set(stack)) >= 3  # split


def _assert_walk_ties(got, want, ts, d, tp, group):
    """A block walk's record against JAX's on one group of tie rays: exact
    on centroids and the stack, with the tie rule's copy winning; at shared
    edges and vertices the same kinds, and where the two take different
    triangles, one t within the tolerance."""
    from path_tracer_torch.scene.procedural import tie_winners

    T = torch.from_numpy
    live = np.isfinite(tp)
    assert got.valid.numpy()[live].mean() > 0.9
    assert not got.valid.numpy()[~live].any()
    if group in EXACT:
        _assert_hits(got, want, ts, d)
        winner = tie_winners(ts)[1]
        prim = got.prim[got.valid].long().numpy()
        np.testing.assert_array_equal(winner[prim], prim)
        return
    # A shared edge or vertex: the kinds agree, and where the two take
    # different triangles, both hit at one t within the tolerance.
    np.testing.assert_array_equal(got.kind.numpy(), want.kind)
    other = got.prim.numpy() != want.prim
    assert other.mean() <= 0.1
    np.testing.assert_allclose(got.t.numpy()[other], want.t[other],
                               rtol=1e-5, atol=1e-6)
    same = ~other
    rec = type(got)(*[x[T(same)] for x in got])
    _assert_hits(rec, _group(want, same), ts, d[same])


@pytest.mark.parametrize("group", list(GROUPS))
def test_flat_ties_match_jax(ties, group):
    from path_tracer_torch.ops.cuda_bvh import closest_hit_triangles_flat

    scenes, o, d, tp, _, jax = ties
    rs = GROUPS[group]
    T = torch.from_numpy
    got = closest_hit_triangles_flat(T(o[rs]), T(d[rs]), T(tp[rs]),
                                     scenes[True])
    _assert_walk_ties(got, _group(jax["flat"], rs), scenes[True], d[rs],
                      tp[rs], group)


@pytest.mark.parametrize("group", list(GROUPS))
def test_flat2_ties_match_jax(ties, group):
    """The plain flat2 walk against JAX's flat2 kernel (interpret mode),
    with the flat walk's rules."""
    from path_tracer_torch.ops.cuda_bvh import closest_hit_triangles_flat2

    scenes, o, d, tp, _, jax = ties
    rs = GROUPS[group]
    T = torch.from_numpy
    got = closest_hit_triangles_flat2(T(o[rs]), T(d[rs]), T(tp[rs]),
                                      scenes[True])
    _assert_walk_ties(got, _group(jax["flat2"], rs), scenes[True], d[rs],
                      tp[rs], group)


@pytest.mark.parametrize("group", list(GROUPS))
def test_tree_ties_match_jax(ties, group):
    """The plain tree walk against JAX's packet kernel (interpret mode),
    with the flat walk's rules: the tied copies sit in one leaf or in
    several, and a later leaf takes over only on a strictly smaller t."""
    from path_tracer_torch.ops.cuda_bvh import closest_hit_triangles_tree

    scenes, o, d, tp, _, jax = ties
    rs = GROUPS[group]
    T = torch.from_numpy
    got = closest_hit_triangles_tree(T(o[rs]), T(d[rs]), T(tp[rs]),
                                     scenes[True])
    _assert_walk_ties(got, _group(jax["tree"], rs), scenes[True], d[rs],
                      tp[rs], group)


@pytest.mark.parametrize("walk", ["flat", "flat2", "tree"])
@pytest.mark.parametrize("group", list(GROUPS))
def test_any_hit_ties_match_jax(ties, walk, group):
    """The plain flat, flat2 and tree any-hits against JAX's (interpret
    mode) on every lane: t_max past and short of the hit, misses, dead
    lanes."""
    from path_tracer_torch.ops import cuda_bvh

    scenes, o, d, tp, tm, jax = ties
    rs = GROUPS[group]
    T = torch.from_numpy
    multi = {"flat": cuda_bvh.occluded_triangles_flat_multi,
             "flat2": cuda_bvh.occluded_triangles_flat2_multi,
             "tree": cuda_bvh.occluded_triangles_tree_multi}[walk]
    got = multi(T(o[rs]), [T(d[rs])], [T(tm[rs])], scenes[True])[0].numpy()
    np.testing.assert_array_equal(got, jax[f"occ_{walk}"][rs])
    live = tm[rs] >= 0.0
    assert got[~live].all()  # dead lanes report occluded
    scored = tm[rs] != 5.0  # t_max set from the flat walk's hit
    if walk == "tree":
        # Moller-Trumbore and Baldwin-Weber part on some rays through a
        # shared edge or vertex: score the lanes the tree's own cast hits.
        scored &= cuda_bvh.closest_hit_triangles_tree(
            T(o[rs]), T(d[rs]), T(tp[rs]), scenes[True]).valid.numpy()
    past = live & (np.arange(R)[rs] % 2 == 0) & scored
    assert got[past].all() and not got[live & ~past & scored].any()


@pytest.fixture(scope="module")
def ties2sb():
    """The two-superblock tie scene (the port alone) and its rays."""
    from path_tracer_torch.scene import build_scene
    from path_tracer_torch.scene.procedural import (
        duplicate_grid_scene,
        tie_rays,
    )

    sc = build_scene(duplicate_grid_scene(N_GRID_2SB, STACK_2SB), ".", "cpu",
                     use_bvh=True, sl_block=BLOCK)
    o, d = (torch.from_numpy(x) for x in tie_rays(R, N_GRID_2SB))
    tp = torch.full((R,), -1.0)
    tp[::11] = float("inf")
    return sc, o, d, tp


def test_stack_spans_two_superblocks(ties2sb):
    """The stacked copies sit in block columns of superblocks 0 and 1."""
    sc = ties2sb[0]
    ids = sc.sl_blkid[0].numpy()
    col_of = {int(b): c for c, b in enumerate(ids) if b >= 0}
    stack = max(_block_of_copies(sc), key=len)
    assert sc.sl_n_blocks > 128 and len(stack) == STACK_2SB + 2
    assert {col_of[b] // 128 for b in stack} == {0, 1}


@pytest.mark.parametrize("group", list(GROUPS))
def test_flat2_equals_flat_across_superblocks(ties2sb, group):
    """The plain flat2 walk equals the plain flat walk on every field of
    every lane where the tied copies sit in two superblocks, and the tie
    rule's copy wins."""
    from path_tracer_torch.ops import cuda_bvh
    from path_tracer_torch.scene.procedural import tie_winners

    sc, o, d, tp = ties2sb
    rs = GROUPS[group]
    got = cuda_bvh.closest_hit_triangles_flat2(o[rs], d[rs], tp[rs], sc)
    want = cuda_bvh.closest_hit_triangles_flat(o[rs], d[rs], tp[rs], sc)
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert got.valid[torch.isfinite(tp[rs])].float().mean() > 0.9
    prim = got.prim[got.valid].long().numpy()
    np.testing.assert_array_equal(tie_winners(sc)[1][prim], prim)


@pytest.mark.parametrize("group", list(GROUPS))
def test_mt_ties_match_jax(ties, group):
    from path_tracer_torch.ops.cuda_intersect import closest_hit_triangles_cuda
    from path_tracer_torch.scene.procedural import tie_winners

    scenes, o, d, tp, _, jax = ties
    ts = scenes[False]
    rs = GROUPS[group]
    T = torch.from_numpy
    got = closest_hit_triangles_cuda(T(o[rs]), T(d[rs]), T(tp[rs]), ts)
    live = np.isfinite(tp[rs])
    assert got.valid.numpy()[live].mean() > 0.9
    assert not got.valid.numpy()[~live].any()
    for route in ("pallas", "jnp"):
        _assert_tri_equal(got, _group(jax[route], rs))
    if group in EXACT:
        winner = tie_winners(ts)[0]
        prim = got.prim[got.valid].long().numpy()
        np.testing.assert_array_equal(winner[prim], prim)


@pytest.fixture(scope="module")
def tie_grid():
    """The tie scene in 128-slot blocks (no JAX)."""
    from path_tracer_torch.scene import build_scene
    from path_tracer_torch.scene.procedural import duplicate_grid_scene

    return build_scene(duplicate_grid_scene(N_GRID, STACK), ".", "cpu",
                       use_bvh=True, sl_block=BLOCK)


def _ungated(sc):
    """The scene with every real block and superblock box at +-1e30: the
    flat and flat2 walks' ungated form, every block tested by every
    live lane."""
    def opened(boxes, ids):
        boxes = boxes.clone()
        real = ids[0] >= 0
        boxes[0:3, real] = -1e30
        boxes[3:6, real] = 1e30
        return boxes

    return dataclasses.replace(
        sc, sl_blkflat=opened(sc.sl_blkflat, sc.sl_blkid),
        sl_sbflat=opened(sc.sl_sbflat, sc.sl_sbid))


def _tree_off_brute(sc, origin: str, walk: str = "tree") -> dict:
    """Lanes where a plain walk leaves its ungated judge on 4,096 tie rays,
    from 3 units above (``near``) or from 800 to 8,000 units back along
    the same rays (``far``): closest hit from t_prev -1 and from an ulp
    before the judge's hit (hit/miss or t differing; the prim may be
    another copy at the same t), any-hit at t_max = that hit's t, misses
    at 5. The tree walks' judge is brute-force MT
    (``intersect.closest_hit_triangles``, the same MT arithmetic); the
    flat and flat2 walks' is the same walk with every box at +-1e30
    (``_ungated``: brute-force Baldwin-Weber)."""
    from path_tracer_torch.ops import cuda_bvh, intersect
    from path_tracer_torch.scene.procedural import tie_rays

    o, d = tie_rays(4096, N_GRID, seed=3)
    if origin == "far":
        g = np.random.default_rng(4)
        aim = o + 3.0 / -d[:, 1:2] * d
        o = (aim - d * 8.0 * 10.0 ** g.uniform(2.0, 3.0, (len(o), 1))
             ).astype(np.float32)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    tp = torch.full((o.shape[0],), -1.0)
    tp[::11] = float("inf")
    closest = getattr(cuda_bvh, f"closest_hit_triangles_{walk}_plain")
    occluded = getattr(cuda_bvh, f"occluded_triangles_{walk}_plain")
    if walk == "tree":
        judge = lambda g: intersect.closest_hit_triangles(o, d, g, sc)
    else:
        brute = _ungated(sc)
        judge = lambda g: closest(o, d, g, brute)
    want = judge(tp)
    # Baldwin-Weber's rounding misses more of the far rays through shared
    # edges and vertices than MT's does.
    hits = want.valid[torch.isfinite(tp)].float().mean()
    assert hits > (0.9 if walk == "tree" else 0.85)
    before = torch.where(want.valid, torch.nextafter(
        want.t, torch.tensor(-1.0)), tp)
    want2 = judge(before)
    off = {}
    for key, g, w in (("closest", tp, want), ("from before", before, want2)):
        got = closest(o, d, g, sc)
        off[key] = int(((got.valid != w.valid)
                        | (w.valid & (got.t != w.t))).sum())
    t_max = torch.where(torch.isinf(tp), -1.0,
                        torch.where(want.valid, want.t, 5.0))
    occ = occluded(o, d, t_max, sc)
    want_occ = (want.valid | (t_max < 0) if walk == "tree"
                else occluded(o, d, t_max, brute))
    off["any-hit"] = int((occ != want_occ).sum())
    return off


@pytest.mark.parametrize("origin", ["near", "far"])
@pytest.mark.parametrize("walk", ["flat", "flat2", "tree"])
def test_tree_walks_equal_brute_force(tie_grid, walk, origin):
    """The plain walks each lane gates by its own slab test on widened
    boxes keep every hit of their ungated judge on rays through the
    grid's centroids, the stack, shared edges and shared vertices, near
    and far: no lane off. The tree walks (rows 7 and 8) against
    brute-force MT; the flat and flat2 walks (rows 9-12) against
    themselves with every box at +-1e30."""
    assert _tree_off_brute(tie_grid, origin, walk) == {
        "closest": 0, "from before": 0, "any-hit": 0}


def test_flat_walks_exact_boxes_drop_hits(tie_grid, monkeypatch):
    """Why the flat walks widen the block boxes: on the exact boxes and
    intervals a lane's own rounded slab test rejects the block whose
    triangle its Baldwin-Weber test hits where the ray passes through a
    vertex or an edge lying on the block's box, and the walk loses hits
    of the ungated walk, near and far."""
    from path_tracer_torch.ops import slab

    for name in ("BOX_PAD_EXT", "BOX_PAD_MAG", "BOX_PAD_T"):
        monkeypatch.setattr(slab, name, 0.0)
    for origin in ("near", "far"):
        off = _tree_off_brute(tie_grid, origin, "flat")
        assert off["closest"] > 0 and off["any-hit"] > 0, off


def test_tree_walks_exact_boxes_drop_hits(tie_grid, monkeypatch):
    """Why the tree walks widen the boxes: on the exact boxes and
    intervals a lane's own rounded slab test rejects the leaf whose
    triangle its MT test hits where the ray passes through a vertex or an
    edge lying on the leaf's box, and the walks lose hits of the brute
    force, near and far (dozens of lanes on these rays)."""
    from path_tracer_torch.ops import slab

    for name in ("BOX_PAD_EXT", "BOX_PAD_MAG", "BOX_PAD_T"):
        monkeypatch.setattr(slab, name, 0.0)
    for origin in ("near", "far"):
        off = _tree_off_brute(tie_grid, origin)
        assert off["closest"] > 0 and off["any-hit"] > 0, off
