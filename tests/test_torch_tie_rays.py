"""Tie and edge rays: the port's plain flat walk and plain brute-force MT
against the JAX package's Pallas kernels in interpret mode, on the CPU.

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
hold.
"""
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

# Builds the scene of argv[1] with and without the BVH and casts the rays
# of argv[2] through JAX's flat kernel, Pallas MT kernel (both interpret
# mode) and jnp brute force, into argv[3].
_JAX_IN_FRESH_INTERPRETER = """
import sys
from pathlib import Path
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from path_tracer_tpu.ops.intersect import closest_hit_triangles
from path_tracer_tpu.ops.pallas_bvh import closest_hit_triangles_flat
from path_tracer_tpu.ops.pallas_intersect import closest_hit_triangles_pallas
from path_tracer_tpu.scene import isf
from path_tracer_tpu.scene.device_scene import build_device_scene
path, z = Path(sys.argv[1]), np.load(sys.argv[2])
o, d, tp = (jnp.asarray(z[k]) for k in ("o", "d", "tp"))
scene = {b: build_device_scene(isf.load(path), path.parent, use_bvh=b,
                               sl_block=int(z["block"])) for b in (0, 1)}
out = {"flat": closest_hit_triangles_flat(o, d, tp, scene[1],
                                          interpret=True),
       "pallas": closest_hit_triangles_pallas(o, d, tp, scene[0],
                                              interpret=True),
       "jnp": closest_hit_triangles(o, d, tp, scene[0])}
np.savez(sys.argv[3], **{f"{k}_{f}": np.asarray(getattr(h, f))
                         for k, h in out.items()
                         for f in ("t", "kind", "prim", "u", "v", "backface")})
"""


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ties(tmp_path_factory):
    """The scene written once as ISF and built by the port with and without
    the BVH, the rays, and JAX's records ({route: SimpleNamespace})."""
    from types import SimpleNamespace

    from path_tracer_torch.scene import isf, load_scene
    from path_tracer_torch.scene.procedural import (
        duplicate_grid_scene,
        tie_rays,
    )

    tmp = tmp_path_factory.mktemp("ties")
    path = tmp / "scene.isf"
    isf.save(duplicate_grid_scene(N_GRID, STACK), path)
    o, d = tie_rays(R, N_GRID)
    tp = np.full(R, -1.0, np.float32)
    tp[::11] = np.inf
    np.savez(tmp / "in.npz", o=o, d=d, tp=tp, block=BLOCK)
    env = dict(os.environ, XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                                      + " --xla_cpu_max_isa=SSE4_2").strip())
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_IN_FRESH_INTERPRETER, str(path),
         str(tmp / "in.npz"), str(tmp / "out.npz")], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    z = np.load(tmp / "out.npz")
    jax = {k: SimpleNamespace(**{f: z[f"{k}_{f}"] for f in FIELDS})
           for k in ("flat", "pallas", "jnp")}
    scenes = {b: load_scene(path, "cpu", use_bvh=b, sl_block=BLOCK)
              for b in (True, False)}
    return scenes, o, d, tp, jax


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


@pytest.mark.parametrize("group", list(GROUPS))
def test_flat_ties_match_jax(ties, group):
    from path_tracer_torch.ops.cuda_bvh import closest_hit_triangles_flat
    from path_tracer_torch.scene.procedural import tie_winners

    scenes, o, d, tp, jax = ties
    ts = scenes[True]
    rs = GROUPS[group]
    T = torch.from_numpy
    got = closest_hit_triangles_flat(T(o[rs]), T(d[rs]), T(tp[rs]), ts)
    want = _group(jax["flat"], rs)
    live = np.isfinite(tp[rs])
    assert got.valid.numpy()[live].mean() > 0.9
    assert not got.valid.numpy()[~live].any()
    if group in EXACT:
        _assert_hits(got, want, ts, d[rs])
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
    _assert_hits(rec, _group(want, same), ts, d[rs][same])


@pytest.mark.parametrize("group", list(GROUPS))
def test_mt_ties_match_jax(ties, group):
    from path_tracer_torch.ops.cuda_intersect import closest_hit_triangles_cuda
    from path_tracer_torch.scene.procedural import tie_winners

    scenes, o, d, tp, jax = ties
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
