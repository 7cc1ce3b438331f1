"""The sphere any-hit's plain version against the JAX package, on the CPU.

``cuda_spheres.occluded_spheres_plain`` (what ``occluded_spheres_cuda``
runs on CPU tensors, and what ``csrc/sph_occ.cu`` is held to on the card)
against ``pallas_spheres.occluded_spheres_pallas`` in interpret mode: the
dense kernel on the ``spheres`` scene (25 spheres) and the block walk on
``sphere_grid_scene(23)`` (529 spheres, above the 512-sphere threshold).
Lanes from a numpy seed: random rays through the spheres and rays that
leave a sphere 1e-5 off its surface, with infinite, finite and dead
(t_max = -1) lanes. Exactly equal: the interpret kernels run in a fresh
interpreter with XLA's CPU code generation held to SSE4.2, as
tests/test_torch_sph_walk.py runs the closest-hit walk (with FMA, XLA
contracts b^2 - 4ac and moves the roots by ulps).

Against JAX's own shadow path, the elementwise any-hit of
``intersect.occluded`` (every sphere, both roots, an occluder in range
when its distance from the surface point is at most the light's), the
plain version with the exact t_max of ``intersect.shadow_t_max`` may part
only at the range boundary: at most 1e-4 of point-light lanes.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from path_tracer_torch.scene import from_numpy
from path_tracer_torch.scene.device_scene import ARRAY_FIELDS, STATIC_FIELDS

REPO = Path(__file__).resolve().parents[1]
KERNEL_RAYS = 768
RANGE_RAYS = 20000


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scenes():
    """name -> (JAX scene, port scene on the same arrays)."""
    from path_tracer_tpu.scene import load_scene
    from path_tracer_tpu.scene.procedural import sphere_grid_device_scene

    out = {}
    for name, js in (("spheres", load_scene(REPO / "tests" / "scenes"
                                            / "spheres" / "scene.isf")),
                     ("grid23", sphere_grid_device_scene(23))):
        out[name] = (js, from_numpy(
            {f: np.asarray(getattr(js, f)) for f in ARRAY_FIELDS},
            {s: getattr(js, s) for s in STATIC_FIELDS}, "cpu"))
    assert not out["spheres"][1].sph_use_blocks
    assert out["grid23"][1].sph_use_blocks
    return out


def _lanes(ts, seed, r):
    """(o, d, surface point, light distance) of r shadow-like lanes, as
    float32 numpy: half from a box around the spheres toward points among
    them, half leaving a random sphere 1e-5 off its surface toward a
    random point of the box, as a bounce's shadow rays do."""
    g = np.random.default_rng(seed)
    n = ts.num_real_spheres
    c = ts.sph_center[:n].numpy().astype(np.float64)
    rad = ts.sph_radius[:n].numpy().astype(np.float64)
    lo, hi = (c - rad[:, None]).min(0), (c + rad[:, None]).max(0)
    span = hi - lo
    half = r // 2
    p = g.uniform(lo - 0.5 * span, hi + 0.5 * span, (r, 3))
    k = g.integers(0, n, r - half)
    nrm = g.normal(size=(r - half, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    p[half:] = c[k] + rad[k, None] * nrm
    o = p.copy()
    o[half:] += 1e-5 * nrm
    light = g.uniform(lo - 0.5 * span, hi + 0.5 * span, (r, 3))
    to = light - p
    dist = np.linalg.norm(to, axis=1)
    d = to / dist[:, None]
    f32 = lambda x: np.ascontiguousarray(x, np.float32)
    return f32(o), f32(d), f32(p), f32(dist)


def _t_maxes(dist):
    """Rows of t_max: infinite, the distance to the lane's light, and
    dead lanes (every 9th) among both."""
    inf = np.full_like(dist, np.inf)
    fin = dist.copy()
    inf[::9] = -1.0
    fin[4::9] = -1.0
    return np.stack([inf, fin])


# Runs occluded_spheres_pallas in interpret mode on the arrays of argv[1]
# for each scene and row of t_max, into argv[2].
_OCC_IN_FRESH_INTERPRETER = """
import sys
from types import SimpleNamespace
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from path_tracer_tpu.ops.pallas_spheres import occluded_spheres_pallas
z = np.load(sys.argv[1])
out = {}
for name in ("spheres", "grid23"):
    sc = SimpleNamespace(
        sph_use_blocks=bool(z[name + "_blocks"]),
        sph_packed_t=jnp.asarray(z[name + "_packed"]),
        sph_blk=jnp.asarray(z[name + "_blk"]),
        sph_blkid=jnp.asarray(z[name + "_blkid"]),
        sph_sorted_t=jnp.asarray(z[name + "_sorted"]))
    out[name] = np.stack([np.asarray(occluded_spheres_pallas(
        jnp.asarray(z[name + "_o"]), jnp.asarray(z[name + "_d"]),
        jnp.asarray(tm), sc, interpret=True)) for tm in z[name + "_tm"]])
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def jax_occ(scenes, tmp_path_factory):
    """name -> (o, d, t_max [2, R], JAX's occluded [2, R])."""
    arrays, lanes = {}, {}
    for seed, (name, (_, ts)) in enumerate(scenes.items()):
        o, d, _, dist = _lanes(ts, 30 + seed, KERNEL_RAYS)
        tm = _t_maxes(dist)
        lanes[name] = (o, d, tm)
        arrays.update({
            name + "_o": o, name + "_d": d, name + "_tm": tm,
            name + "_blocks": ts.sph_use_blocks,
            name + "_packed": ts.sph_packed_t.numpy(),
            name + "_blk": ts.sph_blk.numpy(),
            name + "_blkid": ts.sph_blkid.numpy(),
            name + "_sorted": ts.sph_sorted_t.numpy()})
    tmp = tmp_path_factory.mktemp("sph_occ")
    np.savez(tmp / "in.npz", **arrays)
    env = dict(os.environ, XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                                      + " --xla_cpu_max_isa=SSE4_2").strip())
    proc = subprocess.run(
        [sys.executable, "-c", _OCC_IN_FRESH_INTERPRETER, str(tmp / "in.npz"),
         str(tmp / "out.npz")], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    out = np.load(tmp / "out.npz")
    return {name: (*lanes[name], out[name]) for name in scenes}


@pytest.mark.parametrize("name", ["spheres", "grid23"])
@pytest.mark.parametrize("row", [0, 1], ids=["inf", "finite"])
def test_sphere_any_hit_matches_jax_kernel(scenes, jax_occ, name, row):
    from path_tracer_torch.ops.cuda_spheres import (
        occluded_spheres_cuda,
        occluded_spheres_plain,
    )

    _, ts = scenes[name]
    o, d, tms, want = jax_occ[name]
    T = torch.from_numpy
    got = occluded_spheres_plain(T(o), [T(d)], [T(tms[row])], ts)[0].numpy()
    dead = tms[row] < 0.0
    assert dead.any() and not got[dead].any()
    assert 0.05 < got.mean() < 0.95, got.mean()
    np.testing.assert_array_equal(got, want[row])
    # The wrapper on CPU tensors is the plain version.
    np.testing.assert_array_equal(
        occluded_spheres_cuda(T(o), [T(d)], [T(tms[row])], ts)[0].numpy(),
        got)


def test_sphere_any_hit_sets_are_independent(scenes):
    """One call over L sets equals L calls over one set each."""
    from path_tracer_torch.ops.cuda_spheres import occluded_spheres_plain

    _, ts = scenes["grid23"]
    o, d, _, dist = (torch.from_numpy(x) for x in _lanes(ts, 40, 512))
    sets = [torch.from_numpy(x) for x in _t_maxes(dist.numpy())]
    multi = occluded_spheres_plain(o, [d, -d], sets, ts)
    assert torch.equal(multi[0], occluded_spheres_plain(o, [d], sets[:1],
                                                        ts)[0])
    assert torch.equal(multi[1], occluded_spheres_plain(o, [-d], sets[1:],
                                                        ts)[0])


@pytest.mark.parametrize("name", ["spheres", "grid23"])
def test_sphere_any_hit_matches_jax_in_range(scenes, name):
    """Against JAX's elementwise any-hit with its in_range test, on
    point-light lanes: the exact t_max and the distance test part only at
    the range boundary."""
    import jax.numpy as jnp

    from path_tracer_torch.ops.cuda_spheres import occluded_spheres_plain
    from path_tracer_torch.ops.intersect import shadow_t_max
    from path_tracer_tpu.ops.intersect import occluded

    js, ts = scenes[name]
    o, d, p, dist = _lanes(ts, 50, RANGE_RAYS)
    T = torch.from_numpy
    tm = shadow_t_max(T(o), T(d), T(p), T(dist))
    got = occluded_spheres_plain(T(o), [T(d)], [tm], ts)[0].numpy()
    want = np.asarray(occluded(jnp.asarray(o), jnp.asarray(d), js,
                               surf_pos=jnp.asarray(p),
                               max_dist=jnp.asarray(dist)))
    flips = np.nonzero(got != want)[0]
    assert 0.05 < want.mean() < 0.95
    assert len(flips) <= 1e-4 * RANGE_RAYS, [
        (int(k), float(tm[k]), float(dist[k]), bool(got[k])) for k in flips]
