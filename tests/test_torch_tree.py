"""The superleaf tree walk (rows 7 and 8 of the kernel table,
``ops/cuda_bvh.py``'s tree walks) against the JAX package, on the CPU.

- Tables: ``sl_nodes6``, ``sl_meta6`` and ``sl_n_nodes`` equal the JAX
  builder's on ``head``, forced-BVH ``reflection`` and the textured
  showcase at grid 48 (a two-tree forest: opaque and transparent blocks),
  and ``sl_tris_t`` the first 9 rows of the JAX package's 16.
- Casts: the plain tree walks (what the CUDA wrappers run on CPU tensors)
  against ``closest_hit_triangles_packet`` / ``occluded_triangles_packet``
  with ``interpret=True`` on ``head``, 512 seeded rays, t_prev -1 and 0.5,
  t_max above and below the first hit and dead lanes. The JAX side runs
  in a subprocess held to SSE4.2, so that XLA contracts no multiply-add
  into an FMA; both then round every operation the same way, and every
  field of every lane is equal (in-process, the FMA moved t by up to
  5.6e-7 relative and u by 6e-5 on one lane of 512).
- The per-lane gate: the plain walks test a leaf only for the lanes whose
  own gate admits it (each tested ray's slab test of the leaf box,
  recomputed, passes; far fewer tests than the packets' lanes); a lane's
  result is the same in packets of 32 and 128 and with the rest of its
  group dead.
- The launches refuse tensors off the card before building anything.
- Routing: ``PT_BVH_KERNEL`` forces flat, flat2 or tree; tree never takes
  the flat-family kernels, and the opacity partition stands down under it;
  ``occluded_multi`` makes one tree any-hit call for its L sets, equal to
  the same call light by light.
- Renders (32x24, 2 spp, 3 bounces) under ``PT_BVH_KERNEL=tree``: the
  plain showcase at grid 48, and the textured one through the whole-scene
  walks, against the JAX package's renders of the same scenes (its jnp
  BVH walk, jit in a subprocess held to SSE4.2 so that XLA contracts no
  FMA; ``PT_NO_PARTITION=1`` there for the textured one): at most 2.5% of
  values outside rtol 1e-3 / atol 1e-4, the showcase bound from the
  port's own camera rays (tests/test_torch_render.py). Against the port's
  flat walk (Baldwin-Weber against MT): at least 99% within.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
R = 512
W, H, SPP, BOUNCES = 32, 24, 2, 3


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def head(reference_scenes):
    """(JAX scene, port scene) of ``head`` (2,434 triangles in 512-slot
    blocks), each built by its own package."""
    from path_tracer_torch.scene import load_scene
    from path_tracer_tpu.scene import load_scene as jax_load

    path = reference_scenes / "head" / "scene.isf"
    return jax_load(path), load_scene(path, "cpu")


def _scenes(name, reference_scenes):
    from path_tracer_torch.scene import load_scene
    from path_tracer_torch.scene.showcase import showcase_device_scene
    from path_tracer_tpu.scene import isf as jisf
    from path_tracer_tpu.scene.device_scene import build_device_scene
    from path_tracer_tpu.scene.showcase import (
        showcase_device_scene as jax_showcase,
    )

    if name == "showcase_tex48":
        return (jax_showcase(48, sl_block=256, textured=True),
                showcase_device_scene(48, "cpu", sl_block=256, textured=True))
    path = reference_scenes / name / "scene.isf"
    return (build_device_scene(jisf.load(path), path.parent, use_bvh=True),
            load_scene(path, "cpu", use_bvh=True))


@pytest.mark.parametrize("name", ["head", "reflection", "showcase_tex48"])
def test_tree_tables_equal_jax(reference_scenes, name):
    js, ts = _scenes(name, reference_scenes)
    for f in ("sl_nodes6", "sl_meta6"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)
    assert ts.sl_n_nodes == js.sl_n_nodes
    want = np.asarray(js.sl_tris_t)
    np.testing.assert_array_equal(ts.sl_tris_t.numpy(), want[:9])
    assert not want[9:].any()
    # The first root escapes to the next tree's root (the transparent
    # partition's), or out of a single tree.
    escape = int(ts.sl_meta6[0, 0, 0])
    forest = name == "showcase_tex48"
    assert (escape < ts.sl_n_nodes) == forest and escape > 0


def test_scene_without_triangles_gets_the_placeholder_tree():
    from path_tracer_torch.scene.procedural import sphere_grid_device_scene

    sc = sphere_grid_device_scene(5, "cpu")
    assert sc.num_real_triangles == 0 and sc.sl_n_nodes == 1
    assert sc.sl_nodes6.shape == (6, 8, 128) and sc.sl_meta6[0, 0, 0] == 1
    assert torch.isinf(sc.sl_nodes6[:, :6, 0]).all()


def _rays(js, seed):
    """Rays from around the mesh toward points inside its bounds, half of
    them from the camera; every 37th with a zero y component."""
    g = np.random.default_rng(seed)
    v = np.asarray(js.tri_v0)[: js.num_real_triangles]
    lo, hi = v.min(0), v.max(0)
    o = g.uniform(lo - 0.3 * (hi - lo), hi + 0.3 * (hi - lo), (R, 3))
    o[: R // 2] = np.asarray(js.cam_to_world)[:3, 3]
    d = g.uniform(lo, hi, (R, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[::37, 1] = 0.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


T_PREVS = (-1.0, 0.5)
T_MAX_CASES = ("above", "below", "dead")

_PACKETS_IN_FRESH_INTERPRETER = """
import sys
import numpy as np
import jax.numpy as jnp
from path_tracer_tpu.ops.pallas_bvh import (
    closest_hit_triangles_packet,
    occluded_triangles_packet,
)
from path_tracer_tpu.scene import load_scene

inp = np.load(sys.argv[1])
js = load_scene(sys.argv[3])
o, d = jnp.asarray(inp["o"]), jnp.asarray(inp["d"])
out = {}
for k, tp in enumerate(inp["t_prev"]):
    hit = closest_hit_triangles_packet(o, d, jnp.asarray(tp), js,
                                       interpret=True)
    for f in ("t", "kind", "prim", "u", "v", "backface"):
        out[f"{f}{k}"] = np.asarray(getattr(hit, f))
for k, tm in enumerate(inp["t_max"]):
    out[f"occ{k}"] = np.asarray(occluded_triangles_packet(
        o, d, jnp.asarray(tm), js, interpret=True))
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def packets(head, reference_scenes, tmp_path_factory):
    """Seeded rays on ``head`` and the Pallas packet kernels' results
    (interpret mode, in a subprocess held to SSE4.2: no FMA contraction):
    closest hit at each t_prev of T_PREVS (every 11th lane dead), any-hit
    with t_max 1.01 and 0.99 times the port's first hit (50 on a miss),
    and the first again with every 5th lane dead."""
    from path_tracer_torch.ops.cuda_bvh import closest_hit_triangles_tree

    js, ts = head
    o, d = _rays(js, 3)
    t_prev = np.stack([np.full(R, tp, np.float32) for tp in T_PREVS])
    t_prev[:, ::11] = np.inf
    t = closest_hit_triangles_tree(torch.from_numpy(o), torch.from_numpy(d),
                                   torch.full((R,), -1.0), ts).t.numpy()
    t_max = np.stack([np.where(np.isfinite(t), t * f, 50.0)
                      for f in (1.01, 0.99, 1.01)]).astype(np.float32)
    t_max[2, ::5] = -1.0
    tmp = tmp_path_factory.mktemp("packets")
    np.savez(tmp / "in.npz", o=o, d=d, t_prev=t_prev, t_max=t_max)
    env = dict(os.environ, XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                                      + " --xla_cpu_max_isa=SSE4_2").strip())
    proc = subprocess.run(
        [sys.executable, "-c", _PACKETS_IN_FRESH_INTERPRETER,
         str(tmp / "in.npz"), str(tmp / "out.npz"),
         str(reference_scenes / "head" / "scene.isf")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return o, d, t_prev, t_max, np.isfinite(t), dict(np.load(tmp / "out.npz"))


@pytest.mark.parametrize("k", range(len(T_PREVS)),
                         ids=[str(t) for t in T_PREVS])
def test_tree_closest_hit_matches_jax(head, packets, k):
    from path_tracer_torch.ops.cuda_bvh import closest_hit_triangles_tree

    _, ts = head
    o, d, t_prev, _, _, want = packets
    T = torch.from_numpy
    got = closest_hit_triangles_tree(T(o), T(d), T(t_prev[k]), ts)
    assert 0.5 < float((got.kind == 1).float().mean())
    assert not (got.kind[::11] != 0).any()
    for f in ("t", "kind", "prim", "u", "v", "backface"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      want[f"{f}{k}"], err_msg=f)


@pytest.mark.parametrize("k", range(len(T_MAX_CASES)), ids=T_MAX_CASES)
def test_tree_occluded_matches_jax(head, packets, k):
    from path_tracer_torch.ops.cuda_bvh import occluded_triangles_tree

    _, ts = head
    o, d, _, t_max, hit, want = packets
    T = torch.from_numpy
    got = occluded_triangles_tree(T(o), T(d), T(t_max[k]), ts).numpy()
    np.testing.assert_array_equal(got, want[f"occ{k}"])
    assert got[hit].all() if T_MAX_CASES[k] != "below" \
        else not got[hit].any()
    if T_MAX_CASES[k] == "dead":
        assert got[::5].all()


def _leaf_slab(ts, start, o, d):
    """(tn, tf) of rays o, d [m,3] against the boxes of the leaves whose
    blocks start at packed slots ``start`` [m], in float32 numpy with the
    walks' expressions (zero direction components inverted to 1e30), the
    box and the interval widened as the walks widen them
    (``slab.pad_boxes``, ``slab.pad_slab``)."""
    from path_tracer_torch.ops.slab import pad_boxes, pad_slab

    leaf_of = {int(b): c for c, b in enumerate(ts.sl_meta6[0, 1].numpy())
               if b > 0}
    col = np.array([leaf_of[s // ts.sl_block + 1] for s in start])
    box = pad_boxes(ts.sl_nodes6[0, :6, col]).numpy().T
    with np.errstate(divide="ignore"):
        inv = np.where(d == 0, np.float32(1e30), np.float32(1) / d)
    t0, t1 = (box[:, :3] - o) * inv, (box[:, 3:] - o) * inv
    lo, hi = np.minimum(t0, t1), np.maximum(t0, t1)
    tn, tf = pad_slab(*(torch.from_numpy(x) for x in (lo.max(1),
                                                       hi.min(1))))
    return tn.numpy(), tf.numpy()


def test_plain_tree_walk_tests_own_gate_only(head, monkeypatch):
    """The plain closest-hit and any-hit walks test a leaf for the lanes
    whose own gate admits it, not for every lane of a packet some lane
    admits: every tested ray's slab test of the leaf's widened box
    (recomputed here) passes, and the tests are far fewer than the packets' lanes on
    the leaves they visit."""
    from path_tracer_torch.ops import cuda_bvh

    js, ts = head
    o, d = _rays(js, 5)
    tested = []
    lane_visits = cuda_bvh._lane_visits

    def spy(scene, idx, lane, leaf):
        for pk, ln, start, rows in lane_visits(scene, idx, lane, leaf):
            tested.append((pk * cuda_bvh.GROUP + ln, start))
            yield pk, ln, start, rows

    monkeypatch.setattr(cuda_bvh, "_lane_visits", spy)
    T = torch.from_numpy
    for steps in (cuda_bvh.tree_walk_steps(T(o), T(d), torch.full((R,), -1.0),
                                           ts),
                  cuda_bvh.occluded_tree_steps(T(o), T(d),
                                               torch.full((R,), 50.0), ts)):
        tested.clear()
        union = 0
        while True:
            try:
                _, visit, _ = next(steps)
            except StopIteration:
                break
            union += cuda_bvh.GROUP * int(visit.sum())
        ray = torch.cat([x[0] for x in tested]).numpy()
        start = torch.cat([x[1] for x in tested]).numpy()
        tn, tf = _leaf_slab(ts, start, o[ray], d[ray])
        assert (tf >= np.maximum(tn, 0)).all()
        assert 0 < ray.size < 0.5 * union


@pytest.mark.parametrize("walk", ["closest", "occluded"])
def test_tree_walk_lanes_independent(head, walk):
    """A lane's result does not depend on the lanes it walks beside: the
    plain walks in packets of 32 (the kernel's warps) equal those in
    packets of 128 on every lane and field, and lanes walked with every
    other ray of their group dead (the group's layout unchanged) keep
    their results."""
    from path_tracer_torch.ops import cuda_bvh

    js, ts = head
    o, d = (torch.from_numpy(x) for x in _rays(js, 7))
    steps, dead = ((cuda_bvh.tree_walk_steps, float("inf"))
                   if walk == "closest"
                   else (cuda_bvh.occluded_tree_steps, -1.0))
    g = torch.full((R,), -1.0 if walk == "closest" else 50.0)
    wide = cuda_bvh.drain(steps(o, d, g, ts))
    narrow = cuda_bvh.drain(steps(o, d, g, ts, width=32))
    for a, b in zip(*(x if walk == "closest" else (x,)
                      for x in (wide, narrow))):
        assert torch.equal(a, b)
    kept = torch.tensor([5, 133, 290, 301, 450])
    alone = torch.full((R,), dead)
    alone[kept] = g[kept]
    solo = cuda_bvh.drain(steps(o, d, alone, ts, width=32))
    for a, b in zip(*(x if walk == "closest" else (x,)
                      for x in (wide, solo))):
        assert torch.equal(a[kept], b[kept])
    hits = wide[0] if walk == "closest" else wide
    assert 0.2 < float(torch.isfinite(hits).float().mean()
                       if walk == "closest" else hits.float().mean()) < 1.0


def test_occluded_multi_tree_one_call(monkeypatch):
    """Under ``PT_BVH_KERNEL=tree`` ``occluded_multi`` makes one any-hit
    call for its L sets, equal to the any-hit light by light: a point
    light's range limit, directional lights, dead lanes masked."""
    from path_tracer_torch.ops import cuda_bvh, intersect
    from path_tracer_torch.scene.showcase import showcase_device_scene

    sc = showcase_device_scene(16, "cpu", use_bvh=True, sl_block=256)
    monkeypatch.setenv("PT_BVH_KERNEL", "tree")
    assert intersect._walk_variant(sc) == "tree"
    g = np.random.default_rng(11)
    v = sc.tri_v0[: sc.num_real_triangles].numpy()
    lo, hi = v.min(0), v.max(0)
    n = 300
    T = lambda x: torch.from_numpy(np.asarray(x, np.float32))
    o = T(g.uniform(lo, hi + [0.0, 2.0, 0.0], (n, 3)))
    surf = o.clone()
    dirs, acts = [], []
    for k in range(3):
        dd = g.normal(size=(n, 3))
        dd[:, 1] = -np.abs(dd[:, 1]) if k else np.abs(dd[:, 1])
        dirs.append(T(dd / np.linalg.norm(dd, axis=1, keepdims=True)))
        acts.append(T(g.uniform(size=n)) > 0.1)
    max_dists = [T(g.uniform(0.5, 8.0, n)), None, None]
    calls = []
    multi = cuda_bvh.occluded_triangles_tree_multi
    monkeypatch.setattr(cuda_bvh, "occluded_triangles_tree_multi",
                        lambda *a: calls.append(len(a[1])) or multi(*a))
    kw = dict(surf_pos=surf, max_dists=max_dists, actives=acts)
    got = torch.stack(intersect.occluded_multi(o, dirs, sc, **kw))
    assert calls == [3]
    # The same call with the triangle any-hit taken light by light.
    monkeypatch.setattr(cuda_bvh, "occluded_triangles_tree_multi",
                        lambda o, ds, tms, scene: torch.stack([
                            multi(o, [d], [tm], scene)[0]
                            for d, tm in zip(ds, tms)]))
    want = torch.stack(intersect.occluded_multi(o, dirs, sc, **kw))
    assert torch.equal(got, want)
    assert 0 < float(got.float().mean()) < 1
    assert not got[~torch.stack(acts)].any()


@pytest.mark.parametrize("walk", ["closest", "occluded"])
def test_tree_launch_checks_operands(head, monkeypatch, walk):
    """The tree kernels' launches refuse tensors off the card before any
    build."""
    from path_tracer_torch import native

    def _no_build():
        raise AssertionError("built before its checks")

    monkeypatch.setattr(native, "kernels", _no_build)
    _, ts = head
    o = torch.zeros((4, 3))
    tables = (ts.sl_nodes6, ts.sl_meta6, ts.sl_tris_t, ts.sl_n_nodes,
              ts.sl_block)
    with pytest.raises(ValueError, match="CUDA"):
        if walk == "closest":
            native.launch_tree_closest_hit(o, o, torch.zeros(4), *tables)
        else:
            native.launch_tree_occluded(o, o[None], torch.zeros((1, 4)),
                                        *tables)


def test_bvh_kernel_knob_routes(monkeypatch):
    """``PT_BVH_KERNEL`` forces the walk; under tree the casts and any-hits
    launch the tree walks only (here their plain versions) and the
    partition stands down."""
    from path_tracer_torch.ops import cuda_bvh, intersect
    from path_tracer_torch.scene.device_scene import partitioned
    from path_tracer_torch.scene.showcase import showcase_device_scene

    sc = showcase_device_scene(16, "cpu", use_bvh=True, sl_block=256,
                               textured=True)
    assert intersect._walk_variant(sc) == "flat" and partitioned(sc)
    for forced in ("flat", "flat2", "tree"):
        monkeypatch.setenv("PT_BVH_KERNEL", forced)
        assert intersect._walk_variant(sc) == forced
        assert partitioned(sc) == (forced != "tree")
    monkeypatch.setenv("PT_BVH_KERNEL", "bogus")
    assert intersect._walk_variant(sc) == "flat"
    assert intersect._walk_variant(dataclasses.replace(sc, sl_n_blocks=0)) \
        == "tree"

    monkeypatch.setenv("PT_BVH_KERNEL", "tree")
    calls = []

    def must_not_run(*a, **k):
        raise AssertionError("a flat-family walk ran under tree")

    for name in ("closest_hit_triangles_flat", "closest_hit_triangles_flat2",
                 "occluded_triangles_flat_multi",
                 "occluded_triangles_flat2_multi"):
        monkeypatch.setattr(cuda_bvh, name, must_not_run)
    for name in ("closest_hit_triangles_tree",
                 "occluded_triangles_tree_multi"):
        real = getattr(cuda_bvh, name)
        monkeypatch.setattr(cuda_bvh, name,
                            lambda *a, _n=name, _f=real, **k:
                            calls.append(_n) or _f(*a, **k))
    from path_tracer_torch.models.integrator import IntegratorSpec
    from path_tracer_torch.models.renderer import render_pixel_sums

    # The textured scene's shadows walk the whole scene by casts; the
    # plain one's are the any-hit, every light in one call.
    plain = showcase_device_scene(16, "cpu", use_bvh=True, sl_block=256)
    for scene, want in ((sc, ["closest_hit_triangles_tree"]),
                        (plain, ["closest_hit_triangles_tree",
                                 "occluded_triangles_tree_multi"])):
        calls.clear()
        img = render_pixel_sums(scene, 8, 6, 1, 1, IntegratorSpec(bounces=1))
        assert np.isfinite(img).all() and img.std() > 0
        assert sorted(set(calls)) == want


_JAX_RENDERS_IN_FRESH_INTERPRETER = f"""
import os
import sys
import numpy as np
from path_tracer_tpu.models.integrator import IntegratorSpec
from path_tracer_tpu.models.renderer import render_pixel_sums
from path_tracer_tpu.scene.device_scene import partitioned
from path_tracer_tpu.scene.showcase import showcase_device_scene

spec = IntegratorSpec(bounces={BOUNCES}, differentiable=False)
out = {{}}
for name, textured in (("plain", False), ("textured", True)):
    js = showcase_device_scene(48, use_bvh=True, sl_block=256,
                               textured=textured)
    assert not partitioned(js)  # PT_NO_PARTITION=1: the whole-scene walks
    out[name] = np.asarray(render_pixel_sums(js, {W}, {H}, 1, {SPP},
                                             spec)) / {SPP}
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def jax_renders(tmp_path_factory):
    env = dict(os.environ, PT_NO_PARTITION="1",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_cpu_max_isa=SSE4_2").strip())
    for name in ("PT_BVH_KERNEL", "PT_DENSE_TR", "PT_TRWALK_INTERPRET"):
        env.pop(name, None)
    out = tmp_path_factory.mktemp("tree") / "jax.npz"
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_RENDERS_IN_FRESH_INTERPRETER, str(out)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    return dict(np.load(out))


def _outside(got, want):
    return np.abs(got - want) > 1e-4 + 1e-3 * np.abs(want)


def _render(scene):
    from path_tracer_torch.models.integrator import IntegratorSpec
    from path_tracer_torch.models.renderer import render_pixel_sums

    return render_pixel_sums(scene, W, H, 1, SPP,
                             IntegratorSpec(bounces=BOUNCES)) / SPP


@pytest.mark.parametrize("name", ["plain", "textured"])
def test_tree_render_matches_jax(jax_renders, monkeypatch, name):
    from path_tracer_torch.scene.device_scene import partitioned
    from path_tracer_torch.scene.showcase import showcase_device_scene

    sc = showcase_device_scene(48, "cpu", sl_block=256,
                               textured=name == "textured")
    flat = _render(sc)
    monkeypatch.setenv("PT_BVH_KERNEL", "tree")
    assert not partitioned(sc)
    got = _render(sc)
    assert np.isfinite(got).all() and got.std() > 0
    assert _outside(got, jax_renders[name]).mean() <= 0.025
    assert _outside(got, flat).mean() <= 0.01
