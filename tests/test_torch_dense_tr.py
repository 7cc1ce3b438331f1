"""The dense transparent walk and its producer (row 3 of the kernel table,
``ops/cuda_khit.py``) against the JAX package, on the CPU.

Scene: the textured showcase at grid 48 in 256-slot blocks (600 foliage
card triangles and a billboard in the transparent partition, padded to 766
columns). Tolerances:

- The producer's plain version against ``k_nearest_tr_hits(...,
  interpret=True)`` and against JAX's jnp matrix producer, the contract of
  tests/test_partition.py:175-210: the same finite pattern, t within rtol
  1e-6 (the interpret kernel's FMA contraction), at least 99% of the
  columns equal (an ulp can swap two near-equal hits). With t_max the
  port prunes per lane on widened group boxes: nothing within t_max lost
  (tests/test_torch_walk_gate.py holds that against the ungated
  producer on grazing and far rays), nothing invented, and every entry
  within t_max equal to the unpruned one.
- The dense walk against the walk kernels' route (the port's own, plain
  versions): max <= 1e-5, mean <= 1e-7 (tests/test_partition.py:235-262;
  the dense walk recomputes u, v per column).
- Past ``PT_DENSE_TR_K=1`` the cast walk goes on: max <= 1e-2, mean <=
  1e-5, at most 1% of values beyond 1e-5 (tests/test_partition.py:212).
- The port's dense render against the JAX package's render of the same
  scene on the CPU, which takes its dense walk by default there (jit in a
  subprocess held to SSE4.2, so XLA contracts no multiply-add into an
  FMA): at most 2.5% of values outside rtol 1e-3 / atol 1e-4, the
  textured showcase's bound from the port's own camera rays
  (tests/test_torch_alpha_render.py).
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
R = 512
W, H, SPP, BOUNCES = 32, 24, 2, 3


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tex48():
    """(port scene, JAX scene) of the textured showcase at grid 48, both
    partitioned BVH scenes."""
    from path_tracer_torch.scene.showcase import showcase_device_scene
    from path_tracer_tpu.scene.showcase import (
        showcase_device_scene as jax_showcase,
    )

    port = showcase_device_scene(48, "cpu", sl_block=256, textured=True)
    js = jax_showcase(48, sl_block=256, textured=True)
    return port, js


def _foliage_rays(sc, seed):
    """R rays from around the transparent triangles' bounds through them;
    every 37th has a zero y component (the IEEE slab's inf reciprocal)."""
    g = np.random.default_rng(seed)
    v = sc.tri_v0[sc.n_tris_opaque:sc.num_real_triangles].numpy()
    lo, hi = v.min(0), v.max(0)
    o = g.uniform(lo - 0.5 * (hi - lo), hi + 0.5 * (hi - lo), (R, 3))
    d = g.uniform(lo, hi, (R, 3)) - o
    d[::37, 1] = 0.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _plain(sc, o, d, k, active=None, t_max=None):
    from path_tracer_torch.ops.cuda_khit import k_nearest_tr_hits

    act = torch.ones(R, dtype=torch.bool) if active is None else active
    ts, pos = k_nearest_tr_hits(torch.from_numpy(o), torch.from_numpy(d),
                                act, sc, k, t_max=t_max)
    return ts.numpy(), pos.numpy()


def _assert_contract(ts, pos, want_ts, want_pos):
    fin = np.isfinite(ts)
    np.testing.assert_array_equal(fin, np.isfinite(want_ts))
    assert fin.sum() > R // 2
    np.testing.assert_allclose(ts[fin], want_ts[fin], rtol=1e-6)
    assert (pos[fin] == want_pos[fin]).mean() >= 0.99
    assert (pos[~fin] == 0).all()


def test_khit_plain_matches_jax_kernel_and_producer(tex48):
    from path_tracer_tpu.models.integrator import _dense_tr_hits
    from path_tracer_tpu.ops.pallas_intersect import k_nearest_tr_hits

    port, js = tex48
    o, d = _foliage_rays(port, 3)
    k = 4
    ts, pos = _plain(port, o, d, k)
    act = jnp.ones((R,), jnp.bool_)
    kt, kp = k_nearest_tr_hits(jnp.asarray(o), jnp.asarray(d), act, js, k,
                               interpret=True)
    _assert_contract(ts, pos, np.asarray(kt), np.asarray(kp))
    jt, jp = _dense_tr_hits(js, jnp.asarray(o), jnp.asarray(d), k, act)
    _assert_contract(ts, pos, np.asarray(jt), np.asarray(jp))
    # Ascending, each t once, +inf only past the end.
    a, b = ts[:-1], ts[1:]
    assert (~np.isfinite(b) | (b > a)).all()


def test_khit_table_equals_jax_wrapper(tex48, monkeypatch):
    """The scene's khit_tris and khit_gbox, made once with the scene, equal
    what the JAX wrapper builds and hands its launch on every call (its
    gbox is padded to 128 groups with zero columns)."""
    from path_tracer_tpu.ops import pallas_intersect

    port, js = tex48
    seen = {}

    def capture(o_t, d_t, act, tmax, tris_t, gbox, k, interpret=False):
        seen.update(tris=np.asarray(tris_t), gbox=np.asarray(gbox))
        r = o_t.shape[1]
        return (jnp.full((k, r), jnp.inf, jnp.float32),
                jnp.zeros((k, r), jnp.int32))

    monkeypatch.setattr(pallas_intersect, "_khit_launch", capture)
    o = jnp.zeros((128, 3), jnp.float32)
    pallas_intersect.k_nearest_tr_hits(o, o + 1.0, jnp.ones((128,), bool),
                                       js, 2)
    g = port.khit_gbox.shape[1]
    np.testing.assert_array_equal(port.khit_tris.numpy(), seen["tris"])
    np.testing.assert_array_equal(port.khit_gbox.numpy(), seen["gbox"][:, :g])
    assert not seen["gbox"][:, g:].any() and g == port.khit_tris.shape[1] // 128


def test_khit_t_max_pruning_and_dead_lanes(tex48):
    port, _ = tex48
    o, d = _foliage_rays(port, 5)
    k = 6
    ts, _ = _plain(port, o, d, k)
    g = np.random.default_rng(11)
    t_max = g.uniform(2.0, 30.0, R).astype(np.float32)
    active = torch.from_numpy(g.uniform(size=R) > 0.2)
    tm, _ = _plain(port, o, d, k, active, torch.from_numpy(t_max))
    act = active.numpy()
    assert not np.isfinite(tm[:, ~act]).any()
    pruned = 0
    for i in np.nonzero(act)[0]:
        got = tm[:, i][np.isfinite(tm[:, i])]
        full = ts[:, i][np.isfinite(ts[:, i])]
        near = full[full <= t_max[i]]
        # Within t_max nothing is lost and the order is the unpruned one;
        # beyond it only hits of the groups the segment reaches remain.
        np.testing.assert_array_equal(got[:len(near)], near)
        assert set(got.tolist()) <= set(full.tolist())
        pruned += len(got) < len(full)
    assert pruned > 0 and np.isfinite(tm).sum() > R // 4


def test_dense_hit_columns_match_jax(tex48):
    from path_tracer_torch.models.integrator import _dense_hit_columns
    from path_tracer_tpu.models.integrator import (
        _dense_hit_columns as jax_columns,
    )

    port, js = tex48
    o, d = _foliage_rays(port, 7)
    ts, pos = _plain(port, o, d, 4)
    got = _dense_hit_columns(port, torch.from_numpy(o), torch.from_numpy(d),
                             torch.from_numpy(ts), torch.from_numpy(pos))
    want = jax_columns(js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(ts),
                       jnp.asarray(pos))
    for f in ("t", "kind", "prim", "backface"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    hit = np.isfinite(ts.reshape(-1))
    for f in ("u", "v"):
        np.testing.assert_allclose(getattr(got, f).numpy()[hit],
                                   np.asarray(getattr(want, f))[hit],
                                   rtol=1e-5, atol=1e-6, err_msg=f)


@pytest.mark.parametrize("env, route", [
    ({}, "kernel"),
    ({"PT_DENSE_TR": "1"}, "kernel"),  # the walk kernels come first
    ({"PT_NO_TRWALK_KERNEL": "1"}, "cast"),
    ({"PT_NO_TRWALK_KERNEL": "1", "PT_DENSE_TR": "1"}, "dense"),
    ({"PT_NO_TRWALK_KERNEL": "1", "PT_DENSE_TR": "1",
      "PT_NO_DENSE_TR": "1"}, "cast"),
    ({"PT_NO_TRWALK_KERNEL": "1", "PT_DENSE_TR": "1",
      "PT_DENSE_TR_MAX": "700"}, "cast"),  # 766 columns past the cap
])
def test_dense_routing_knobs(tex48, monkeypatch, env, route):
    from path_tracer_torch.models import integrator as I

    port, _ = tex48
    for name in ("PT_DENSE_TR", "PT_NO_DENSE_TR", "PT_DENSE_TR_MAX",
                 "PT_NO_TRWALK_KERNEL", "PT_DENSE_TR_K"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    got = ("kernel" if I._use_tr_kernel(port)
           else "dense" if I._use_dense_tr(port) else "cast")
    assert got == route
    t = port.tri_v0.shape[0] - port.n_tris_opaque
    assert I._dense_k(port, 601) == min(6, t)
    monkeypatch.setenv("PT_DENSE_TR_K", "3")
    assert I._dense_k(port, 2) == 2 and I._dense_k(port, 601) == 3


def _render(scene):
    from path_tracer_torch.models.integrator import IntegratorSpec
    from path_tracer_torch.models.renderer import render_pixel_sums

    return render_pixel_sums(scene, W, H, 1, SPP,
                             IntegratorSpec(bounces=BOUNCES)) / SPP


def _count_producer(monkeypatch):
    from path_tracer_torch.ops import cuda_khit

    calls = []
    plain = cuda_khit.k_nearest_tr_hits_plain

    def counted(*args):
        calls.append(args[0].shape[0])
        return plain(*args)

    monkeypatch.setattr(cuda_khit, "k_nearest_tr_hits_plain", counted)
    return calls


@pytest.fixture(scope="module")
def dense_render(tex48):
    """The port's render of the textured showcase through the dense walk
    (walk kernels off), and the number of producer calls it made."""
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("PT_NO_TRWALK_KERNEL", "1")
        mp.setenv("PT_DENSE_TR", "1")
        calls = _count_producer(mp)
        return _render(tex48[0]), len(calls)
    finally:
        mp.undo()


def test_dense_walk_matches_kernel_walks(tex48, dense_render):
    port, _ = tex48
    dense, calls = dense_render
    assert calls > 0 and np.isfinite(dense).all() and dense.std() > 0
    diff = np.abs(dense - _render(port))
    assert diff.max() <= 1e-5, diff.max()
    assert diff.mean() <= 1e-7, diff.mean()


def test_dense_residual_past_one_column(tex48, dense_render, monkeypatch):
    monkeypatch.setenv("PT_NO_TRWALK_KERNEL", "1")
    monkeypatch.setenv("PT_DENSE_TR", "1")
    monkeypatch.setenv("PT_DENSE_TR_K", "1")
    diff = np.abs(_render(tex48[0]) - dense_render[0])
    assert diff.max() <= 1e-2, diff.max()
    assert diff.mean() <= 1e-5, diff.mean()
    assert (diff > 1e-5).mean() <= 1e-2, (diff > 1e-5).mean()


_JAX_RENDER_IN_FRESH_INTERPRETER = f"""
import sys
import numpy as np
from path_tracer_tpu.models.integrator import IntegratorSpec, _use_dense_tr
from path_tracer_tpu.models.renderer import render_pixel_sums
from path_tracer_tpu.scene.showcase import showcase_device_scene

js = showcase_device_scene(48, sl_block=256, textured=True)
assert _use_dense_tr(js)
img = render_pixel_sums(js, {W}, {H}, 1, {SPP},
                        IntegratorSpec(bounces={BOUNCES},
                                       differentiable=False))
np.save(sys.argv[1], np.asarray(img) / {SPP})
"""


def test_dense_render_matches_jax(dense_render, tmp_path):
    env = dict(os.environ, XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                                      + " --xla_cpu_max_isa=SSE4_2").strip())
    for name in ("PT_DENSE_TR", "PT_NO_DENSE_TR", "PT_NO_TRWALK_KERNEL",
                 "PT_TRWALK_INTERPRET", "PT_DENSE_TR_K", "PT_DENSE_TR_MAX"):
        env.pop(name, None)
    out = tmp_path / "jax.npy"
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_RENDER_IN_FRESH_INTERPRETER, str(out)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    want = np.load(out)
    got = dense_render[0]
    outside = np.abs(got - want) > 1e-4 + 1e-3 * np.abs(want)
    assert outside.mean() <= 0.025, outside.mean()
