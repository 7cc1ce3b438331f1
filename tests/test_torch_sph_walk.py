"""The sphere block walk against the JAX package, on the CPU.

- Tables: ``build_scene`` equals the JAX builder on every field and static
  for ``sphere_grid_scene(23)`` (529 spheres, the smallest grid above the
  512-sphere threshold) and ``sphere_grid_scene(70)`` (4,900): the sorted
  spheres, block AABBs, block ids and slot map of the walk, and the dense
  table padded to a multiple of 512.
- Lanes: the walk's plain version (what ``closest_hit_spheres_cuda`` runs
  on CPU tensors) against ``pallas_spheres._sph_walk_launch`` in interpret
  mode on the grid-70 tables, rays as tests/test_pallas_spheres.py draws
  them, with dead lanes: t, backface and sorted slot exactly (slots may
  differ only at an exact equal-t tie of distinct spheres). The interpret
  kernel runs in a fresh interpreter with XLA's CPU code generation held
  to SSE4.2 (``--xla_cpu_max_isa``): with FMA instructions available, XLA
  contracts b^2 - 4ac and the other products into fused multiply-adds,
  with or without ``jax.disable_jit``, which moves t on about a third of
  the lanes by up to 1.1e-4 relative at 45 units from the grid. The port
  rounds every operation, as the CUDA kernel (built -fmad=false) does.
- Against the dense reference (``intersect.closest_hit_spheres``, the
  stable centered quadratic): the prim flip rate at most 1%, t within
  rtol 1e-3 where the prim agrees (tests/test_pallas_spheres.py's bound).
- A 32x24, 2-spp, 2-bounce render of the 529-sphere grid against the JAX
  package run op by op with its sphere casts through the walk, as its TPU
  path casts them (``closest_hit_spheres_pallas``, interpret mode): at
  least 97.5% of values within rtol 1e-3 / atol 1e-4 (the bound of the
  showcase from the port's own camera rays, tests/test_torch_render.py);
  against JAX's unpatched CPU render (the dense stable quadratic) the mean
  energy within 1%.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_tracer_torch.scene import from_numpy
from path_tracer_torch.scene.device_scene import ARRAY_FIELDS, STATIC_FIELDS

W, H, SPP, BOUNCES = 32, 24, 2, 2
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def grid70():
    """(JAX scene, port scene) of the 4,900-sphere grid."""
    from path_tracer_torch.scene.procedural import sphere_grid_device_scene
    from path_tracer_tpu.scene.procedural import (
        sphere_grid_device_scene as jax_grid,
    )

    return jax_grid(70), sphere_grid_device_scene(70, "cpu")


def _rays(seed, r):
    """test_pallas_spheres.py's rays: from a 90-unit box toward a 76-unit
    one around the grid."""
    g = np.random.default_rng(seed)
    o = g.uniform(-45, 45, (r, 3)).astype(np.float32)
    d = g.uniform(-38, 38, (r, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


@pytest.mark.parametrize("n", [23, 70])
def test_sphere_block_tables_equal_jax(grid70, n):
    from path_tracer_torch.scene.procedural import sphere_grid_device_scene
    from path_tracer_tpu.scene.procedural import (
        sphere_grid_device_scene as jax_grid,
    )

    js, built = grid70 if n == 70 else (jax_grid(n),
                                        sphere_grid_device_scene(n, "cpu"))
    carried = from_numpy({f: np.asarray(getattr(js, f)) for f in ARRAY_FIELDS},
                         {s: getattr(js, s) for s in STATIC_FIELDS}, "cpu")
    for f in ARRAY_FIELDS:
        a, b = getattr(built, f), getattr(carried, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=f)
    for s in STATIC_FIELDS:
        assert getattr(built, s) == getattr(carried, s), s
    assert built.sph_use_blocks and built.num_real_spheres == n * n
    assert built.sph_packed_t.shape[1] % 512 == 0
    real = built.sph_sorted_t[3] > 0.0
    assert int(real.sum()) == n * n
    assert sorted(built.sph_smap[real].tolist()) == list(range(n * n))


T_PREVS = (-1.0, 5.0)
# Seed 9 at 512 rays holds a lane where the CPU's float32 sqrt is an ulp
# off the rounded root.
WALK_RAYS = 512

# Runs _sph_walk_launch in interpret mode on the arrays of argv[1] for each
# row of t_prev, into argv[2].
_WALK_IN_FRESH_INTERPRETER = """
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from path_tracer_tpu.ops.pallas_spheres import _sph_walk_launch
z = np.load(sys.argv[1])
res = [_sph_walk_launch(jnp.asarray(z["o"]).T, jnp.asarray(z["d"]).T,
                        jnp.asarray(tp)[None], jnp.asarray(z["blk"]),
                        jnp.asarray(z["blkid"]), jnp.asarray(z["sph"]),
                        z["blk"].shape[1], interpret=True) for tp in z["tp"]]
np.savez(sys.argv[2], fout=np.stack([np.asarray(f) for f, _ in res]),
         iout=np.stack([np.asarray(i)[0] for _, i in res]))
"""


@pytest.fixture(scope="module")
def jax_walk(grid70, tmp_path_factory):
    """(o, d, t_prev [2, R], JAX's t [2, R], backface [2, R], sorted slot
    [2, R]) of the Pallas walk in interpret mode, without FMA."""
    js, _ = grid70
    o, d = _rays(9, WALK_RAYS)
    tp = np.stack([np.full(WALK_RAYS, t, np.float32) for t in T_PREVS])
    tp[:, ::11] = np.inf  # dead lanes
    tmp = tmp_path_factory.mktemp("sph_walk")
    np.savez(tmp / "in.npz", o=o, d=d, tp=tp, blk=np.asarray(js.sph_blk),
             blkid=np.asarray(js.sph_blkid), sph=np.asarray(js.sph_sorted_t))
    env = dict(os.environ, XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                                      + " --xla_cpu_max_isa=SSE4_2").strip())
    proc = subprocess.run(
        [sys.executable, "-c", _WALK_IN_FRESH_INTERPRETER, str(tmp / "in.npz"),
         str(tmp / "out.npz")], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = np.load(tmp / "out.npz")
    wt, wb = out["fout"][:, 0], out["fout"][:, 1]
    return o, d, tp, wt, wb, np.where(np.isfinite(wt), out["iout"], -1)


@pytest.mark.parametrize("k", range(len(T_PREVS)),
                         ids=[str(t) for t in T_PREVS])
def test_sphere_walk_matches_jax(grid70, jax_walk, k):
    from path_tracer_torch.ops.cuda_spheres import (
        _sph_walk_plain,
        closest_hit_spheres_cuda,
    )

    _, ts = grid70
    o, d, tps, wts, wbs, wslots = jax_walk
    tp, wt, wb, wslot = tps[k], wts[k], wbs[k], wslots[k]
    T = torch.from_numpy
    t, back, slot = (x.numpy() for x in _sph_walk_plain(T(o), T(d), T(tp),
                                                        ts))
    assert not np.isfinite(t[::11]).any() and 0.2 < np.isfinite(t).mean()
    np.testing.assert_array_equal(t, wt)
    tie = np.isfinite(t) & (slot != wslot)  # t is equal on every lane
    np.testing.assert_array_equal(slot[~tie], wslot[~tie])
    np.testing.assert_array_equal(back[~tie], wb[~tie] != 0.0)
    rec = closest_hit_spheres_cuda(T(o), T(d), T(tp), ts)  # CPU: plain walk
    np.testing.assert_array_equal(
        rec.prim.numpy(), np.where(np.isfinite(t), ts.sph_smap.numpy()[
            np.maximum(slot, 0)], 0))


def test_sphere_walk_against_dense(grid70):
    from path_tracer_torch.ops import cuda_spheres, intersect

    _, ts = grid70
    o, d = (torch.from_numpy(x) for x in _rays(10, 2048))
    for t_prev in (-1.0, 5.0):
        tp = torch.full((2048,), t_prev)
        walk = cuda_spheres.closest_hit_spheres_cuda(o, d, tp, ts)
        dense = intersect.closest_hit_spheres(o, d, tp, ts)
        flip = (walk.prim != dense.prim) | (walk.kind != dense.kind)
        assert flip.float().mean() <= 0.01
        ok = ~flip & dense.valid
        np.testing.assert_allclose(walk.t[ok].numpy(), dense.t[ok].numpy(),
                                   rtol=1e-3)
        assert dense.valid.float().mean() > 0.3


@pytest.fixture(scope="module")
def grid23_port():
    """The port's render of the 529-sphere grid (the sphere walk's plain
    version)."""
    from path_tracer_torch.models.integrator import IntegratorSpec
    from path_tracer_torch.models.renderer import render_pixel_sums
    from path_tracer_torch.scene.procedural import sphere_grid_device_scene

    sc = sphere_grid_device_scene(23, "cpu")
    assert sc.sph_use_blocks
    return render_pixel_sums(sc, W, H, 1, SPP,
                             IntegratorSpec(bounces=BOUNCES)) / SPP


def _outside(got, want):
    return np.abs(got - want) > 1e-4 + 1e-3 * np.abs(want)


def test_sphere_grid_render_matches_jax_walk(grid23_port, monkeypatch):
    """Against JAX run op by op, its sphere casts through the Pallas walk in
    interpret mode (jitted: the walk is a compiled kernel on its TPU path
    too)."""
    from path_tracer_tpu.models.integrator import (
        IntegratorSpec,
        render_wavefront,
    )
    from path_tracer_tpu.ops import intersect as jax_intersect
    from path_tracer_tpu.ops.pallas_spheres import closest_hit_spheres_pallas
    from path_tracer_tpu.scene.procedural import sphere_grid_device_scene

    calls = []

    def walk(o, d, t_prev, scene):
        calls.append(o.shape[0])
        with jax.disable_jit(False):
            return closest_hit_spheres_pallas(o, d, t_prev, scene,
                                              interpret=True)

    monkeypatch.setattr(jax_intersect, "closest_hit_spheres", walk)
    js = sphere_grid_device_scene(23)
    spec = IntegratorSpec(bounces=BOUNCES, differentiable=False)
    pix = jnp.arange(W * H, dtype=jnp.int32)
    acc = jnp.zeros((W * H, 3), jnp.float32)
    with jax.disable_jit():
        for sample in range(1, SPP + 1):
            acc = acc + render_wavefront(js, pix, W, H, jnp.int32(sample),
                                         spec)
    want = np.asarray(acc) / SPP
    assert calls and np.isfinite(grid23_port).all() and grid23_port.std() > 0
    assert _outside(grid23_port, want).mean() <= 0.025


def test_sphere_grid_render_energy_matches_jax_dense(grid23_port):
    """Against JAX's own CPU render (jitted; spheres through the dense
    stable quadratic): mean energy within 1%."""
    from path_tracer_tpu.models.integrator import IntegratorSpec
    from path_tracer_tpu.models.renderer import render_pixel_sums
    from path_tracer_tpu.scene.procedural import sphere_grid_device_scene

    spec = IntegratorSpec(bounces=BOUNCES, differentiable=False)
    want = np.asarray(render_pixel_sums(sphere_grid_device_scene(23), W, H,
                                        1, SPP, spec)) / SPP
    np.testing.assert_allclose(grid23_port.mean(), want.mean(), rtol=0.01)


def test_sphere_grid_cli_renders(tmp_path):
    """The CLI renders the grid from an ISF file written by the port."""
    from path_tracer_torch import cli
    from path_tracer_torch.scene import isf
    from path_tracer_torch.scene.procedural import sphere_grid_scene
    from path_tracer_torch.utils.image_io import load_texture_rgb

    isf.save(sphere_grid_scene(23), tmp_path / "scene.isf")
    prof = tmp_path / "p.yaml"
    prof.write_text("resolution: {width: 16, height: 12}\nsamples: 1\n"
                    "bounces: 2\n")
    out = tmp_path / "grid.png"
    cli.main(["render", str(tmp_path / "scene.isf"), "-o", str(out), "-p",
              str(prof), "-q", "--device", "cpu"])
    img = load_texture_rgb(out)
    assert img.shape == (12, 16, 3) and img.std() > 0
