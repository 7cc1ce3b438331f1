"""The fused shadow path against the JAX package and against the port's
two-launch path, on the CPU.

- Lanes: ``cuda_shadow.fused_shadow_plain`` (what ``fused_shadow`` runs on
  CPU tensors, and what ``csrc/fused_shadow.cu`` is held to on the card)
  against ``pallas_shadow.fused_shadow`` in interpret mode on the textured
  showcase at grid 48 in 256-slot blocks, 3 lights x 2,048 lanes from a
  numpy seed (shadow rays from terrain points and from the foliage, 10%
  of the walk windows closed, every 9th lane dead), at step caps 8 and 1.
  The interpret kernel runs in a fresh interpreter with XLA's CPU code
  generation held to SSE4.2 (no FMA contraction), as
  tests/test_torch_sph_walk.py runs the sphere walk, on its own build of
  the scene (tests/test_torch_trwalk.py holds the tables equal to the
  port's). t_prev and still
  equal exactly; trans_eff exactly except where the Pallas product's
  butterfly order rounds apart from the port's ascending column order
  (ROADMAP Queue 3): at most 1e-3 of lanes, within relative 1e-6.
- Renders: the port with ``PT_FUSED_SHADOW=1`` against its two-launch
  route (``occluded_multi`` + ``_shadow_attenuation_multi``) at 32x24,
  2 spp, 3 bounces, at rtol 3e-7 / atol 1e-7 (the JAX package's own bound,
  tests/test_fused_shadow.py:46); with one light, and with a step cap of 1
  that sends deep lanes through the exact cast residual
  (tests/test_fused_shadow.py:78).
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
R = 2048  # lanes per light (a multiple of the Pallas 256-lane tile)
CAPS = (8, 1)
W, H, SPP, BOUNCES = 32, 24, 2, 3


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def showcase48():
    """The port's textured showcase at grid 48 in 256-slot blocks."""
    from path_tracer_torch.scene.showcase import showcase_device_scene

    sc = showcase_device_scene(48, "cpu", sl_block=256, textured=True)
    assert sc.tr_kernel_ok and sc.num_real_spheres == 48
    return sc


def _lanes(sc, seed):
    """The fused kernel's arguments as numpy arrays: R origins (half 1e-5
    above random terrain points, half 0.05-1 off random points of the
    foliage cards, on either side), their
    directions toward each light (directional first), the any-hit t_max
    (+inf, or the distance to the point light; -1 on every 9th lane), the
    walk windows (pd; -1 on 10% of the lanes), the surface points (the
    origins) and random original uvs and sphere flags."""
    g = np.random.default_rng(seed)
    half = R // 2

    def points(first, end, n):
        """n random points of triangles [first, end) and unit normals."""
        k = g.integers(first, end, n)
        v0, e1, e2 = (x.numpy()[k] for x in (sc.tri_v0, sc.tri_e1,
                                             sc.tri_e2))
        u, v = g.uniform(size=(2, n, 1))
        fold = u + v > 1.0
        u, v = np.where(fold, 1.0 - u, u), np.where(fold, 1.0 - v, v)
        nrm = np.cross(e1, e2)
        return v0 + u * e1 + v * e2, nrm / np.linalg.norm(nrm, axis=1,
                                                          keepdims=True)

    p, nrm = points(0, sc.n_tris_opaque, half)
    terrain = p + 1e-5 * nrm * np.where(nrm[:, 1:2] < 0.0, -1.0, 1.0)
    p, nrm = points(sc.n_tris_opaque, sc.num_real_triangles, R - half)
    foliage = p + nrm * g.uniform(0.05, 1.0, (R - half, 1)) * g.choice(
        [-1.0, 1.0], (R - half, 1))
    o = np.concatenate([terrain, foliage]).astype(np.float32)
    ds, tms, pds, is_pt = [], [], [], []
    for k in range(sc.num_dir_lights):
        ds.append(np.broadcast_to(-sc.dir_dir[k].numpy(), (R, 3)))
        tms.append(np.full(R, np.inf))
        is_pt.append(False)
    for k in range(sc.num_point_lights):
        to = sc.point_pos[k].numpy() - o
        dist = np.linalg.norm(to, axis=1)
        ds.append(to / dist[:, None])
        tms.append(dist)
        is_pt.append(True)
    for tm in tms:
        pds.append(np.where(g.uniform(size=R) < 0.1, -1.0, tm))
        tm[::9] = -1.0
    f32 = lambda x: np.ascontiguousarray(x, np.float32)
    return dict(s_o=o, dirs=np.stack([f32(x) for x in ds]),
                t_maxes=f32(np.stack(tms)), pds=f32(np.stack(pds)),
                is_pt=np.array(is_pt), surf_pos=o,
                orig_uv=f32(g.uniform(-1.0, 2.0, (R, 2))),
                orig_simple=g.uniform(size=R) < 0.2)


# Runs pallas_shadow.fused_shadow in interpret mode on the lanes of argv[1]
# for each step cap, into argv[2].
_FUSED_IN_FRESH_INTERPRETER = """
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from path_tracer_tpu.ops.pallas_shadow import fused_shadow
from path_tracer_tpu.scene.showcase import showcase_device_scene
js = showcase_device_scene(48, sl_block=256, textured=True)
z = np.load(sys.argv[1])
a = lambda k: jnp.asarray(z[k])
out = {}
for cap in z["caps"]:
    res = fused_shadow(js, a("s_o"), list(a("dirs")), list(a("t_maxes")),
                       list(a("pds")), tuple(bool(x) for x in z["is_pt"]),
                       a("surf_pos"), a("orig_uv"), a("orig_simple"),
                       int(cap), interpret=True)
    for name, x in zip(("trans", "t_prev", "still"), res):
        out[f"{name}_{cap}"] = np.asarray(x)
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def jax_fused(showcase48, tmp_path_factory):
    """(lanes, {cap: (trans_eff, t_prev, still)}) of JAX's fused kernel
    in interpret mode, without FMA."""
    lanes = _lanes(showcase48, 60)
    tmp = tmp_path_factory.mktemp("fused_shadow")
    np.savez(tmp / "in.npz", caps=np.array(CAPS), **lanes)
    env = dict(os.environ, XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                                      + " --xla_cpu_max_isa=SSE4_2").strip())
    env.pop("PT_TRWALK_GROUPS", None)
    proc = subprocess.run(
        [sys.executable, "-c", _FUSED_IN_FRESH_INTERPRETER,
         str(tmp / "in.npz"), str(tmp / "out.npz")], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr
    z = np.load(tmp / "out.npz")
    return lanes, {cap: tuple(z[f"{k}_{cap}"] for k in ("trans", "t_prev",
                                                        "still"))
                   for cap in CAPS}


def _plain(sc, lanes, cap):
    from path_tracer_torch.ops.cuda_shadow import fused_shadow

    T = torch.from_numpy
    return [x.numpy() for x in fused_shadow(
        sc, T(lanes["s_o"]), list(T(lanes["dirs"])),
        list(T(lanes["t_maxes"])), list(T(lanes["pds"])),
        list(lanes["is_pt"]), T(lanes["surf_pos"]), T(lanes["orig_uv"]),
        T(lanes["orig_simple"]), cap)]


@pytest.mark.parametrize("cap", CAPS)
def test_fused_plain_matches_jax_kernel(showcase48, jax_fused, cap):
    lanes, want = jax_fused
    trans, t_prev, still = _plain(showcase48, lanes, cap)
    w_trans, w_tprev, w_still = want[cap]
    np.testing.assert_array_equal(t_prev, w_tprev)
    np.testing.assert_array_equal(still, w_still)
    off = trans != w_trans
    assert off.mean() <= 1e-3, off.sum()
    np.testing.assert_allclose(trans[off], w_trans[off], rtol=1e-6)
    dead = lanes["t_maxes"] < 0.0
    assert (trans[dead] == 0.0).all() and not still[dead].any()
    blocked = (trans == 0.0) & ~dead
    partial = (trans > 0.0) & (trans < 1.0)
    assert 0.02 < blocked.mean() < 0.9 and partial.mean() > 0.01
    if cap == 1:
        assert still.any()  # directional lanes past the cap


def _render(sc, monkeypatch, fused: bool):
    from path_tracer_torch.models import integrator
    from path_tracer_torch.models.renderer import render_pixel_sums
    from path_tracer_torch.ops import cuda_shadow

    calls = []
    plain = cuda_shadow.fused_shadow_plain

    def counted(*args):
        calls.append(len(args[2]))
        return plain(*args)

    monkeypatch.setattr(cuda_shadow, "fused_shadow_plain", counted)
    if fused:
        monkeypatch.setenv("PT_FUSED_SHADOW", "1")
    else:
        monkeypatch.delenv("PT_FUSED_SHADOW", raising=False)
    assert integrator._use_fused_shadow(sc) == fused
    out = render_pixel_sums(sc, W, H, 1, SPP,
                            integrator.IntegratorSpec(bounces=BOUNCES)) / SPP
    assert bool(calls) == fused
    monkeypatch.delenv("PT_FUSED_SHADOW", raising=False)
    return out, calls


def _assert_fused_equals_two_launch(sc, monkeypatch):
    a, calls = _render(sc, monkeypatch, fused=True)
    b, _ = _render(sc, monkeypatch, fused=False)
    np.testing.assert_allclose(a, b, rtol=3e-7, atol=1e-7)
    assert np.isfinite(a).all() and a.std() > 0
    return calls


def test_fused_render_matches_two_launch(showcase48, monkeypatch):
    calls = _assert_fused_equals_two_launch(showcase48, monkeypatch)
    assert set(calls) == {3}


def test_single_light_takes_fused_route(showcase48, monkeypatch):
    """One light (the directional one) still takes the fused kernel."""
    s1 = dataclasses.replace(showcase48, point_pos=showcase48.point_pos[:0],
                             point_color=showcase48.point_color[:0])
    assert s1.num_dir_lights == 1 and s1.num_point_lights == 0
    calls = _assert_fused_equals_two_launch(s1, monkeypatch)
    assert set(calls) == {1}


def test_fused_residual_past_cap(showcase48, monkeypatch):
    """A step cap of 1 sends deep directional lanes through the exact cast
    residual after the fused kernel, as after the two launches."""
    from path_tracer_torch.ops import trwalk

    monkeypatch.setattr(trwalk, "TRWALK_K", 1)
    _assert_fused_equals_two_launch(showcase48, monkeypatch)
    lanes = _lanes(showcase48, 61)
    _, _, still = _plain(showcase48, lanes, 1)
    assert still.any()


def test_fused_route_off_by_default(showcase48, monkeypatch):
    from path_tracer_torch.models.integrator import _use_fused_shadow

    monkeypatch.delenv("PT_FUSED_SHADOW", raising=False)
    assert not _use_fused_shadow(showcase48)
    monkeypatch.setenv("PT_FUSED_SHADOW", "1")
    assert _use_fused_shadow(showcase48)
    assert not _use_fused_shadow(dataclasses.replace(showcase48,
                                                     tr_kernel_ok=False))
