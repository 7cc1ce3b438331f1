"""The wide shading rows of the port (``sl_attr``, ``tex_wide``;
``models/integrator.py`` ``_tri_attr``, ``ops/texturing.py`` ``rows=``)
against the JAX package and against the port's own per-model tables.

- the port's ``sl_attr``, ``sl_inv``, ``tex_wide``, ``wide_covered``,
  ``attr_tex_baked`` and ``sph_row_base`` equal the JAX ``DeviceScene``'s
  exactly: the textured showcase at grid 16, ``head``,
  ``alpha_transparency`` (BVH forced) and the converted glb;
- a wide texel equals the per-channel atlas fetch on every covered
  channel, and ``sample_material`` / ``sample_opacity`` /
  ``sample_normal_map`` through rows equal them through the tables bit
  for bit (also with no channel in ``tex_wide``); a JAX scene built with
  ``attr_tex_baked`` is refused;
- a small forward render through the rows equals the table route bit for
  bit on every walk route (the textured showcase), and the JAX package's
  ``differentiable=False`` render within tests/test_torch_alpha_render.py's
  bound (``alpha_transparency``, BVH forced); so does a render whose
  ``tex_wide`` budget leaves a channel out;
- ``rebake_material_rows`` after ``apply_params`` equals a fresh build
  with the new factors, and a training step (``value_and_grad``) calls
  none; ``refresh_baked_textures`` rebuilds ``tex_wide``
  as the JAX package does.
"""
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

W, H = 16, 12
WIDE_FIELDS = ("sl_attr", "sl_inv", "tex_wide")
WIDE_STATICS = ("wide_covered", "attr_tex_baked", "sph_row_base", "has_tex")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def showcase16():
    """(port scene, JAX scene): the textured showcase at grid 16, BVH
    forced, 256-slot blocks."""
    from path_tracer_torch.scene.showcase import showcase_device_scene
    from path_tracer_tpu.scene.showcase import (
        showcase_device_scene as jax_showcase,
    )

    return (showcase_device_scene(16, "cpu", use_bvh=True, sl_block=256,
                                  textured=True),
            jax_showcase(16, use_bvh=True, sl_block=256, textured=True))


@pytest.fixture(scope="module")
def glb_dir(tmp_path_factory):
    """The JAX generator's glb through the JAX converter."""
    from path_tracer_tpu.scene.gltf import convert_gltf_to_isf
    from tests.tools.gen_test_glb import write_glb

    td = tmp_path_factory.mktemp("wide_glb")
    write_glb(td / "scene.glb")
    convert_gltf_to_isf(td / "scene.glb", td / "isf")
    return td / "isf"


def _pair(name, reference_scenes, showcase16, glb_dir):
    from path_tracer_torch.scene import load_scene
    from path_tracer_tpu.scene import isf
    from path_tracer_tpu.scene.device_scene import build_device_scene

    if name == "showcase16":
        return showcase16
    if name == "glb":
        path = glb_dir / "scene.isf"
        use_bvh = None
    else:
        path = reference_scenes / name / "scene.isf"
        use_bvh = True if name == "alpha_transparency" else None
    return (load_scene(path, "cpu", use_bvh=use_bvh),
            build_device_scene(isf.load(path), path.parent, use_bvh=use_bvh))


@pytest.mark.parametrize("name", ["showcase16", "head", "alpha_transparency",
                                  "glb"])
def test_wide_tables_equal_jax(reference_scenes, showcase16, glb_dir, name):
    port, js = _pair(name, reference_scenes, showcase16, glb_dir)
    for f in WIDE_FIELDS:
        a = getattr(port, f).numpy()
        b = np.asarray(getattr(js, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for s in WIDE_STATICS:
        assert getattr(port, s) == getattr(js, s), s
    assert port.sl_attr.shape[0] == port.sph_row_base + port.sph_center.shape[0]
    if name in ("showcase16", "glb"):
        assert port.use_bvh and any(port.wide_covered)


def _random_hits(sc, n, seed):
    """(rows, model, uv, simple) of n random lanes: real triangle slots
    and sphere rows, uvs within and beyond [0, 1)."""
    g = np.random.default_rng(seed)
    slots = np.nonzero(sc.sl_map.numpy() + 1)[0]  # every slot index
    used = slots[np.abs(sc.sl_attr.numpy()[slots, 3:9]).sum(1) > 0]
    n_sph = sc.num_real_spheres
    pick = g.choice(len(used) + n_sph, n)
    packed = np.where(pick < len(used), used[np.minimum(pick, len(used) - 1)],
                      sc.sph_row_base + pick - len(used))
    rows = sc.sl_attr[torch.from_numpy(packed)]
    model = rows[:, 27].to(torch.int32)
    uv = torch.from_numpy(g.uniform(-1.5, 2.5, (n, 2)).astype(np.float32))
    simple = torch.from_numpy(pick >= len(used))
    return rows, model, uv, simple


def test_wide_texel_equals_the_channel_fetch(showcase16):
    from path_tracer_torch.ops import texturing as T

    sc, _ = showcase16
    rows, model, uv, _ = _random_hits(sc, 4096, 1)
    wide = T._wide_texels(sc, rows, uv)
    tex_ids = (sc.mat_albedo_tex, sc.mat_emissive_tex, sc.mat_opacity_tex,
               sc.mat_metalness_tex, sc.mat_roughness_tex, sc.mat_normal_tex)
    covered = [c for c in range(6) if T._wide(sc, c)]
    assert covered  # the normal and roughness maps share one size
    for c in covered:
        tid = tex_ids[c][model.long()]
        textured = tid >= 0
        assert bool(textured.any())
        want = T._fetch(sc, tid, uv)[textured]
        col = T._WIDE_COL[c]
        got = wide[textured][:, col:col + (3 if c in (0, 1, 5) else 1)]
        assert torch.equal(got, want[:, :got.shape[1]]), c


@pytest.mark.parametrize("covered", ["all", "none"])
def test_sampling_through_rows_equals_the_tables(showcase16, covered):
    """sample_material, sample_opacity and sample_normal_map from rows
    equal the table path's on every lane and field: with ``tex_wide``
    covering the scene's channels, and with none covered (every texel
    fetched through the row's texture id)."""
    from path_tracer_torch.ops import texturing as T

    sc, _ = showcase16
    assert any(sc.wide_covered)
    if covered == "none":
        sc = dataclasses.replace(sc, wide_covered=(False,) * 6)
    rows, model, uv, simple = _random_hits(sc, 4096, 2)
    got = T.sample_material(sc, model, uv, simple, rows=rows)
    want = T.sample_material(sc, model, uv, simple)
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert torch.equal(T.sample_opacity(sc, model, uv, simple, rows=rows),
                       T.sample_opacity(sc, model, uv, simple))
    for a, b in zip(T.sample_normal_map(sc, model, uv, rows=rows),
                    T.sample_normal_map(sc, model, uv)):
        assert torch.equal(a, b)


def test_a_baked_jax_scene_is_refused(showcase16):
    """A JAX scene built under its ``PT_BAKED_TEX`` knob (not ported) is not
    carried across: the port's rows read no baked atlas columns."""
    from path_tracer_torch.scene.device_scene import (
        ARRAY_FIELDS,
        STATIC_FIELDS,
        from_numpy,
    )

    _, js = showcase16
    fields = {f: np.asarray(getattr(js, f)) for f in ARRAY_FIELDS}
    statics = {f: getattr(js, f) for f in STATIC_FIELDS}
    assert not statics["attr_tex_baked"]
    assert from_numpy(fields, statics, "cpu").attr_tex_baked is False
    with pytest.raises(ValueError, match="attr_tex_baked"):
        from_numpy(fields, dict(statics, attr_tex_baked=True), "cpu")


def _render(sc, wide_rows, bounces=3, spp=1):
    """Pixel means of a forward render; without ``wide_rows`` it reads the
    per-model tables (``integrator._uses_rows`` answers False, the route
    the differentiable path takes)."""
    from path_tracer_torch.models import integrator
    from path_tracer_torch.models.renderer import render_pixel_sums

    spec = integrator.IntegratorSpec(bounces=bounces)
    if wide_rows:
        return render_pixel_sums(sc, W, H, 1, spp, spec) / spp
    with mock.patch.object(integrator, "_uses_rows",
                           lambda scene, spec: False):
        return render_pixel_sums(sc, W, H, 1, spp, spec) / spp


@pytest.mark.parametrize("route", ["kernels", "cast", "dense"])
def test_render_through_rows_equals_the_tables(showcase16, monkeypatch,
                                               route):
    """Every walk route: the walk kernels' plain versions, the cast walks
    (``PT_NO_TRWALK_KERNEL=1``), the dense walk (also ``PT_DENSE_TR=1``)."""
    from path_tracer_torch.models.integrator import IntegratorSpec, _uses_rows

    sc, _ = showcase16
    if route != "kernels":
        monkeypatch.setenv("PT_NO_TRWALK_KERNEL", "1")
    if route == "dense":
        monkeypatch.setenv("PT_DENSE_TR", "1")
    assert _uses_rows(sc, IntegratorSpec())
    assert not _uses_rows(sc, IntegratorSpec(differentiable=True))
    got = _render(sc, True)
    assert got.std() > 0
    np.testing.assert_array_equal(got, _render(sc, False))


def test_render_through_rows_matches_jax(reference_scenes):
    """``alpha_transparency`` with the BVH forced (rows, partitioned walks)
    against the JAX package's forward render of it (``differentiable=False``,
    op by op, brute force) within tests/test_torch_alpha_render.py's
    bound: at most 1% of values beyond rtol 1e-3 / atol 1e-4."""
    from path_tracer_torch.models.integrator import IntegratorSpec as Spec
    from path_tracer_torch.models.integrator import _uses_rows
    from path_tracer_torch.scene import load_scene
    from path_tracer_tpu.models.integrator import (
        IntegratorSpec,
        render_wavefront,
    )
    from path_tracer_tpu.scene import load_scene as jax_load

    path = reference_scenes / "alpha_transparency" / "scene.isf"
    sc = load_scene(path, "cpu", use_bvh=True)
    assert _uses_rows(sc, Spec())
    got = _render(sc, True, bounces=2)
    with jax.disable_jit():
        want = np.asarray(render_wavefront(
            jax_load(path), jnp.arange(W * H, dtype=jnp.int32), W, H,
            jnp.int32(1), IntegratorSpec(bounces=2, differentiable=False)))
    assert np.isfinite(want).all() and want.std() > 0
    outside = np.abs(got - want) > 1e-4 + 1e-3 * np.abs(want)
    assert outside.mean() <= 0.01


def test_small_budget_leaves_a_channel_out_and_renders_equal(monkeypatch):
    from path_tracer_torch.scene import device_scene
    from path_tracer_torch.scene.showcase import showcase_device_scene

    full = showcase_device_scene(16, "cpu", use_bvh=True, sl_block=256,
                                 textured=True)
    # Room for the first material's block (the terrain's 512^2 normal and
    # roughness maps) but not the next.
    monkeypatch.setattr(device_scene, "WIDE_TEX_MAX_MB", 13)
    small = showcase_device_scene(16, "cpu", use_bvh=True, sl_block=256,
                                  textured=True)
    left_out = [c for c in range(6)
                if full.wide_covered[c] and not small.wide_covered[c]]
    assert left_out and small.tex_wide.shape[0] < full.tex_wide.shape[0]
    got = _render(small, True)
    np.testing.assert_array_equal(got, _render(small, False))
    np.testing.assert_array_equal(got, _render(full, True))


def test_a_training_step_reads_no_rebaked_rows(showcase16, monkeypatch):
    """value_and_grad's differentiable render reads the ``mat_*`` tables
    live, so a step over material factors rebakes no ``sl_attr`` (nor the
    walk kernels' rows) and leaves the scene's tables as they were."""
    from path_tracer_torch.models.integrator import IntegratorSpec
    from path_tracer_torch.parallel import train

    def refuse(scene):
        raise AssertionError("a training step rebaked the material rows")

    sc, _ = showcase16
    monkeypatch.setattr(train, "rebake_material_rows", refuse)
    attr = sc.sl_attr.clone()
    params = {"mat_albedo_factor": sc.mat_albedo_factor * 0.5,
              "mat_roughness_factor": sc.mat_roughness_factor}
    ids = torch.arange(W * H, dtype=torch.int32)
    loss, grads = train.value_and_grad(
        params, sc, ids, torch.zeros((W * H, 3)), 1, W, H,
        IntegratorSpec(bounces=2, differentiable=True))
    assert torch.isfinite(loss) and float(loss) > 0
    assert float(grads["mat_albedo_factor"].abs().sum()) > 0
    assert torch.equal(sc.sl_attr, attr)


def test_rebake_after_apply_params_equals_a_fresh_build(showcase16):
    from path_tracer_torch.parallel.train import apply_params
    from path_tracer_torch.scene import build_scene
    from path_tracer_torch.scene.showcase import (
        default_texture_dir,
        showcase_scene,
    )

    sc, _ = showcase16  # built from showcase_scene(16) in this directory
    base = showcase_scene(16, textured=True)
    root = default_texture_dir()
    g = np.random.default_rng(5)
    m = len(base.models)
    new = {"mat_albedo_factor": g.uniform(0, 1, (m, 3)),
           "mat_emissive_factor": g.uniform(0, 1, (m, 3)),
           "mat_metalness_factor": g.uniform(0, 1, m),
           "mat_roughness_factor": g.uniform(0, 1, m)}
    new = {k: torch.from_numpy(v.astype(np.float32)) for k, v in new.items()}
    got = apply_params(sc, new)

    def material(k, mat):
        f = lambda name: new[name][k].tolist()
        return dataclasses.replace(
            mat,
            albedo=dataclasses.replace(mat.albedo,
                                       factor=tuple(f("mat_albedo_factor"))),
            emissive=dataclasses.replace(
                mat.emissive, factor=tuple(f("mat_emissive_factor"))),
            metalness=dataclasses.replace(mat.metalness,
                                          factor=f("mat_metalness_factor")),
            roughness=dataclasses.replace(mat.roughness,
                                          factor=f("mat_roughness_factor")))

    models = [dataclasses.replace(mdl, material=material(k, mdl.material))
              for k, mdl in enumerate(base.models)]
    fresh = build_scene(dataclasses.replace(base, models=models), root,
                        "cpu", use_bvh=True, sl_block=256)
    assert not torch.equal(got.sl_attr, sc.sl_attr)
    assert torch.equal(got.sl_attr, fresh.sl_attr)
    # The walk table's real columns (padding columns, never hit, take model
    # 0's factor from the live rebuild, as in the JAX package).
    real = fresh.tr_bw.abs().sum(0) > 0
    assert torch.equal(got.tr_rows[:, real], fresh.tr_rows[:, real])
    np.testing.assert_array_equal(_render(got, True), _render(fresh, True))


def test_refresh_baked_textures_rebuilds_tex_wide_as_jax(showcase16):
    from path_tracer_torch.parallel.train import refresh_baked_textures
    from path_tracer_tpu.parallel.train import (
        refresh_baked_textures as jax_refresh,
    )

    sc, js = showcase16
    g = np.random.default_rng(9)
    atlas = np.asarray(js.tex_data) * g.uniform(0.5, 1.0, (1, 3)).astype(
        np.float32)
    got = refresh_baked_textures(dataclasses.replace(
        sc, tex_data=torch.from_numpy(atlas)))
    want = jax_refresh(dataclasses.replace(js, tex_data=jnp.asarray(atlas)))
    assert not torch.equal(got.tex_wide, sc.tex_wide)
    np.testing.assert_array_equal(got.tex_wide.numpy(),
                                  np.asarray(want.tex_wide))
    assert got.tr_kernel_ok == want.tr_kernel_ok
