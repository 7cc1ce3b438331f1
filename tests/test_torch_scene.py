"""The port's scene builder against the JAX package's, field by field.

``build_scene`` must reproduce every field the slice reads EXACTLY,
including the triangle order (the JAX builder stores triangles in its C++
SAH BVH's leaf order, which the port rebuilds from the same bvh.cpp), so
prim ids and tie-breaks agree between the packages.
"""
import numpy as np
import pytest
import torch

from path_tracer_torch.scene import from_numpy, load_scene
from path_tracer_torch.scene.device_scene import ARRAY_FIELDS, STATIC_FIELDS

SLICE_SCENES = ["cube", "spheres", "reflection", "white_furnace_direct",
                "white_furnace_indirect"]


@pytest.mark.parametrize("name", SLICE_SCENES)
def test_build_scene_equals_jax_scene(reference_scenes, name):
    from path_tracer_tpu.scene import load_scene as jax_load

    js = jax_load(reference_scenes / name / "scene.isf")
    carried = from_numpy({f: np.asarray(getattr(js, f)) for f in ARRAY_FIELDS},
                         {s: getattr(js, s) for s in STATIC_FIELDS}, "cpu")
    built = load_scene(reference_scenes / name / "scene.isf", device="cpu")
    for f in ARRAY_FIELDS:
        a, b = getattr(built, f), getattr(carried, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=f)
    for s in STATIC_FIELDS:
        assert getattr(built, s) == getattr(carried, s), s
    assert built.device == torch.device("cpu")


@pytest.mark.parametrize("name", ["head", "alpha_transparency"])
def test_later_slices_are_refused(reference_scenes, name):
    """The non-opaque reference scenes build and render; more than 512
    spheres (the sphere block walk) now render too: the 529-sphere grid
    with this scene's meshes added (two kinds of primitive; with
    ``alpha_transparency``'s, more spheres than padded triangles). The
    scene forced onto a BVH without superleaf blocks, once refused, takes
    the tree walk (the JAX package's rule), whose Moller-Trumbore renders
    what brute force renders: at least 99% of the values within rtol 1e-3
    / atol 1e-4 (the two part only where equal-t hits in two blocks
    tie)."""
    import dataclasses

    from path_tracer_torch.models.integrator import IntegratorSpec
    from path_tracer_torch.models.renderer import render_pixel_sums
    from path_tracer_torch.scene import build_scene, isf
    from path_tracer_torch.scene.procedural import sphere_grid_scene

    path = reference_scenes / name / "scene.isf"
    sc = load_scene(path, device="cpu")
    assert not sc.all_opaque
    img = render_pixel_sums(sc, 8, 6, 1, 1, IntegratorSpec(bounces=1))
    assert img.shape == (48, 3) and np.isfinite(img).all() and img.std() > 0
    grid = sphere_grid_scene(23)
    grid.models += [m for m in isf.load(path).models
                    if isinstance(m, isf.Mesh)]
    many = build_scene(grid, path.parent, "cpu")
    assert many.sph_use_blocks and many.num_real_spheres == 529
    if name == "alpha_transparency":  # sphere prims past the triangles
        assert many.tri_v0.shape[0] < many.num_real_spheres
    img = render_pixel_sums(many, 8, 6, 1, 1, IntegratorSpec(bounces=1))
    assert np.isfinite(img).all() and img.std() > 0
    tree = dataclasses.replace(sc, use_bvh=True, sl_n_blocks=0)
    got = render_pixel_sums(tree, 8, 6, 1, 1, IntegratorSpec(bounces=1))
    want = render_pixel_sums(sc, 8, 6, 1, 1, IntegratorSpec(bounces=1))
    assert (np.abs(got - want) <= 1e-4 + 1e-3 * np.abs(want)).mean() >= 0.99


def _flat_triangles_scene(n: int):
    """n copies of one lit triangle in front of the camera."""
    from path_tracer_torch.scene import isf

    vert = {"position": [0, 0, 0], "normal": [0, 0, 1], "tex_coords": [0, 0]}
    tri = [vert, dict(vert, position=[1, 0, 0]), dict(vert, position=[0, 1, 0])]
    cam = np.eye(4)
    cam[3, :3] = [0.3, 0.3, 2.0]  # column-major: translation in column 3
    raw = {
        "models": [{"type": "Mesh", "triangles": [tri] * n,
                    "material": {"albedo": {"factor": [1, 1, 1]}}}],
        "camera": {"transform": cam.tolist(), "fov": 1.0, "zfar": 10.0,
                   "znear": 0.1},
        "lights": [{"type": "Directional", "direction": [0, 0, -1],
                    "color": [1, 1, 1]}],
        "background": [0.2, 0.2, 0.2],
    }
    return isf.from_dict(raw)


def test_bvh_scene_builds_and_renders():
    """>= 4096 triangles takes the flat BVH walk (auto use_bvh), which
    builds and renders on the CPU through the plain versions."""
    from path_tracer_torch.models.integrator import IntegratorSpec
    from path_tracer_torch.models.renderer import render_pixel_sums
    from path_tracer_torch.scene import build_scene

    sc = build_scene(_flat_triangles_scene(4096), root=".", device="cpu")
    assert sc.use_bvh and sc.sl_n_blocks >= 8 and sc.sl_block == 512
    img = render_pixel_sums(sc, 8, 6, 1, 1, IntegratorSpec(bounces=1))
    assert img.shape == (48, 3) and np.isfinite(img).all() and img.std() > 0


def test_bvh_scene_is_refused(reference_scenes, monkeypatch):
    """The walk routing of a BVH scene, as the JAX package's
    ``_walk_variant``: up to FLAT_MAX_BLOCKS = 2,048 superleaf blocks the
    flat walk, 2,049 the flat2 walk (through which the scene renders);
    a BVH scene without superleaf blocks, once refused, takes the tree
    walk and renders what brute force renders (rtol 1e-3, atol 1e-4)."""
    import dataclasses

    from path_tracer_torch.models.integrator import IntegratorSpec
    from path_tracer_torch.models.renderer import render_pixel_sums
    from path_tracer_torch.ops import cuda_bvh, intersect

    sc = load_scene(reference_scenes / "cube" / "scene.isf", device="cpu",
                    use_bvh=True)
    fields = {f: getattr(sc, f).numpy() for f in ARRAY_FIELDS}
    statics = {s: getattr(sc, s) for s in STATIC_FIELDS}
    assert intersect._walk_variant(sc) == "flat"
    for n_blocks, walk in ((2048, "flat"), (2049, "flat2")):
        assert intersect._walk_variant(dataclasses.replace(
            sc, sl_n_blocks=n_blocks)) == walk
    # 2,049 block columns, all but the cube's first one empty boxes.
    n_blocks, bpad = 2049, 2176
    blkflat = np.zeros((8, bpad), np.float32)
    blkflat[:, 0] = fields["sl_blkflat"][:, 0]
    blkid = np.full((1, bpad), -1, np.int32)
    blkid[0, :n_blocks] = 0
    fields.update(sl_blkflat=blkflat, sl_blkid=blkid)
    statics["sl_n_blocks"] = n_blocks
    big = from_numpy(fields, statics, "cpu")
    calls = []
    monkeypatch.setattr(cuda_bvh, "closest_hit_triangles_flat",
                        lambda *a, **k: calls.append("flat"))
    img = render_pixel_sums(big, 8, 6, 1, 1, IntegratorSpec(bounces=1))
    want = render_pixel_sums(dataclasses.replace(sc, use_bvh=False), 8, 6,
                             1, 1, IntegratorSpec(bounces=1))
    assert not calls and img.std() > 0
    np.testing.assert_allclose(img, want, rtol=1e-3, atol=1e-4)
    tree = dataclasses.replace(sc, sl_n_blocks=0)
    assert intersect._walk_variant(tree) == "tree"
    img = render_pixel_sums(tree, 8, 6, 1, 1, IntegratorSpec(bounces=1))
    np.testing.assert_allclose(img, want, rtol=1e-3, atol=1e-4)


def test_isf_loader_matches_jax(reference_scenes):
    """The stdlib ISF loader parses every reference scene like the JAX
    package's (serde defaults included)."""
    import dataclasses

    from path_tracer_torch.scene import isf as tisf
    from path_tracer_tpu.scene import isf as jisf

    for path in sorted(reference_scenes.glob("*/scene.isf")):
        a = dataclasses.asdict(tisf.load(path))
        b = dataclasses.asdict(jisf.load(path))
        assert a == b, path.parent.name
