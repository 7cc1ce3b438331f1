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
    """The non-opaque reference scenes build and render, and what a later
    slice brings is still refused by name, never rendered through another
    path: the same scene marked as one of more than 512 spheres (the
    sphere block walk) fails in its casts."""
    import dataclasses

    from path_tracer_torch.models.integrator import IntegratorSpec
    from path_tracer_torch.models.renderer import render_pixel_sums

    sc = load_scene(reference_scenes / name / "scene.isf", device="cpu")
    assert not sc.all_opaque
    img = render_pixel_sums(sc, 8, 6, 1, 1, IntegratorSpec(bounces=1))
    assert img.shape == (48, 3) and np.isfinite(img).all() and img.std() > 0
    big = dataclasses.replace(sc, sph_use_blocks=True)
    with pytest.raises(NotImplementedError, match="sphere block walk"):
        render_pixel_sums(big, 8, 6, 1, 1, IntegratorSpec(bounces=1))


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


def test_bvh_scene_is_refused(reference_scenes):
    """A BVH scene of more than FLAT_MAX_BLOCKS = 2,048 superleaf blocks
    needs the flat2 walk, a later slice: its casts refuse it by name."""
    from path_tracer_torch.models.integrator import IntegratorSpec
    from path_tracer_torch.models.renderer import render_pixel_sums

    sc = load_scene(reference_scenes / "cube" / "scene.isf", device="cpu",
                    use_bvh=True)
    fields = {f: getattr(sc, f).numpy() for f in ARRAY_FIELDS}
    statics = {s: getattr(sc, s) for s in STATIC_FIELDS}
    n_blocks, bpad = 2049, 2176
    fields["sl_blkflat"] = np.zeros((8, bpad), np.float32)
    fields["sl_blkid"] = np.full((1, bpad), -1, np.int32)
    fields["sl_blkid"][0, :n_blocks] = np.arange(n_blocks)
    statics["sl_n_blocks"] = n_blocks
    big = from_numpy(fields, statics, "cpu")
    with pytest.raises(NotImplementedError, match="flat2"):
        render_pixel_sums(big, 8, 6, 1, 1, IntegratorSpec(bounces=1))


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
