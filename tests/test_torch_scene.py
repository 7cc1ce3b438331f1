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
    """Non-opaque scenes are refused by the builder AND by the renderer
    (for a scene carried across from the JAX package), never rendered
    through another path."""
    from path_tracer_torch.models.integrator import IntegratorSpec
    from path_tracer_torch.models.renderer import render_pixel_sums
    from path_tracer_tpu.scene import load_scene as jax_load

    with pytest.raises(NotImplementedError, match="transparency"):
        load_scene(reference_scenes / name / "scene.isf", device="cpu")
    js = jax_load(reference_scenes / name / "scene.isf")
    carried = from_numpy({f: np.asarray(getattr(js, f)) for f in ARRAY_FIELDS},
                         {s: getattr(js, s) for s in STATIC_FIELDS}, "cpu")
    with pytest.raises(NotImplementedError, match="transparency"):
        render_pixel_sums(carried, 8, 6, 1, 1, IntegratorSpec(bounces=1))


def test_bvh_scene_is_refused():
    """>= 4096 triangles means the BVH walk: a later slice."""
    from path_tracer_torch.scene import build_scene, isf

    vert = {"position": [0, 0, 0], "normal": [0, 0, 1], "tex_coords": [0, 0]}
    tri = [vert, dict(vert, position=[1, 0, 0]), dict(vert, position=[0, 1, 0])]
    raw = {
        "models": [{"type": "Mesh", "triangles": [tri] * 4096,
                    "material": {"albedo": {"factor": [1, 1, 1]}}}],
        "camera": {"transform": np.eye(4).tolist(), "fov": 1.0, "zfar": 10.0,
                   "znear": 0.1},
        "lights": [], "background": [0, 0, 0],
    }
    with pytest.raises(NotImplementedError, match="BVH"):
        build_scene(isf.from_dict(raw), root=".", device="cpu")


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
