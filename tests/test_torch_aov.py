"""The port's AOV dump and OBJ ray logger against the JAX package's.

AOVs: one unjittered closest hit per pixel; the seven buffers against the
JAX package's ``compute_aovs`` within rtol 1e-3 / atol 1e-4 (the golden
tolerance: the two packages' camera rays differ by an ulp), on the Cornell
box carried across and on the textured ``head`` and ``alpha_transparency``
scenes (at least 99% of values within it, as for the BVH renders of
tests/test_torch_render.py, since an ulp can move a ray across an edge).
The OBJ text must equal the JAX package's for the same rays.
"""
import numpy as np
import pytest
import torch

NAMES = ("normal", "albedo", "opacity", "metalness", "roughness",
         "emissive", "ior")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _scenes(reference_scenes, name):
    """(the JAX package's scene, the port's)."""
    from path_tracer_torch.scene import load_scene
    from path_tracer_torch.scene.device_scene import (
        ARRAY_FIELDS,
        STATIC_FIELDS,
        from_numpy,
    )
    from path_tracer_tpu.scene import load_scene as jax_load_scene
    from path_tracer_tpu.scene.procedural import cornell_device_scene

    if name == "cornell":
        js = cornell_device_scene()
        return js, from_numpy(
            {f: np.asarray(getattr(js, f)) for f in ARRAY_FIELDS},
            {s: getattr(js, s) for s in STATIC_FIELDS}, "cpu")
    path = reference_scenes / name / "scene.isf"
    return jax_load_scene(path), load_scene(path, "cpu")


@pytest.mark.parametrize("name", ["cornell", "head", "alpha_transparency"])
def test_aovs_match_jax(reference_scenes, name):
    from path_tracer_torch.config import Resolution
    from path_tracer_torch.models.debug_aov import compute_aovs
    from path_tracer_tpu.config import Resolution as JaxResolution
    from path_tracer_tpu.models.debug_aov import compute_aovs as jax_aovs

    js, ps = _scenes(reference_scenes, name)
    got = compute_aovs(ps, Resolution(32, 24))
    want = jax_aovs(js, JaxResolution(32, 24))
    assert tuple(got) == NAMES and set(want) == set(NAMES)
    for k in NAMES:
        assert got[k].shape == (24, 32, 3) and got[k].dtype == np.float32
        assert np.isfinite(got[k]).all(), k
        near = np.isclose(got[k], want[k], rtol=1e-3, atol=1e-4)
        assert near.mean() >= (1.0 if name == "cornell" else 0.99), k
    assert got["albedo"].max() > 0
    if name == "cornell":  # the centre ray hits the white back wall
        np.testing.assert_allclose(got["albedo"][12, 16], 0.73, atol=1e-5)
        np.testing.assert_allclose(got["normal"][12, 16], (0.5, 0.5, 1.0),
                                   atol=1e-5)


def test_debug_render_writes_pngs(reference_scenes, tmp_path):
    """Seven PNGs, each the buffer times 255 truncated (read back with the
    port's PNG reader)."""
    from path_tracer_torch.config import Resolution
    from path_tracer_torch.models.debug_aov import compute_aovs, debug_render
    from path_tracer_torch.utils.image_io import read_png

    _, ps = _scenes(reference_scenes, "cornell")
    debug_render(ps, Resolution(8, 6), out_dir=tmp_path)
    bufs = compute_aovs(ps, Resolution(8, 6))
    for k in NAMES:
        png = read_png(tmp_path / f"{k}.png")
        want = np.clip(bufs[k] * 255.0, 0, 255).astype(np.uint8)
        np.testing.assert_array_equal(png, want)


def test_obj_logger_text_matches_jax(reference_scenes, tmp_path):
    """The same rays logged by both packages (single rays, a batch and a
    line) give the same file; dump_camera_rays' text against the JAX
    package's within the camera's ulp."""
    from path_tracer_torch.utils.obj_logger import (
        ObjRayLogger,
        dump_camera_rays,
    )
    from path_tracer_tpu.utils.obj_logger import ObjRayLogger as JaxLogger
    from path_tracer_tpu.utils.obj_logger import (
        dump_camera_rays as jax_dump,
    )

    g = np.random.default_rng(3)
    o = g.normal(size=(20, 3)).astype(np.float32)
    d = g.normal(size=(20, 3)).astype(np.float32)
    for cls, name in ((ObjRayLogger, "port.obj"), (JaxLogger, "jax.obj")):
        log = cls()
        log.ray(o[0], d[0])
        log.rays(o[1:], d[1:], length=2.5)
        log.line((0, 0, 0), (1.5, -2, 3))
        log.write(tmp_path / name)
    port, jax = ((tmp_path / n).read_text() for n in ("port.obj", "jax.obj"))
    assert port == jax and port.count("\nl ") == 21
    log = ObjRayLogger()
    log.rays(torch.from_numpy(o), torch.from_numpy(d))  # tensors too
    log.write(tmp_path / "t.obj")
    log = JaxLogger()
    log.rays(o, d)
    log.write(tmp_path / "j.obj")
    assert (tmp_path / "t.obj").read_text() == (tmp_path / "j.obj"
                                                ).read_text()

    js, ps = _scenes(reference_scenes, "cube")
    dump_camera_rays(ps, 32, 24, tmp_path / "cam.obj", stride=7)
    jax_dump(js, 32, 24, tmp_path / "jcam.obj", stride=7)

    def rows(path):
        lines = path.read_text().splitlines()
        v = np.array([[float(x) for x in ln.split()[1:]] for ln in lines
                      if ln.startswith("v ")])
        return v, [ln for ln in lines if ln.startswith("l ")]

    (pv, pl), (jv, jl) = rows(tmp_path / "cam.obj"), rows(tmp_path / "jcam.obj")
    assert pl == jl and pv.shape == jv.shape == (2 * len(range(0, 768, 7)), 3)
    np.testing.assert_allclose(pv, jv, rtol=1e-6, atol=1e-6)
