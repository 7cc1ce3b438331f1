"""The port's examples and package-level API on the CPU.

- examples/torch_render_scene.py renders ``cube`` to a PNG, and
  examples/torch_inverse_rendering.py takes a few steps whose loss falls,
  both with ``--device cpu`` at a tiny size;
- ``cornell_device_scene`` equals the JAX package's arrays exactly;
- ``path_tracer_torch.Profile``, ``Resolution``, ``load_scene`` and
  ``render`` work as the JAX package's do.
"""
import importlib.util
import re
from pathlib import Path

import numpy as np
import torch

from path_tracer_torch.scene.device_scene import (
    ARRAY_FIELDS,
    STATIC_FIELDS,
    from_numpy,
)

REPO = Path(__file__).resolve().parents[1]
CUBE = REPO / "tests" / "scenes" / "cube" / "scene.isf"


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_render_scene_example_writes_a_png(tmp_path, capsys):
    from path_tracer_torch.utils.image_io import read_png

    out = tmp_path / "cube.png"
    _example("torch_render_scene").main(
        [str(CUBE), str(out), "2", "2", "--device", "cpu", "--width", "24",
         "--height", "16"])
    assert f"wrote {out}" in capsys.readouterr().out
    img = read_png(out)
    assert img.shape == (16, 24, 3) and img.std() > 0


def test_inverse_rendering_example_loss_falls(capsys):
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        _example("torch_inverse_rendering").main(
            ["4", "--device", "cpu", "--size", "8"])
    finally:
        torch.set_num_threads(n)
    out = capsys.readouterr().out
    losses = [float(x) for x in re.findall(r"loss ([0-9.]+)", out)]
    assert len(losses) == 2 and losses[1] < losses[0], out
    assert "recovered albedos" in out


def test_cornell_device_scene_equals_jax():
    from path_tracer_torch.scene.procedural import cornell_device_scene
    from path_tracer_tpu.scene.procedural import (
        cornell_device_scene as jax_cornell,
    )

    port = cornell_device_scene("cpu")
    js = jax_cornell()
    carried = from_numpy({f: np.asarray(getattr(js, f)) for f in ARRAY_FIELDS},
                         {s: getattr(js, s) for s in STATIC_FIELDS}, "cpu")
    for f in ARRAY_FIELDS:
        a, b = getattr(port, f), getattr(carried, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert torch.equal(a, b), f
    for s in STATIC_FIELDS:
        assert getattr(port, s) == getattr(carried, s), s
    assert port.num_real_triangles == 10 and port.num_real_spheres == 2


def test_package_level_api(monkeypatch):
    import path_tracer_torch as pt
    from path_tracer_torch.models import renderer
    from path_tracer_torch.scene.device_scene import TorchScene

    scene = pt.load_scene(CUBE, device="cpu")
    assert isinstance(scene, TorchScene) and scene.device.type == "cpu"
    img = pt.render(scene, pt.Profile(resolution=pt.Resolution(8, 6),
                                      samples=1, bounces=1))
    assert img.shape == (6, 8, 3) and img.dtype == np.uint8
    seen = {}
    monkeypatch.setattr(renderer, "render",
                        lambda sc, profile, **kw: seen.update(
                            profile=profile, kw=kw))
    pt.render(scene, progress=True)
    assert seen == {"profile": pt.Profile(), "kw": {"progress": True}}
