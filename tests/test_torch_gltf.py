"""The port's glTF → ISF converter (``scene/gltf.py``, ``path-tracer-torch
convert``) against the JAX package's, with no Pillow in the port.

- the cases of tests/test_gltf.py and tests/test_gltf_e2e.py: a ``.gltf``
  (data URIs) and a ``.glb`` round trip, the errors, the CLI (exit 2 on
  an error), the ~13.6k-triangle generated glb and its AOVs;
- each held against the JAX converter's output: the same ``scene.isf``
  bytes, the same file names, the same decoded texels;
- the port's generator (tests/tools/torch_gen_test_glb.py, PNGs by
  ``encode_png``) converts to what the JAX generator's glb converts to;
- in a fresh interpreter where ``import PIL`` fails, the port generates,
  converts and renders.
"""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from tests.test_gltf import _build_gltf

REPO = Path(__file__).resolve().parents[1]


def _assert_same_output(got: Path, want: Path) -> None:
    """Equal scene.isf bytes, file names and decoded texels."""
    names = sorted(p.name for p in want.iterdir() if p.suffix != ".glb")
    assert sorted(p.name for p in got.iterdir() if p.suffix != ".glb") \
        == names
    assert (got / "scene.isf").read_bytes() == (want / "scene.isf").read_bytes()
    for name in names:
        if name.endswith(".png"):
            a, b = Image.open(got / name), Image.open(want / name)
            assert a.mode == b.mode, name
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), name)


def _both(src: Path, tmp_path: Path) -> tuple:
    from path_tracer_torch.scene.gltf import convert_gltf_to_isf
    from path_tracer_tpu.scene.gltf import convert_gltf_to_isf as jax_convert

    convert_gltf_to_isf(src, tmp_path / "port")
    jax_convert(src, tmp_path / "jax")
    return tmp_path / "port", tmp_path / "jax"


@pytest.mark.parametrize("binary", [False, True])
def test_convert_roundtrip_equals_jax(tmp_path, binary):
    from path_tracer_torch.config import Profile, Resolution
    from path_tracer_torch.models.renderer import render
    from path_tracer_torch.scene import isf, load_scene

    port, jax_out = _both(_build_gltf(tmp_path, binary=binary), tmp_path)
    _assert_same_output(port, jax_out)
    scene = isf.load(port / "scene.isf")
    mat = scene.models[0].material
    assert mat.albedo.texture == "albedo_tex_0.png"
    assert mat.opacity.texture == "alpha_tex_0.png"
    assert mat.opacity.factor == pytest.approx(0.6)
    assert isinstance(scene.lights[0], isf.PointLight)
    assert isinstance(scene.lights[1], isf.DirectionalLight)
    assert scene.camera.transform[3][:3] == pytest.approx([0.0, 0.0, 5.0])
    img = render(load_scene(port / "scene.isf", "cpu"),
                 Profile(resolution=Resolution(8, 8), samples=1, bounces=1))
    assert img.shape == (8, 8, 3)


def test_convert_errors(tmp_path):
    from path_tracer_torch.scene.gltf import convert_gltf_to_isf

    empty = tmp_path / "empty.gltf"
    empty.write_text(json.dumps({"asset": {"version": "2.0"}}))
    with pytest.raises(ValueError, match="No scenes"):
        convert_gltf_to_isf(empty, tmp_path / "o1")
    no_cam = tmp_path / "nocam.gltf"
    no_cam.write_text(json.dumps({"asset": {"version": "2.0"}, "scene": 0,
                                  "scenes": [{"nodes": []}], "nodes": []}))
    with pytest.raises(ValueError, match="No camera"):
        convert_gltf_to_isf(no_cam, tmp_path / "o2")
    not_dir = tmp_path / "file"
    not_dir.write_text("")
    with pytest.raises(ValueError, match="is not a directory"):
        convert_gltf_to_isf(no_cam, not_dir)


def test_convert_via_cli(tmp_path, capsys):
    from path_tracer_torch import cli

    src = _build_gltf(tmp_path, binary=True)
    cli.main(["convert", str(src), str(tmp_path / "cli_out")])
    assert (tmp_path / "cli_out" / "scene.isf").exists()
    with pytest.raises(SystemExit) as exc:
        cli.main(["convert", str(tmp_path / "missing.glb"),
                  str(tmp_path / "cli_out")])
    assert exc.value.code == 2
    assert "missing.glb" in capsys.readouterr().err


@pytest.fixture(scope="module")
def generated(tmp_path_factory):
    """{multi_opacity: (port generator's glb, JAX generator's glb)}."""
    from tests.tools.gen_test_glb import write_glb
    from tests.tools.torch_gen_test_glb import write_glb as port_write_glb

    td = tmp_path_factory.mktemp("gen_glb")
    out = {}
    for multi in (False, True):
        port, jax_glb = td / f"port_{multi}.glb", td / f"jax_{multi}.glb"
        assert port_write_glb(port, multi_opacity=multi) == write_glb(
            jax_glb, multi_opacity=multi)
        out[multi] = (port, jax_glb)
    return out


@pytest.mark.parametrize("multi", [False, True])
def test_generated_glb_converts_as_jax(generated, tmp_path, multi):
    """Both converters on the JAX generator's glb, and the port's on the
    port generator's glb: one output."""
    from path_tracer_torch.scene.gltf import convert_gltf_to_isf

    port_glb, jax_glb = generated[multi]
    port, jax_out = _both(jax_glb, tmp_path)
    _assert_same_output(port, jax_out)
    convert_gltf_to_isf(port_glb, tmp_path / "port_gen")
    _assert_same_output(tmp_path / "port_gen", jax_out)
    doc = json.loads((port / "scene.isf").read_text())
    assert len(doc["models"]) == (4 if multi else 2)
    assert doc["models"][1]["material"]["opacity"]["factor"] == \
        pytest.approx(0.35)
    (light,) = doc["lights"]
    assert light["type"] == "Point" and light["size"] == 0.1
    assert light["color"][0] == pytest.approx(1200.0)


def test_aovs_on_converted(generated, tmp_path):
    """tests/test_gltf_e2e.py's AOV check on the port: a BVH scene, the
    terrain's normals mostly up."""
    from path_tracer_torch.config import Resolution
    from path_tracer_torch.models.debug_aov import compute_aovs
    from path_tracer_torch.scene import load_scene
    from path_tracer_torch.scene.gltf import convert_gltf_to_isf

    convert_gltf_to_isf(generated[False][0], tmp_path / "isf")
    scene = load_scene(tmp_path / "isf" / "scene.isf", "cpu")
    assert scene.use_bvh and scene.sl_n_blocks > 10 and not scene.all_opaque
    bufs = compute_aovs(scene, Resolution(48, 36))
    normal = np.asarray(bufs["normal"])
    assert normal[..., 1].mean() > 0.52 and normal[..., 1].max() > 0.9
    assert np.isfinite(np.asarray(bufs["albedo"])).all()


_WITHOUT_PIL = """
import sys
sys.modules["PIL"] = None  # any import of Pillow now fails
sys.path.insert(0, sys.argv[1])
sys.path.insert(0, sys.argv[1] + "/tests/tools")
from pathlib import Path
from torch_gen_test_glb import write_glb
from path_tracer_torch import cli, Profile, Resolution, load_scene, render

out = Path(sys.argv[2])
write_glb(out / "scene.glb", multi_opacity=True)
cli.main(["convert", str(out / "scene.glb"), str(out / "isf")])
scene = load_scene(out / "isf" / "scene.isf", device="cpu")
img = render(scene, Profile(resolution=Resolution(12, 8), samples=1,
                            bounces=1))
assert img.shape == (8, 12, 3) and img.std() > 0
print("RENDERED", scene.num_real_triangles, len(scene.tr_pages))
"""


def test_convert_and_render_without_pillow(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-c", _WITHOUT_PIL, str(REPO), str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "RENDERED 13706 2" in proc.stdout, proc.stdout
