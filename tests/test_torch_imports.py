"""The port stands alone: no JAX, no JAX-package module, no PyYAML and no
Pillow on its main path, and its CUDA wrappers never fall back to the plain
versions for a tensor on the card."""
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]

_RENDER_IN_FRESH_INTERPRETER = """
import sys
import numpy as np
import path_tracer_torch
from path_tracer_torch.config import Profile, Resolution
from path_tracer_torch.models.renderer import render
from path_tracer_torch.scene import load_scene

scene = load_scene(sys.argv[1], device="cpu")
img = render(scene, Profile(resolution=Resolution(16, 12), samples=1,
                            bounces=2))
assert img.shape == (12, 16, 3) and img.dtype == np.uint8 and img.std() > 0
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "path_tracer_tpu",
                                    "yaml", "PIL"))
print("LOADED:" + ",".join(bad))
"""


def test_port_renders_without_jax_yaml_or_pil():
    proc = subprocess.run(
        [sys.executable, "-c", _RENDER_IN_FRESH_INTERPRETER,
         str(REPO / "tests" / "scenes" / "cube" / "scene.isf")],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "LOADED:\n" in proc.stdout, proc.stdout


def test_port_sources_import_no_jax():
    """No module of the port (nor chip_smoke.py) names jax or the JAX
    package in an import statement."""
    import ast

    files = sorted((REPO / "path_tracer_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib",
                                                  "path_tracer_tpu"), \
                    f"{path}: imports {name}"


def _fake_cuda_operands(n_rays: int, table_rows: int):
    """CUDA-device tensors that need no card (FakeTensorMode)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    mode = FakeTensorMode()
    with mode:
        o = torch.empty((n_rays, 3), device="cuda")
        d = torch.empty((n_rays, 3), device="cuda")
        tp = torch.empty((n_rays,), device="cuda")
        table = torch.empty((table_rows, 256), device="cuda")
    return mode, o, d, tp, table


@pytest.mark.parametrize("kernel", ["triangles", "spheres"])
def test_cuda_wrappers_raise_instead_of_falling_back(kernel, monkeypatch):
    """Handed CUDA tensors where the kernel cannot be built or launched,
    a wrapper raises; it never returns the plain version's result."""
    from types import SimpleNamespace

    from path_tracer_torch import native
    from path_tracer_torch.ops import cuda_intersect, cuda_spheres, intersect

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the card tests cover it")
    # Make the plain versions loud if anything reached them.
    def _plain_must_not_run(*args, **kw):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(cuda_intersect, "closest_hit_triangles",
                        _plain_must_not_run)
    monkeypatch.setattr(cuda_spheres, "closest_hit_spheres",
                        _plain_must_not_run)
    monkeypatch.setattr(intersect, "closest_hit_triangles", _plain_must_not_run)
    rows = 9 if kernel == "triangles" else 4
    mode, o, d, tp, table = _fake_cuda_operands(300, rows)
    scene = SimpleNamespace(tri_packed_t=table, sph_packed_t=table)
    wrapper = (cuda_intersect.closest_hit_triangles_cuda
               if kernel == "triangles"
               else cuda_spheres.closest_hit_spheres_cuda)

    def _no_toolkit():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(native, "_kernels", None)  # not built yet
    monkeypatch.setattr(native, "_nvcc", _no_toolkit)
    before = (cuda_intersect.launches, cuda_spheres.launches)
    with mode, pytest.raises(RuntimeError, match="nvcc"):
        wrapper(o, d, tp, scene)
    assert (cuda_intersect.launches, cuda_spheres.launches) == before


def test_cuda_wrapper_checks_operands():
    """Wrong dtype, shape, device or layout raise before any launch."""
    from path_tracer_torch import native

    mode, o, d, tp, table = _fake_cuda_operands(64, 9)
    with mode:
        cuda = dict(device="cuda")
        bad = [
            (torch.empty((64, 3), dtype=torch.float64, **cuda), d, tp, table),
            (o, torch.empty((32, 3), **cuda), tp, table),  # ray count
            (o, d, tp, torch.empty((4, 256), **cuda)),  # table rows
            (o, d, tp, torch.empty_strided((9, 256), (1, 9), **cuda)),  # layout
        ]
    for args in bad:
        with mode, pytest.raises(ValueError):
            native.launch_closest_hit("ptt_mt_closest_hit", *args,
                                      table_rows=9, out_rows=4)
    with pytest.raises(ValueError):  # CPU tensors are not the kernel's
        native.launch_closest_hit(
            "ptt_mt_closest_hit", torch.zeros(4, 3), torch.zeros(4, 3),
            torch.zeros(4), torch.zeros(9, 256), table_rows=9, out_rows=4)
