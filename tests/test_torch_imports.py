"""The port stands alone: no JAX, no JAX-package module, no PyYAML and no
Pillow on its main path (a reference scene, the showcase and the textured
showcase with its textures written and read, built and rendered, a
training step on the textured showcase through ``path_tracer_torch.parallel``,
the renderer's options: samples per wavefront, compaction, a
checkpointed render through the viewer, AOVs, the OBJ logger and the
CLI's profiler trace; the wide shading rows, the JPEG and PNG decoders and
the glTF converter, the Cornell box and the package-level API), run in an
interpreter where ``import jax`` and ``import PIL`` fail; no source of the
port, its examples or its glb generator imports them; and its CUDA
wrappers never fall back to the plain versions for a tensor on the
card."""
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]

_RENDER_IN_FRESH_INTERPRETER = """
import sys
for name in ("jax", "jaxlib", "PIL"):
    sys.modules[name] = None  # any import of these now fails
import numpy as np
import path_tracer_torch
from path_tracer_torch.config import Profile, Resolution
from path_tracer_torch.models.renderer import render
from path_tracer_torch.scene import load_scene

scene = load_scene(sys.argv[1], device="cpu")
img = render(scene, Profile(resolution=Resolution(16, 12), samples=1,
                            bounces=2))
assert img.shape == (12, 16, 3) and img.dtype == np.uint8 and img.std() > 0

from path_tracer_torch.scene import build_scene
from path_tracer_torch.scene.showcase import showcase_scene

showcase = build_scene(showcase_scene(48), ".", "cpu", sl_block=256)
assert showcase.use_bvh and showcase.sl_n_blocks == 31
img = render(showcase, Profile(resolution=Resolution(16, 12), samples=1,
                               bounces=2))
assert img.shape == (12, 16, 3) and img.std() > 0

from path_tracer_torch.scene.device_scene import partitioned
from path_tracer_torch.scene.showcase import showcase_device_scene

textured = showcase_device_scene(16, "cpu", use_bvh=True, sl_block=256,
                                 textured=True)
assert partitioned(textured) and textured.tr_kernel_ok
img = render(textured, Profile(resolution=Resolution(16, 12), samples=1,
                               bounces=2))
assert img.shape == (12, 16, 3) and img.std() > 0

import torch
from path_tracer_torch.models.integrator import IntegratorSpec
from path_tracer_torch.parallel import get_params, make_train_step

step = make_train_step(16, 12, IntegratorSpec(bounces=1, differentiable=True))
new, loss = step(get_params(textured), textured,
                 torch.arange(16 * 12, dtype=torch.int32),
                 torch.zeros((16 * 12, 3)), 1)
assert torch.isfinite(loss) and torch.isfinite(new["tex_data"]).all()

# The render driver's modules: spw packing, compaction, a checkpointed
# render, the viewer, the AOV dump and the OBJ logger.
import tempfile
from pathlib import Path
from path_tracer_torch import cli
from path_tracer_torch.models.debug_aov import compute_aovs
from path_tracer_torch.models.integrator import render_wavefront
from path_tracer_torch.utils.obj_logger import dump_camera_rays
from path_tracer_torch.viewer import ProgressiveViewer

cube = load_scene(sys.argv[1], device="cpu")
img = render(cube, Profile(resolution=Resolution(16, 12), samples=2,
                           bounces=1, samples_per_wavefront=2,
                           tile_rays=128))
assert img.std() > 0
pix = torch.arange(192, dtype=torch.int32)
col = render_wavefront(cube, pix, 16, 12, 1,
                       IntegratorSpec(bounces=2, compact=True))
assert col.shape == (192, 3)
assert compute_aovs(cube, Resolution(8, 6))["albedo"].shape == (6, 8, 3)
with tempfile.TemporaryDirectory() as tmp:
    viewer = ProgressiveViewer(port=0)
    img = render(cube, Profile(resolution=Resolution(8, 6), samples=1,
                               bounces=1), viewer=viewer,
                 checkpoint_path=Path(tmp) / "r.ckpt")
    viewer.close()
    dump_camera_rays(cube, 8, 6, Path(tmp) / "cam.obj")
    with cli._trace(tmp, torch.device("cpu")):
        render(cube, Profile(resolution=Resolution(8, 6), samples=1,
                             bounces=1))
    assert (Path(tmp) / cli.TRACE_FILE).exists()

# The wide rows, the decoders, the converter's modules, the Cornell box and
# the package-level API.
from path_tracer_torch.models.integrator import IntegratorSpec, _uses_rows
assert _uses_rows(textured, IntegratorSpec())
from path_tracer_torch.scene import gltf  # noqa: F401
from path_tracer_torch.scene.procedural import cornell_device_scene
from path_tracer_torch.utils.image_io import decode_image_rgba
fixtures = Path(sys.argv[1]).parents[2] / "fixtures" / "torch_images"
for name in ("rgb_420_q50.jpg", "palette_trns.png"):
    rgba = decode_image_rgba((fixtures / name).read_bytes(), name)
    assert rgba.shape == (29, 37, 4)
from path_tracer_torch.parallel import multihost, render as prender  # noqa
from path_tracer_torch.parallel.mesh import default_mesh  # noqa: F401
img = path_tracer_torch.render(
    cornell_device_scene("cpu"),
    path_tracer_torch.Profile(resolution=Resolution(8, 6), samples=1,
                              bounces=1))
assert img.shape == (6, 8, 3)
assert path_tracer_torch.load_scene(sys.argv[1], device="cpu").use_bvh is False
bad = sorted(m for m, mod in sys.modules.items()
             if mod is not None
             and m.split(".")[0] in ("jax", "jaxlib", "path_tracer_tpu",
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
    """No module of the port (its multi-device modules included, nor
    chip_smoke.py, the port's examples, its glb generator, the worker of
    its multi-process tests, or the JPEG writer and timing tools that
    chip_smoke.py loads) names jax, the JAX package or Pillow in an
    import statement, save exactly one lazy import of Pillow inside
    ``utils/image_io.py``'s ``_pillow_u8``, which decodes the formats other
    than PNG and JPEG."""
    import ast

    files = sorted((REPO / "path_tracer_torch").rglob("*.py"))
    for module in ("parallel/train.py", "parallel/mesh.py",
                   "parallel/render.py", "parallel/multihost.py",
                   "ops/cuda_khit.py",
                   "scene/bvh_layouts.py", "models/debug_aov.py",
                   "utils/checkpoint.py", "utils/obj_logger.py",
                   "viewer/http_viewer.py", "scene/gltf.py",
                   "utils/jpeg.py", "utils/jpeg_arith.py",
                   "utils/telemetry.py"):
        assert REPO / "path_tracer_torch" / module in files
    files += [REPO / "chip_smoke.py"]
    files += [REPO / "tests" / "tools" / f"torch_{name}.py" for name in (
        "gen_test_glb", "parallel_worker", "jpeg_writer", "jpeg_timing")]
    files += sorted((REPO / "examples").glob("torch_*.py"))
    assert len(files) > 40
    lazy_pil = REPO / "path_tracer_torch" / "utils" / "image_io.py"
    pil_imports = []
    for path in files:
        tree = ast.parse(path.read_text())
        func = {}  # node -> the innermost function that holds it
        for fn in ast.walk(tree):  # breadth first: outer functions first
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for node in ast.walk(fn):
                    func[node] = fn.name
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for name in names:
                top = name.split(".")[0]
                if (top == "PIL" and path == lazy_pil
                        and func.get(node) == "_pillow_u8"):
                    pil_imports.append(name)
                    continue
                assert top not in ("jax", "jaxlib", "path_tracer_tpu",
                                   "PIL"), f"{path}: imports {name}"
    assert pil_imports == ["PIL"], pil_imports


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


def _fake_flat_scene(mode):
    from types import SimpleNamespace

    with mode:
        cuda = dict(device="cuda")
        i32 = dict(dtype=torch.int32, **cuda)
        return SimpleNamespace(
            sl_blkflat=torch.empty((8, 128), **cuda),
            sl_blkid=torch.empty((1, 128), **i32),
            sl_sbflat=torch.empty((8, 128), **cuda),
            sl_sbid=torch.empty((1, 128), **i32),
            sl_bw_t=torch.empty((16, 512), **cuda),
            sl_map=torch.empty((512,), **i32),
            sph_packed_t=torch.empty((4, 128), **cuda), sl_block=256,
            sph_row_base=512)


def _fake_sph_scene(mode):
    """The sphere block walk's tables as CUDA-device fakes."""
    from types import SimpleNamespace

    with mode:
        cuda = dict(device="cuda")
        return SimpleNamespace(
            sph_blk=torch.empty((8, 128), **cuda),
            sph_blkid=torch.empty((1, 128), dtype=torch.int32, **cuda),
            sph_sorted_t=torch.empty((4, 256), **cuda),
            sph_smap=torch.empty((256,), dtype=torch.int32, **cuda),
            sph_use_blocks=True)


def _fake_tr_scene(mode):
    """The walk kernels' tables as CUDA-device fakes."""
    from types import SimpleNamespace

    with mode:
        cuda = dict(device="cuda")
        return SimpleNamespace(
            tr_bw=torch.empty((16, 256), **cuda),
            tr_rows=torch.empty((9, 256), **cuda),
            tr_tex8=torch.empty((128, 128), dtype=torch.uint8, **cuda),
            tr_lut=torch.empty((1, 256), **cuda),
            tr_page_table=torch.empty((1, 3), dtype=torch.int32, **cuda),
            tr_grp=torch.empty((7, 128), **cuda), tr_textured=True,
            tr_prefilter=torch.empty((32, 6), **cuda))


def _fake_tree_scene(mode):
    """The superleaf tree walk's tables as CUDA-device fakes."""
    from types import SimpleNamespace

    with mode:
        cuda = dict(device="cuda")
        return SimpleNamespace(
            sl_nodes6=torch.empty((6, 8, 128), **cuda),
            sl_meta6=torch.empty((6, 2, 128), dtype=torch.int32, **cuda),
            sl_tris_t=torch.empty((9, 512), **cuda),
            sl_map=torch.empty((512,), dtype=torch.int32, **cuda),
            sl_n_nodes=3, sl_block=256)


def _fake_khit_scene(mode):
    """The dense walk's table of 300 transparent columns (three groups of
    128), as CUDA-device fakes."""
    from types import SimpleNamespace

    with mode:
        return SimpleNamespace(
            khit_tris=torch.empty((9, 384), device="cuda"),
            khit_gbox=torch.empty((6, 3), device="cuda"),
            khit_sbox=torch.empty((6, 12), device="cuda"))


def _fake_fused_scene(mode):
    """The fused shadow kernel's tables (flat and walk) as CUDA-device
    fakes, with an opaque partition of 128 block columns."""
    from types import SimpleNamespace

    return SimpleNamespace(**vars(_fake_flat_scene(mode)),
                           **vars(_fake_tr_scene(mode)), sl_cols_opaque=128,
                           sl_n_blocks_opaque=1)


def _launch_counts():
    from path_tracer_torch.utils.telemetry import counters

    return tuple(counters["launch." + k] for k in (
        "k_nearest_tr_hits", "tree_closest_hit", "tree_occluded",
        "mt_closest_hit", "sphere_closest_hit", "sph_walk",
        "flat_closest_hit", "flat_occluded", "flat2_closest_hit",
        "flat2_occluded", "alpha_walk", "trans_walk", "sph_occluded",
        "sph_occ_walk", "fused_shadow", "alpha_walk_live", "trans_walk_live",
        "fused_shadow_live", "tr_prefilter"))


def _fake_live(mode):
    """Live walk tables (rows, f32 plane) as CUDA-device fakes."""
    from path_tracer_torch.ops.trwalk import LiveTables

    with mode:
        return LiveTables(torch.empty((9, 256), device="cuda"),
                          torch.empty((128, 128), device="cuda"))


def _fake_tri(mode, n_rays: int):
    """A triangle HitRecord of n_rays lanes as CUDA-device fakes."""
    from path_tracer_torch.ops.intersect import HitRecord

    with mode:
        f32 = lambda: torch.empty((n_rays,), device="cuda")
        i32 = lambda: torch.empty((n_rays,), dtype=torch.int32, device="cuda")
        return HitRecord(t=f32(), kind=i32(), prim=i32(), u=f32(), v=f32(),
                         backface=torch.empty((n_rays,), dtype=torch.bool,
                                              device="cuda"))


@pytest.mark.parametrize("kernel", ["triangles", "spheres",
                                    "spheres_merged", "flat",
                                    "flat_spheres", "flat_occluded",
                                    "alpha_walk", "trans_walk", "flat2",
                                    "flat2_occluded", "sph_walk", "sph_occ",
                                    "sph_occ_walk", "fused_shadow",
                                    "alpha_walk_live", "trans_walk_live",
                                    "fused_shadow_live", "khit", "tree",
                                    "tree_occluded", "tr_prefilter"])
def test_cuda_wrappers_raise_instead_of_falling_back(kernel, monkeypatch):
    """Handed CUDA tensors where the kernel cannot be built or launched,
    a wrapper raises; it never returns the plain version's result."""
    from types import SimpleNamespace

    from path_tracer_torch import native
    from path_tracer_torch.ops import (
        cuda_bvh,
        cuda_intersect,
        cuda_khit,
        cuda_shadow,
        cuda_spheres,
        cuda_trwalk,
        intersect,
    )

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
    for name in ("closest_hit_triangles_flat_plain", "_flat_walk_plain",
                 "occluded_triangles_flat_plain",
                 "occluded_triangles_flat_multi_plain",
                 "closest_hit_triangles_flat2_plain", "_flat2_walk_plain",
                 "occluded_triangles_flat2_plain",
                 "occluded_triangles_flat2_multi_plain",
                 "closest_hit_triangles_tree_plain", "tree_walk_steps",
                 "occluded_triangles_tree_plain", "occluded_tree_steps",
                 "occluded_triangles_tree_multi_plain"):
        monkeypatch.setattr(cuda_bvh, name, _plain_must_not_run)
    monkeypatch.setattr(cuda_khit, "k_nearest_tr_hits_plain",
                        _plain_must_not_run)
    for name in ("closest_hit_spheres_walk_plain", "_sph_walk_plain",
                 "occluded_spheres_plain", "_occluded_dense_plain",
                 "_occluded_walk_plain", "closest_hit_spheres_merged_plain",
                 "merge_hits"):
        monkeypatch.setattr(cuda_spheres, name, _plain_must_not_run)
    for name in ("alpha_walk_plain", "trans_walk_plain",
                 "hits_transparent_bounds"):
        monkeypatch.setattr(cuda_trwalk, name, _plain_must_not_run)
    monkeypatch.setattr(cuda_shadow, "fused_shadow_plain",
                        _plain_must_not_run)
    rows = 9 if kernel == "triangles" else 4
    mode, o, d, tp, table = _fake_cuda_operands(300, rows)
    live = _fake_live(mode)
    scene = SimpleNamespace(tri_packed_t=table, sph_packed_t=table)
    wrapper = {
        "triangles": cuda_intersect.closest_hit_triangles_cuda,
        "spheres": cuda_spheres.closest_hit_spheres_cuda,
        "spheres_merged": lambda o, d, tp, sc: (
            cuda_spheres.closest_hit_spheres_cuda(
                o, d, tp, sc, tri=_fake_tri(mode, 300))),
        "flat": cuda_bvh.closest_hit_triangles_flat,
        "flat_spheres": lambda *a: cuda_bvh.closest_hit_triangles_flat(
            *a, spheres=True),
        "flat_occluded": cuda_bvh.occluded_triangles_flat,
        "alpha_walk": lambda o, d, tp, sc: cuda_trwalk.alpha_walk(
            sc, o, d, tp, torch.empty((2, 300), device="cuda"), 2),
        "trans_walk": lambda o, d, tp, sc: cuda_trwalk.trans_walk(
            sc, o, d, tp, tp > 0, o, o.narrow(1, 0, 2), tp > 1, tp >= 0, 2),
        "flat2": cuda_bvh.closest_hit_triangles_flat2,
        "flat2_occluded": lambda o, d, tp, sc: (
            cuda_bvh.occluded_triangles_flat2_multi(o, [d], [tp], sc)),
        "sph_walk": cuda_spheres.closest_hit_spheres_cuda,
        "sph_occ": lambda o, d, tp, sc: cuda_spheres.occluded_spheres_cuda(
            o, [d], [tp], sc),
        "sph_occ_walk": lambda o, d, tp, sc: (
            cuda_spheres.occluded_spheres_cuda(o, [d], [tp], sc)),
        "fused_shadow": lambda o, d, tp, sc: cuda_shadow.fused_shadow(
            sc, o, [d], [tp], [tp], [True], o, o.narrow(1, 0, 2), tp > 0, 2),
        "alpha_walk_live": lambda o, d, tp, sc: cuda_trwalk.alpha_walk(
            sc, o, d, tp, torch.empty((2, 300), device="cuda"), 2,
            live=live),
        "trans_walk_live": lambda o, d, tp, sc: cuda_trwalk.trans_walk(
            sc, o, d, tp, tp > 0, o, o.narrow(1, 0, 2), tp > 1, tp >= 0, 2,
            live=live),
        "fused_shadow_live": lambda o, d, tp, sc: cuda_shadow.fused_shadow(
            sc, o, [d], [tp], [tp], [True], o, o.narrow(1, 0, 2), tp > 0, 2,
            live=live),
        "khit": lambda o, d, tp, sc: cuda_khit.k_nearest_tr_hits(
            o, d, tp > 0, sc, 6, t_max=tp),
        "tree": cuda_bvh.closest_hit_triangles_tree,
        "tree_occluded": cuda_bvh.occluded_triangles_tree,
        "tr_prefilter": lambda o, d, tp, sc: cuda_trwalk.prefilter(
            sc, o, d, tp, tp > 0),
    }[kernel]
    if kernel.startswith("flat"):
        scene = _fake_flat_scene(mode)
    elif kernel.startswith("tree"):
        scene = _fake_tree_scene(mode)
    elif kernel == "khit":
        scene = _fake_khit_scene(mode)
    elif kernel in ("sph_walk", "sph_occ_walk"):
        scene = _fake_sph_scene(mode)
    elif kernel == "sph_occ":
        scene = SimpleNamespace(sph_packed_t=table, num_real_spheres=200,
                                sph_use_blocks=False)
    elif kernel.startswith("fused_shadow"):
        scene = _fake_fused_scene(mode)
    elif kernel.endswith(("walk", "walk_live")) or kernel == "tr_prefilter":
        scene = _fake_tr_scene(mode)

    def _no_toolkit():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(native, "_kernels", None)  # not built yet
    monkeypatch.setattr(native, "_nvcc", _no_toolkit)
    before = _launch_counts()
    with mode, pytest.raises(RuntimeError, match="nvcc"):
        wrapper(o, d, tp, scene)
    assert _launch_counts() == before


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


def test_flat_wrappers_check_operands():
    """The flat kernels' launchers raise on a wrong table, ray or set
    layout before any launch."""
    from path_tracer_torch import native

    mode, o, d, tp, _ = _fake_cuda_operands(64, 4)
    sc = _fake_flat_scene(mode)
    tables = (sc.sl_blkflat, sc.sl_blkid, sc.sl_bw_t)
    with mode:
        cuda = dict(device="cuda")
        bad_closest = [
            (o, d, tp, sc.sl_blkflat, sc.sl_blkid.float(), sc.sl_bw_t),
            (o, d, tp, torch.empty((6, 128), **cuda), sc.sl_blkid,
             sc.sl_bw_t),
            (o, d, tp, sc.sl_blkflat, sc.sl_blkid,
             torch.empty((16, 300), **cuda)),  # not whole blocks
            (o, d, torch.empty((63,), **cuda), *tables),
        ]
        ds = torch.empty((2, 64, 3), **cuda)
        tms = torch.empty((2, 64), **cuda)
        bad_occluded = [
            (o, torch.empty((2, 64, 4), **cuda), tms, *tables),
            (o, ds, torch.empty((3, 64), **cuda), *tables),
            (o, ds.transpose(0, 1), tms, *tables),
        ]
    for args in bad_closest:
        with mode, pytest.raises(ValueError):
            native.launch_flat_closest_hit(*args, block=256)
    for args in bad_occluded:
        with mode, pytest.raises(ValueError):
            native.launch_flat_occluded(*args, block=256)


def test_flat2_launchers_check_operands():
    """The flat2 kernels' launchers raise on wrong superblock tables, which
    must cover the block columns in groups of 128, before any launch."""
    from path_tracer_torch import native

    mode, o, d, tp, _ = _fake_cuda_operands(64, 4)
    sc = _fake_flat_scene(mode)
    blocks = (sc.sl_blkflat, sc.sl_blkid, sc.sl_bw_t)
    with mode:
        cuda = dict(device="cuda")
        i32 = dict(dtype=torch.int32, **cuda)
        ds = torch.empty((2, 64, 3), **cuda)
        tms = torch.empty((2, 64), **cuda)
        wide = (torch.empty((8, 384), **cuda), torch.empty((1, 384), **i32),
                sc.sl_bw_t)  # three groups of block columns
        bad_tables = [
            (torch.empty((6, 128), **cuda), sc.sl_sbid, *blocks),
            (sc.sl_sbflat, sc.sl_sbid.float(), *blocks),
            (sc.sl_sbflat, torch.empty((1, 64), **i32), *blocks),
            (torch.empty((8, 2), **cuda), torch.empty((1, 2), **i32), *wide),
        ]
        short_ds = torch.empty((2, 32, 3), **cuda)  # rays off the origins'
    for tables in bad_tables:
        with mode, pytest.raises(ValueError):
            native.launch_flat2_closest_hit(o, d, tp, *tables, block=256)
        with mode, pytest.raises(ValueError):
            native.launch_flat2_occluded(o, ds, tms, *tables, block=256)
    with mode, pytest.raises(ValueError):
        native.launch_flat2_occluded(o, short_ds, tms, sc.sl_sbflat,
                                     sc.sl_sbid, *blocks, block=256)


def test_sph_walk_launcher_checks_operands():
    """The sphere walk's launcher raises on a wrong block or sphere table
    before any launch."""
    from path_tracer_torch import native

    mode, o, d, tp, _ = _fake_cuda_operands(64, 4)
    sc = _fake_sph_scene(mode)
    with mode:
        cuda = dict(device="cuda")
        bad = [
            (torch.empty((6, 128), **cuda), sc.sph_blkid, sc.sph_sorted_t),
            (sc.sph_blk, sc.sph_blkid.float(), sc.sph_sorted_t),
            (sc.sph_blk, sc.sph_blkid, torch.empty((4, 200), **cuda)),
            (sc.sph_blk, sc.sph_blkid, torch.empty((3, 256), **cuda)),
        ]
        short_tp = torch.empty((32,), **cuda)
    for tables in bad:
        with mode, pytest.raises(ValueError):
            native.launch_sph_walk(o, d, tp, *tables, sc.sph_smap)
    with mode, pytest.raises(ValueError):
        native.launch_sph_walk(o, d, short_tp, sc.sph_blk, sc.sph_blkid,
                               sc.sph_sorted_t, sc.sph_smap)


def test_walk_launchers_check_operands():
    """The walk kernels' launchers raise on a wrong lane or table layout
    before any launch."""
    from types import SimpleNamespace

    from path_tracer_torch import native

    mode, o, d, tp, _ = _fake_cuda_operands(64, 4)
    sc = _fake_tr_scene(mode)
    with mode:
        cuda = dict(device="cuda")
        rnd = torch.empty((2, 64), **cuda)
        aux = torch.empty((8, 64), **cuda)
        bad_tables = [
            dict(tr_bw=torch.empty((16, 200), **cuda),
                 tr_rows=torch.empty((9, 200), **cuda)),  # not 128 columns
            dict(tr_tex8=torch.empty((128, 128), **cuda)),  # not uint8
            dict(tr_lut=torch.empty((1, 255), **cuda)),
            dict(tr_page_table=torch.empty((1, 3), **cuda)),  # not int32
        ]
        bad_alpha = [
            (o, d, tp.double(), rnd),
            (o, d, tp, torch.empty((3, 64), **cuda)),  # rnd rows != cap
            (o, torch.empty((64, 4), **cuda), tp, rnd),
        ]
        bad_trans = [(o, d, torch.empty((7, 64), **cuda)),
                     (o, d, torch.empty_strided((8, 64), (1, 8), **cuda))]
    for fields in bad_tables:
        bad = SimpleNamespace(**{**vars(sc), **fields})
        with mode, pytest.raises(ValueError):
            native.launch_alpha_walk(o, d, tp, rnd, bad, 2)
        with mode, pytest.raises(ValueError):
            native.launch_trans_walk(o, d, aux, bad, 2)
    for args in bad_alpha:
        with mode, pytest.raises(ValueError):
            native.launch_alpha_walk(*args, sc, 2)
    for args in bad_trans:
        with mode, pytest.raises(ValueError):
            native.launch_trans_walk(*args, sc, 2)
    # The live variant: rows and an f32 plane of the scene's table shapes.
    live = _fake_live(mode)
    with mode:
        bad_live = [
            live._replace(plane=torch.empty((128, 128), dtype=torch.uint8,
                                            device="cuda")),
            live._replace(plane=torch.empty((128, 256), device="cuda")),
            live._replace(rows=torch.empty((8, 256), device="cuda")),
        ]
    for bad in bad_live:
        with mode, pytest.raises(ValueError):
            native.launch_alpha_walk(o, d, tp, rnd, sc, 2, bad)
        with mode, pytest.raises(ValueError):
            native.launch_trans_walk(o, d, aux, sc, 2, bad)


def test_prefilter_checks_operands():
    """The segment prefilter raises on a wrong lane, mask or box layout
    before any launch: its wrapper on a wrong dtype or shape, its launcher
    also on a non-contiguous operand (the wrapper makes o, d, t_max and
    the mask contiguous, as the walks' wrappers do)."""
    from types import SimpleNamespace

    from path_tracer_torch import native
    from path_tracer_torch.ops import cuda_trwalk

    mode, o, d, tp, _ = _fake_cuda_operands(64, 4)
    sc = _fake_tr_scene(mode)
    with mode:
        cuda = dict(device="cuda")
        mask = torch.empty((64,), dtype=torch.bool, **cuda)
        bad_wrapper = [
            (sc, o.double(), d, tp, mask),
            (sc, o, torch.empty((64, 4), **cuda), tp, mask),
            (sc, o, d, torch.empty((63,), **cuda), mask),
            (sc, o, d, tp.half(), None),
            (sc, o, d, tp, torch.empty((64,), dtype=torch.uint8, **cuda)),
            (sc, o, d, tp, torch.empty((32,), dtype=torch.bool, **cuda)),
            (SimpleNamespace(tr_prefilter=torch.empty((33, 6), **cuda)), o,
             d, tp, mask),  # more boxes than the kernel stages
            (SimpleNamespace(tr_prefilter=torch.empty((32, 4), **cuda)), o,
             d, tp, mask),
            (SimpleNamespace(tr_prefilter=torch.empty(
                (32, 6), dtype=torch.float64, **cuda)), o, d, tp, mask),
        ]
        strided = torch.empty_strided((64, 3), (1, 64), **cuda)
        bad_launcher = [
            (strided, d, tp, mask, sc.tr_prefilter),
            (o, strided, tp, mask, sc.tr_prefilter),
            (o, d, torch.empty_strided((64,), (2,), **cuda), mask,
             sc.tr_prefilter),
            (o, d, tp, torch.empty_strided((64,), (2,), dtype=torch.bool,
                                           **cuda), sc.tr_prefilter),
            (o, d, tp, None,
             torch.empty_strided((32, 6), (1, 32), **cuda)),
        ]
    before = _launch_counts()
    for args in bad_wrapper:
        with mode, pytest.raises(ValueError):
            cuda_trwalk.prefilter(*args)
    for args in bad_launcher:
        with mode, pytest.raises(ValueError):
            native.launch_tr_prefilter(*args)
    with pytest.raises(ValueError):  # CPU tensors are not the kernel's
        native.launch_tr_prefilter(torch.zeros(4, 3), torch.zeros(4, 3),
                                   torch.zeros(4), None, torch.zeros(32, 6))
    assert _launch_counts() == before


def test_any_hit_launchers_check_operands():
    """The sphere any-hit and fused shadow launchers raise on a wrong set,
    table or lane layout before any launch."""
    from path_tracer_torch import native

    mode, o, _, _, table = _fake_cuda_operands(64, 4)
    sph = _fake_sph_scene(mode)
    sc = _fake_fused_scene(mode)
    flat = (sc.sl_blkflat, sc.sl_blkid, sc.sl_bw_t)
    with mode:
        cuda = dict(device="cuda")
        ds = torch.empty((2, 64, 3), **cuda)
        tms = torch.empty((2, 64), **cuda)
        aux = torch.empty((6, 64), **cuda)
        bad_sets = [
            (o, torch.empty((2, 64, 4), **cuda), tms),
            (o, ds, torch.empty((3, 64), **cuda)),
            (o, ds.transpose(0, 1), tms),
            (o, torch.empty((2, 32, 3), **cuda), tms),  # rays off origins'
        ]
        bad_fused = [
            (o, ds, tms, torch.empty((2, 63), **cuda), aux, (True, False)),
            (o, ds, tms, tms, torch.empty((8, 64), **cuda), (True, False)),
            (o, ds, tms, tms, aux, (True,)),  # one light type for 2 sets
        ]
        bad_sph = [torch.empty((3, 256), **cuda),
                   torch.empty((4, 256), dtype=torch.float64, **cuda)]
    for args in bad_sets:
        with mode, pytest.raises(ValueError):
            native.launch_sph_occluded(*args, table, 200)
        with mode, pytest.raises(ValueError):
            native.launch_sph_occ_walk(*args, sph.sph_blk, sph.sph_blkid,
                                       sph.sph_sorted_t)
        with mode, pytest.raises(ValueError):
            native.launch_fused_shadow(*args, tms, aux, (True, False), *flat,
                                       256, sc, 2)
    for bad in bad_sph:
        with mode, pytest.raises(ValueError):
            native.launch_sph_occluded(o, ds, tms, bad, 200)
    with mode, pytest.raises(ValueError):  # more spheres than columns
        native.launch_sph_occluded(o, ds, tms, table, 257)
    with mode, pytest.raises(ValueError):  # not whole blocks of 128
        native.launch_sph_occ_walk(o, ds, tms, sph.sph_blk, sph.sph_blkid,
                                   table.narrow(1, 0, 200))
    with mode:  # the prior the walk folds in: the [L,R] bool it writes
        bad_prior = [torch.empty((2, 64), device="cuda"),
                     torch.empty((1, 64), dtype=torch.bool, device="cuda")]
    for prior in bad_prior:
        with mode, pytest.raises(ValueError):
            native.launch_sph_occ_walk(o, ds, tms, sph.sph_blk,
                                       sph.sph_blkid, sph.sph_sorted_t, prior)
    for args in bad_fused:
        with mode, pytest.raises(ValueError):
            native.launch_fused_shadow(*args, *flat, 256, sc, 2)


def test_khit_and_tree_launchers_check_operands():
    """The k-nearest-hits and tree walk launchers raise on a wrong table,
    ray layout or k before any launch."""
    from path_tracer_torch import native

    mode, o, d, tp, _ = _fake_cuda_operands(64, 4)
    sc = _fake_tree_scene(mode)
    with mode:
        cuda = dict(device="cuda")
        tris = torch.empty((9, 256), **cuda)
        gbox = torch.empty((6, 2), **cuda)
        sbox = torch.empty((6, 8), **cuda)
        bad_khit = [
            (o, d, tp, torch.empty((9, 200), **cuda), gbox, sbox, 6),  # ragged
            (o, d, tp, tris, torch.empty((6, 3), **cuda), sbox, 6),  # groups
            (o, d, tp, tris, gbox, torch.empty((6, 4), **cuda), 6),  # subs
            (o, d, tp.double(), tris, gbox, sbox, 6),
            (o, d, tp, tris, gbox, sbox, 9),  # k past the register list
            (o, d, tp, tris, gbox, sbox, 0),
            # past the table resident in shared memory (4,096 columns)
            (o, d, tp, torch.empty((9, 4224), **cuda),
             torch.empty((6, 33), **cuda), torch.empty((6, 132), **cuda), 6),
        ]
        tables = (sc.sl_nodes6, sc.sl_meta6, sc.sl_tris_t)
        bad_tree = [
            ((torch.empty((6, 6, 128), **cuda), sc.sl_meta6, sc.sl_tris_t),
             3, 256),
            ((sc.sl_nodes6, sc.sl_meta6.float(), sc.sl_tris_t), 3, 256),
            ((sc.sl_nodes6, sc.sl_meta6, torch.empty((16, 512), **cuda)),
             3, 256),  # the JAX package's 16 rows
            (tables, 129, 256),  # more nodes than columns
            (tables, 3, 384),  # slots not whole blocks
        ]
        short_tp = torch.empty((63,), **cuda)
    for args in bad_khit:
        with mode, pytest.raises(ValueError):
            native.launch_khit(*args)
    for tabs, n_nodes, block in bad_tree:
        with mode, pytest.raises(ValueError):
            native.launch_tree_closest_hit(o, d, tp, *tabs, n_nodes, block)
        with mode, pytest.raises(ValueError):
            native.launch_tree_occluded(o, d, tp, *tabs, n_nodes, block)
    with mode, pytest.raises(ValueError):
        native.launch_tree_closest_hit(o, d, short_tp, *tables, 3, 256)


def test_tree_never_routes_to_the_flat_walks(monkeypatch):
    """Under ``PT_BVH_KERNEL=tree`` a cast and an any-hit on the card go to
    the tree kernels (which raise here, with no toolkit) and never to the
    flat or flat2 kernels."""
    from types import SimpleNamespace

    from path_tracer_torch import native
    from path_tracer_torch.ops import cuda_bvh, intersect

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the card tests cover it")

    def _flat_must_not_run(*args, **kw):
        raise AssertionError("a flat-family walk ran under tree")

    for name in ("closest_hit_triangles_flat", "closest_hit_triangles_flat2",
                 "occluded_triangles_flat_multi",
                 "occluded_triangles_flat2_multi"):
        monkeypatch.setattr(cuda_bvh, name, _flat_must_not_run)

    def _no_toolkit():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(native, "_kernels", None)
    monkeypatch.setattr(native, "_nvcc", _no_toolkit)
    monkeypatch.setenv("PT_BVH_KERNEL", "tree")
    mode, o, d, tp, _ = _fake_cuda_operands(300, 4)
    scene = SimpleNamespace(**vars(_fake_tree_scene(mode)),
                            num_real_triangles=1000, num_real_spheres=0,
                            use_bvh=True, sph_use_blocks=False,
                            sl_n_blocks=2)
    assert intersect._walk_variant(scene) == "tree"
    before = _launch_counts()
    with mode, pytest.raises(RuntimeError, match="nvcc"):
        intersect.closest_hit(o, d, tp, scene)
    with mode, pytest.raises(RuntimeError, match="nvcc"):
        intersect.occluded_multi(o, [d, d], scene)
    assert _launch_counts() == before
