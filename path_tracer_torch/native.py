"""Native builds at first use: the C++ BVH builder and the CUDA kernels.

Both are plain-C-ABI shared libraries loaded with ``ctypes`` and cached in
``build/path_tracer_torch/`` (git-ignored) under a hash of their sources and
flags, so a fresh checkout builds them on first call and later processes
reuse the files.

- ``build_bvh`` compiles ``csrc/bvh.cpp`` (a byte-for-byte copy of the
  JAX package's ``native/bvh.cpp``) with the same ``g++`` flags as the
  JAX package's builder and returns the whole flattened binned-SAH BVH
  (``Bvh``): the leaf-4 tree gives the order the scene builder stores
  every triangle array in, the superleaf tree (one leaf per block of
  ``sl_block`` triangles) gives the flat walk's block tables.
- ``kernels`` compiles ``csrc/*.cu`` with ``nvcc`` for ``sm_90a``, one
  ``nvcc`` process per source, all started together, then links them. No
  ``--use_fast_math``: the 1e-6 intersection cutoffs and the sphere table's
  1e30 padding rely on IEEE division, sqrt and denormals. ``-fmad=false``
  keeps every multiply and add separately rounded, as the plain PyTorch
  versions are: contracting them into FMAs changes the sphere quadratic's
  rounding for rays that start 1e-5 off a surface, and with it which of
  them re-hit their own sphere. (XLA's CPU jit contracts that way and, on
  the ``spheres`` oracle case, renders 3.35% more energy than the scalar
  oracle against a 4% band; the uncontracted port renders 0.18% more.)
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

_PKG = Path(__file__).resolve().parent
_REPO = _PKG.parent
BUILD_DIR = _REPO / "build" / "path_tracer_torch"
CSRC = _PKG / "csrc"
BVH_SRC = CSRC / "bvh.cpp"

# Same flags as the JAX package's builder, so both give one permutation.
BVH_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_bvh_lib = None
_kernels = None


def _run(cmds: list) -> str:
    """Run the commands side by side; raise with their output if any
    fails, else return their joined output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed:\n{out}")
    return "".join(outs)


def _cached_build(name: str, sources: list[Path], flags: list,
                  build) -> tuple[Path, str]:
    """Build ``sources`` into BUILD_DIR/lib<name>_<hash>.so unless present.

    ``build(out)`` compiles into ``out`` and returns the compilers' output;
    the hash covers the sources and ``flags``. Returns (path, compiler
    output). Concurrent builders each write a private temp file and rename
    it into place, so a reader never sees a partial library."""
    h = hashlib.sha1()
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(flags).encode())
    so_path = BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"
    if so_path.exists():
        return so_path, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so_path.with_suffix(f".{os.getpid()}.tmp.so")
    log = build(tmp)
    tmp.replace(so_path)
    return so_path, log


class Bvh(NamedTuple):
    """Flattened skip-pointer BVH (DFS order; hit -> i+1, miss -> skip[i]),
    as ``path_tracer_tpu/native/build.py`` returns it."""

    node_min: np.ndarray  # [N,3] f32
    node_max: np.ndarray  # [N,3] f32
    first_prim: np.ndarray  # [N] i32 (leaves; 0 for internal)
    prim_count: np.ndarray  # [N] i32 (0 for internal nodes)
    skip: np.ndarray  # [N] i32 escape index (N at the root tail)
    prim_order: np.ndarray  # [n_prims] i32 permutation into the input prims


def _bvh_library() -> ctypes.CDLL:
    global _bvh_lib
    if _bvh_lib is None:
        path, _ = _cached_build(
            "ptt_torch_bvh", [BVH_SRC], BVH_FLAGS,
            lambda out: _run([["g++", *BVH_FLAGS, str(BVH_SRC), "-o",
                               str(out)]]))
        lib = ctypes.CDLL(str(path))
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.ptt_build_bvh.restype = ctypes.c_int
        lib.ptt_build_bvh.argtypes = [f32p, f32p, ctypes.c_int, ctypes.c_int,
                                      f32p, f32p, i32p, i32p, i32p, i32p]
        _bvh_lib = lib
    return _bvh_lib


def build_bvh(bb_min: np.ndarray, bb_max: np.ndarray,
              leaf_size: int = 4) -> Bvh:
    """Binned-SAH BVH over n primitive AABBs ([n,3] f32 min/max)."""
    lib = _bvh_library()
    bb_min = np.ascontiguousarray(bb_min, np.float32)
    bb_max = np.ascontiguousarray(bb_max, np.float32)
    n = bb_min.shape[0]
    if n == 0 or bb_max.shape != bb_min.shape or bb_min.shape[1:] != (3,):
        raise ValueError(f"need [n,3] boxes with n > 0, got {bb_min.shape}")
    cap = 2 * n
    node_min = np.empty((cap, 3), np.float32)
    node_max = np.empty((cap, 3), np.float32)
    first_prim, prim_count, skip = (np.empty(cap, np.int32) for _ in range(3))
    order = np.empty(n, np.int32)
    n_nodes = lib.ptt_build_bvh(bb_min, bb_max, n, int(leaf_size), node_min,
                                node_max, first_prim, prim_count, skip, order)
    if not 0 < n_nodes <= cap:
        raise RuntimeError(f"BVH build returned {n_nodes} nodes for {n} prims")
    return Bvh(node_min=node_min[:n_nodes].copy(),
               node_max=node_max[:n_nodes].copy(),
               first_prim=first_prim[:n_nodes].copy(),
               prim_count=prim_count[:n_nodes].copy(),
               skip=skip[:n_nodes].copy(), prim_order=order)


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           f"{CSRC} at their first launch and need the CUDA "
                           "toolkit")
    return found


class Kernels:
    """The loaded kernel library, its build time and the compiler's report
    (``-Xptxas -v``: registers, shared memory, spills per kernel)."""

    def __init__(self, lib: ctypes.CDLL, seconds: float, log: str):
        self.lib = lib
        self.build_seconds = seconds
        self.build_log = log


def _build_kernels(out: Path) -> str:
    """One nvcc per ``csrc/*.cu``, all started together, then the link."""
    nvcc = _nvcc()
    cus = sorted(CSRC.glob("*.cu"))
    objs = [out.with_suffix(f".{cu.stem}.o") for cu in cus]
    try:
        log = _run([[nvcc, *NVCC_FLAGS, "-c", str(cu), "-o", str(obj)]
                    for cu, obj in zip(cus, objs)])
        return log + _run([[nvcc, "-shared", *NVCC_FLAGS[:2],
                            *map(str, objs), "-o", str(out)]])
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)


def kernels() -> Kernels:
    """Build (once per source hash) and load ``csrc/*.cu``."""
    global _kernels
    if _kernels is None:
        sources = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
        t0 = time.perf_counter()
        path, log = _cached_build("ptt_torch_kernels", sources, NVCC_FLAGS,
                                  _build_kernels)
        seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(path))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        # (o, d, t_prev, table, R, N, fout, iout, device, stream)
        lib.ptt_mt_closest_hit.restype = ci
        lib.ptt_mt_closest_hit.argtypes = [vp, vp, vp, vp, ci, ci, vp, vp, ci,
                                           vp]
        # (o, d, t_prev, sph, tri_t, tri_u, tri_v, tri_kind, tri_prim,
        #  tri_back, R, S, fout, iout, bout, device, stream)
        lib.ptt_sphere_closest_hit.restype = ci
        lib.ptt_sphere_closest_hit.argtypes = [vp] * 10 + [ci] * 2 + [vp] * 3 \
            + [ci, vp]
        # (o, d, t_prev, blkflat, blkid, bw, sph, R, bpad, block, n_cols, S,
        #  sph_row_base, fout, iout, device, stream)
        lib.ptt_flat_closest_hit.restype = ci
        lib.ptt_flat_closest_hit.argtypes = [vp] * 7 + [ci] * 6 + [vp, vp,
                                                                  ci, vp]
        # (o, d, t_max, blkflat, blkid, bw, R, L, bpad, block, n_cols, out,
        #  device, stream)
        lib.ptt_flat_occluded.restype = ci
        lib.ptt_flat_occluded.argtypes = [vp] * 6 + [ci] * 5 + [vp, ci, vp]
        # (o, d, t_prev, sbflat, sbid, blkflat, blkid, bw, R, sbpad, bpad,
        #  block, n_cols, fout, iout, device, stream)
        lib.ptt_flat2_closest_hit.restype = ci
        lib.ptt_flat2_closest_hit.argtypes = [vp] * 8 + [ci] * 5 + [vp, vp,
                                                                   ci, vp]
        # (o, d, t_max, sbflat, sbid, blkflat, blkid, bw, R, L, sbpad, bpad,
        #  block, n_cols, out, device, stream)
        lib.ptt_flat2_occluded.restype = ci
        lib.ptt_flat2_occluded.argtypes = [vp] * 8 + [ci] * 6 + [vp, ci, vp]
        # (o, d, t_prev, blk, blkid, sph, smap, tri_t, tri_u, tri_v,
        #  tri_kind, tri_prim, tri_back, R, sbpad, n_slots, lane_wise,
        #  cut_widen, fout, iout, bout, device, stream)
        lib.ptt_sph_walk.restype = ci
        lib.ptt_sph_walk.argtypes = ([vp] * 13 + [ci] * 4 + [ctypes.c_float]
                                     + [vp] * 3 + [ci, vp])
        # (o, d, t_op, rnd, bw, rows, tex, lut, pages, grp, R, T, gp, wp,
        #  steps_cap, textured, live, fout, iout, device, stream)
        lib.ptt_alpha_walk.restype = ci
        lib.ptt_alpha_walk.argtypes = [vp] * 10 + [ci] * 7 + [vp, vp, ci, vp]
        # (o, d, aux, bw, rows, tex, lut, pages, grp, R, T, gp, wp,
        #  steps_cap, textured, live, fout, device, stream)
        lib.ptt_trans_walk.restype = ci
        lib.ptt_trans_walk.argtypes = [vp] * 9 + [ci] * 7 + [vp, ci, vp]
        # (o, d, t_max, prior, sph, R, L, S, ld, out, device, stream)
        lib.ptt_sph_occluded.restype = ci
        lib.ptt_sph_occluded.argtypes = [vp] * 5 + [ci] * 4 + [vp, ci, vp]
        # (o, d, t_max, prior, blk, blkid, sph, R, L, sbpad, n_slots,
        #  lane_wise, out, device, stream)
        lib.ptt_sph_occ_walk.restype = ci
        lib.ptt_sph_occ_walk.argtypes = [vp] * 7 + [ci] * 5 + [vp, ci, vp]
        # (o, d, t_max, pd, aux, is_pt_mask, blk, blkid, bw, bpad, block,
        #  n_cols, tr_bw, tr_rows, tex, lut, pages, grp, T, gp, wp, R, L,
        #  steps_cap, textured, live, next, out, device, stream)
        lib.ptt_fused_shadow.restype = ci
        lib.ptt_fused_shadow.argtypes = ([vp] * 5 + [ctypes.c_ulonglong]
                                         + [vp] * 3 + [ci] * 3 + [vp] * 6
                                         + [ci] * 8 + [vp, vp, ci, vp])
        # (o, d, t_max, tris, gbox, sbox, R, T, K, next, tout, iout, device,
        #  stream)
        lib.ptt_khit.restype = ci
        lib.ptt_khit.argtypes = [vp] * 6 + [ci] * 3 + [vp] * 3 + [ci, vp]
        # (o, d, t_prev, nodes6, meta6, tris, R, npad, n_nodes, block,
        #  n_slots, lane_wise, cut_widen, fout, iout, device, stream)
        lib.ptt_tree_closest_hit.restype = ci
        lib.ptt_tree_closest_hit.argtypes = ([vp] * 6 + [ci] * 6
                                             + [ctypes.c_float, vp, vp, ci,
                                                vp])
        # (o, d, t_max, nodes6, meta6, tris, R, L, npad, n_nodes, block,
        #  n_slots, lane_wise, out, device, stream)
        lib.ptt_tree_occluded.restype = ci
        lib.ptt_tree_occluded.argtypes = [vp] * 6 + [ci] * 7 + [vp, ci, vp]
        # The replaced design (ab_baselines.cu): row 6's first port, as
        # ptt_sph_occ_walk without prior and lane_wise, writing f32.
        lib.ptt_sph_occ_walk_cta.restype = ci
        lib.ptt_sph_occ_walk_cta.argtypes = [vp] * 6 + [ci] * 4 + [vp, ci, vp]
        _kernels = Kernels(lib, seconds, log)
    return _kernels


def _check(name: str, t: torch.Tensor, shape: tuple, dtype, device):
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_rays(fn: str, o, d, t_prev, device) -> int:
    """o, d [R,3] and t_prev [R] f32 on the CUDA ``device``; returns R."""
    if device.type != "cuda":
        raise ValueError(f"{fn}: needs CUDA tensors, got {device}")
    r = o.shape[0]
    _check("o", o, (r, 3), torch.float32, device)
    _check("d", d, (r, 3), torch.float32, device)
    _check("t_prev", t_prev, (r,), torch.float32, device)
    if 3 * r >= 2**31:
        raise ValueError(f"{fn}: {r} rays exceed int32 indexing")
    return r


def launch_closest_hit(fn: str, o, d, t_prev, table, table_rows: int,
                       out_rows: int):
    """Check the operands of a closest-hit kernel, allocate its outputs and
    launch it on the current stream (no synchronisation).

    o, d: [R,3] f32; t_prev: [R] f32; table: [table_rows, N] f32, all
    contiguous on one CUDA device. Returns (fout [out_rows, R] f32,
    iout [R] i32). Raises on anything the kernel does not take and when the
    launch is refused."""
    device = o.device
    r = _check_rays(fn, o, d, t_prev, device)
    n = table.shape[1] if table.dim() == 2 else -1
    _check("table", table, (table_rows, n), torch.float32, device)
    if n >= 2**31:
        raise ValueError(f"{fn}: {n} columns exceed int32 indexing")
    lib = kernels().lib
    fout = torch.empty((out_rows, r), dtype=torch.float32, device=device)
    iout = torch.empty((r,), dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(lib, fn)(o.data_ptr(), d.data_ptr(), t_prev.data_ptr(),
                           table.data_ptr(), r, n, fout.data_ptr(),
                           iout.data_ptr(), device.index, stream)
    if err != 0:
        raise RuntimeError(f"{fn}: launch failed with CUDA error {err}")
    return fout, iout


def launch_sphere_closest_hit(o, d, t_prev, sph, tri=None):
    """Check the operands of the dense sphere closest-hit kernel, allocate
    its outputs and launch it on the current stream (no synchronisation).

    o, d: [R,3] f32; t_prev: [R] f32; sph: [4,S] f32; tri: None or a
    triangle record (t, kind, prim, u, v, backface: [R] f32, i32, i32, f32,
    f32, bool) merged in the launch, a sphere winning only on a strictly
    smaller t. Returns the record's storage: (fout [3,R] f32 rows t, u, v;
    iout [2,R] i32 rows kind, prim; backface [R] bool)."""
    fn = "ptt_sphere_closest_hit"
    device = o.device
    r = _check_rays(fn, o, d, t_prev, device)
    n = sph.shape[1] if sph.dim() == 2 else -1
    _check("sph", sph, (4, n), torch.float32, device)
    fields = _tri_fields(tri, r, device)
    if 4 * n >= 2**31:
        raise ValueError(f"{fn}: {n} spheres exceed int32 indexing")
    lib = kernels().lib
    fout, iout, bout = _record_outputs(r, device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.ptt_sphere_closest_hit(
        o.data_ptr(), d.data_ptr(), t_prev.data_ptr(), sph.data_ptr(),
        *_ptrs(fields), r, n, fout.data_ptr(), iout.data_ptr(),
        bout.data_ptr(), device.index, stream)
    if err != 0:
        raise RuntimeError(f"{fn}: launch failed with CUDA error {err}")
    return fout, iout, bout


def _tri_fields(tri, r: int, device) -> tuple:
    """The fields of a triangle record ``tri`` (t, kind, prim, u, v,
    backface: [R] f32, i32, i32, f32, f32, bool) in the kernels' order (t,
    u, v, kind, prim, backface), checked; () for None."""
    if tri is None:
        return ()
    t, kind, prim, u, v, back = tri
    fields = (t, u, v, kind, prim, back)
    for name, x, dtype in zip(("tri t", "tri u", "tri v", "tri kind",
                               "tri prim", "tri backface"), fields,
                              (torch.float32,) * 3 + (torch.int32,) * 2
                              + (torch.bool,)):
        _check(name, x, (r,), dtype, device)
    return fields


def _ptrs(fields: tuple) -> list:
    """Device pointers of the checked triangle record fields, six nulls
    for none."""
    return [x.data_ptr() for x in fields] or [None] * 6


def _record_outputs(r: int, device):
    """A HitRecord's storage as the sphere closest hits write it: fout
    [3,R] f32 rows t, u, v; iout [2,R] i32 rows kind, prim; backface [R]
    bool."""
    return (torch.empty((3, r), dtype=torch.float32, device=device),
            torch.empty((2, r), dtype=torch.int32, device=device),
            torch.empty((r,), dtype=torch.bool, device=device))


def _check_flat_tables(fn: str, blkflat, blkid, bw, block: int, device):
    """The superleaf tables a flat kernel reads; returns (bpad, n_cols)."""
    bpad = blkflat.shape[1] if blkflat.dim() == 2 else -1
    n_cols = bw.shape[1] if bw.dim() == 2 else -1
    _check("blkflat", blkflat, (8, bpad), torch.float32, device)
    _check("blkid", blkid, (1, bpad), torch.int32, device)
    _check("bw", bw, (16, n_cols), torch.float32, device)
    if block <= 0 or n_cols % block:
        raise ValueError(f"{fn}: bw has {n_cols} columns, not a multiple of "
                         f"the block size {block}")
    if 16 * n_cols >= 2**31:
        raise ValueError(f"{fn}: {n_cols} BW columns exceed int32 indexing")
    return bpad, n_cols


def _check_sets(fn: str, o, ds, t_maxes, device) -> tuple[int, int]:
    """L direction sets sharing R origins; returns (R, L)."""
    if device.type != "cuda":
        raise ValueError(f"{fn}: needs CUDA tensors, got {device}")
    r = o.shape[0]
    n_sets = ds.shape[0] if ds.dim() == 3 else -1
    _check("o", o, (r, 3), torch.float32, device)
    _check("ds", ds, (n_sets, r, 3), torch.float32, device)
    _check("t_maxes", t_maxes, (n_sets, r), torch.float32, device)
    if not 0 < n_sets < 65536 or 3 * n_sets * r >= 2**31:
        raise ValueError(f"{fn}: {n_sets} sets x {r} rays out of range")
    return r, n_sets


def launch_flat_closest_hit(o, d, t_prev, blkflat, blkid, bw, block: int,
                            sph=None, sph_row_base: int = 0):
    """Check the operands of the flat closest-hit kernel, allocate its
    outputs and launch it on the current stream (no synchronisation).

    o, d: [R,3] f32; t_prev: [R] f32; blkflat [8,Bpad] f32, blkid [1,Bpad]
    i32, bw [16, n_blocks*block] f32; sph: None or [4,S] f32 (the fused
    sphere pass). Returns (fout [4 or 5, R] f32, iout [R] i32)."""
    fn = "ptt_flat_closest_hit"
    device = o.device
    r = _check_rays(fn, o, d, t_prev, device)
    bpad, n_cols = _check_flat_tables(fn, blkflat, blkid, bw, block, device)
    n_sph = 0
    if sph is not None:
        n_sph = sph.shape[1] if sph.dim() == 2 else -1
        _check("sph", sph, (4, n_sph), torch.float32, device)
    if 5 * r >= 2**31:
        raise ValueError(f"{fn}: {r} rays exceed int32 indexing")
    lib = kernels().lib
    fout = torch.empty((5 if n_sph else 4, r), dtype=torch.float32,
                       device=device)
    iout = torch.empty((r,), dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.ptt_flat_closest_hit(
        o.data_ptr(), d.data_ptr(), t_prev.data_ptr(), blkflat.data_ptr(),
        blkid.data_ptr(), bw.data_ptr(), sph.data_ptr() if n_sph else None,
        r, bpad, block, n_cols, n_sph, sph_row_base, fout.data_ptr(),
        iout.data_ptr(), device.index, stream)
    if err != 0:
        raise RuntimeError(f"{fn}: launch failed with CUDA error {err}")
    return fout, iout


def launch_flat_occluded(o, ds, t_maxes, blkflat, blkid, bw, block: int):
    """Check the operands of the flat any-hit kernel, allocate its output
    and launch it on the current stream (no synchronisation).

    o: [R,3] f32; ds: [L,R,3] f32; t_maxes: [L,R] f32 (< 0 = dead lane);
    tables as for ``launch_flat_closest_hit``. Returns out [L,R] bool
    (occluded or dead)."""
    fn = "ptt_flat_occluded"
    device = o.device
    r, n_sets = _check_sets(fn, o, ds, t_maxes, device)
    bpad, n_cols = _check_flat_tables(fn, blkflat, blkid, bw, block, device)
    lib = kernels().lib
    out = torch.empty((n_sets, r), dtype=torch.bool, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.ptt_flat_occluded(
        o.data_ptr(), ds.data_ptr(), t_maxes.data_ptr(), blkflat.data_ptr(),
        blkid.data_ptr(), bw.data_ptr(), r, n_sets, bpad, block, n_cols,
        out.data_ptr(), device.index, stream)
    if err != 0:
        raise RuntimeError(f"{fn}: launch failed with CUDA error {err}")
    return out


def _check_superblocks(fn: str, sbflat, sbid, bpad: int, device) -> int:
    """The superblock tables a flat2 kernel reads; returns sbpad."""
    sbpad = sbflat.shape[1] if sbflat.dim() == 2 else -1
    _check("sbflat", sbflat, (8, sbpad), torch.float32, device)
    _check("sbid", sbid, (1, sbpad), torch.int32, device)
    if sbpad <= 0 or bpad % 128 or sbpad * 128 < bpad:
        raise ValueError(f"{fn}: {sbpad} superblocks do not cover {bpad} "
                         "block columns in groups of 128")
    return sbpad


def launch_flat2_closest_hit(o, d, t_prev, sbflat, sbid, blkflat, blkid, bw,
                             block: int):
    """Check the operands of the flat2 closest-hit kernel, allocate its
    outputs and launch it on the current stream (no synchronisation).

    o, d: [R,3] f32; t_prev: [R] f32; sbflat [8,SBpad] f32, sbid [1,SBpad]
    i32 (superblock g covers block columns [128g, 128g + 128)); blkflat,
    blkid, bw as for ``launch_flat_closest_hit``. Returns (fout [4, R] f32,
    iout [R] i32)."""
    fn = "ptt_flat2_closest_hit"
    device = o.device
    r = _check_rays(fn, o, d, t_prev, device)
    bpad, n_cols = _check_flat_tables(fn, blkflat, blkid, bw, block, device)
    sbpad = _check_superblocks(fn, sbflat, sbid, bpad, device)
    if 4 * r >= 2**31:
        raise ValueError(f"{fn}: {r} rays exceed int32 indexing")
    lib = kernels().lib
    fout = torch.empty((4, r), dtype=torch.float32, device=device)
    iout = torch.empty((r,), dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.ptt_flat2_closest_hit(
        o.data_ptr(), d.data_ptr(), t_prev.data_ptr(), sbflat.data_ptr(),
        sbid.data_ptr(), blkflat.data_ptr(), blkid.data_ptr(), bw.data_ptr(),
        r, sbpad, bpad, block, n_cols, fout.data_ptr(), iout.data_ptr(),
        device.index, stream)
    if err != 0:
        raise RuntimeError(f"{fn}: launch failed with CUDA error {err}")
    return fout, iout


def launch_flat2_occluded(o, ds, t_maxes, sbflat, sbid, blkflat, blkid, bw,
                          block: int):
    """Check the operands of the flat2 any-hit kernel, allocate its output
    and launch it on the current stream (no synchronisation).

    o: [R,3] f32; ds: [L,R,3] f32; t_maxes: [L,R] f32 (< 0 = dead lane);
    tables as for ``launch_flat2_closest_hit``. Returns out [L,R] bool
    (occluded or dead)."""
    fn = "ptt_flat2_occluded"
    device = o.device
    r, n_sets = _check_sets(fn, o, ds, t_maxes, device)
    bpad, n_cols = _check_flat_tables(fn, blkflat, blkid, bw, block, device)
    sbpad = _check_superblocks(fn, sbflat, sbid, bpad, device)
    lib = kernels().lib
    out = torch.empty((n_sets, r), dtype=torch.bool, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.ptt_flat2_occluded(
        o.data_ptr(), ds.data_ptr(), t_maxes.data_ptr(), sbflat.data_ptr(),
        sbid.data_ptr(), blkflat.data_ptr(), blkid.data_ptr(), bw.data_ptr(),
        r, n_sets, sbpad, bpad, block, n_cols, out.data_ptr(), device.index,
        stream)
    if err != 0:
        raise RuntimeError(f"{fn}: launch failed with CUDA error {err}")
    return out


def _check_sph_blocks(fn: str, blk, blkid, sph, device) -> tuple[int, int]:
    """The sphere block tables a walk reads: blk [8,SBpad] f32 block AABBs,
    blkid [1,SBpad] i32, sph [4, nblk*128] f32 sorted spheres. Returns
    (SBpad, n_slots)."""
    sbpad = blk.shape[1] if blk.dim() == 2 else -1
    n_slots = sph.shape[1] if sph.dim() == 2 else -1
    _check("blk", blk, (8, sbpad), torch.float32, device)
    _check("blkid", blkid, (1, sbpad), torch.int32, device)
    _check("sph", sph, (4, n_slots), torch.float32, device)
    if sbpad <= 0 or n_slots <= 0 or n_slots % 128 or 4 * n_slots >= 2**31:
        raise ValueError(f"{fn}: {n_slots} sphere slots are not whole "
                         "blocks of 128")
    return sbpad, n_slots


# Row 5's walk (csrc/sph_walk.cu): a block is served lane per ray from
# SPH_WALK_LANE_WISE rays of need (fewer: the block spread over the warp),
# and a lane's cut admits a block whose slab entry is at most
# SPH_WALK_CUT_WIDEN times its best t. chip_smoke.py's visit simulation
# reads both from here.
SPH_WALK_LANE_WISE = 25
SPH_WALK_CUT_WIDEN = 1.0 + 2.0 ** -8


def launch_sph_walk(o, d, t_prev, blk, blkid, sph, smap, tri=None,
                    lane_wise: int = SPH_WALK_LANE_WISE):
    """Check the operands of the sphere block-walk kernel, allocate its
    outputs and launch it on the current stream (no synchronisation).

    o, d: [R,3] f32; t_prev: [R] f32; blk [8,SBpad] f32 block AABBs, blkid
    [1,SBpad] i32, sph [4, nblk*128] f32 sorted spheres, smap [nblk*128]
    i32 sorted slot -> sphere index; tri: None or a triangle record as for
    ``launch_sphere_closest_hit``, merged in the launch; lane_wise (1 to
    33) the rays of need from which a block is served lane per ray, 33
    serving every block over the warp (the layouts give one result).
    Returns the record's storage: (fout [3,R] f32 rows t, u, v; iout
    [2,R] i32 rows kind, prim; backface [R] bool)."""
    fn = "ptt_sph_walk"
    device = o.device
    if not 1 <= lane_wise <= 33:
        raise ValueError(f"{fn}: lane_wise {lane_wise} is not in 1..33")
    r = _check_rays(fn, o, d, t_prev, device)
    sbpad, n_slots = _check_sph_blocks(fn, blk, blkid, sph, device)
    _check("smap", smap, (n_slots,), torch.int32, device)
    fields = _tri_fields(tri, r, device)
    lib = kernels().lib
    fout, iout, bout = _record_outputs(r, device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.ptt_sph_walk(
        o.data_ptr(), d.data_ptr(), t_prev.data_ptr(), blk.data_ptr(),
        blkid.data_ptr(), sph.data_ptr(), smap.data_ptr(), *_ptrs(fields), r,
        sbpad, n_slots, lane_wise, SPH_WALK_CUT_WIDEN, fout.data_ptr(),
        iout.data_ptr(), bout.data_ptr(), device.index, stream)
    if err != 0:
        raise RuntimeError(f"{fn}: launch failed with CUDA error {err}")
    return fout, iout, bout


def _check_tr_tables(fn: str, scene, device, live=None):
    """The transparent table a walk kernel reads: the scene's ``tr_rows``
    and u8 ``tr_tex8``, or with ``live`` (``trwalk.LiveTables``) its rows
    and f32 plane, of the same shapes. Returns (T, wp, rows, plane)."""
    n_cols = scene.tr_bw.shape[1] if scene.tr_bw.dim() == 2 else -1
    wp = scene.tr_tex8.shape[1] if scene.tr_tex8.dim() == 2 else -1
    hp = scene.tr_tex8.shape[0]
    n_pages = scene.tr_page_table.shape[0]
    rows, tex = ((scene.tr_rows, scene.tr_tex8) if live is None
                 else (live.rows, live.plane))
    _check("tr_bw", scene.tr_bw, (16, n_cols), torch.float32, device)
    _check("tr_rows" if live is None else "live rows", rows, (9, n_cols),
           torch.float32, device)
    _check("tr_tex8" if live is None else "live plane", tex, (hp, wp),
           torch.uint8 if live is None else torch.float32, device)
    _check("tr_lut", scene.tr_lut, (1, 256), torch.float32, device)
    _check("tr_page_table", scene.tr_page_table, (n_pages, 3), torch.int32,
           device)
    if n_cols <= 0 or n_cols % 128 or 16 * n_cols >= 2**31 or n_pages < 1 \
            or hp * wp >= 2**31:
        raise ValueError(f"{fn}: a table of {n_cols} columns and {n_pages} "
                         "pages is not a walk table")
    return n_cols, wp, rows, tex


def _check_resident(fn: str, scene, n_cols: int, device) -> int:
    """The group boxes ``tr_grp`` [7, GP] the resident walks read, and their
    limit: at most 4,096 columns (the table in shared memory, one bit per
    128-column group of a lane's mask). Returns GP."""
    gp = scene.tr_grp.shape[1] if scene.tr_grp.dim() == 2 else -1
    _check("tr_grp", scene.tr_grp, (7, gp), torch.float32, device)
    if n_cols > 4096 or 128 * gp < n_cols:
        raise ValueError(f"{fn}: a table of {n_cols} columns and {gp} group "
                         "boxes exceeds the resident walk (4,096 columns)")
    return gp


def launch_alpha_walk(o, d, t_op, rnd, scene, steps_cap: int, live=None):
    """Check the operands of the alpha walk kernel, allocate its outputs
    and launch it on the current stream (no synchronisation).

    o, d: [R,3] f32; t_op: [R] f32 (< 0 dead); rnd: [steps_cap, R] f32;
    the scene's tr_* tables and ``tr_grp``, or with ``live``
    (``trwalk.LiveTables``) the live variant on its rows and f32 plane.
    Returns (fout [8,R] f32, iout [R] i32)."""
    fn = "ptt_alpha_walk"
    device = o.device
    if device.type != "cuda":
        raise ValueError(f"{fn}: needs CUDA tensors, got {device}")
    r = o.shape[0]
    _check("o", o, (r, 3), torch.float32, device)
    _check("d", d, (r, 3), torch.float32, device)
    _check("t_op", t_op, (r,), torch.float32, device)
    _check("rnd", rnd, (steps_cap, r), torch.float32, device)
    n_cols, wp, rows, tex = _check_tr_tables(fn, scene, device, live)
    gp = _check_resident(fn, scene, n_cols, device)
    if steps_cap < 0 or 8 * r >= 2**31 or steps_cap * r >= 2**31:
        raise ValueError(f"{fn}: {r} rays x {steps_cap} steps out of range")
    lib = kernels().lib
    fout = torch.empty((8, r), dtype=torch.float32, device=device)
    iout = torch.empty((r,), dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.ptt_alpha_walk(
        o.data_ptr(), d.data_ptr(), t_op.data_ptr(), rnd.data_ptr(),
        scene.tr_bw.data_ptr(), rows.data_ptr(), tex.data_ptr(),
        scene.tr_lut.data_ptr(), scene.tr_page_table.data_ptr(),
        scene.tr_grp.data_ptr(), r, n_cols, gp, wp, steps_cap,
        int(scene.tr_textured), int(live is not None), fout.data_ptr(),
        iout.data_ptr(), device.index, stream)
    if err != 0:
        raise RuntimeError(f"{fn}: launch failed with CUDA error {err}")
    return fout, iout


def launch_trans_walk(o, d, aux, scene, steps_cap: int, live=None):
    """Check the operands of the transmittance walk kernel, allocate its
    output and launch it on the current stream (no synchronisation).

    o, d: [R,3] f32; aux: [8,R] f32 (pd, is point, surface xyz, original
    uv, original is sphere); the scene's tr_* tables, or ``live`` as for
    ``launch_alpha_walk``. Returns fout [3,R] f32 (trans, t_prev, still
    walking)."""
    fn = "ptt_trans_walk"
    device = o.device
    if device.type != "cuda":
        raise ValueError(f"{fn}: needs CUDA tensors, got {device}")
    r = o.shape[0]
    _check("o", o, (r, 3), torch.float32, device)
    _check("d", d, (r, 3), torch.float32, device)
    _check("aux", aux, (8, r), torch.float32, device)
    n_cols, wp, rows, tex = _check_tr_tables(fn, scene, device, live)
    gp = _check_resident(fn, scene, n_cols, device)
    if steps_cap < 0 or 8 * r >= 2**31:
        raise ValueError(f"{fn}: {r} rays out of range")
    lib = kernels().lib
    fout = torch.empty((3, r), dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.ptt_trans_walk(
        o.data_ptr(), d.data_ptr(), aux.data_ptr(), scene.tr_bw.data_ptr(),
        rows.data_ptr(), tex.data_ptr(), scene.tr_lut.data_ptr(),
        scene.tr_page_table.data_ptr(), scene.tr_grp.data_ptr(), r, n_cols,
        gp, wp, steps_cap, int(scene.tr_textured), int(live is not None),
        fout.data_ptr(), device.index, stream)
    if err != 0:
        raise RuntimeError(f"{fn}: launch failed with CUDA error {err}")
    return fout


# Direction sets the dense sphere any-hit takes in one launch (the sets'
# rays live in registers; csrc/sph_occ.cu's kMaxSets).
SPH_OCC_MAX_SETS = 8


def launch_sph_occluded(o, ds, t_maxes, sph, n_spheres: int, prior=None):
    """Check the operands of the dense sphere any-hit kernel, allocate its
    output and launch it on the current stream (no synchronisation).

    o: [R,3] f32; ds: [L,R,3] f32 (L <= SPH_OCC_MAX_SETS); t_maxes: [L,R]
    f32 (< 0 = dead lane); sph: [4, ld] f32 of which the first
    ``n_spheres`` columns are tested; prior: None or [L,R] bool (the
    triangle any-hit's result), folded in. Returns out [L,R] bool: prior |
    occluded by a sphere (dead lanes not occluded by a sphere)."""
    fn = "ptt_sph_occluded"
    device = o.device
    r, n_sets = _check_sets(fn, o, ds, t_maxes, device)
    if n_sets > SPH_OCC_MAX_SETS:
        raise ValueError(f"{fn}: {n_sets} sets, at most {SPH_OCC_MAX_SETS}")
    ld = sph.shape[1] if sph.dim() == 2 else -1
    _check("sph", sph, (4, ld), torch.float32, device)
    if not 0 <= n_spheres <= ld or 4 * ld >= 2**31:
        raise ValueError(f"{fn}: {n_spheres} spheres in a table of {ld} "
                         "columns")
    if prior is not None:
        _check("prior", prior, (n_sets, r), torch.bool, device)
    lib = kernels().lib
    out = torch.empty((n_sets, r), dtype=torch.bool, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.ptt_sph_occluded(
        o.data_ptr(), ds.data_ptr(), t_maxes.data_ptr(),
        None if prior is None else prior.data_ptr(), sph.data_ptr(), r,
        n_sets, n_spheres, ld, out.data_ptr(), device.index, stream)
    if err != 0:
        raise RuntimeError(f"{fn}: launch failed with CUDA error {err}")
    return out


# Row 6's walk (csrc/sph_occ.cu): a block is served lane per ray from
# SPH_OCC_WALK_LANE_WISE lanes of need (fewer: the block spread over the
# warp).
SPH_OCC_WALK_LANE_WISE = 25


def launch_sph_occ_walk(o, ds, t_maxes, blk, blkid, sph, prior=None,
                        lane_wise: int = SPH_OCC_WALK_LANE_WISE):
    """Check the operands of the sphere any-hit walk, allocate its output
    and launch it on the current stream (no synchronisation).

    o: [R,3] f32; ds: [L,R,3] f32; t_maxes: [L,R] f32 (< 0 = dead lane);
    blk [8,SBpad] f32, blkid [1,SBpad] i32, sph [4, nblk*128] f32 as for
    ``launch_sph_walk``; prior: None or [L,R] bool (the triangle any-hit's
    result), folded in; lane_wise (1 to 33) the lanes of need from which a
    block is served lane per ray, 33 serving every block over the warp
    (the layouts give one result). Returns out [L,R] bool: prior |
    occluded by a sphere (dead lanes not occluded by a sphere)."""
    fn = "ptt_sph_occ_walk"
    device = o.device
    if not 1 <= lane_wise <= 33:
        raise ValueError(f"{fn}: lane_wise {lane_wise} is not in 1..33")
    r, n_sets = _check_sets(fn, o, ds, t_maxes, device)
    sbpad, n_slots = _check_sph_blocks(fn, blk, blkid, sph, device)
    if prior is not None:
        _check("prior", prior, (n_sets, r), torch.bool, device)
    lib = kernels().lib
    out = torch.empty((n_sets, r), dtype=torch.bool, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.ptt_sph_occ_walk(
        o.data_ptr(), ds.data_ptr(), t_maxes.data_ptr(),
        None if prior is None else prior.data_ptr(), blk.data_ptr(),
        blkid.data_ptr(), sph.data_ptr(), r, n_sets, sbpad, n_slots,
        lane_wise, out.data_ptr(), device.index, stream)
    if err != 0:
        raise RuntimeError(f"{fn}: launch failed with CUDA error {err}")
    return out


def launch_fused_shadow(o, ds, t_maxes, pds, aux, is_pt, blkflat, blkid, bw,
                        block: int, scene, steps_cap: int, live=None):
    """Check the operands of the fused shadow kernel, allocate its output
    and launch it on the current stream (no synchronisation).

    o: [R,3] f32; ds: [L,R,3] f32; t_maxes, pds: [L,R] f32; aux: [6,R] f32
    (surface point xyz, original uv, original is sphere); is_pt: L bools;
    blkflat, blkid, bw: the opaque view's flat tables (as for
    ``launch_flat_occluded``); the scene's tr_* tables and ``tr_grp`` (the
    walk phase's table resident in shared memory: at most 4,096 columns),
    or ``live`` as for ``launch_alpha_walk``. Returns out [3L,R] f32 (per
    light: trans_eff, t_prev, still walking)."""
    fn = "ptt_fused_shadow"
    device = o.device
    r, n_sets = _check_sets(fn, o, ds, t_maxes, device)
    _check("pds", pds, (n_sets, r), torch.float32, device)
    _check("aux", aux, (6, r), torch.float32, device)
    if len(is_pt) != n_sets or n_sets > 64:
        raise ValueError(f"{fn}: {len(is_pt)} light types for {n_sets} sets "
                         "(at most 64 lights)")
    bpad, n_cols = _check_flat_tables(fn, blkflat, blkid, bw, block, device)
    t_cols, wp, rows, tex = _check_tr_tables(fn, scene, device, live)
    gp = _check_resident(fn, scene, t_cols, device)
    if steps_cap < 0 or 3 * n_sets * r >= 2**31:
        raise ValueError(f"{fn}: {n_sets} sets x {r} rays out of range")
    mask = sum(1 << k for k, pt in enumerate(is_pt) if pt)
    lib = kernels().lib
    out = torch.empty((3 * n_sets, r), dtype=torch.float32, device=device)
    nxt = torch.zeros((1,), dtype=torch.int32, device=device)  # work counter
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.ptt_fused_shadow(
        o.data_ptr(), ds.data_ptr(), t_maxes.data_ptr(), pds.data_ptr(),
        aux.data_ptr(), mask, blkflat.data_ptr(), blkid.data_ptr(),
        bw.data_ptr(), bpad, block, n_cols, scene.tr_bw.data_ptr(),
        rows.data_ptr(), tex.data_ptr(), scene.tr_lut.data_ptr(),
        scene.tr_page_table.data_ptr(), scene.tr_grp.data_ptr(), t_cols, gp,
        wp, r, n_sets, steps_cap, int(scene.tr_textured),
        int(live is not None), nxt.data_ptr(), out.data_ptr(), device.index,
        stream)
    if err != 0:
        raise RuntimeError(f"{fn}: launch failed with CUDA error {err}")
    return out


KHIT_MAX_COLUMNS = 4096  # row 3's table resident in shared memory


def launch_khit(o, d, t_max, tris, gbox, sbox, k: int):
    """Check the operands of the k-nearest-hits kernel, allocate its
    outputs and launch it on the current stream (no synchronisation).

    o, d: [R,3] f32; t_max: [R] f32 (<= 0 marks a dead lane); tris [9,T]
    f32 MT rows, T a multiple of 128 and at most KHIT_MAX_COLUMNS (the
    table resident in shared memory); gbox [6, T/128] f32 group AABBs and
    sbox [6, T/32] f32 sub-group AABBs; 1 <= k <= 8. Returns (ts [k,R]
    f32, pos [k,R] i32)."""
    fn = "ptt_khit"
    device = o.device
    if device.type != "cuda":
        raise ValueError(f"{fn}: needs CUDA tensors, got {device}")
    r = o.shape[0]
    t_n = tris.shape[1] if tris.dim() == 2 else -1
    _check("o", o, (r, 3), torch.float32, device)
    _check("d", d, (r, 3), torch.float32, device)
    _check("t_max", t_max, (r,), torch.float32, device)
    _check("tris", tris, (9, t_n), torch.float32, device)
    _check("gbox", gbox, (6, max(t_n, 0) // 128), torch.float32, device)
    if t_n <= 0 or t_n % 128 or 9 * t_n >= 2**31:
        raise ValueError(f"{fn}: {t_n} columns are not whole groups of 128")
    if not 0 < k <= 8 or k * r >= 2**31 or 3 * r >= 2**31:
        raise ValueError(f"{fn}: {r} rays x k = {k} out of range")
    _check("sbox", sbox, (6, t_n // 32), torch.float32, device)
    if t_n > KHIT_MAX_COLUMNS:
        raise ValueError(f"{fn}: {t_n} columns exceed the resident table "
                         f"({KHIT_MAX_COLUMNS})")
    lib = kernels().lib
    ts = torch.empty((k, r), dtype=torch.float32, device=device)
    pos = torch.empty((k, r), dtype=torch.int32, device=device)
    nxt = torch.zeros((1,), dtype=torch.int32, device=device)  # work counter
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.ptt_khit(o.data_ptr(), d.data_ptr(), t_max.data_ptr(),
                       tris.data_ptr(), gbox.data_ptr(), sbox.data_ptr(), r,
                       t_n, k, nxt.data_ptr(), ts.data_ptr(), pos.data_ptr(),
                       device.index, stream)
    if err != 0:
        raise RuntimeError(f"{fn}: launch failed with CUDA error {err}")
    return ts, pos


def _check_tree_tables(fn: str, nodes6, meta6, tris, n_nodes: int,
                       block: int, device) -> tuple[int, int]:
    """The superleaf tree tables a tree kernel reads; returns (npad,
    n_slots)."""
    npad = nodes6.shape[2] if nodes6.dim() == 3 else -1
    n_slots = tris.shape[1] if tris.dim() == 2 else -1
    _check("nodes6", nodes6, (6, 8, npad), torch.float32, device)
    _check("meta6", meta6, (6, 2, npad), torch.int32, device)
    _check("tris", tris, (9, n_slots), torch.float32, device)
    if not 0 < n_nodes <= npad or block <= 0 or block % 128 \
            or n_slots <= 0 or n_slots % block or 9 * n_slots >= 2**31 \
            or 48 * npad >= 2**31:
        raise ValueError(f"{fn}: {n_nodes} nodes of {npad} columns over "
                         f"{n_slots} slots in blocks of {block} are not a "
                         "superleaf tree")
    return npad, n_slots


# Rows 7 and 8's walk (csrc/tree_walk.cu): a leaf is served lane per ray
# from TREE_WALK_LANE_WISE rays of need (fewer: the leaf spread over the
# warp), and a lane's closest-hit gate admits a node whose slab entry is at
# most TREE_WALK_CUT_WIDEN times its best t. The plain walks
# (ops/cuda_bvh.py) and chip_smoke.py's visit count read both from here.
TREE_WALK_LANE_WISE = 26
TREE_WALK_CUT_WIDEN = 1.0 + 2.0 ** -8


def launch_tree_closest_hit(o, d, t_prev, nodes6, meta6, tris, n_nodes: int,
                            block: int):
    """Check the operands of the tree closest-hit kernel, allocate its
    outputs and launch it on the current stream (no synchronisation).

    o, d: [R,3] f32; t_prev: [R] f32 (+inf marks a dead lane); nodes6
    [6,8,Npad] f32, meta6 [6,2,Npad] i32 (the six directional layouts; the
    walk ends at ``n_nodes``); tris [9, n_blocks*block] f32 MT rows of the
    packed slots. A leaf is served lane per ray from TREE_WALK_LANE_WISE
    rays of need, read at each call (the in-leaf layouts give one result).
    Returns (fout [4,R] f32 (t, u, v, backface), iout [R] i32 packed slot,
    -1 on a miss)."""
    fn = "ptt_tree_closest_hit"
    device = o.device
    r = _check_rays(fn, o, d, t_prev, device)
    npad, n_slots = _check_tree_tables(fn, nodes6, meta6, tris, n_nodes,
                                       block, device)
    if 4 * r >= 2**31:
        raise ValueError(f"{fn}: {r} rays exceed int32 indexing")
    lib = kernels().lib
    fout = torch.empty((4, r), dtype=torch.float32, device=device)
    iout = torch.empty((r,), dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.ptt_tree_closest_hit(
        o.data_ptr(), d.data_ptr(), t_prev.data_ptr(), nodes6.data_ptr(),
        meta6.data_ptr(), tris.data_ptr(), r, npad, n_nodes, block, n_slots,
        TREE_WALK_LANE_WISE, TREE_WALK_CUT_WIDEN, fout.data_ptr(),
        iout.data_ptr(), device.index, stream)
    if err != 0:
        raise RuntimeError(f"{fn}: launch failed with CUDA error {err}")
    return fout, iout


def launch_tree_occluded(o, ds, t_maxes, nodes6, meta6, tris, n_nodes: int,
                         block: int):
    """Check the operands of the tree any-hit kernel, allocate its output
    and launch it on the current stream (no synchronisation).

    o: [R,3] f32; ds: [L,R,3] f32; t_maxes: [L,R] f32 (< 0 marks a dead
    lane); tables and the in-leaf layouts as for
    ``launch_tree_closest_hit``. Returns out [L,R] bool (occluded or
    dead)."""
    fn = "ptt_tree_occluded"
    device = o.device
    r, n_sets = _check_sets(fn, o, ds, t_maxes, device)
    npad, n_slots = _check_tree_tables(fn, nodes6, meta6, tris, n_nodes,
                                       block, device)
    lib = kernels().lib
    out = torch.empty((n_sets, r), dtype=torch.bool, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.ptt_tree_occluded(
        o.data_ptr(), ds.data_ptr(), t_maxes.data_ptr(), nodes6.data_ptr(),
        meta6.data_ptr(), tris.data_ptr(), r, n_sets, npad, n_nodes, block,
        n_slots, TREE_WALK_LANE_WISE, out.data_ptr(), device.index, stream)
    if err != 0:
        raise RuntimeError(f"{fn}: launch failed with CUDA error {err}")
    return out
