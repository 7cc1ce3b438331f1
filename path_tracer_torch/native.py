"""Native builds at first use: the C++ BVH builder and the CUDA kernels.

Both are plain-C-ABI shared libraries loaded with ``ctypes`` and cached in
``build/path_tracer_torch/`` (git-ignored) under a hash of their sources and
flags, so a fresh checkout builds them on first call and later processes
reuse the files.

- ``bvh_prim_order`` compiles the JAX package's ``native/bvh.cpp`` with the
  same ``g++`` flags (``path_tracer_tpu/native/build.py``) and returns the
  binned-SAH leaf order the JAX scene builder stores every triangle array
  in. The source file is read by path; no module of the JAX package is
  imported.
- ``kernels`` compiles ``csrc/*.cu`` with ``nvcc`` for ``sm_90a``. No
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

import numpy as np
import torch

_PKG = Path(__file__).resolve().parent
_REPO = _PKG.parent
BUILD_DIR = _REPO / "build" / "path_tracer_torch"
BVH_SRC = _REPO / "path_tracer_tpu" / "native" / "bvh.cpp"
CSRC = _PKG / "csrc"

# Same flags as the JAX package's builder, so both give one permutation.
BVH_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_bvh_lib = None
_kernels = None


def _cached_build(name: str, sources: list[Path], cmd) -> tuple[Path, str]:
    """Build ``sources`` into BUILD_DIR/lib<name>_<hash>.so unless present.

    ``cmd(out)`` gives the compiler command line. Returns (path, compiler
    output). Concurrent builders each write a private temp file and rename
    it into place, so a reader never sees a partial library."""
    h = hashlib.sha1()
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(cmd(Path("out.so"))).encode())
    so_path = BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"
    if so_path.exists():
        return so_path, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so_path.with_suffix(f".{os.getpid()}.tmp.so")
    proc = subprocess.run(cmd(tmp), capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {name} failed:\n{proc.stdout}{proc.stderr}")
    tmp.replace(so_path)
    return so_path, proc.stdout + proc.stderr


def bvh_prim_order(bb_min: np.ndarray, bb_max: np.ndarray,
                   leaf_size: int = 4) -> np.ndarray:
    """Leaf order [n] int32 of the binned-SAH BVH over n primitive AABBs."""
    global _bvh_lib
    if _bvh_lib is None:
        path, _ = _cached_build(
            "ptt_torch_bvh", [BVH_SRC],
            lambda out: ["g++", *BVH_FLAGS, str(BVH_SRC), "-o", str(out)])
        lib = ctypes.CDLL(str(path))
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.ptt_build_bvh.restype = ctypes.c_int
        lib.ptt_build_bvh.argtypes = [f32p, f32p, ctypes.c_int, ctypes.c_int,
                                      f32p, f32p, i32p, i32p, i32p, i32p]
        _bvh_lib = lib
    bb_min = np.ascontiguousarray(bb_min, np.float32)
    bb_max = np.ascontiguousarray(bb_max, np.float32)
    n = bb_min.shape[0]
    if n == 0 or bb_max.shape != bb_min.shape or bb_min.shape[1:] != (3,):
        raise ValueError(f"need [n,3] boxes with n > 0, got {bb_min.shape}")
    cap = 2 * n
    node_min = np.empty((cap, 3), np.float32)
    node_max = np.empty((cap, 3), np.float32)
    ints = [np.empty(cap, np.int32) for _ in range(3)]
    order = np.empty(n, np.int32)
    n_nodes = _bvh_lib.ptt_build_bvh(bb_min, bb_max, n, int(leaf_size),
                                     node_min, node_max, *ints, order)
    if not 0 < n_nodes <= cap:
        raise RuntimeError(f"BVH build returned {n_nodes} nodes for {n} prims")
    return order


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


def kernels() -> Kernels:
    """Build (once per source hash) and load ``csrc/*.cu``."""
    global _kernels
    if _kernels is None:
        sources = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
        cus = [str(s) for s in sources if s.suffix == ".cu"]
        t0 = time.perf_counter()
        path, log = _cached_build(
            "ptt_torch_kernels", sources,
            lambda out: [_nvcc(), *NVCC_FLAGS, *cus, "-o", str(out)])
        seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(path))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        # (o, d, t_prev, table, R, N, fout, iout, device, stream)
        for fn in (lib.ptt_mt_closest_hit, lib.ptt_sphere_closest_hit):
            fn.restype = ci
            fn.argtypes = [vp, vp, vp, vp, ci, ci, vp, vp, ci, vp]
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


def launch_closest_hit(fn: str, o, d, t_prev, table, table_rows: int,
                       out_rows: int):
    """Check the operands of a closest-hit kernel, allocate its outputs and
    launch it on the current stream (no synchronisation).

    o, d: [R,3] f32; t_prev: [R] f32; table: [table_rows, N] f32, all
    contiguous on one CUDA device. Returns (fout [out_rows, R] f32,
    iout [R] i32). Raises on anything the kernel does not take and when the
    launch is refused."""
    device = o.device
    if device.type != "cuda":
        raise ValueError(f"{fn}: needs CUDA tensors, got {device}")
    r = o.shape[0]
    n = table.shape[1] if table.dim() == 2 else -1
    _check("o", o, (r, 3), torch.float32, device)
    _check("d", d, (r, 3), torch.float32, device)
    _check("t_prev", t_prev, (r,), torch.float32, device)
    _check("table", table, (table_rows, n), torch.float32, device)
    if 3 * r >= 2**31 or n >= 2**31:
        raise ValueError(f"{fn}: {r} rays x {n} columns exceed int32 indexing")
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
