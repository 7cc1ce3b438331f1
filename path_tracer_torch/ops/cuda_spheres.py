"""Dense sphere closest hit: the CUDA kernel's wrapper.

Counterpart of ``path_tracer_tpu/ops/pallas_spheres.py``: the kernel
``csrc/sphere_closest_hit.cu`` replaces ``pallas_spheres._kernel`` (entry
``closest_hit_spheres_pallas``) for scenes of at most 512 spheres.

Bound on the card: arithmetic — R*S quadratic solves (about 25 flops, a
sqrt and two IEEE divisions per valid discriminant); the [4, S] table is
staged in shared memory and read as a broadcast.

Tolerance against the plain version (``intersect.closest_hit_spheres``):
both divide by 2a (the TPU kernel multiplies by 1/(2a)), sum in the same
order, and the library is built with ``-fmad=false``, so every operation
rounds the same way and the two should agree exactly. The bounds held on
the card are the repo's own: at most 1e-4 of lanes differing in kind or
prim, and 5e-5 relative t error on agreeing lanes.
"""
from __future__ import annotations

import torch

from path_tracer_torch import native
from path_tracer_torch.ops.intersect import (
    KIND_SPHERE,
    HitRecord,
    _kind,
    closest_hit_spheres,
)

# Kernel launches made by closest_hit_spheres_cuda in this process.
launches = 0


def closest_hit_spheres_cuda(o, d, t_prev, scene) -> HitRecord:
    """Nearest sphere root of each ray that is >= 0 and > t_prev.

    o, d: [R,3] f32; t_prev: [R] f32 (+inf marks a dead lane); reads
    ``scene.sph_packed_t`` [4, S]. CUDA tensors launch the kernel (or
    raise); CPU tensors take the plain version."""
    global launches
    if o.device.type == "cpu":
        return closest_hit_spheres(o, d, t_prev, scene)
    fout, iout = native.launch_closest_hit(
        "ptt_sphere_closest_hit", o, d, t_prev, scene.sph_packed_t,
        table_rows=4, out_rows=2)
    launches += 1
    t = fout[0]
    zeros = torch.zeros_like(t)
    return HitRecord(t=t, kind=_kind(t, KIND_SPHERE), prim=iout, u=zeros,
                     v=zeros, backface=fout[1] != 0.0)
