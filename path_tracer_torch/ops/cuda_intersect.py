"""Brute-force Möller-Trumbore closest hit: the CUDA kernel's wrapper.

Counterpart of ``path_tracer_tpu/ops/pallas_intersect.py``: the kernel
``csrc/mt_closest_hit.cu`` replaces ``pallas_intersect._kernel`` (entry
``closest_hit_triangles_pallas``). It serves every scene under the BVH
threshold (4,096 triangles), for the closest hit and, through
``intersect.occluded_multi`` (light by light), the shadow cast's
nearest-hit check.

Bound on the card: arithmetic — about 30 flops and one IEEE reciprocal per
ray-triangle test, R*N tests; the [9, N] table is a broadcast read. The
kernel stages the table in shared memory 256 columns at a time and keeps
each ray's running best in registers (see the source for the design).

The plain version is ``intersect.closest_hit_triangles``, the port of the
jnp reference path, on the same scene arrays (``tri_v0/e1/e2`` hold the
same triangles in the same order as the packed ``tri_packed_t``).
"""
from __future__ import annotations

from path_tracer_torch import native
from path_tracer_torch.ops.intersect import (
    KIND_TRIANGLE,
    HitRecord,
    _kind,
    closest_hit_triangles,
)
from path_tracer_torch.utils.telemetry import counters


def closest_hit_triangles_cuda(o, d, t_prev, scene) -> HitRecord:
    """Closest triangle hit of each ray with t > max(1e-6, t_prev).

    o, d: [R,3] f32; t_prev: [R] f32 (+inf marks a dead lane); reads
    ``scene.tri_packed_t`` [9, N]. CUDA tensors launch the kernel (or
    raise); CPU tensors take the plain version."""
    if o.device.type == "cpu":
        return closest_hit_triangles(o, d, t_prev, scene)
    fout, iout = native.launch_closest_hit(
        "ptt_mt_closest_hit", o, d, t_prev, scene.tri_packed_t,
        table_rows=9, out_rows=4)
    counters["launch.mt_closest_hit"] += 1
    t = fout[0]
    return HitRecord(t=t, kind=_kind(t, KIND_TRIANGLE), prim=iout, u=fout[1],
                     v=fout[2], backface=fout[3] != 0.0)

