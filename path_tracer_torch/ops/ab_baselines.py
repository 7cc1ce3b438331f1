"""The designs the flat2 any-hit and the dense sphere closest hit replaced,
launched through their own symbols (``csrc/ab_baselines.cu``), only to be
timed against the current kernels in turns on one card and to show that
the two designs agree.

Nothing on the main path reaches this module: ``chip_smoke.py``'s phase 3l
and two card tests in ``tests/test_torch_cuda.py`` call it. The functions
take CUDA tensors only, count no launches and take their operands as
``cuda_bvh.occluded_triangles_flat2_multi`` and
``cuda_spheres.closest_hit_spheres_cuda`` do, so either can stand in for
its kernel's wrapper.
"""
from __future__ import annotations

import torch

from path_tracer_torch import native
from path_tracer_torch.ops.intersect import (
    KIND_SPHERE,
    HitRecord,
    _detach_for_kernel,
    _kind,
    merge_hits,
)


@_detach_for_kernel
def occluded_triangles_flat2_cta(o, ds, t_maxes, scene) -> torch.Tensor:
    """The flat2 any-hit through the CTA walk (128 rays share one cursor,
    each visited block staged in shared memory behind CTA barriers):
    [L,R] bool."""
    out = native._launch_flat2_occluded(
        "ptt_flat2_occluded_cta", o.contiguous(),
        torch.stack(list(ds)).contiguous(),
        torch.stack(list(t_maxes)).contiguous(), scene.sl_sbflat,
        scene.sl_sbid, scene.sl_blkflat, scene.sl_blkid, scene.sl_bw_t,
        scene.sl_block)
    return out > 0.0


@_detach_for_kernel
def closest_hit_spheres_chunked(o, d, t_prev, scene, tri=None) -> HitRecord:
    """The dense sphere closest hit as it was: the chunked kernel's (t,
    backface, prim), mapped to a HitRecord by ATen ops and merged with the
    triangle record ``tri`` by ``merge_hits`` (six ``torch.where``)."""
    if getattr(scene, "sph_use_blocks", False):
        raise ValueError("the replaced dense kernel serves no sphere walk")
    fout, iout = native.launch_closest_hit(
        "ptt_sphere_closest_hit_chunked", o, d, t_prev, scene.sph_packed_t,
        table_rows=4, out_rows=2)
    t = fout[0]
    zeros = torch.zeros_like(t)
    sph = HitRecord(t=t, kind=_kind(t, KIND_SPHERE), prim=iout, u=zeros,
                    v=zeros, backface=fout[1] != 0.0)
    return sph if tri is None else merge_hits(tri, sph)
