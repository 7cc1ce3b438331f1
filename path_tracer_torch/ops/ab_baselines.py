"""The designs the flat closest hit and the brute-force Möller-Trumbore
closest hit replaced, launched through their own symbols
(``csrc/ab_baselines.cu``), only to be timed against the current kernels in
turns on one card and to show that both designs give the same records.

Nothing on the main path reaches this module: ``chip_smoke.py``'s phase 3i
and one card test in ``tests/test_torch_cuda.py`` call it. The functions
take CUDA tensors only, count no launches and map their outputs exactly as
``cuda_bvh.closest_hit_triangles_flat`` and
``cuda_intersect.closest_hit_triangles_cuda`` do.
"""
from __future__ import annotations

import torch

from path_tracer_torch import native
from path_tracer_torch.ops.cuda_bvh import _record
from path_tracer_torch.ops.intersect import (
    KIND_NONE,
    KIND_TRIANGLE,
    HitRecord,
    _kind,
)


def flat_closest_hit_cta(o, d, t_prev, scene,
                         spheres: bool = False) -> HitRecord:
    """The flat closest hit through the CTA walk (one walk per 128 rays,
    every warp with a needing ray testing all slots of each block)."""
    fout, slot = native.launch_flat_closest_hit(
        o, d, t_prev, scene.sl_blkflat, scene.sl_blkid, scene.sl_bw_t,
        scene.sl_block, sph=scene.sph_packed_t if spheres else None,
        sph_row_base=scene.sph_row_base, fn="ptt_flat_closest_hit_cta")
    t = fout[0]
    kind = (fout[4] if spheres
            else torch.where(torch.isfinite(t), KIND_TRIANGLE, KIND_NONE))
    return _record(t, fout[1], fout[2], fout[3] != 0.0, slot, kind, scene)


def mt_closest_hit_chunked(o, d, t_prev, scene) -> HitRecord:
    """Brute-force Möller-Trumbore through the chunked design (one ray per
    thread, the table restaged per CTA 256 columns at a time)."""
    fout, iout = native.launch_closest_hit(
        "ptt_mt_closest_hit_chunked", o, d, t_prev, scene.tri_packed_t,
        table_rows=9, out_rows=4)
    t = fout[0]
    return HitRecord(t=t, kind=_kind(t, KIND_TRIANGLE), prim=iout, u=fout[1],
                     v=fout[2], backface=fout[3] != 0.0)
