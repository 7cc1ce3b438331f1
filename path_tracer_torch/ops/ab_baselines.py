"""The designs the flat any-hit and the flat2 closest hit replaced, launched
through their own symbols (``csrc/ab_baselines.cu``), only to be timed
against the current kernels in turns on one card and to show where the two
designs' results part.

Nothing on the main path reaches this module: ``chip_smoke.py``'s phase 3j
and two card tests in ``tests/test_torch_cuda.py`` call it. The functions
take CUDA tensors only, count no launches and map their outputs exactly as
``cuda_bvh.occluded_triangles_flat_multi`` and
``cuda_bvh.closest_hit_triangles_flat2`` do.
"""
from __future__ import annotations

import torch

from path_tracer_torch import native
from path_tracer_torch.ops.cuda_bvh import _record
from path_tracer_torch.ops.intersect import KIND_NONE, KIND_TRIANGLE, HitRecord


def flat_occluded_cta_multi(o, ds, t_maxes, scene) -> torch.Tensor:
    """The flat any-hit through the CTA walk (one walk per 128 rays of a
    set, blocks staged behind CTA barriers): [L,R] bool."""
    out = native._launch_flat_occluded(
        "ptt_flat_occluded_cta", o.contiguous(),
        torch.stack(list(ds)).contiguous(),
        torch.stack(list(t_maxes)).contiguous(), scene.sl_blkflat,
        scene.sl_blkid, scene.sl_bw_t, scene.sl_block)
    return out > 0.0


def flat2_closest_hit_cta(o, d, t_prev, scene) -> HitRecord:
    """The flat2 closest hit through the CTA walk (superblocks and blocks
    nearest first, cut at the lanes' best t)."""
    fout, slot = native._launch_flat2_closest_hit(
        "ptt_flat2_closest_hit_cta", o, d, t_prev, scene.sl_sbflat,
        scene.sl_sbid, scene.sl_blkflat, scene.sl_blkid, scene.sl_bw_t,
        scene.sl_block)
    t = fout[0]
    kind = torch.where(torch.isfinite(t), KIND_TRIANGLE, KIND_NONE)
    return _record(t, fout[1], fout[2], fout[3] != 0.0, slot, kind, scene)
