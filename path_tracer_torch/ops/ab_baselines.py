"""The designs the sphere block walk and the dense sphere any-hit replaced,
launched through their own symbols (``csrc/ab_baselines.cu``), only to be
timed against the current kernels in turns on one card and to show that
the two designs agree.

Nothing on the main path reaches this module: ``chip_smoke.py``'s phase 3m
and two card tests in ``tests/test_torch_cuda.py`` call it. The functions
take CUDA tensors only, count no launches and take their operands as
``cuda_spheres.closest_hit_spheres_cuda`` and
``cuda_spheres.occluded_spheres_cuda`` do, so either can stand in for its
kernel's wrapper, the ATen ops around the old launches included.
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


def launch_sph_walk_cta(o, d, t_prev, scene):
    """The CTA walk's launch alone: (fout [2,R] f32 rows t, backface 0/1;
    iout [R] i32 sorted slot)."""
    fn = "ptt_sph_walk_cta"
    device = o.device
    r = native._check_rays(fn, o, d, t_prev, device)
    sbpad, n_slots = native._check_sph_blocks(
        fn, scene.sph_blk, scene.sph_blkid, scene.sph_sorted_t, device)
    lib = native.kernels().lib
    fout = torch.empty((2, r), dtype=torch.float32, device=device)
    iout = torch.empty((r,), dtype=torch.int32, device=device)
    err = lib.ptt_sph_walk_cta(
        o.data_ptr(), d.data_ptr(), t_prev.data_ptr(),
        scene.sph_blk.data_ptr(), scene.sph_blkid.data_ptr(),
        scene.sph_sorted_t.data_ptr(), r, sbpad, n_slots, fout.data_ptr(),
        iout.data_ptr(), device.index,
        torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn}: launch failed with CUDA error {err}")
    return fout, iout


@_detach_for_kernel
def closest_hit_spheres_walk_cta(o, d, t_prev, scene, tri=None) -> HitRecord:
    """The sphere block walk as it was: the CTA walk's (t, backface, sorted
    slot), mapped to a HitRecord by ATen ops (prim through ``sph_smap``)
    and merged with the triangle record ``tri`` by ``merge_hits``."""
    if not getattr(scene, "sph_use_blocks", False):
        raise ValueError("the replaced sphere walk serves no dense table")
    fout, slot = launch_sph_walk_cta(o, d, t_prev, scene)
    t = fout[0]
    hit = torch.isfinite(t)
    prim = torch.where(hit, scene.sph_smap[slot.clamp(min=0).long()], 0)
    zeros = torch.zeros_like(t)
    sph = HitRecord(t=t, kind=_kind(t, KIND_SPHERE),
                    prim=prim.to(torch.int32), u=zeros, v=zeros,
                    backface=fout[1] != 0.0)
    return sph if tri is None else merge_hits(tri, sph)


def launch_sph_occluded_chunked(o, ds, t_maxes, scene):
    """The chunked dense any-hit's launch alone, on stacked sets: out [L,R]
    f32 (1 = occluded, dead lanes 0)."""
    fn = "ptt_sph_occluded_chunked"
    device = o.device
    r, n_sets = native._check_sets(fn, o, ds, t_maxes, device)
    sph = scene.sph_packed_t
    lib = native.kernels().lib
    out = torch.empty((n_sets, r), dtype=torch.float32, device=device)
    err = lib.ptt_sph_occluded_chunked(
        o.data_ptr(), ds.data_ptr(), t_maxes.data_ptr(), sph.data_ptr(), r,
        n_sets, scene.num_real_spheres, sph.shape[1], out.data_ptr(),
        device.index, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn}: launch failed with CUDA error {err}")
    return out


@_detach_for_kernel
def occluded_spheres_chunked(o, ds, t_maxes, scene,
                             prior=None) -> torch.Tensor:
    """The dense sphere any-hit as it was: the directions and t_max stacked,
    the chunked kernel, ``out > 0.0`` and, with ``prior``, an ATen OR:
    [L,R] bool."""
    if getattr(scene, "sph_use_blocks", False):
        raise ValueError("the replaced dense any-hit serves no sphere walk")
    out = launch_sph_occluded_chunked(
        o.contiguous(), torch.stack(list(ds)).contiguous(),
        torch.stack(list(t_maxes)).contiguous(), scene) > 0.0
    return out if prior is None else prior | out
