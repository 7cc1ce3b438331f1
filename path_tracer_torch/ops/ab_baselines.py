"""The design the superleaf tree walk (rows 7 and 8) replaced, launched
through its own symbols (``csrc/ab_baselines.cu``), only to be timed against
the current kernels in turns on one card and to log where the two designs
differ.

Nothing on the main path reaches this module: only ``chip_smoke.py``'s
phase 3n calls it. The functions take CUDA tensors only, count no launches
and take their operands as ``cuda_bvh.closest_hit_triangles_tree`` and
``cuda_bvh.occluded_triangles_tree_multi`` do; the old any-hit launches
once per set, as ``occluded_multi`` called it.
"""
from __future__ import annotations

import torch

from path_tracer_torch import native
from path_tracer_torch.ops.cuda_bvh import tree_record
from path_tracer_torch.ops.intersect import HitRecord


def _tables(fn: str, scene, device):
    npad, n_slots = native._check_tree_tables(
        fn, scene.sl_nodes6, scene.sl_meta6, scene.sl_tris_t,
        scene.sl_n_nodes, scene.sl_block, device)
    return (scene.sl_nodes6.data_ptr(), scene.sl_meta6.data_ptr(),
            scene.sl_tris_t.data_ptr()), (npad, scene.sl_n_nodes,
                                          scene.sl_block, n_slots)


def launch_tree_closest_hit_cta(o, d, t_prev, scene):
    """The CTA walk's closest-hit launch: (fout [4,R] f32 rows t, u, v,
    backface 0/1; iout [R] i32 packed slot)."""
    fn = "ptt_tree_closest_hit_cta"
    device = o.device
    r = native._check_rays(fn, o, d, t_prev, device)
    ptrs, sizes = _tables(fn, scene, device)
    fout = torch.empty((4, r), dtype=torch.float32, device=device)
    iout = torch.empty((r,), dtype=torch.int32, device=device)
    err = native.kernels().lib.ptt_tree_closest_hit_cta(
        o.data_ptr(), d.data_ptr(), t_prev.data_ptr(), *ptrs, r, *sizes,
        fout.data_ptr(), iout.data_ptr(), device.index,
        torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn}: launch failed with CUDA error {err}")
    return fout, iout


def closest_hit_triangles_tree_cta(o, d, t_prev, scene) -> HitRecord:
    """The tree closest hit as it was: one 128-ray CTA a packet, every lane
    testing every leaf some lane admits."""
    fout, slot = launch_tree_closest_hit_cta(o, d, t_prev, scene)
    return tree_record(fout[0], fout[1], fout[2], fout[3] != 0.0, slot, scene)


def launch_tree_occluded_cta(o, d, t_max, scene):
    """The CTA walk's any-hit launch for one set: out [R] f32 (1 =
    occluded or dead)."""
    fn = "ptt_tree_occluded_cta"
    device = o.device
    r = native._check_rays(fn, o, d, t_max, device)
    ptrs, sizes = _tables(fn, scene, device)
    out = torch.empty((r,), dtype=torch.float32, device=device)
    err = native.kernels().lib.ptt_tree_occluded_cta(
        o.data_ptr(), d.data_ptr(), t_max.data_ptr(), *ptrs, r, *sizes,
        out.data_ptr(), device.index,
        torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn}: launch failed with CUDA error {err}")
    return out


def occluded_triangles_tree_cta_multi(o, ds, t_maxes, scene) -> torch.Tensor:
    """The tree any-hit as ``occluded_multi`` called it: one launch per set,
    each compared with 0, stacked: [L,R] bool."""
    o = o.contiguous()
    return torch.stack([
        launch_tree_occluded_cta(o, d.contiguous(), tm.contiguous(), scene)
        > 0.0 for d, tm in zip(ds, t_maxes)])
