"""The fused shadow kernel's wrapper and launch count, and its plain version.

``csrc/fused_shadow.cu`` replaces ``pallas_shadow._shadow_kernel`` (entry
``fused_shadow`` of ``path_tracer_tpu/ops/pallas_shadow.py``): for every
light of a bounce, the flat any-hit over the opaque partition
(``csrc/flat_occluded.cu``'s per-set body) and then the transmittance walk
over the transparent table (``csrc/trans_walk.cu``'s per-lane body), in
one launch. The plain version is the composition of the two kernels' plain
versions (``cuda_bvh.occluded_triangles_flat_multi_plain`` over the opaque
view, ``trwalk.trans_walk_plain`` over the stacked lanes), so the fused
kernel, the two launches and the plain version agree on every lane.
Its live variant (the JAX package's ``live=True``, for a differentiable
render) reads ``trwalk.LiveTables`` in the walk phase, as the live
transmittance walk does, and is counted apart. A CUDA tensor launches the
kernel (or raises); a CPU tensor takes the plain version. Bound on the
card: the sum of the two kernels' arithmetic; see the source for the
design.
"""
from __future__ import annotations

import torch

from path_tracer_torch import native
from path_tracer_torch.ops.cuda_bvh import occluded_triangles_flat_multi_plain
from path_tracer_torch.ops.intersect import _detach_for_kernel
from path_tracer_torch.ops.trwalk import trans_walk_plain
from path_tracer_torch.scene.device_scene import opaque_view

# Kernel launches made by fused_shadow in this process, forward and live.
launches = 0
live_launches = 0


def fused_shadow_plain(scene, s_o, dirs, t_maxes, pds, is_pt, surf_pos,
                       orig_uv, orig_simple, steps_cap: int, live=None):
    """Plain version of ``fused_shadow``, on any device: the flat any-hit
    over the opaque view, then the transmittance walk of the stacked lanes
    with pd = -1 where the any-hit blocked (on ``live``'s tables when
    given)."""
    n_l, r = len(dirs), s_o.shape[0]
    occ = occluded_triangles_flat_multi_plain(s_o, dirs, t_maxes,
                                              opaque_view(scene))
    pd3 = torch.where(occ, -1.0, torch.stack(list(pds))).reshape(n_l * r)
    is_pt3 = torch.cat([torch.full((r,), bool(pt), device=s_o.device)
                        for pt in is_pt])
    w = trans_walk_plain(scene, s_o.repeat(n_l, 1), torch.cat(list(dirs)),
                         pd3, is_pt3, surf_pos.repeat(n_l, 1),
                         orig_uv.repeat(n_l, 1), orig_simple.repeat(n_l),
                         torch.ones_like(is_pt3), steps_cap, live)
    trans = torch.where(occ, 0.0, w.trans.view(n_l, r))
    return trans, w.t_prev.view(n_l, r), w.still.view(n_l, r)


def launch_operands(scene, s_o, dirs, t_maxes, pds, is_pt, surf_pos,
                    orig_uv, orig_simple) -> tuple:
    """The kernel's operands from ``fused_shadow``'s arguments, in
    ``native.launch_fused_shadow``'s order up to ``block``: the stacked
    sets, the aux rows and the opaque view's flat tables."""
    c = scene.sl_cols_opaque  # the opaque view's block columns
    stack = lambda xs: torch.stack(list(xs)).contiguous()
    aux = torch.cat([surf_pos.T, orig_uv.T,
                     orig_simple.to(torch.float32).unsqueeze(0)]).contiguous()
    return (s_o.contiguous(), stack(dirs), stack(t_maxes), stack(pds), aux,
            tuple(bool(pt) for pt in is_pt),
            scene.sl_blkflat.narrow(1, 0, c).contiguous(),
            scene.sl_blkid.narrow(1, 0, c).contiguous(), scene.sl_bw_t,
            scene.sl_block)


@_detach_for_kernel
def fused_shadow(scene, s_o, dirs, t_maxes, pds, is_pt, surf_pos, orig_uv,
                 orig_simple, steps_cap: int, live=None):
    """Every light's shadow against a partitioned scene: the opaque any-hit
    and the transparent transmittance, in one launch.

    s_o: [R,3] shadow origins; dirs: L [R,3]; t_maxes: L [R] any-hit
    limits (< 0 marks a dead lane); pds: L [R] transmittance windows (+inf
    directional, the distance to the light for a point light, -1 a lane
    that does not walk); is_pt: L bools; surf_pos [R,3], orig_uv [R,2],
    orig_simple [R] bool of the shaded hit. Returns (trans_eff, t_prev,
    still), each [L,R]: trans_eff is 0 where the any-hit blocked (dead
    lanes included), else the transmittance (1 where pd < 0); lanes still
    walking past ``steps_cap`` go on outside. ``live``: the
    ``trwalk.LiveTables`` of a differentiable render, or None."""
    global launches, live_launches
    if s_o.device.type == "cpu":
        return fused_shadow_plain(scene, s_o, dirs, t_maxes, pds, is_pt,
                                  surf_pos, orig_uv, orig_simple, steps_cap,
                                  live)
    n_l, r = len(dirs), s_o.shape[0]
    out = native.launch_fused_shadow(
        *launch_operands(scene, s_o, dirs, t_maxes, pds, is_pt, surf_pos,
                         orig_uv, orig_simple), scene, steps_cap, live)
    if live is None:
        launches += 1
    else:
        live_launches += 1
    out = out.view(n_l, 3, r)
    return out[:, 0], out[:, 1], out[:, 2] > 0.0
