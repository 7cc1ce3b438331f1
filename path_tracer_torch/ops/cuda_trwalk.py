"""The transparent walks' CUDA kernels: wrappers and launch counts.

- ``csrc/alpha_walk.cu`` replaces ``pallas_trwalk._alpha_kernel`` (entry
  ``alpha_walk``);
- ``csrc/trans_walk.cu`` replaces ``pallas_trwalk._trans_kernel`` and its
  tile body ``trans_tile`` (entry ``trans_walk``).

Both walk the scene's compact transparent table (``tr_*``) and keep the
contract of their plain versions in ``ops/trwalk.py``. Each has a live
variant (the JAX package's ``live_factor=True``, for a differentiable
render): given ``live`` (``trwalk.LiveTables``) the kernel reads its rows
and its f32 page plane, values read directly, where the forward variant
reads ``tr_rows`` and the u8 plane through the LUT; it is counted apart.
A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
plain version. Bound on the card: the Baldwin-Weber test of the columns in
the 128-column groups (``tr_grp``) each live lane's segment enters, once
per lane (twice for point lanes); see the sources for the design.
"""
from __future__ import annotations

import torch

from path_tracer_torch import native
from path_tracer_torch.ops.intersect import _detach_for_kernel
from path_tracer_torch.ops.trwalk import (
    AlphaWalk,
    TransWalk,
    alpha_walk_plain,
    trans_walk_plain,
)

# Kernel launches made by the wrappers in this process, forward and live.
alpha_launches = 0
trans_launches = 0
alpha_live_launches = 0
trans_live_launches = 0


@_detach_for_kernel
def alpha_walk(scene, o, d, t_op, rnd, steps_cap: int,
               live=None) -> AlphaWalk:
    """The alpha walk over the transparent table. o, d: [R,3] f32; t_op:
    [R] f32 (< 0 marks a dead lane); rnd: [steps_cap, R] f32; ``live``:
    the tables of a differentiable render, or None."""
    global alpha_launches, alpha_live_launches
    if o.device.type == "cpu":
        return alpha_walk_plain(scene, o, d, t_op, rnd, steps_cap, live)
    fout, col = native.launch_alpha_walk(
        o.contiguous(), d.contiguous(), t_op.contiguous(),
        rnd.narrow(0, 0, steps_cap).contiguous(), scene, steps_cap, live)
    if live is None:
        alpha_launches += 1
    else:
        alpha_live_launches += 1
    return AlphaWalk(fout[0], fout[1], fout[2], fout[3], fout[4] > 0.0,
                     fout[5] > 0.0, fout[6] > 0.0, fout[7], col)


@_detach_for_kernel
def trans_walk(scene, o, d, pd, is_pt, surf_pos, orig_uv, orig_simple,
               walking0, steps_cap: int, live=None) -> TransWalk:
    """The shadow transmittance walk over the transparent table (stacked
    lanes of all lights). o, d, surf_pos: [R,3]; pd: [R] distance to the
    light (+inf directional); is_pt, orig_simple, walking0: [R] bool;
    orig_uv: [R,2]; ``live`` as for ``alpha_walk``."""
    global trans_launches, trans_live_launches
    if o.device.type == "cpu":
        return trans_walk_plain(scene, o, d, pd, is_pt, surf_pos, orig_uv,
                                orig_simple, walking0, steps_cap, live)
    fout = native.launch_trans_walk(
        o.contiguous(), d.contiguous(),
        trans_aux(pd, is_pt, surf_pos, orig_uv, orig_simple, walking0),
        scene, steps_cap, live)
    if live is None:
        trans_launches += 1
    else:
        trans_live_launches += 1
    return TransWalk(fout[0], fout[1], fout[2] > 0.0)


def trans_aux(pd, is_pt, surf_pos, orig_uv, orig_simple, walking0):
    """The transmittance kernel's per-lane operands as one [8,R] f32 table:
    pd (-1 where the lane does not walk), is point, surface point xyz,
    original uv, original is sphere."""
    row = lambda x: x.to(torch.float32).unsqueeze(0)
    return torch.cat([row(torch.where(walking0, pd, -1.0)), row(is_pt),
                      surf_pos.T, orig_uv.T, row(orig_simple)]).contiguous()
