"""The transparent walks' CUDA kernels: wrappers and launch counts.

- ``csrc/alpha_walk.cu`` replaces ``pallas_trwalk._alpha_kernel`` (entry
  ``alpha_walk``);
- ``csrc/trans_walk.cu`` replaces ``pallas_trwalk._trans_kernel`` and its
  tile body ``trans_tile`` (entry ``trans_walk``).

Both walk the scene's compact transparent table (``tr_*``) and keep the
contract of their plain versions in ``ops/trwalk.py``. A CUDA tensor
launches the kernel (or raises); a CPU tensor takes the plain version.
Bound on the card: the Baldwin-Weber test of every table column per walk
step; see the sources for the design.
"""
from __future__ import annotations

import torch

from path_tracer_torch import native
from path_tracer_torch.ops.trwalk import (
    AlphaWalk,
    TransWalk,
    alpha_walk_plain,
    trans_walk_plain,
)

# Kernel launches made by the wrappers in this process.
alpha_launches = 0
trans_launches = 0


def alpha_walk(scene, o, d, t_op, rnd, steps_cap: int) -> AlphaWalk:
    """The alpha walk over the transparent table. o, d: [R,3] f32; t_op:
    [R] f32 (< 0 marks a dead lane); rnd: [steps_cap, R] f32."""
    global alpha_launches
    if o.device.type == "cpu":
        return alpha_walk_plain(scene, o, d, t_op, rnd, steps_cap)
    fout, col = native.launch_alpha_walk(
        o.contiguous(), d.contiguous(), t_op.contiguous(),
        rnd.narrow(0, 0, steps_cap).contiguous(), scene, steps_cap)
    alpha_launches += 1
    return AlphaWalk(fout[0], fout[1], fout[2], fout[3], fout[4] > 0.0,
                     fout[5] > 0.0, fout[6] > 0.0, fout[7], col)


def trans_walk(scene, o, d, pd, is_pt, surf_pos, orig_uv, orig_simple,
               walking0, steps_cap: int) -> TransWalk:
    """The shadow transmittance walk over the transparent table (stacked
    lanes of all lights). o, d, surf_pos: [R,3]; pd: [R] distance to the
    light (+inf directional); is_pt, orig_simple, walking0: [R] bool;
    orig_uv: [R,2]."""
    global trans_launches
    if o.device.type == "cpu":
        return trans_walk_plain(scene, o, d, pd, is_pt, surf_pos, orig_uv,
                                orig_simple, walking0, steps_cap)
    row = lambda x: x.to(torch.float32).unsqueeze(0)
    aux = torch.cat([row(torch.where(walking0, pd, -1.0)), row(is_pt),
                     surf_pos.T, orig_uv.T, row(orig_simple)]).contiguous()
    fout = native.launch_trans_walk(o.contiguous(), d.contiguous(), aux,
                                    scene, steps_cap)
    trans_launches += 1
    return TransWalk(fout[0], fout[1], fout[2] > 0.0)
