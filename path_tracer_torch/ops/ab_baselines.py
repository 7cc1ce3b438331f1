"""The designs the alpha walk and the transmittance walk replaced, launched
through their own symbols (``csrc/ab_baselines.cu``), only to be timed
against the current kernels in turns on one card and to show that the two
designs agree.

Nothing on the main path reaches this module: ``chip_smoke.py``'s phase 3k
and two card tests in ``tests/test_torch_cuda.py`` call it. The functions
take CUDA tensors only, count no launches and take and map their operands
exactly as ``cuda_trwalk.alpha_walk`` and ``cuda_trwalk.trans_walk`` do,
so either can stand in for its kernel's wrapper.
"""
from __future__ import annotations

from path_tracer_torch import native
from path_tracer_torch.ops.cuda_trwalk import trans_aux
from path_tracer_torch.ops.intersect import _detach_for_kernel
from path_tracer_torch.ops.trwalk import AlphaWalk, TransWalk


@_detach_for_kernel
def alpha_walk_cta(scene, o, d, t_op, rnd, steps_cap: int,
                   live=None) -> AlphaWalk:
    """The alpha walk through the CTA walk (128 lanes share each step, the
    table streamed through shared memory in 256-column chunks)."""
    fout, col = native._launch_alpha_walk(
        "ptt_alpha_walk_cta", o.contiguous(), d.contiguous(),
        t_op.contiguous(), rnd.narrow(0, 0, steps_cap).contiguous(), scene,
        steps_cap, live)
    return AlphaWalk(fout[0], fout[1], fout[2], fout[3], fout[4] > 0.0,
                     fout[5] > 0.0, fout[6] > 0.0, fout[7], col)


@_detach_for_kernel
def trans_walk_cta(scene, o, d, pd, is_pt, surf_pos, orig_uv, orig_simple,
                   walking0, steps_cap: int, live=None) -> TransWalk:
    """The transmittance walk through the CTA walk (``trans_lane_cta``,
    the body row 15 keeps)."""
    fout = native._launch_trans_walk(
        "ptt_trans_walk_cta", o.contiguous(), d.contiguous(),
        trans_aux(pd, is_pt, surf_pos, orig_uv, orig_simple, walking0),
        scene, steps_cap, live)
    return TransWalk(fout[0], fout[1], fout[2] > 0.0)
