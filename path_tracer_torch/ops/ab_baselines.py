"""The designs rows 15 and 3 replaced, launched through their own symbols
(``csrc/ab_baselines.cu``), only to be timed against the current kernels in
turns on one card and to hold the current kernels to them.

Nothing on the main path reaches this module: only ``chip_smoke.py``'s
phase 3o and ``tests/test_torch_cuda.py`` call it. The functions take CUDA
tensors only, count no launches and take their operands as
``cuda_shadow.fused_shadow`` and ``cuda_khit.k_nearest_tr_hits`` do. Both
gate as the current kernels do: the fused kernel's first port gets the
opaque view's block boxes widened by ``slab.pad_boxes`` (it widens each
lane's interval itself), row 3's first port widens its group boxes in the
kernel.
"""
from __future__ import annotations

import torch

from path_tracer_torch import native
from path_tracer_torch.ops.cuda_shadow import launch_operands
from path_tracer_torch.ops.slab import pad_boxes


def launch_fused_shadow_cta(scene, s_o, dirs, t_maxes, pds, is_pt, surf_pos,
                            orig_uv, orig_simple, steps_cap: int, live=None):
    """The fused shadow kernel's first port (a 128-ray CTA a light, the CTA
    any-hit then the CTA transmittance walk): out [3L,R] f32, as
    ``native.launch_fused_shadow``."""
    fn = "ptt_fused_shadow_cta"
    o, ds, tms, pd, aux, pts, blk, blkid, bw, block = launch_operands(
        scene, s_o, dirs, t_maxes, pds, is_pt, surf_pos, orig_uv,
        orig_simple)
    device = o.device
    r, n_sets = native._check_sets(fn, o, ds, tms, device)
    bpad, n_cols = native._check_flat_tables(fn, blk, blkid, bw, block,
                                             device)
    t_cols, wp, rows, tex = native._check_tr_tables(fn, scene, device, live)
    widened = torch.cat([pad_boxes(blk), blk[6:8]]).contiguous()
    out = torch.empty((3 * n_sets, r), dtype=torch.float32, device=device)
    err = native.kernels().lib.ptt_fused_shadow_cta(
        o.data_ptr(), ds.data_ptr(), tms.data_ptr(), pd.data_ptr(),
        aux.data_ptr(), sum(1 << k for k, pt in enumerate(pts) if pt),
        widened.data_ptr(), blkid.data_ptr(), bw.data_ptr(), bpad, block,
        n_cols, scene.tr_bw.data_ptr(), rows.data_ptr(), tex.data_ptr(),
        scene.tr_lut.data_ptr(), scene.tr_page_table.data_ptr(), t_cols, wp,
        r, n_sets, steps_cap, int(scene.tr_textured), int(live is not None),
        out.data_ptr(), device.index,
        torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn}: launch failed with CUDA error {err}")
    return out


def fused_shadow_cta(scene, s_o, dirs, t_maxes, pds, is_pt, surf_pos,
                     orig_uv, orig_simple, steps_cap: int, live=None):
    """(trans_eff, t_prev, still) [L,R] of the first port, as
    ``cuda_shadow.fused_shadow`` returns them."""
    out = launch_fused_shadow_cta(scene, s_o, dirs, t_maxes, pds, is_pt,
                                  surf_pos, orig_uv, orig_simple, steps_cap,
                                  live).view(len(dirs), 3, -1)
    return out[:, 0], out[:, 1], out[:, 2] > 0.0


def launch_khit_cta(o, d, t_max, tris, gbox, k: int):
    """Row 3's first port (one thread per ray, a 128-ray CTA staging each
    group some lane reaches): (ts [k,R] f32, pos [k,R] i32), as
    ``native.launch_khit``."""
    fn = "ptt_khit_cta"
    r, t_n = native.check_khit(fn, o, d, t_max, tris, gbox, k)
    device = o.device
    ts = torch.empty((k, r), dtype=torch.float32, device=device)
    pos = torch.empty((k, r), dtype=torch.int32, device=device)
    err = native.kernels().lib.ptt_khit_cta(
        o.data_ptr(), d.data_ptr(), t_max.data_ptr(), tris.data_ptr(),
        gbox.data_ptr(), r, t_n, k, ts.data_ptr(), pos.data_ptr(),
        device.index, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn}: launch failed with CUDA error {err}")
    return ts, pos


def k_nearest_tr_hits_cta(o, d, active, scene, k: int, t_max=None):
    """Row 3's first port on ``cuda_khit.k_nearest_tr_hits``'s
    arguments."""
    r = o.shape[0]
    if t_max is None:
        t_max = torch.full((r,), float("inf"), device=o.device)
    tm = torch.where(active, t_max, -1.0).contiguous()
    return launch_khit_cta(o.contiguous(), d.contiguous(), tm,
                           scene.khit_tris, scene.khit_gbox, k)
