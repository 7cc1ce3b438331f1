"""The design row 6 (the sphere any-hit walk) replaced, launched through its
own symbol (``csrc/ab_baselines.cu``), only to be timed against the current
kernel in turns on one card and to hold the current kernel to it.

Nothing on the main path reaches this module: only ``chip_smoke.py``'s
phase 3q and ``tests/test_torch_cuda.py`` call it. The functions take CUDA
tensors only, count no launches and take their operands as
``native.launch_sph_occ_walk`` does. The replaced design gates as the
current kernel does: it gets the block boxes widened by
``slab.pad_boxes`` and widens each lane's interval itself.
"""
from __future__ import annotations

import torch

from path_tracer_torch import native
from path_tracer_torch.ops.slab import pad_boxes


def launch_sph_occ_walk_cta(o, ds, t_maxes, blk, blkid, sph):
    """Row 6's first port (a 128-ray CTA a set sharing one walk, each block
    staged behind CTA barriers): out [L,R] f32, 1 = occluded."""
    fn = "ptt_sph_occ_walk_cta"
    device = o.device
    r, n_sets = native._check_sets(fn, o, ds, t_maxes, device)
    sbpad, n_slots = native._check_sph_blocks(fn, blk, blkid, sph, device)
    widened = torch.cat([pad_boxes(blk), blk[6:8]]).contiguous()
    out = torch.empty((n_sets, r), dtype=torch.float32, device=device)
    err = native.kernels().lib.ptt_sph_occ_walk_cta(
        o.data_ptr(), ds.data_ptr(), t_maxes.data_ptr(), widened.data_ptr(),
        blkid.data_ptr(), sph.data_ptr(), r, n_sets, sbpad, n_slots,
        out.data_ptr(), device.index,
        torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn}: launch failed with CUDA error {err}")
    return out


def sph_occ_walk_cta(o, ds, t_maxes, blk, blkid, sph, prior=None):
    """[L,R] bool of the first port with ``prior`` ORed in ATen, as its
    wrapper did: ``native.launch_sph_occ_walk``'s result."""
    occ = launch_sph_occ_walk_cta(o, ds, t_maxes, blk, blkid, sph) > 0.0
    return occ if prior is None else prior | occ
