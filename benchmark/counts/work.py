"""The work a hand-written kernel's launch needs, counted from its inputs.

Frozen copies of the repository's kernel accounting (``chip_smoke.py``'s
``bound``, ``flat_work``, ``flat2_work``, ``needed_gate``, ``rows_bytes``,
``walk_needed``, and the slab and group gates they call), so that a later
change to the program cannot move the yardstick. A launch's least time is
the larger of its FP32 operations over the peak FP32 rate and its bytes
(inputs read once, outputs written once) over the peak HBM rate; the
operations count what these rays need whatever implements it:

- the flat and flat2 walks (rows 9-12): a slab test of every real block
  (flat2: superblock, then the blocks of each superblock entered) per
  live ray, and a Baldwin-Weber test of every real slot of each block the
  ray enters before its closest hit's t (any-hit: within t_max; an
  occluded ray needs one test);
- the transparent walks (rows 13, 14): a Baldwin-Weber test of every real
  column of each 128-column group the lane's segment enters, once per
  live lane.

Functions take the program's own tables (the tensors the launch read) and
the launch's inputs and outputs.
"""
from __future__ import annotations

import torch

# Peak rates of one NVIDIA H100 SXM at 700 W (NVIDIA's data sheet): FP32
# outside the tensor cores, and HBM bandwidth.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# FP32 operations per test, counted from the kernels' expressions: one
# Baldwin-Weber test, one slab test of a block AABB, the centred sphere
# quadratic.
OPS_BW, OPS_SLAB, OPS_SPHERE = 32, 22, 25


def least_seconds(ops: float, n_bytes: float) -> float:
    """The least time the card could take for ``ops`` FP32 operations
    moving ``n_bytes``."""
    return max(ops / PEAK_FP32, n_bytes / PEAK_BYTES)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# --- gates ----------------------------------------------------------------

def safe_inv(d):
    zero = d == 0.0
    return torch.where(zero, 1e30, 1.0 / torch.where(zero, 1.0, d))


def slab(o, inv, boxes):
    """Slab entry and exit [R, C] of every ray against AABB columns."""
    t0 = [(boxes[k][None, :] - o[:, k:k + 1]) * inv[:, k:k + 1]
          for k in range(3)]
    t1 = [(boxes[3 + k][None, :] - o[:, k:k + 1]) * inv[:, k:k + 1]
          for k in range(3)]
    lo = [torch.minimum(a, b) for a, b in zip(t0, t1)]
    hi = [torch.maximum(a, b) for a, b in zip(t0, t1)]
    tn = torch.maximum(torch.maximum(lo[0], lo[1]), lo[2])
    tf = torch.minimum(torch.minimum(hi[0], hi[1]), hi[2])
    return tn, tf


def closest_gate(tn, tf, t_prev, ids):
    return ((tf >= torch.clamp(tn, min=0.0)) & (tf > t_prev[:, None])
            & (ids >= 0)[None, :])


def occluded_gate(tn, tf, t_max, ids):
    return ((tf >= torch.clamp(tn, min=0.0)) & (tn <= t_max[:, None])
            & (t_max >= 0.0)[:, None] & (ids >= 0)[None, :])


def needed_gate(tn, tf, ids, t_prev, t_max, occluded):
    """The slab gate cut to what the result needs: a closest hit
    (``t_prev`` given) enters only columns whose entry lies before the
    hit's t (``t_max``); an any-hit lane already ``occluded`` none."""
    if t_prev is None:
        return occluded_gate(tn, tf, t_max, ids) & ~occluded[:, None]
    return closest_gate(tn, tf, t_prev, ids) & (tn <= t_max[:, None])


def real_per_column(real, block: int, ids):
    per_block = real.view(-1, block).sum(1)
    return torch.where(ids >= 0, per_block[ids.clamp(min=0).long()], 0)


# --- rows 9-12 --------------------------------------------------------------

def flat_work(o, d, sc, t_prev, t_max, occluded=None) -> tuple[int, int]:
    """(slab tests, triangle tests) of the flat walk on these rays;
    ``t_prev`` None marks the any-hit."""
    ids = sc.sl_blkid[0]
    real = real_per_column(sc.sl_bw_t[0:3].abs().sum(0) > 0, sc.sl_block, ids)
    live = (t_max >= 0.0) if t_prev is None else torch.isfinite(t_prev)
    slabs = int(live.sum()) * sc.sl_n_blocks
    tests = 0 if t_prev is not None else int((occluded & live).sum())
    for a in range(0, o.shape[0], 1 << 15):
        rs = slice(a, a + (1 << 15))
        tn, tf = slab(o[rs], safe_inv(d[rs]), sc.sl_blkflat)
        gate = needed_gate(tn, tf, ids, None if t_prev is None else t_prev[rs],
                           t_max[rs], None if occluded is None else occluded[rs])
        tests += int((gate * real).sum())
    return slabs, tests


def flat2_work(o, d, sc, t_prev, t_max, occluded=None):
    """(slab tests, triangle tests, block columns entered [bpad] bool) of
    the flat2 walk on these rays; ``t_prev`` None marks the any-hit."""
    ids, sb_ids = sc.sl_blkid[0], sc.sl_sbid[0]
    real = real_per_column(sc.sl_bw_t[0:3].abs().sum(0) > 0, sc.sl_block, ids)
    bpad = sc.sl_blkflat.shape[1]
    live = (t_max >= 0.0) if t_prev is None else torch.isfinite(t_prev)
    slabs = int(live.sum()) * int((sb_ids >= 0).sum())
    tests = 0 if t_prev is not None else int((occluded & live).sum())
    needed = torch.zeros_like(ids, dtype=torch.bool)
    for a in range(0, o.shape[0], 1 << 13):
        rs = slice(a, a + (1 << 13))
        inv = safe_inv(d[rs])
        g_sb, g = (needed_gate(*slab(o[rs], inv, table), table_ids,
                               None if t_prev is None else t_prev[rs],
                               t_max[rs],
                               None if occluded is None else occluded[rs])
                   for table, table_ids in ((sc.sl_sbflat, sb_ids),
                                            (sc.sl_blkflat, ids)))
        g &= g_sb.repeat_interleave(128, dim=1)[:, :bpad]
        slabs += 128 * int(g_sb.sum())
        tests += int((g * real).sum())
        needed |= g.any(0)
    return slabs, tests, needed


def rows_bytes(sc, needed) -> int:
    """Bytes of the 12 used BW rows of the blocks in ``needed``."""
    return int(needed.sum()) * 12 * sc.sl_block * 4


def closest_least(o, d, t_prev, sc, t_hit, spheres: bool, two_level: bool):
    """Least seconds of a flat (row 9, the dense sphere pass fused when
    ``spheres``) or flat2 (row 11) closest-hit launch."""
    n = o.shape[0]
    if two_level:
        slabs, tests, needed = flat2_work(o, d, sc, t_prev, t_hit)
        return least_seconds(
            slabs * OPS_SLAB + tests * OPS_BW,
            nbytes(o, d, t_prev, sc.sl_sbflat, sc.sl_sbid, sc.sl_blkflat,
                   sc.sl_blkid) + rows_bytes(sc, needed) + n * (4 * 4 + 4))
    slabs, tests = flat_work(o, d, sc, t_prev, t_hit)
    ops = slabs * OPS_SLAB + tests * OPS_BW
    tables = [sc.sl_blkflat, sc.sl_blkid, sc.sl_bw_t]
    if spheres:
        ops += n * sc.num_real_spheres * OPS_SPHERE
        tables.append(sc.sph_packed_t)
    return least_seconds(ops, nbytes(o, d, t_prev, *tables) + n * (5 * 4 + 4))


def occluded_least(o, ds, tms, sc, occ, two_level: bool):
    """Least seconds of a flat (row 10) or flat2 (row 12) any-hit launch
    of L sets ``ds`` [L,R,3], ``tms`` [L,R] with result ``occ`` [L,R]."""
    n, n_l = o.shape[0], ds.shape[0]
    slabs = tests = 0
    if two_level:
        needed = torch.zeros_like(sc.sl_blkid[0], dtype=torch.bool)
        for k in range(n_l):
            a, b, c = flat2_work(o, ds[k], sc, None, tms[k], occ[k])
            slabs, tests, needed = slabs + a, tests + b, needed | c
        return least_seconds(
            slabs * OPS_SLAB + tests * OPS_BW,
            nbytes(o, ds, tms, sc.sl_sbflat, sc.sl_sbid, sc.sl_blkflat,
                   sc.sl_blkid) + rows_bytes(sc, needed) + n * n_l)
    for k in range(n_l):
        a, b = flat_work(o, ds[k], sc, None, tms[k], occ[k])
        slabs, tests = slabs + a, tests + b
    return least_seconds(slabs * OPS_SLAB + tests * OPS_BW,
                         nbytes(o, ds, tms, sc.sl_blkflat, sc.sl_blkid,
                                sc.sl_bw_t) + n * n_l)


# --- rows 13, 14 ------------------------------------------------------------

BOX_PAD_EXT = 2.0 ** -12
BOX_PAD_MAG = 2.0 ** -16


def pad_boxes(boxes):
    """AABB rows 0-5 widened as the walk kernels stage them."""
    lo, hi = boxes[0:3], boxes[3:6]
    ext = torch.maximum(torch.maximum(hi[0] - lo[0], hi[1] - lo[1]),
                        hi[2] - lo[2])
    a = boxes[0:6].abs()
    mag = torch.maximum(torch.maximum(torch.maximum(a[0], a[3]),
                                      torch.maximum(a[1], a[4])),
                        torch.maximum(a[2], a[5]))
    pad = ext * BOX_PAD_EXT + mag * BOX_PAD_MAG
    return torch.cat([lo - pad, hi + pad])


def group_gate(o, d, t_hi, grp):
    """[N, GP] bool: the 128-column groups (``grp`` [7, GP]: widened box,
    valid flag) whose box each lane's segment [0, t_hi] enters."""
    inv = torch.where(d == 0.0, 1e30, 1.0 / torch.where(d == 0.0, 1.0, d))
    t0 = (grp[None, 0:3, :] - o[:, :, None]) * inv[:, :, None]
    t1 = (grp[None, 3:6, :] - o[:, :, None]) * inv[:, :, None]
    lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
    tn = torch.maximum(torch.maximum(lo[:, 0], lo[:, 1]), lo[:, 2])
    tf = torch.minimum(torch.minimum(hi[:, 0], hi[:, 1]), hi[:, 2])
    th = t_hi[:, None]
    return ((tf >= torch.clamp(tn, min=0.0)) & (tn <= th) & (th >= 0.0)
            & (grp[6] > 0.0)[None, :])


def walk_tests(sc, o, d, t_hi) -> int:
    """The Baldwin-Weber tests the transparent walks need on these lanes:
    the real columns of every group the lane's gate admits (t_hi < 0: a
    dead lane)."""
    n_groups = sc.tr_bw.shape[1] // 128
    real = (sc.tr_bw[0:3].abs().sum(0) > 0).view(n_groups, 128).sum(1)
    grp = torch.cat([pad_boxes(sc.tr_grp), sc.tr_grp[6:7]])[:, :n_groups]
    total = 0
    for a in range(0, o.shape[0], 1 << 16):
        sl = slice(a, a + (1 << 16))
        total += int((group_gate(o[sl], d[sl], t_hi[sl], grp) * real).sum())
    return total


def walk_tables(sc) -> tuple:
    return (sc.tr_bw, sc.tr_rows, sc.tr_tex8, sc.tr_lut, sc.tr_page_table,
            sc.tr_grp)


def alpha_least(sc, o, d, t_op, rnd) -> float:
    """Least seconds of an alpha-walk launch (row 13)."""
    t_hi = torch.where(t_op < 0.0, -1.0, t_op)
    n = o.shape[0]
    return least_seconds(walk_tests(sc, o, d, t_hi) * OPS_BW,
                         nbytes(o, d, t_op, rnd, *walk_tables(sc))
                         + n * (8 * 4 + 4))


def trans_least(sc, o, d, pd, walking0) -> float:
    """Least seconds of a transmittance-walk launch (row 14): ``pd`` < 0
    or ``walking0`` False marks a lane that does not walk; its per-lane
    operands are one [8, R] f32 table."""
    live = walking0 & (pd >= 0.0)
    t_hi = torch.where(live, float("inf"), -1.0)
    n = o.shape[0]
    return least_seconds(walk_tests(sc, o, d, t_hi) * OPS_BW,
                         nbytes(o, d, *walk_tables(sc)) + 8 * 4 * n
                         + 3 * 4 * n)
