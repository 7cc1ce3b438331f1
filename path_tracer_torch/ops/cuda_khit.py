"""Each ray's K nearest transparent hits: the CUDA kernel's wrapper and its
plain PyTorch version, the producer of the dense transparent walks.

Counterpart of ``path_tracer_tpu/ops/pallas_intersect.py``'s
``k_nearest_tr_hits``: ``csrc/khit.cu`` replaces ``_khit_kernel``. The
integrator's dense walks (``models/integrator.py``, ``_dense_tr_hits``,
taken with ``PT_DENSE_TR=1``) call ``k_nearest_tr_hits`` once per walk
for the whole wavefront and then visit the K columns with no further
casts.

The table is the scene's ``khit_tris``, ``khit_gbox`` and ``khit_sbox``
(``scene/device_scene.py``, made once with the scene): the transparent
slice of ``tri_packed_t`` (column j is global triangle
``n_tris_opaque + j``), padded with zero rows to a multiple of 128
columns, and one AABB per group of 128 columns (padding rows excluded, an
all-padding group at the 1e30 sentinel that no segment reaches), as the
JAX wrapper builds them on every call, and one per sub-group of 32.

Contract, kernel and plain version alike (see ``csrc/khit.cu``): a lane
is live when it is active and t_max > 0, and tests a column where its own
segment reaches both the column's 128-column group box (``khit_gbox``)
and its 32-column sub-group box (``khit_sbox``): the slab with IEEE 1/d
(NaN bounds opened to all t) on the box widened by ``slab.pad_boxes``,
the interval widened by ``slab.pad_slab``, tf >= max(tn, 0), tn <= t_max.
On an exact box a ray through a card's vertex or edge lying on the box's
face can fail the group whose triangle its rounded MT test hits (the
Pallas kernel pruned per 512-ray tile, whose union hid most such lanes);
widened, within t_max no hit is lost (tests/test_torch_walk_gate.py
holds it against the ungated producer). Moller-Trumbore with t >= 1e-6
and no t_max test; the K smallest distinct t per lane, ascending, each
with the lowest column that reaches it; +inf and column 0 past the end
and on dead lanes. Beyond t_max the entries depend on the gate (the
Pallas kernel's on its tile, the replaced CUDA design's on the 128-column
groups alone); the walks mask with their own bound.

Bound on the card: arithmetic, about 45 flops per MT test over the
columns a lane's gate admits.
"""
from __future__ import annotations

import torch

from path_tracer_torch import native
from path_tracer_torch.ops.intersect import mt_rows
from path_tracer_torch.ops.slab import pad_boxes, pad_slab
from path_tracer_torch.scene.device_scene import KHIT_GRP, KHIT_SUB
from path_tracer_torch.utils.telemetry import counters

KHIT_MAX_K = 8  # the kernel's register list
_PLAIN_LANES = 1 << 12  # lanes per slice of the plain version


def _group_reach(o, d, t_max, gbox):
    """[n, G] whether each lane's segment (0, t_max] reaches each group's
    box, widened by ``slab.pad_boxes``: the slab with IEEE reciprocals, a
    NaN interval bound (0 * inf) opened to all t, the interval widened by
    ``slab.pad_slab``."""
    inv = 1.0 / d
    box = pad_boxes(gbox)
    tn = tf = None
    for k in range(3):
        lo = (box[k][None, :] - o[:, k:k + 1]) * inv[:, k:k + 1]
        hi = (box[3 + k][None, :] - o[:, k:k + 1]) * inv[:, k:k + 1]
        nan = lo.isnan() | hi.isnan()
        a = torch.where(nan, -float("inf"), torch.minimum(lo, hi))
        b = torch.where(nan, float("inf"), torch.maximum(lo, hi))
        tn = a if tn is None else torch.maximum(tn, a)
        tf = b if tf is None else torch.minimum(tf, b)
    tn, tf = pad_slab(tn, tf)
    return ((tf >= torch.clamp(tn, min=0.0)) & (tn <= t_max[:, None])
            & (t_max > 0.0)[:, None])


def _mt_columns(o, d, tris):
    """[n, T] MT distance of every lane to every column, +inf where the
    test fails (the kernel's expressions, in its order)."""
    t, _, _, _, ok = mt_rows([o[:, k:k + 1] for k in range(3)],
                             [d[:, k:k + 1] for k in range(3)],
                             [row[None, :] for row in tris])
    return torch.where(ok, t, float("inf"))


def k_nearest_tr_hits_plain(o, d, t_max, tris, gbox, k: int, sbox=None):
    """Plain version of the kernel on the wrapper's operands (t_max
    encoded: <= 0 on dead lanes) → (ts [k, R] f32, pos [k, R] i32). A
    column is tested where the lane reaches its 128-column group's box and,
    given ``sbox`` (the scene's ``khit_sbox``), its 32-column sub-group's
    box; without ``sbox``, the gate of the design the kernel replaced."""
    r = o.shape[0]
    ts = torch.full((k, r), float("inf"), device=o.device)
    pos = torch.zeros((k, r), dtype=torch.int32, device=o.device)
    for a in range(0, r, _PLAIN_LANES):
        rs = slice(a, min(r, a + _PLAIN_LANES))
        reach = _group_reach(o[rs], d[rs], t_max[rs], gbox).repeat_interleave(
            KHIT_GRP, dim=1)
        if sbox is not None:
            reach &= _group_reach(o[rs], d[rs], t_max[rs],
                                  sbox).repeat_interleave(KHIT_SUB, dim=1)
        work = torch.where(reach, _mt_columns(o[rs], d[rs], tris),
                           float("inf"))
        for q in range(k):
            m, j = work.min(dim=1)  # the lowest column among equal minima
            ts[q, rs] = m
            pos[q, rs] = j.to(torch.int32)
            work = torch.where(work <= m[:, None], float("inf"), work)
    return ts, pos


def k_nearest_tr_hits(o, d, active, scene, k: int, t_max=None):
    """(ts [k, R] ascending, pos [k, R] i32): each ray's k nearest
    transparent hits with t >= 1e-6 among the groups its segment
    (0, t_max] reaches (module docstring); column j of ``pos`` is global
    triangle ``scene.n_tris_opaque + j``. ``active`` [R] bool, ``t_max``
    [R] (None: +inf). CUDA tensors launch the kernel (or raise); CPU
    tensors take the plain version."""
    if not 0 < k <= KHIT_MAX_K:
        raise ValueError(f"k_nearest_tr_hits: k = {k} outside 1.."
                         f"{KHIT_MAX_K}")
    r = o.shape[0]
    if t_max is None:
        t_max = torch.full((r,), float("inf"), device=o.device)
    tm = torch.where(active, t_max, -1.0).contiguous()
    tris, gbox, sbox = scene.khit_tris, scene.khit_gbox, scene.khit_sbox
    if o.device.type == "cpu":
        return k_nearest_tr_hits_plain(o, d, tm, tris, gbox, k, sbox)
    out = native.launch_khit(o.contiguous(), d.contiguous(), tm, tris, gbox,
                             sbox, k)
    counters["launch.k_nearest_tr_hits"] += 1
    return out
