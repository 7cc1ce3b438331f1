"""Slab gates and the nearest-hit merge shared by the plain block walks
(``ops/cuda_bvh.py``: flat and flat2; ``ops/cuda_spheres.py``: the sphere
block walk), in the kernels' arithmetic (``csrc/flat_common.cuh``).

- ``safe_inv``: 1 / d with zero components inverted to 1e30;
- ``slab``: entry tn and exit tf of every ray against every AABB column
  (rows 0-2 the mins, 3-5 the maxes);
- ``closest_gate``: tf >= max(tn, 0), tf > t_prev and id >= 0, so a dead
  lane (t_prev = +inf) passes nothing;
- ``occluded_gate``: tf >= max(tn, 0), tn <= t_max, t_max >= 0 and
  id >= 0, so a dead lane (t_max < 0) passes nothing;
- ``merge_nearest``: the lexicographic (t, slot) minimum of a record and
  one block's nearest candidates, so the visit order decides nothing;
- ``pad_boxes`` and ``pad_slab``: the widened boxes and slab intervals of
  the walks that gate a lane by its own slab test (the transparent walks,
  ``ops/trwalk.py``; the tree, flat and flat2 walks, ``ops/cuda_bvh.py``;
  row 3, ``ops/cuda_khit.py``; the sphere any-hit walk,
  ``ops/cuda_spheres.py``), in ``csrc/flat_common.cuh``'s ``pad_box``
  and ``pad_slab`` arithmetic; ``padded_slab`` is ``slab`` on both.
"""
from __future__ import annotations

import torch


def safe_inv(d):
    zero = d == 0.0
    return torch.where(zero, 1e30, 1.0 / torch.where(zero, 1.0, d))


def slab(o, inv, boxes):
    """Slab entry and exit [R, C] of every ray against the [>=6, C] AABB
    columns ``boxes``."""
    t0 = [(boxes[k][None, :] - o[:, k:k + 1]) * inv[:, k:k + 1]
          for k in range(3)]
    t1 = [(boxes[3 + k][None, :] - o[:, k:k + 1]) * inv[:, k:k + 1]
          for k in range(3)]
    lo = [torch.minimum(a, b) for a, b in zip(t0, t1)]
    hi = [torch.maximum(a, b) for a, b in zip(t0, t1)]
    tn = torch.maximum(torch.maximum(lo[0], lo[1]), lo[2])
    tf = torch.minimum(torch.minimum(hi[0], hi[1]), hi[2])
    return tn, tf


# A box holds its triangles' vertices exactly, but a hit's rounded t and
# barycentrics can place a grazing hit (a ray through a vertex or an edge
# lying on the box) outside the slab interval the rounded slab test
# computes: by about 2^-24 of the coordinates' magnitude over the ray's
# direction component, so far more than an ulp of t where that component
# is small. The walks that gate a lane by its own slab test widen each box
# on every side by ext * BOX_PAD_EXT + mag * BOX_PAD_MAG (ext the box's
# largest side, mag its largest coordinate magnitude), and each lane's
# interval to tn - |tn| * BOX_PAD_T, tf + |tf| * BOX_PAD_T, which grows with
# the origin's distance from the box as a hit's rounding does. A widened
# box only admits more; a child's widened box stays inside its parent's.
BOX_PAD_EXT = 2.0 ** -12
BOX_PAD_MAG = 2.0 ** -16
BOX_PAD_T = 2.0 ** -16


def pad_boxes(boxes) -> torch.Tensor:
    """The AABBs ``boxes`` (rows 0-2 the mins, 3-5 the maxes, any trailing
    shape) widened as the kernels widen them (float32, their expression
    and order): rows 0-5 only."""
    lo, hi = boxes[0:3], boxes[3:6]
    ext = torch.maximum(torch.maximum(hi[0] - lo[0], hi[1] - lo[1]),
                        hi[2] - lo[2])
    a = boxes[0:6].abs()
    mag = torch.maximum(torch.maximum(torch.maximum(a[0], a[3]),
                                      torch.maximum(a[1], a[4])),
                        torch.maximum(a[2], a[5]))
    pad = ext * BOX_PAD_EXT + mag * BOX_PAD_MAG
    return torch.cat([lo - pad, hi + pad])


def pad_slab(tn, tf):
    """A slab interval widened by ``BOX_PAD_T`` of its ends' magnitudes."""
    return tn - tn.abs() * BOX_PAD_T, tf + tf.abs() * BOX_PAD_T


def padded_slab(o, inv, boxes):
    """``slab`` on the widened boxes, its interval widened: the gate's
    interval of the flat and flat2 walks."""
    return pad_slab(*slab(o, inv, pad_boxes(boxes)))


def closest_gate(tn, tf, t_prev, ids):
    """[n, C] slab gate of the closest hit on columns with ids [C]."""
    return ((tf >= torch.maximum(tn, torch.zeros_like(tn)))
            & (tf > t_prev[:, None]) & (ids >= 0)[None, :])


def occluded_gate(tn, tf, t_max, ids):
    """[n, C] slab gate of the any-hit on columns with ids [C]."""
    return ((tf >= torch.maximum(tn, torch.zeros_like(tn)))
            & (tn <= t_max[:, None]) & (t_max >= 0.0)[:, None]
            & (ids >= 0)[None, :])


def live_columns(gate):
    """Columns of a [R, C] gate some lane passes (one host sync)."""
    return torch.nonzero(gate.any(dim=0))[:, 0].tolist()


def merge_nearest(t, start: int, lanes, best_t, best_slot):
    """Merge ``lanes``' candidate t [n, block] (+inf where none) over the
    slots ``start``.. of one block into the record (best_t, best_slot),
    in place: the lexicographic (t, slot) minimum. Returns (j, better):
    each lane's nearest column in the block (the lowest among equal t) and
    whether it replaced the record, for the caller's other fields."""
    tj, j = t.min(dim=1)  # first (lowest) slot among equal minima
    slot = (j + start).to(torch.int32)
    cur_t, cur_s = best_t[lanes], best_slot[lanes]
    better = (tj < cur_t) | ((tj == cur_t) & (slot < cur_s))
    best_t[lanes] = torch.where(better, tj, cur_t)
    best_slot[lanes] = torch.where(better, slot, cur_s)
    return j, better
