"""Flat superleaf block walks: closest hit and batched any-hit, one level
and two, the CUDA kernels' wrappers and their plain PyTorch versions.

Counterpart of the flat and flat2 halves of
``path_tracer_tpu/ops/pallas_bvh.py``:

- ``csrc/flat_closest_hit.cu`` replaces ``pallas_bvh._flat_kernel``
  (entry ``closest_hit_triangles_flat``), with its fused dense sphere pass;
- ``csrc/flat_occluded.cu`` replaces ``pallas_bvh._flat_occ_kernel`` and
  ``flat_occ_set`` (entries ``occluded_triangles_flat[_multi]``);
- ``csrc/flat2_closest_hit.cu`` replaces ``pallas_bvh._flat2_kernel``
  (entry ``closest_hit_triangles_flat2``);
- ``csrc/flat2_occluded.cu`` replaces ``pallas_bvh._flat2_occ_kernel``
  (entries ``occluded_triangles_flat2[_multi]``);
- ``csrc/tree_walk.cu`` replaces ``pallas_bvh._kernel`` and
  ``pallas_bvh._occ_kernel``, the superleaf tree walk (entries
  ``closest_hit_triangles_tree`` and
  ``occluded_triangles_tree[_multi]``, taken with ``PT_BVH_KERNEL=tree``
  or for a BVH scene without blocks).

The flat walks serve scenes (or opacity-partition views) with ``use_bvh``
and at most ``FLAT_MAX_BLOCKS`` superleaf blocks, the flat2 walks larger
ones (``ops/intersect.py`` dispatches). Bound on the card: arithmetic in
the dense Baldwin-Weber visits of the blocks a ray's slab test admits,
and for flat2 at 1M triangles the HBM reads of those blocks' rows (the
tables outgrow the L2); see the sources for the design.

Semantics (kernel and plain version alike):

- block gate: slab entry tn and exit tf of the block AABB widened by
  ``slab.pad_boxes``, with zero direction components inverted to 1e30,
  the interval widened by ``slab.pad_slab``; closest hit needs
  tf >= max(tn, 0) and tf > t_prev, any-hit tf >= max(tn, 0),
  tn <= t_max and t_max >= 0; pad columns (block id < 0) never pass. On
  the exact box, a ray through a vertex or an edge lying on a block's box
  can fail the block whose triangle its rounded Baldwin-Weber test hits
  (the Pallas kernels gated the union of a tile's rays, which hid most
  such lanes);
- flat2: the same gate first on the superblock AABBs (``sl_sbflat``, the
  union of 128 block columns; id < 0 never passes), then on the block
  columns of each superblock that passed; a block's rows are addressed by
  its id (``sl_blkid``), never by its column;
- Baldwin-Weber test per packed slot: |d.n| >= 1e-6,
  t = (c - o.n) * (1 / d.n), u = Au.h + au, v = Av.h + av on h = o + t d,
  u >= 0, v >= 0, u + v <= 1; closest hit keeps t >= 1e-6 and t > t_prev
  (backface = d.n > 0), any-hit 1e-6 <= t <= t_max;
- TIE RULE: the smallest t wins, among equal t the lowest packed slot;
- dead lanes: t_prev = +inf (closest hit, all-miss record) and
  t_max < 0 (any-hit, reported occluded for the caller to mask).

The plain versions visit every block a lane's slab test admits, in column
order, with no best-t pruning, and so do the flat and flat2 closest-hit
kernels: each equals its plain version on every lane. A cut of whole
blocks at a lane's best t would not be exact: rounding can put a hit a few
ulps before its block's slab entry (a ray through a vertex or an edge on
the block's box), and the visit order would then decide between equal-t
copies. A widened block box lies inside its widened superblock box and
slab rounding is monotone, so a block that passes its gate always lies in
a superblock that passes.

The tree walk keeps the Pallas packet's inputs, outputs, layouts, tie
rule and dead lanes, not its shared visits (see ``csrc/tree_walk.cu``):
each group of 128 consecutive rays (the last padded with o = 0,
d = (1, 1, 1) and a dead gate value) picks one of the six directional
layouts from its pairwise-summed directions; the rays then walk the
forest in that layout's order in packets sharing a cursor (the kernel's
warps of 32; the plain versions' packets of 128 or 32), the cursor
entering an internal node some lane's gate admits, and a lane tests a
leaf only when its OWN gate admits it: closest hit tf >= max(tn, 0),
tf > t_prev and tn <= its best t times ``native.TREE_WALK_CUT_WIDEN``
(1 + 2^-8: rounding can put a hit before its box's entry); any-hit not
yet occluded, tf >= max(tn, 0) and tn <= t_max. The slab test runs on
the node box widened by ``slab.pad_boxes`` and its interval by
``slab.pad_slab``: on the exact box, a ray through a vertex or an edge
lying on a leaf's box can fail the leaf whose triangle its rounded MT
test hits, and no other lane's visit stands in for it (the Pallas packet
tested every leaf some lane admitted). A child's widened box lies inside
its parent's and slab rounding is monotone, so a lane whose gate admits a
node admitted its ancestors when the cursor met them: its result is that
of its own walk, whatever the packet. A visit is plain
Moller-Trumbore on ``sl_tris_t``: within a leaf the lowest slot wins equal
t, a later leaf only a strictly smaller t; any-hit t <= t_max, dead lanes
occluded. The plain versions step the packets side by side, one node per
packet per step.
"""
from __future__ import annotations

import torch

from path_tracer_torch import native
from path_tracer_torch.ops.intersect import (
    DET_EPS,
    KIND_NONE,
    KIND_SPHERE,
    KIND_TRIANGLE,
    T_MIN,
    HitRecord,
    _ray_chunks,
    closest_hit_spheres,
    mt_rows,
    stacked,
)
from path_tracer_torch.ops.slab import (
    closest_gate,
    live_columns,
    merge_nearest,
    occluded_gate,
    pad_boxes,
    pad_slab,
    padded_slab,
    safe_inv,
)
from path_tracer_torch.utils.telemetry import counters

GROUP = 128  # rays of a tree walk's layout group (the Pallas packet)
_TREE_VISIT_ELEMS = 1 << 22  # (lane, slot) pairs per step of a plain visit


def _bw_test(o, d, rows):
    """Baldwin-Weber test of [n] rays against one block's [16, block] rows:
    (t, u, v, dn, ok) each [n, block], ``ok`` before the caller's t range."""
    def dot(v, r0):
        return (v[:, 0:1] * rows[r0] + v[:, 1:2] * rows[r0 + 1]
                + v[:, 2:3] * rows[r0 + 2])

    dn = dot(d, 0)
    ok = dn.abs() >= DET_EPS
    invdn = 1.0 / torch.where(ok, dn, 1.0)
    t = (rows[3] - dot(o, 0)) * invdn
    h = [o[:, k:k + 1] + t * d[:, k:k + 1] for k in range(3)]
    u = h[0] * rows[4] + h[1] * rows[5] + h[2] * rows[6] + rows[7]
    v = h[0] * rows[8] + h[1] * rows[9] + h[2] * rows[10] + rows[11]
    ok = ok & (t >= T_MIN) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    return t, u, v, dn, ok


def _block_rows(scene, col: int):
    """(first packed slot, [16, block] BW rows) of block column ``col``."""
    bid = int(scene.sl_blkid[0, col])
    start = bid * scene.sl_block
    return start, scene.sl_bw_t[:, start:start + scene.sl_block]


def _miss_best(r: int, device):
    """(t, u, v, backface, slot) of r lanes that hit nothing yet."""
    return (torch.full((r,), float("inf"), device=device),
            torch.zeros((r,), device=device), torch.zeros((r,), device=device),
            torch.zeros((r,), dtype=torch.bool, device=device),
            torch.full((r,), -1, dtype=torch.int32, device=device))


def _closest_visit(scene, col: int, lanes, o, d, t_prev, best):
    """Baldwin-Weber test of ``lanes`` (indices into o, d, t_prev and the
    best record) against block column ``col``: the lexicographic (t,
    packed slot) minimum of the record and the block's hits past t_prev."""
    bt, bu, bv, bb, bi = best
    start, rows = _block_rows(scene, col)
    t, u, v, dn, ok = _bw_test(o[lanes], d[lanes], rows)
    t = torch.where(ok & (t > t_prev[lanes][:, None]), t, float("inf"))
    j, better = merge_nearest(t, start, lanes, bt, bi)
    jj = j[:, None]
    bu[lanes] = torch.where(better, u.gather(1, jj)[:, 0], bu[lanes])
    bv[lanes] = torch.where(better, v.gather(1, jj)[:, 0], bv[lanes])
    bb[lanes] = torch.where(better, dn.gather(1, jj)[:, 0] > 0.0, bb[lanes])


def _occluded_visit(scene, col: int, lanes, o, d, t_max, occ):
    """Any-hit of ``lanes`` against block column ``col``, into ``occ``."""
    _, rows = _block_rows(scene, col)
    t, _, _, _, ok = _bw_test(o[lanes], d[lanes], rows)
    occ[lanes] = (ok & (t <= t_max[lanes][:, None])).any(dim=1)


def _flat_walk_plain(o, d, t_prev, scene):
    """The plain flat walk → (t, u, v, backface, slot), each [R] (slot -1
    and t = +inf on a miss)."""
    parts = []
    for rs in _ray_chunks(o.shape[0]):
        oc, dc, tpc = o[rs], d[rs], t_prev[rs]
        tn, tf = padded_slab(oc, safe_inv(dc), scene.sl_blkflat)
        gate = closest_gate(tn, tf, tpc, scene.sl_blkid[0])
        best = _miss_best(oc.shape[0], o.device)
        for col in live_columns(gate):
            lanes = torch.nonzero(gate[:, col])[:, 0]
            _closest_visit(scene, col, lanes, oc, dc, tpc, best)
        parts.append(best)
    return tuple(torch.cat(x) for x in zip(*parts))


def occluded_triangles_flat_plain(o, d, t_max, scene):
    """Plain version of the flat any-hit → [R] bool (dead lanes True)."""
    parts = []
    for rs in _ray_chunks(o.shape[0]):
        oc, dc, tmc = o[rs], d[rs], t_max[rs]
        tn, tf = padded_slab(oc, safe_inv(dc), scene.sl_blkflat)
        gate = occluded_gate(tn, tf, tmc, scene.sl_blkid[0])
        occ = tmc < 0.0
        for col in live_columns(gate):
            lanes = torch.nonzero(gate[:, col] & ~occ)[:, 0]
            if lanes.numel():
                _occluded_visit(scene, col, lanes, oc, dc, tmc, occ)
        parts.append(occ)
    return torch.cat(parts)


def _superblock_lanes(scene, sb_gate, gate_fn, o, inv, g, skip=None):
    """Per superblock some lane passes: (first block column, lanes that
    pass it, their [n, 128] gate on its 128 block columns). ``gate_fn`` is
    ``closest_gate`` or ``occluded_gate`` with g its t_prev or t_max;
    lanes in ``skip`` (the occluded ones, read when the superblock is
    reached) sit the superblock out."""
    for sb in live_columns(sb_gate):
        keep = sb_gate[:, sb] if skip is None else sb_gate[:, sb] & ~skip
        lanes = torch.nonzero(keep)[:, 0]
        if lanes.numel() == 0:
            continue
        w = sb * 128
        tn, tf = padded_slab(o[lanes], inv[lanes],
                             scene.sl_blkflat[:, w:w + 128])
        yield w, lanes, gate_fn(tn, tf, g[lanes], scene.sl_blkid[0, w:w + 128])


def _flat2_walk_plain(o, d, t_prev, scene):
    """The plain two-level walk → (t, u, v, backface, slot) as
    ``_flat_walk_plain``: the superblock gate, then the block gate of each
    admitted superblock's 128 columns, then the Baldwin-Weber test. Gates
    are [chunk, SBpad] and [lanes, 128], never [R, Bpad]."""
    parts = []
    for rs in _ray_chunks(o.shape[0]):
        oc, dc, tpc = o[rs], d[rs], t_prev[rs]
        inv = safe_inv(dc)
        tn, tf = padded_slab(oc, inv, scene.sl_sbflat)
        sb_gate = closest_gate(tn, tf, tpc, scene.sl_sbid[0])
        best = _miss_best(oc.shape[0], o.device)
        for w, sb_lanes, gate in _superblock_lanes(
                scene, sb_gate, closest_gate, oc, inv, tpc):
            for col in live_columns(gate):
                lanes = sb_lanes[torch.nonzero(gate[:, col])[:, 0]]
                _closest_visit(scene, w + col, lanes, oc, dc, tpc, best)
        parts.append(best)
    return tuple(torch.cat(x) for x in zip(*parts))


def occluded_triangles_flat2_plain(o, d, t_max, scene):
    """Plain version of the two-level any-hit → [R] bool (dead lanes
    True)."""
    parts = []
    for rs in _ray_chunks(o.shape[0]):
        oc, dc, tmc = o[rs], d[rs], t_max[rs]
        inv = safe_inv(dc)
        tn, tf = padded_slab(oc, inv, scene.sl_sbflat)
        sb_gate = occluded_gate(tn, tf, tmc, scene.sl_sbid[0])
        occ = tmc < 0.0
        for w, sb_lanes, gate in _superblock_lanes(
                scene, sb_gate, occluded_gate, oc, inv, tmc, skip=occ):
            for col in live_columns(gate):
                lanes = sb_lanes[torch.nonzero(gate[:, col])[:, 0]]
                lanes = lanes[~occ[lanes]]
                if lanes.numel():
                    _occluded_visit(scene, w + col, lanes, oc, dc, tmc, occ)
        parts.append(occ)
    return torch.cat(parts)


def _record(t, u, v, back, slot, kind, scene) -> HitRecord:
    """HitRecord of a flat cast: ``prim`` is the global triangle id
    (``sl_map`` of the packed slot) or, on sphere lanes, the sphere index."""
    kind = kind.to(torch.int32)
    n_slots = scene.sl_map.shape[0]
    tri_prim = torch.where(
        (slot >= 0) & (slot < n_slots),
        scene.sl_map[torch.clamp(slot, 0, n_slots - 1).long()], -1)
    prim = torch.where(kind == KIND_SPHERE, slot - scene.sph_row_base,
                       tri_prim).to(torch.int32)
    return HitRecord(t=t, kind=kind, prim=prim, u=u, v=v, backface=back)


def closest_hit_triangles_flat_plain(o, d, t_prev, scene,
                                     spheres: bool = False) -> HitRecord:
    """Plain version of ``closest_hit_triangles_flat``, on any device: the
    walk, and with ``spheres`` the dense sphere cast merged after it."""
    t, u, v, back, slot = _flat_walk_plain(o, d, t_prev, scene)
    kind = torch.where(torch.isfinite(t), KIND_TRIANGLE, KIND_NONE)
    if spheres:
        sph = closest_hit_spheres(o, d, t_prev, scene)
        wins = sph.t < t  # the triangle wins ties
        t = torch.where(wins, sph.t, t)
        u = torch.where(wins, 0.0, u)
        v = torch.where(wins, 0.0, v)
        back = torch.where(wins, sph.backface, back)
        slot = torch.where(wins, scene.sph_row_base + sph.prim, slot)
        kind = torch.where(wins, KIND_SPHERE, kind)
    return _record(t, u, v, back, slot, kind, scene)


def occluded_triangles_flat_multi_plain(o, ds, t_maxes, scene):
    """Plain version of ``occluded_triangles_flat_multi``: [L,R] bool."""
    return torch.stack([occluded_triangles_flat_plain(o, d, tm, scene)
                        for d, tm in zip(ds, t_maxes)])


def closest_hit_triangles_flat2_plain(o, d, t_prev, scene) -> HitRecord:
    """Plain version of ``closest_hit_triangles_flat2``, on any device."""
    t, u, v, back, slot = _flat2_walk_plain(o, d, t_prev, scene)
    kind = torch.where(torch.isfinite(t), KIND_TRIANGLE, KIND_NONE)
    return _record(t, u, v, back, slot, kind, scene)


def occluded_triangles_flat2_multi_plain(o, ds, t_maxes, scene):
    """Plain version of ``occluded_triangles_flat2_multi``: [L,R] bool."""
    return torch.stack([occluded_triangles_flat2_plain(o, d, tm, scene)
                        for d, tm in zip(ds, t_maxes)])


def closest_hit_triangles_flat(o, d, t_prev, scene,
                               spheres: bool = False) -> HitRecord:
    """Closest hit over the superleaf blocks; with ``spheres`` the dense
    sphere pass too, merged (a sphere wins only on a strictly smaller t).

    o, d: [R,3] f32; t_prev: [R] f32 (+inf marks a dead lane). CUDA tensors
    launch the kernel (or raise); CPU tensors take the plain version."""
    if o.device.type == "cpu":
        return closest_hit_triangles_flat_plain(o, d, t_prev, scene, spheres)
    fout, slot = native.launch_flat_closest_hit(
        o, d, t_prev, scene.sl_blkflat, scene.sl_blkid, scene.sl_bw_t,
        scene.sl_block, sph=scene.sph_packed_t if spheres else None,
        sph_row_base=scene.sph_row_base)
    counters["launch.flat_closest_hit"] += 1
    t = fout[0]
    kind = (fout[4] if spheres
            else torch.where(torch.isfinite(t), KIND_TRIANGLE, KIND_NONE))
    return _record(t, fout[1], fout[2], fout[3] != 0.0, slot, kind, scene)


def occluded_triangles_flat_multi(o, ds, t_maxes, scene) -> torch.Tensor:
    """Any-hit for L direction sets sharing one origin set, in one launch.

    o: [R,3]; ds: [L,R,3] or a list of L [R,3]; t_maxes: [L,R] or a list
    of L [R] (< 0 marks a dead lane, reported occluded); stacked tensors
    are taken without a copy. Returns [L,R] bool, the launch's output. CUDA
    tensors launch the kernel (or raise); CPU tensors take the plain
    version, set by set."""
    if o.device.type == "cpu":
        return occluded_triangles_flat_multi_plain(o, ds, t_maxes, scene)
    out = native.launch_flat_occluded(
        o.contiguous(), stacked(ds), stacked(t_maxes), scene.sl_blkflat,
        scene.sl_blkid, scene.sl_bw_t, scene.sl_block)
    counters["launch.flat_occluded"] += 1
    return out


def occluded_triangles_flat(o, d, t_max, scene) -> torch.Tensor:
    """[R] bool any-hit: the multi-set launch with one set."""
    return occluded_triangles_flat_multi(o, [d], [t_max], scene)[0]


def closest_hit_triangles_flat2(o, d, t_prev, scene) -> HitRecord:
    """Closest hit over the superleaf blocks through the two-level
    superblock walk (scenes of more than ``FLAT_MAX_BLOCKS`` blocks).

    o, d: [R,3] f32; t_prev: [R] f32 (+inf marks a dead lane). CUDA tensors
    launch the kernel (or raise); CPU tensors take the plain version."""
    if o.device.type == "cpu":
        return closest_hit_triangles_flat2_plain(o, d, t_prev, scene)
    fout, slot = native.launch_flat2_closest_hit(
        o, d, t_prev, scene.sl_sbflat, scene.sl_sbid, scene.sl_blkflat,
        scene.sl_blkid, scene.sl_bw_t, scene.sl_block)
    counters["launch.flat2_closest_hit"] += 1
    t = fout[0]
    kind = torch.where(torch.isfinite(t), KIND_TRIANGLE, KIND_NONE)
    return _record(t, fout[1], fout[2], fout[3] != 0.0, slot, kind, scene)


def occluded_triangles_flat2_multi(o, ds, t_maxes, scene) -> torch.Tensor:
    """Two-level any-hit for L direction sets sharing one origin set, in
    one launch; arguments and result as ``occluded_triangles_flat_multi``.
    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version, set by set."""
    if o.device.type == "cpu":
        return occluded_triangles_flat2_multi_plain(o, ds, t_maxes, scene)
    out = native.launch_flat2_occluded(
        o.contiguous(), stacked(ds), stacked(t_maxes), scene.sl_sbflat,
        scene.sl_sbid, scene.sl_blkflat, scene.sl_blkid, scene.sl_bw_t,
        scene.sl_block)
    counters["launch.flat2_occluded"] += 1
    return out


def _packets(o, d, g, fill: float, width: int):
    """The rays as [P, width] packets (width 32 or 128) in layout groups of
    128, the last group padded with o = 0, d = 1 and ``g`` = ``fill`` (a
    dead lane): (o, d, inv [P, width, 3], g [P, width], layout [P], the
    group's)."""
    r = o.shape[0]
    pad = -r % GROUP
    o = torch.nn.functional.pad(o, (0, 0, 0, pad))
    d = torch.nn.functional.pad(d, (0, 0, 0, pad), value=1.0)
    g = torch.nn.functional.pad(g, (0, pad), value=fill)
    layout = packet_layouts(d.view(-1, GROUP, 3))
    layout = layout.repeat_interleave(GROUP // width)
    return (o.view(-1, width, 3), d.view(-1, width, 3),
            safe_inv(d).view(-1, width, 3), g.view(-1, width), layout)


def packet_layouts(d):
    """[G] layout of each [128, 3] group of ``d`` [G, 128, 3]: 2 * axis +
    (sum < 0) for the axis of the largest |sum| (x, then y, on ties), the
    sums taken pairwise as the kernel reduces them."""
    s = d
    while s.shape[1] > 1:
        w = s.shape[1] // 2
        s = s[:, :w] + s[:, w:]
    s = s[:, 0]
    a = s.abs()
    axis = torch.where(a[:, 0] >= torch.maximum(a[:, 1], a[:, 2]), 0,
                       torch.where(a[:, 1] >= a[:, 2], 1, 2))
    along = s.gather(1, axis[:, None])[:, 0]
    return 2 * axis + (along < 0.0).long()


def _node_slab(scene, layout, cursor, o, inv):
    """(tn, tf [m, width], escape [m], leaf [m]) of each packet's current
    node in its layout, the box and the interval widened
    (``slab.pad_boxes``, ``slab.pad_slab``)."""
    box = pad_boxes(scene.sl_nodes6[layout, :6, cursor].T).T  # [m, 6]
    meta = scene.sl_meta6[layout, :, cursor]  # [m, 2]
    t0 = [(box[:, k, None] - o[..., k]) * inv[..., k] for k in range(3)]
    t1 = [(box[:, 3 + k, None] - o[..., k]) * inv[..., k] for k in range(3)]
    lo = [torch.minimum(a, b) for a, b in zip(t0, t1)]
    hi = [torch.maximum(a, b) for a, b in zip(t0, t1)]
    tn = torch.maximum(torch.maximum(lo[0], lo[1]), lo[2])
    tf = torch.minimum(torch.minimum(hi[0], hi[1]), hi[2])
    return (*pad_slab(tn, tf), meta[:, 0].long(), meta[:, 1].long())


def _tree_steps(scene, n_packets: int, device, walking=None):
    """Yield (packets, cursor) per step of the packet walks: the packets
    whose cursor is inside the forest and (when given) ``walking()``
    admits, and the cursors; the caller sets ``cursor[packets]`` to the
    next node."""
    cursor = torch.zeros((n_packets,), dtype=torch.long, device=device)
    while True:
        inside = cursor < scene.sl_n_nodes
        if walking is not None:
            inside &= walking()
        idx = torch.nonzero(inside)[:, 0]
        if idx.numel() == 0:
            return
        yield idx, cursor


def _lane_visits(scene, idx, lane, leaf):
    """The (packet, lane) pairs whose own gate admits the leaf their
    packet's cursor stands on, a few at a time: (packets [m], lanes [m],
    first slot [m], [9, m, block] MT rows)."""
    block = scene.sl_block
    p, ln = torch.nonzero(lane & (leaf > 0)[:, None], as_tuple=True)
    slots = torch.arange(block, device=leaf.device)
    step = max(1, _TREE_VISIT_ELEMS // block)
    for a in range(0, p.numel(), step):
        pa = p[a:a + step]
        start = (leaf[pa] - 1) * block
        yield (idx[pa], ln[a:a + step], start,
               scene.sl_tris_t[:, start[:, None] + slots])


def drain(steps):
    """The value a walk generator returns, its steps run and dropped."""
    while True:
        try:
            next(steps)
        except StopIteration as done:
            return done.value


def tree_walk_steps(o, d, t_prev, scene, width: int = GROUP):
    """The plain closest-hit walk as a generator, packets of ``width`` lanes
    (128, or 32 as the kernel's warps) sharing a cursor: yields (lane [m,
    width] bool, visit [m] bool, leaf [m]) for the packets of each step (the
    lanes whose own gate passed, whether some lane's did on a leaf, and the
    node's leaf field); returns (t, u, v, backface, slot), each [R] (slot -1
    and t = +inf on a miss). A lane tests a leaf only when its own gate
    passes, so its result does not depend on ``width``."""
    r = o.shape[0]
    widen = native.TREE_WALK_CUT_WIDEN
    o, d, inv, tp, layout = _packets(o, d, t_prev, float("inf"), width)
    bt = torch.full(tp.shape, float("inf"), device=o.device)
    bu = torch.zeros_like(bt)
    bv = torch.zeros_like(bt)
    bb = torch.zeros_like(bt, dtype=torch.bool)
    bi = torch.full_like(bt, -1, dtype=torch.int32)
    for idx, cursor in _tree_steps(scene, o.shape[0], o.device):
        tn, tf, escape, leaf = _node_slab(scene, layout[idx], cursor[idx],
                                          o[idx], inv[idx])
        lane = ((tf >= torch.maximum(tn, torch.zeros_like(tn)))
                & (tf > tp[idx]) & (tn <= bt[idx] * widen))
        hit_any = lane.any(1)
        yield lane, hit_any & (leaf > 0), leaf
        for pk, ln, start, rows in _lane_visits(scene, idx, lane, leaf):
            t, u, v, det, ok = mt_rows(
                [o[pk, ln, k, None] for k in range(3)],
                [d[pk, ln, k, None] for k in range(3)], rows)
            t = torch.where(ok & (t > tp[pk, ln, None]), t, float("inf"))
            tmin, col = t.min(dim=1)  # the lowest slot among equal t
            better = tmin < bt[pk, ln]
            pick = lambda x: x.gather(1, col[:, None])[:, 0]
            bt[pk, ln] = torch.where(better, tmin, bt[pk, ln])
            bu[pk, ln] = torch.where(better, pick(u), bu[pk, ln])
            bv[pk, ln] = torch.where(better, pick(v), bv[pk, ln])
            bb[pk, ln] = torch.where(better, pick(det) < 0.0, bb[pk, ln])
            slot = (start + col).to(torch.int32)
            bi[pk, ln] = torch.where(better, slot, bi[pk, ln])
        cursor[idx] = torch.where(hit_any & (leaf == 0), cursor[idx] + 1,
                                  escape)
    return tuple(x.reshape(-1)[:r] for x in (bt, bu, bv, bb, bi))


def occluded_tree_steps(o, d, t_max, scene, width: int = GROUP):
    """The plain any-hit walk as a generator: yields as ``tree_walk_steps``
    does; returns [R] bool (dead lanes True). A packet stops once every
    lane is occluded."""
    r = o.shape[0]
    o, d, inv, tm, layout = _packets(o, d, t_max, -1.0, width)
    occ = tm < 0.0
    for idx, cursor in _tree_steps(scene, o.shape[0], o.device,
                                   lambda: ~occ.all(1)):
        tn, tf, escape, leaf = _node_slab(scene, layout[idx], cursor[idx],
                                          o[idx], inv[idx])
        lane = (~occ[idx] & (tf >= torch.maximum(tn, torch.zeros_like(tn)))
                & (tn <= tm[idx]))
        hit_any = lane.any(1)
        yield lane, hit_any & (leaf > 0), leaf
        for pk, ln, _, rows in _lane_visits(scene, idx, lane, leaf):
            t, _, _, _, ok = mt_rows(
                [o[pk, ln, k, None] for k in range(3)],
                [d[pk, ln, k, None] for k in range(3)], rows)
            occ[pk, ln] = (ok & (t <= tm[pk, ln, None])).any(1)
        cursor[idx] = torch.where(hit_any & (leaf == 0), cursor[idx] + 1,
                                  escape)
    return occ.reshape(-1)[:r]


def occluded_triangles_tree_plain(o, d, t_max, scene) -> torch.Tensor:
    """Plain version of ``occluded_triangles_tree``, on any device."""
    return drain(occluded_tree_steps(o, d, t_max, scene))


def occluded_triangles_tree_multi_plain(o, ds, t_maxes, scene):
    """Plain version of ``occluded_triangles_tree_multi``: [L,R] bool."""
    return torch.stack([occluded_triangles_tree_plain(o, d, tm, scene)
                        for d, tm in zip(ds, t_maxes)])


def tree_record(t, u, v, back, slot, scene) -> HitRecord:
    """The HitRecord of a closest-hit tree walk's outputs."""
    kind = torch.where(torch.isfinite(t), KIND_TRIANGLE, KIND_NONE)
    return _record(t, u, v, back, slot, kind, scene)


def closest_hit_triangles_tree_plain(o, d, t_prev, scene) -> HitRecord:
    """Plain version of ``closest_hit_triangles_tree``, on any device."""
    return tree_record(*drain(tree_walk_steps(o, d, t_prev, scene)), scene)


def closest_hit_triangles_tree(o, d, t_prev, scene) -> HitRecord:
    """Closest hit through the superleaf tree walk (module docstring).

    o, d: [R,3] f32; t_prev: [R] f32 (+inf marks a dead lane). CUDA tensors
    launch the kernel (or raise); CPU tensors take the plain version."""
    if o.device.type == "cpu":
        return closest_hit_triangles_tree_plain(o, d, t_prev, scene)
    fout, slot = native.launch_tree_closest_hit(
        o.contiguous(), d.contiguous(), t_prev.contiguous(), scene.sl_nodes6,
        scene.sl_meta6, scene.sl_tris_t, scene.sl_n_nodes, scene.sl_block)
    counters["launch.tree_closest_hit"] += 1
    return tree_record(fout[0], fout[1], fout[2], fout[3] != 0.0, slot, scene)


def occluded_triangles_tree_multi(o, ds, t_maxes, scene) -> torch.Tensor:
    """Any-hit through the superleaf tree walk for L direction sets sharing
    one origin set, in one launch: a triangle hit with 1e-6 <= t <= t_max
    (t_max < 0 marks a dead lane, reported occluded). Arguments and result
    as ``occluded_triangles_flat_multi``. CUDA tensors launch the kernel (or
    raise); CPU tensors take the plain version, set by set."""
    if o.device.type == "cpu":
        return occluded_triangles_tree_multi_plain(o, ds, t_maxes, scene)
    out = native.launch_tree_occluded(
        o.contiguous(), stacked(ds), stacked(t_maxes), scene.sl_nodes6,
        scene.sl_meta6, scene.sl_tris_t, scene.sl_n_nodes, scene.sl_block)
    counters["launch.tree_occluded"] += 1
    return out


def occluded_triangles_tree(o, d, t_max, scene) -> torch.Tensor:
    """[R] bool any-hit through the superleaf tree walk: the multi-set
    launch with one set."""
    return occluded_triangles_tree_multi(o, [d], [t_max], scene)[0]
