"""Sphere closest hit and any-hit: the CUDA kernels' wrappers, and the
plain versions of the block walks and the any-hit.

Counterpart of ``path_tracer_tpu/ops/pallas_spheres.py``:

- ``csrc/sphere_closest_hit.cu`` replaces ``pallas_spheres._kernel``
  (entry ``closest_hit_spheres_pallas``) for scenes of at most 512
  spheres: dense, every ray against every sphere, the launch writing the
  whole HitRecord and merging a triangle record into it;
- ``csrc/sph_walk.cu`` replaces ``pallas_spheres._sph_walk_kernel``
  (``_sph_walk_launch``, the same entry with ``sph_use_blocks``) for
  larger scenes: a walk over SAH blocks of 128 spheres in warp packets,
  its launch too writing the whole HitRecord and merging a triangle
  record;
- ``csrc/sph_occ.cu`` replaces ``pallas_spheres._occ_kernel`` and
  ``_sph_occ_walk_kernel`` (entry ``occluded_spheres_pallas``): the
  any-hit, dense up to 512 spheres (one thread per ray for all L sets)
  and the block walk above (warp packets of 32 (ray, set) lanes), for L
  direction sets in one launch, each folding the triangle any-hit's
  result in as ``prior``.

Bound on the card: arithmetic. The dense kernels do R*S quadratic solves
(about 25 flops, a sqrt and an IEEE division or reciprocal per valid
discriminant), the walks a slab test per block and the solves of the
blocks a ray's slab test admits. The kernels read their sphere tables
through the read-only cache, as broadcasts or one slot a lane. The
any-hit kernels stop a lane at its first occluder.

Two root forms, as in the JAX package. The dense closest hit and
``intersect.closest_hit_spheres`` divide by 2a; the block walk, the
any-hit kernels and their plain versions keep the TPU kernels' naive
quadratic (oc = o - c, a = |d|^2, b = 2 oc.d, c = |oc|^2 - r^2,
disc = b^2 - 4ac) and multiply by inv2a = 1 / (2a). Sphere walk
semantics:

- block gate: slab entry tn and exit tf of the block AABB (zero direction
  components inverted to 1e30), tf >= max(tn, 0), tf > t_prev, id >= 0;
- per sphere: has = disc >= 0, sq = sqrt(has ? disc : 0),
  t1 = (-b - sq) inv2a, t2 = (-b + sq) inv2a; root k valid iff has,
  tk >= 0 and tk > t_prev; t = t1 if valid, else t2 if valid, else +inf;
  backface = the far root alone is valid;
- TIE RULE: the lexicographic (t, sorted slot) minimum;
- pad slots (center 1e30, radius 0) overflow: disc is NaN, has false;
- a dead lane is t_prev = +inf; a miss is t = +inf, slot -1;
- the record: prim = ``sph_smap`` of the sorted slot on a hit, 0 on a
  miss, u = v = 0, merged with a triangle record by ``merge_hits``.

Any-hit semantics (both kernels): a ray is occluded when some sphere has
a root t with 0 <= t <= t_max (has, and the root in range); the walk's
block gate is tf >= max(tn, 0), tn <= t_max, t_max >= 0, id >= 0 on the
boxes and intervals widened as the flat walks widen theirs
(``slab.padded_slab``): on the exact boxes a ray aimed where a sphere
touches a face of its block's box can round its entry past the root and
lose the occluder. A dead lane (t_max < 0) is NOT occluded by a sphere,
unlike the triangle any-hit. A ``prior`` [L,R] bool is ORed in, by both
kernels in their launch (a set whose prior is set costs no sphere
test).

Each kernel is built -fmad=false and sums in its plain version's order,
so the two agree exactly.
"""
from __future__ import annotations

import torch

from path_tracer_torch import native
from path_tracer_torch.ops.intersect import (
    KIND_SPHERE,
    HitRecord,
    _kind,
    _ray_chunks,
    closest_hit_spheres,
    merge_hits,
    stacked,
)
from path_tracer_torch.ops.slab import (
    closest_gate,
    live_columns,
    merge_nearest,
    occluded_gate,
    padded_slab,
    safe_inv,
    slab,
)

# Kernel launches made in this process by closest_hit_spheres_cuda (the
# dense kernel and the block walk) and by occluded_spheres_cuda (the dense
# any-hit and the any-hit walk).
launches = 0
sph_walk_launches = 0
occluded_launches = 0
sph_occ_walk_launches = 0


def _sqrt_rn(x):
    """float32 square root rounded to nearest, as the kernel's IEEE sqrtf:
    the float64 root of a float32 operand, rounded once to float32, is the
    correctly rounded float32 root. The CPU's vectorised float32 sqrt can
    land an ulp off."""
    return torch.sqrt(x.double()).float()


def _sph_walk_plain(o, d, t_prev, scene):
    """The plain sphere block walk → (t, backface, sorted slot), each [R]
    (t = +inf and slot -1 on a miss)."""
    sph, blkid = scene.sph_sorted_t, scene.sph_blkid[0]
    parts = []
    for rs in _ray_chunks(o.shape[0]):
        oc, dc, tpc = o[rs], d[rs], t_prev[rs]
        r = oc.shape[0]
        tn, tf = slab(oc, safe_inv(dc), scene.sph_blk)
        gate = closest_gate(tn, tf, tpc, blkid)
        a = dc[:, 0] * dc[:, 0] + dc[:, 1] * dc[:, 1] + dc[:, 2] * dc[:, 2]
        inv2a = 1.0 / (2.0 * a)
        bt = torch.full((r,), float("inf"), device=o.device)
        bs = torch.full((r,), -1, dtype=torch.int32, device=o.device)
        bb = torch.zeros((r,), dtype=torch.bool, device=o.device)
        for col in live_columns(gate):
            lanes = torch.nonzero(gate[:, col])[:, 0]
            start = int(blkid[col]) * 128
            c = sph[:, start:start + 128]
            lo, ld, tp = oc[lanes], dc[lanes], tpc[lanes][:, None]
            ocx = lo[:, 0:1] - c[None, 0]
            ocy = lo[:, 1:2] - c[None, 1]
            ocz = lo[:, 2:3] - c[None, 2]
            b = 2.0 * (ocx * ld[:, 0:1] + ocy * ld[:, 1:2] + ocz * ld[:, 2:3])
            cc = ocx * ocx + ocy * ocy + ocz * ocz - (c[3] * c[3])[None, :]
            disc = b * b - 4.0 * a[lanes][:, None] * cc
            has = disc >= 0.0
            sq = _sqrt_rn(torch.where(has, disc, 0.0))
            t1 = (-b - sq) * inv2a[lanes][:, None]
            t2 = (-b + sq) * inv2a[lanes][:, None]
            v1 = has & (t1 >= 0.0) & (t1 > tp)
            v2 = has & (t2 >= 0.0) & (t2 > tp)
            t = torch.where(v1, t1, torch.where(v2, t2, float("inf")))
            j, better = merge_nearest(t, start, lanes, bt, bs)
            far = (~v1 & v2).gather(1, j[:, None])[:, 0]
            bb[lanes] = torch.where(better, far, bb[lanes])
        parts.append((bt, bb, bs))
    return tuple(torch.cat(x) for x in zip(*parts))


def closest_hit_spheres_walk_plain(o, d, t_prev, scene) -> HitRecord:
    """Plain version of the sphere block walk, on any device: its
    HitRecord, prim = ``sph_smap`` of the sorted slot on a hit, 0 on a
    miss; u = v = 0."""
    t, back, slot = _sph_walk_plain(o, d, t_prev, scene)
    hit = torch.isfinite(t)
    prim = torch.where(hit, scene.sph_smap[slot.clamp(min=0).long()], 0)
    zeros = torch.zeros_like(t)
    return HitRecord(t=t, kind=_kind(t, KIND_SPHERE),
                     prim=prim.to(torch.int32), u=zeros, v=zeros,
                     backface=back)


def closest_hit_spheres_walk_merged_plain(o, d, t_prev, scene,
                                          tri=None) -> HitRecord:
    """Plain version of the sphere walk kernel, on any device: the walk's
    record, merged with the triangle record ``tri`` (``merge_hits``) when
    one is given."""
    sph = closest_hit_spheres_walk_plain(o, d, t_prev, scene)
    return sph if tri is None else merge_hits(tri, sph)


def closest_hit_spheres_merged_plain(o, d, t_prev, scene,
                                     tri=None) -> HitRecord:
    """Plain version of the dense kernel, on any device: the dense sphere
    cast, merged with the triangle record ``tri`` (``merge_hits``) when
    one is given."""
    sph = closest_hit_spheres(o, d, t_prev, scene)
    return sph if tri is None else merge_hits(tri, sph)


def closest_hit_spheres_cuda(o, d, t_prev, scene, tri=None) -> HitRecord:
    """Nearest sphere root of each ray that is >= 0 and > t_prev: the block
    walk when ``scene.sph_use_blocks``, else the dense pass; with ``tri``
    (a triangle HitRecord of the same rays) the closest of the two, a
    sphere winning only on a strictly smaller t (``merge_hits``).

    o, d: [R,3] f32; t_prev: [R] f32 (+inf marks a dead lane); reads
    ``scene.sph_packed_t`` [4, S] or the ``sph_*`` block tables. CUDA
    tensors launch the kernel (or raise), which writes the whole record,
    merge included, in its launch; CPU tensors take the plain version."""
    global launches, sph_walk_launches
    walk = getattr(scene, "sph_use_blocks", False)
    if o.device.type == "cpu":
        plain = (closest_hit_spheres_walk_merged_plain if walk
                 else closest_hit_spheres_merged_plain)
        return plain(o, d, t_prev, scene, tri)
    if walk:
        fout, iout, back = native.launch_sph_walk(
            o, d, t_prev, scene.sph_blk, scene.sph_blkid, scene.sph_sorted_t,
            scene.sph_smap, tri)
        sph_walk_launches += 1
    else:
        fout, iout, back = native.launch_sphere_closest_hit(
            o, d, t_prev, scene.sph_packed_t, tri)
        launches += 1
    return HitRecord(t=fout[0], kind=iout[0], prim=iout[1], u=fout[1],
                     v=fout[2], backface=back)


def _any_root(o, d, sph, t_max):
    """[n] bool: has one of the spheres ``sph`` [4, S] a root in
    [0, t_max] for each of the n rays, in the any-hit kernels' naive
    quadratic."""
    a = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
    inv2a = (1.0 / (2.0 * a))[:, None]
    ocx = o[:, 0:1] - sph[None, 0]
    ocy = o[:, 1:2] - sph[None, 1]
    ocz = o[:, 2:3] - sph[None, 2]
    b = 2.0 * (ocx * d[:, 0:1] + ocy * d[:, 1:2] + ocz * d[:, 2:3])
    cc = ocx * ocx + ocy * ocy + ocz * ocz - (sph[3] * sph[3])[None, :]
    disc = b * b - (4.0 * a)[:, None] * cc
    has = disc >= 0.0
    sq = _sqrt_rn(torch.where(has, disc, 0.0))
    t1 = (-b - sq) * inv2a
    t2 = (-b + sq) * inv2a
    tm = t_max[:, None]
    return (has & (((t1 >= 0.0) & (t1 <= tm))
                   | ((t2 >= 0.0) & (t2 <= tm)))).any(dim=1)


def _occluded_dense_plain(o, d, t_max, scene):
    """The dense any-hit over the scene's real spheres → [R] bool."""
    sph = scene.sph_packed_t[:, :scene.num_real_spheres]
    return torch.cat([_any_root(o[rs], d[rs], sph, t_max[rs])
                      for rs in _ray_chunks(o.shape[0])])


def _occluded_walk_plain(o, d, t_max, scene):
    """The any-hit walk over the sphere blocks → [R] bool: every block a
    lane's gate admits, on the widened boxes and intervals
    (``slab.padded_slab``), until it is occluded."""
    sph, blkid = scene.sph_sorted_t, scene.sph_blkid[0]
    parts = []
    for rs in _ray_chunks(o.shape[0]):
        oc, dc, tmc = o[rs], d[rs], t_max[rs]
        tn, tf = padded_slab(oc, safe_inv(dc), scene.sph_blk)
        gate = occluded_gate(tn, tf, tmc, blkid)
        occ = torch.zeros_like(tmc, dtype=torch.bool)
        for col in live_columns(gate):
            lanes = torch.nonzero(gate[:, col] & ~occ)[:, 0]
            if lanes.numel():
                start = int(blkid[col]) * 128
                occ[lanes] = _any_root(oc[lanes], dc[lanes],
                                       sph[:, start:start + 128], tmc[lanes])
        parts.append(occ)
    return torch.cat(parts)


def occluded_spheres_plain(o, ds, t_maxes, scene, prior=None) -> torch.Tensor:
    """Plain version of ``occluded_spheres_cuda``, on any device (the dense
    any-hit or the walk): [L,R] bool, set by set, ORed with ``prior`` when
    one is given, as both kernels write it."""
    one = (_occluded_walk_plain if getattr(scene, "sph_use_blocks", False)
           else _occluded_dense_plain)
    out = torch.stack([one(o, d, tm, scene) for d, tm in zip(ds, t_maxes)])
    return out if prior is None else prior | out


def occluded_spheres_cuda(o, ds, t_maxes, scene, prior=None) -> torch.Tensor:
    """Sphere any-hit for L direction sets sharing one origin set, in one
    launch: the block walk when ``scene.sph_use_blocks``, else the dense
    pass.

    o: [R,3] f32; ds: [L,R,3] f32 or a list of L [R,3]; t_maxes: [L,R] f32
    or a list of L [R] (the exact range limit, +inf for a directional
    light; < 0 marks a dead lane, reported not occluded by a sphere);
    prior: None or [L,R] bool (the triangle any-hit's result). Returns
    [L,R] bool, prior | occluded by a sphere. CUDA tensors launch the
    kernel (or raise), which writes that bool, prior folded in: the walk
    in one launch, the dense kernel one launch per
    ``native.SPH_OCC_MAX_SETS`` sets; CPU tensors take the plain
    version."""
    global occluded_launches, sph_occ_walk_launches
    if o.device.type == "cpu":
        return occluded_spheres_plain(o, ds, t_maxes, scene, prior)
    o, ds, t_maxes = o.contiguous(), stacked(ds), stacked(t_maxes)
    if prior is not None:
        prior = prior.contiguous()  # the triangle launch's output already is
    if not getattr(scene, "sph_use_blocks", False):
        step = native.SPH_OCC_MAX_SETS
        if ds.shape[0] > step:  # more sets than a lane holds: chunks
            return torch.cat([occluded_spheres_cuda(
                o, ds[k:k + step], t_maxes[k:k + step], scene,
                None if prior is None else prior[k:k + step])
                for k in range(0, ds.shape[0], step)])
        out = native.launch_sph_occluded(o, ds, t_maxes, scene.sph_packed_t,
                                         scene.num_real_spheres, prior)
        occluded_launches += 1
        return out
    out = native.launch_sph_occ_walk(o, ds, t_maxes, scene.sph_blk,
                                     scene.sph_blkid, scene.sph_sorted_t,
                                     prior)
    sph_occ_walk_launches += 1
    return out
