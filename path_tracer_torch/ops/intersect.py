"""Closest-hit and any-hit intersection over the flat scene SoA.

Port of ``path_tracer_tpu/ops/intersect.py``: brute force under the BVH
threshold, the flat superleaf block walk above it, the two-level flat2
walk above ``FLAT_MAX_BLOCKS`` blocks.

Semantics:
- Möller-Trumbore with det cutoff 1e-6, no backface culling, u in [0,1],
  v >= 0, u+v <= 1, t > max(1e-6, t_prev); backface flag = det < 0.
- Analytic sphere quadratic in the centered oc = o - c form: each root valid
  iff >= 0 and > t_prev; the far root's normal is negated (inside hit).
- Ties keep the lowest primitive index.

``moller_trumbore``, ``closest_hit_triangles`` and ``closest_hit_spheres``
are the plain PyTorch versions: the port of the jnp reference path, used for
tensors on the CPU and as the reference the CUDA kernels are held against.
``closest_hit`` and ``occluded_multi`` dispatch on the scene and the
tensors' device:

- brute-force scenes (``use_bvh`` False): ``cuda_intersect`` (MT), then
  ``cuda_spheres`` merging its record as for flat2 below; shadows take
  the nearest triangle hit, light by light;
- BVH scenes (``use_bvh``) of at most ``FLAT_MAX_BLOCKS`` blocks (per
  scene or per opacity-partition view): ``cuda_bvh``'s flat walk with the
  dense sphere pass fused in (the JAX bench's ``PT_SPH_FUSE`` mode), and
  shadows through the exact-t_max any-hit, one launch for all of a
  bounce's lights;
- larger BVH scenes: the flat2 walk and its any-hit, the same way; the
  spheres are cast apart (``cuda_spheres``), and the dense sphere kernel
  merges the triangle record in its launch, the triangle winning ties
  (``merge_hits``, the plain version of that merge), as the JAX package
  fuses only on the flat walk;
- ``PT_BVH_KERNEL=flat|flat2|tree`` forces a walk (the JAX package's A/B
  knob, read at call time); a BVH scene without superleaf blocks takes
  "tree". The superleaf tree walk (``cuda_bvh``'s tree kernels) casts the
  closest hit with the spheres merged as for flat2, and the shadows light
  by light; under it the opacity partition stands down
  (``device_scene.partitioned``);
- spheres: the dense kernel up to 512 spheres, the sphere block walk
  above (``sph_use_blocks``); their any-hit likewise
  (``cuda_spheres.occluded_spheres_cuda``), all lights of a bounce in one
  launch, with the exact t_max of the triangle any-hit. The JAX package
  keeps its sphere any-hit elementwise in XLA, where a kernel launch is a
  fusion barrier; the port runs eagerly and fuses nothing, so the kernel
  (and, on the CPU, its plain version) serves it.

CUDA tensors go to the hand-written kernels, CPU tensors to their plain
versions. Every cast and any-hit entry is a discrete event and runs under
``torch.no_grad()`` (``_detach_for_kernel``), plain versions included, so
gradients on the CPU and on the card come from one graph.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import torch

DET_EPS = 1e-6
T_MIN = 1e-6

KIND_NONE = 0
KIND_TRIANGLE = 1
KIND_SPHERE = 2

# Rays per slice of the plain versions: bounds their [R, B] intermediates
# (about 30 of them) to a few GB at any wavefront size.
PLAIN_RAY_CHUNK = 1 << 16


class HitRecord(NamedTuple):
    """SoA closest-hit record for a ray wavefront. t = +inf means miss."""

    t: torch.Tensor  # [R] f32
    kind: torch.Tensor  # [R] int32 (0 none / 1 triangle / 2 sphere)
    prim: torch.Tensor  # [R] int32 index into tri_* or sph_* arrays
    u: torch.Tensor  # [R] f32 barycentric (triangles)
    v: torch.Tensor  # [R] f32
    backface: torch.Tensor  # [R] bool: tri det<0 | sphere far-root hit

    @property
    def valid(self):
        return self.kind != KIND_NONE


def _dot(a, b):
    return (a * b).sum(-1)


def _kind(t: torch.Tensor, kind: int) -> torch.Tensor:
    return torch.where(torch.isfinite(t), kind, KIND_NONE).to(torch.int32)


def moller_trumbore(o, d, v0, e1, e2, t_prev):
    """MT for [R] rays x [B] triangles → (t, u, v, back, valid), each [R,B].
    o,d: [R,3]; v0,e1,e2: [B,3]; t_prev: [R]. Component-wise, so only [R,B]
    intermediates exist."""
    t, u, v, det, ok = mt_rows([o[:, k:k + 1] for k in range(3)],
                               [d[:, k:k + 1] for k in range(3)],
                               [x[None, :, k] for x in (v0, e1, e2)
                                for k in range(3)])
    return t, u, v, det < 0.0, ok & (t > t_prev[:, None])


def mt_rows(o, d, rows):
    """Moller-Trumbore of ray components ``o``, ``d`` (3 tensors each)
    against triangle rows ``rows`` (9 tensors: v0.xyz, e1.xyz, e2.xyz), all
    broadcast together, in the hand-written kernels' expressions: (t, u, v,
    det, ok) with ok = |det| >= 1e-6, u >= 0, v >= 0, u + v <= 1 and
    t >= 1e-6 (u <= 1 follows; no t_prev)."""
    ox, oy, oz = o
    dx, dy, dz = d
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = rows
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    ok = det.abs() >= DET_EPS
    invdet = 1.0 / torch.where(ok, det, 1.0)
    tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * invdet
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * invdet
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * invdet
    ok = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t >= T_MIN)
    return t, u, v, det, ok


def _ray_chunks(n: int):
    return [slice(a, min(n, a + PLAIN_RAY_CHUNK))
            for a in range(0, max(n, 1), PLAIN_RAY_CHUNK)]


def closest_hit_triangles(o, d, t_prev, scene, block: int = 512) -> HitRecord:
    """Plain version: scan triangle blocks keeping a running argmin (a later
    block wins only on a strictly smaller t, so ties keep the lowest index).
    o,d: [R,3]; t_prev: [R]."""
    n = scene.tri_v0.shape[0]
    block = min(block, n)
    while n % block:  # n is padded to a multiple of 256
        block //= 2
    parts = []
    for rs in _ray_chunks(o.shape[0]):
        oc, dc, tpc = o[rs], d[rs], t_prev[rs]
        r = oc.shape[0]
        bt = torch.full((r,), float("inf"), device=o.device)
        bi = torch.full((r,), -1, dtype=torch.int32, device=o.device)
        bu = torch.zeros((r,), device=o.device)
        bv = torch.zeros((r,), device=o.device)
        bb = torch.zeros((r,), dtype=torch.bool, device=o.device)
        for a in range(0, n, block):
            t, u, v, back, valid = moller_trumbore(
                oc, dc, scene.tri_v0[a:a + block], scene.tri_e1[a:a + block],
                scene.tri_e2[a:a + block], tpc)
            t = torch.where(valid, t, float("inf"))
            tj, j = t.min(dim=1)  # first index among equal minima
            jj = j[:, None]
            better = tj < bt
            bt = torch.where(better, tj, bt)
            bi = torch.where(better, (j + a).to(torch.int32), bi)
            bu = torch.where(better, u.gather(1, jj)[:, 0], bu)
            bv = torch.where(better, v.gather(1, jj)[:, 0], bv)
            bb = torch.where(better, back.gather(1, jj)[:, 0], bb)
        parts.append((bt, bi, bu, bv, bb))
    bt, bi, bu, bv, bb = (torch.cat(x) for x in zip(*parts))
    return HitRecord(t=bt, kind=_kind(bt, KIND_TRIANGLE), prim=bi, u=bu, v=bv,
                     backface=bb)


def _sphere_quadratic(o, d, scene):
    """(a [R,1], b [R,S], cc [R,S]) of the per-sphere quadratic in the
    reference's centered oc = o - c form, component-wise so only [R,S]
    intermediates materialize.

    Do NOT rewrite this as |o|^2 - 2 o.c + |c|^2 - r^2 matmuls: that
    expansion cancels catastrophically in f32 for rays originating ON a
    sphere (shadow/bounce rays biased 1e-5 off the surface), producing
    spurious self-occlusion."""
    c = scene.sph_center  # [S,3]
    radius = scene.sph_radius  # [S]
    # a summed left to right, exactly as the kernel sums it.
    a = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2])[:, None]
    ocx = o[:, 0:1] - c[None, :, 0]  # [R,S]
    ocy = o[:, 1:2] - c[None, :, 1]
    ocz = o[:, 2:3] - c[None, :, 2]
    b = 2.0 * (ocx * d[:, 0:1] + ocy * d[:, 1:2] + ocz * d[:, 2:3])
    cc = ocx * ocx + ocy * ocy + ocz * ocz - (radius * radius)[None, :]
    return a, b, cc


def _sphere_roots(o, d, scene):
    """(has [R,S], t1, t2): the two roots, t1 <= t2, dividing by 2a."""
    a, b, cc = _sphere_quadratic(o, d, scene)
    disc = b * b - 4.0 * a * cc
    has = disc >= 0.0
    sq = torch.sqrt(torch.where(has, disc, 0.0))
    return has, (-b - sq) / (2.0 * a), (-b + sq) / (2.0 * a)


def closest_hit_spheres(o, d, t_prev, scene) -> HitRecord:
    """Plain version: nearest valid sphere root per ray. A root is valid iff
    >= 0 and > t_prev; the far root carries backface (inside hit)."""
    parts = []
    for rs in _ray_chunks(o.shape[0]):
        has, t1, t2 = _sphere_roots(o[rs], d[rs], scene)
        tp = t_prev[rs][:, None]
        v1 = has & (t1 >= 0.0) & (t1 > tp)
        v2 = has & (t2 >= 0.0) & (t2 > tp)
        t_near = torch.where(v1, t1, torch.where(v2, t2, float("inf")))
        far_root = ~v1 & v2
        tj, j = t_near.min(dim=1)
        parts.append((tj, j.to(torch.int32),
                      far_root.gather(1, j[:, None])[:, 0]))
    tj, j, back = (torch.cat(x) for x in zip(*parts))
    zeros = torch.zeros_like(tj)
    return HitRecord(t=tj, kind=_kind(tj, KIND_SPHERE), prim=j, u=zeros,
                     v=zeros, backface=back)


def merge_hits(tri: HitRecord, sph: HitRecord) -> HitRecord:
    """``closest_hit``'s merge of a triangle and a sphere record, field by
    field: the sphere's fields where its t is strictly smaller, else the
    triangle's (ties and two misses keep the triangle record). The plain
    version of the merge the dense sphere kernel makes in its launch."""
    tri_wins = tri.t <= sph.t
    return HitRecord(*[torch.where(tri_wins, a, b) for a, b in zip(tri, sph)])


def stacked(xs) -> torch.Tensor:
    """L per-set tensors as one contiguous [L, ...] tensor: a tensor is
    taken as it is (no copy when it is contiguous), a list is stacked."""
    if isinstance(xs, torch.Tensor):
        return xs.contiguous()
    return torch.stack(list(xs)).contiguous()


def _detach_for_kernel(fn):
    """The JAX package's ``_detach_for_kernel`` (``stop_gradient`` on a
    kernel's inputs) as a decorator: the entry runs under
    ``torch.no_grad()``, so it reads its rays and the scene's tables as
    values and its outputs carry no gradient. Hit selection is detached by
    design (gradients flow through shading), and the kernels have no
    backward."""
    return torch.no_grad()(fn)


def _miss_record(r: int, device) -> HitRecord:
    zeros = torch.zeros((r,), device=device)
    zi = torch.zeros((r,), dtype=torch.int32, device=device)
    return HitRecord(t=torch.full((r,), float("inf"), device=device), kind=zi,
                     prim=zi, u=zeros, v=zeros,
                     backface=torch.zeros((r,), dtype=torch.bool,
                                          device=device))


# Superleaf blocks the flat walk serves (``FLAT_MAX_BLOCKS`` of the JAX
# package: about 1M triangles at 512-triangle blocks); larger scenes take
# the two-level flat2 walk.
FLAT_MAX_BLOCKS = 2048


def _walk_variant(scene) -> str:
    """The triangle walk of a BVH scene (or view), as the JAX package's
    ``_walk_variant``: "tree" without superleaf blocks; else the walk
    ``PT_BVH_KERNEL`` names ("flat", "flat2" or "tree"); else "flat" up to
    FLAT_MAX_BLOCKS blocks and "flat2" above."""
    n = scene.sl_n_blocks
    if n <= 0:
        return "tree"
    forced = os.environ.get("PT_BVH_KERNEL")
    if forced in ("tree", "flat", "flat2"):
        return forced
    return "flat" if n <= FLAT_MAX_BLOCKS else "flat2"


def _use_flat_walk(scene) -> bool:
    """A flat-family walk (flat or flat2) serves the scene: the walks the
    opacity-partition views scope, and the batched any-hit launch."""
    return _walk_variant(scene) != "tree"


def _closest_hit_tris_dispatch(o, d, t_prev, scene) -> HitRecord:
    o, d = o.contiguous(), d.contiguous()
    if scene.use_bvh:
        from path_tracer_torch.ops import cuda_bvh

        walk = {"flat": cuda_bvh.closest_hit_triangles_flat,
                "flat2": cuda_bvh.closest_hit_triangles_flat2,
                "tree": cuda_bvh.closest_hit_triangles_tree}
        return walk[_walk_variant(scene)](o, d, t_prev, scene)
    from path_tracer_torch.ops.cuda_intersect import closest_hit_triangles_cuda

    return closest_hit_triangles_cuda(o, d, t_prev, scene)


@_detach_for_kernel
def closest_hit(o, d, t_prev, scene, active=None,
                include_spheres: bool = True) -> HitRecord:
    """Closest hit among all primitives with t > t_prev (t_prev = -1 for a
    fresh cast: triangles still enforce t > 1e-6, spheres allow t >= 0).
    ``active`` marks dead lanes t_prev = +inf, which no test passes.
    ``include_spheres=False`` casts against the triangles alone (the
    partitioned walks over the transparent view: every sphere is opaque
    and lives in the opaque cast)."""
    from path_tracer_torch.ops.cuda_spheres import closest_hit_spheres_cuda

    r = o.shape[0]
    has_tris = scene.num_real_triangles != 0
    has_sphs = include_spheres and scene.num_real_spheres != 0
    if active is not None:
        t_prev = torch.where(active, t_prev, float("inf"))
    if (has_tris and has_sphs and scene.use_bvh and not scene.sph_use_blocks
            and _walk_variant(scene) == "flat"):
        # The dense sphere pass runs inside the flat walk's launch and the
        # records merge there (a sphere wins only on a smaller t).
        from path_tracer_torch.ops.cuda_bvh import closest_hit_triangles_flat

        return closest_hit_triangles_flat(o.contiguous(), d.contiguous(),
                                          t_prev, scene, spheres=True)
    tri = (_closest_hit_tris_dispatch(o, d, t_prev, scene) if has_tris
           else _miss_record(r, o.device))
    if not has_sphs:
        return tri
    # The sphere cast merges the triangle record (``merge_hits``; on the
    # card inside the dense sphere kernel's launch).
    return closest_hit_spheres_cuda(o.contiguous(), d.contiguous(), t_prev,
                                    scene, tri=tri if has_tris else None)


def shadow_t_max(o, d, surf_pos, max_dist):
    """[R] the any-hit range limit as a t_max: +inf without ``max_dist``
    (a directional light), else the positive root of
    |o + t d - surf_pos| = max_dist, dist^2 = t^2|d|^2 + 2t(b.d) + |b|^2
    with b = o - surf_pos."""
    if max_dist is None:
        return torch.full((o.shape[0],), float("inf"), device=o.device)
    bvec = o - surf_pos
    b_dot_d, b_sq, d_sq = _dot(bvec, d), _dot(bvec, bvec), _dot(d, d)
    disc = b_dot_d * b_dot_d - d_sq * (b_sq - max_dist * max_dist)
    return (-b_dot_d + torch.sqrt(torch.clamp(disc, min=0.0))) / d_sq


@_detach_for_kernel
def occluded_multi(o, dirs, scene, surf_pos=None, max_dists=None,
                   actives=None) -> list:
    """Any-hit occlusion for L direction sets sharing one origin set (a
    bounce's shadow casts toward L lights). Returns L [R] bool.

    dirs: L [R,3]; max_dists: None or L entries ([R] or None); actives:
    None or L entries ([R] bool or None; dead lanes report False). For a
    point light pass surf_pos [R,3] and its max_dist [R]: an occluder
    counts only when its distance FROM THE SURFACE POINT is <= max_dist,
    the range limit turned into the exact t_max (``shadow_t_max``; dead
    lanes t_max = -1).

    The directions and t_max are stacked once, [L,R,3] and [L,R].
    Triangles: BVH scenes cast all L sets in one any-hit launch (flat,
    flat2 or tree, ``_walk_variant``) up to t_max; brute-force scenes take
    the nearest hit light by light, in range when
    dist^2 = t^2|d|^2 + 2t(b.d) + |b|^2 <= max_dist^2 (dist(t) is monotone
    in t, so if the nearest hit is out of range no hit is). Spheres: all L
    sets in one any-hit launch up to t_max, the triangles' [L,R] result
    handed to it as ``prior``: on the card the sphere kernel (dense or
    the walk) writes the final [L,R] bool, with no ATen op between the
    triangle launch and it.
    """
    n_lights = len(dirs)
    max_dists = max_dists or [None] * n_lights
    actives = actives or [None] * n_lights
    r = o.shape[0]

    t_maxes = []
    for d, md, act in zip(dirs, max_dists, actives):
        tm = shadow_t_max(o, d, surf_pos, md)
        t_maxes.append(tm if act is None else torch.where(act, tm, -1.0))
    ds, tms = stacked(dirs), stacked(t_maxes)
    hits = None  # [L,R] bool, or None for no triangle
    if scene.num_real_triangles != 0 and scene.use_bvh:
        from path_tracer_torch.ops import cuda_bvh

        multi = {"tree": cuda_bvh.occluded_triangles_tree_multi,
                 "flat2": cuda_bvh.occluded_triangles_flat2_multi,
                 "flat": cuda_bvh.occluded_triangles_flat_multi}
        hits = multi[_walk_variant(scene)](o, ds, tms, scene)
    elif scene.num_real_triangles != 0:
        per_light = []
        for d, md, act in zip(dirs, max_dists, actives):
            t_prev = torch.full((r,), -1.0, device=o.device)
            if act is not None:
                t_prev = torch.where(act, t_prev, float("inf"))
            tri = _closest_hit_tris_dispatch(o, d, t_prev, scene)
            hit = tri.valid
            if md is not None:
                bvec = o - surf_pos
                t = tri.t
                dist_sq = (t * t * _dot(d, d) + 2.0 * t * _dot(bvec, d)
                           + _dot(bvec, bvec))
                hit = hit & (dist_sq <= md * md)
            per_light.append(hit)
        hits = torch.stack(per_light)

    if scene.num_real_spheres != 0:
        from path_tracer_torch.ops.cuda_spheres import occluded_spheres_cuda

        hits = occluded_spheres_cuda(o, ds, tms, scene, prior=hits)
    elif hits is None:
        hits = torch.zeros((n_lights, r), dtype=torch.bool, device=o.device)
    return [h if act is None else h & act for h, act in zip(hits, actives)]
