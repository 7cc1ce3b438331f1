"""Wavefront unidirectional Monte Carlo path-tracing integrator.

Port of ``path_tracer_tpu/models/integrator.py``. Path state lives in
[R]-batched tensors over a ray wavefront; the JAX package's ``lax.scan``
over bounces and its ``while_loop`` walks are Python loops here (PyTorch
runs eagerly), and its ``lax.cond(any(...))`` gates are host checks.

Semantics reproduced exactly (reference quirks included):

- Bounce loop runs bounces+1 iterations.
- A ray that hits nothing on the FIRST cast of a bounce returns
  color + throughput*background.
- Stochastic alpha walk: hits are visited in distance order; a hit is
  accepted when ``op >= 1 || (op > 0.001 && rand < op)``, with the uniform
  of site SITE_ALPHA + k at step k. If NO hit accepts, the FARTHEST
  visited hit still shades. All-opaque scenes collapse it to ONE
  closest-hit cast with no opacity sampling or rng draw.
- Shadows: directional lights multiply (1 - opacity) over ALL occluders,
  stopping at zero; point lights stop at the first occluder farther from
  the surface than the light and sample its opacity at the ORIGINAL hit's
  UV and type (reference quirk). All-opaque scenes make this a binary
  any-hit, cast for every light at once per bounce (``occluded_multi``),
  directional lights first, then point lights, as in the JAX package.
- Partitioned scenes (``device_scene.partitioned``: a BVH scene with
  opaque and possibly-transparent triangles, opaque spheres) cast the
  opaque half once (the alpha walk's terminator, the lights' any-hit) and
  walk only the transparent triangles, through the walk kernels
  (``ops/cuda_trwalk.py``) for the first ``TRWALK_K`` steps and the exact
  cast walk after them. Other non-opaque scenes take the re-cast walks
  over the whole scene. The walk bounds default to the scene's
  ``num_transparent_hits`` + 1, which reproduces the reference's unbounded
  sorted-hit iteration.
- Fused shadows: with the environment variable ``PT_FUSED_SHADOW=1`` (the
  JAX package's own opt-in, off by default there and here), a partitioned
  scene with the walk kernels' tables and a flat whole-scene walk casts
  every light's opaque any-hit and transmittance walk in one launch
  (``ops/cuda_shadow.py``), the same values as the two launches.
- The partitioned walks route as the JAX package's do on its chip: the
  walk kernels first (off with ``PT_NO_TRWALK_KERNEL=1``); else the dense
  walk with ``PT_DENSE_TR=1`` (off with ``PT_NO_DENSE_TR=1``) when the
  transparent slice holds 0 < T <= ``PT_DENSE_TR_MAX`` (4,096) triangles:
  one ``cuda_khit.k_nearest_tr_hits`` launch yields each lane's
  ``PT_DENSE_TR_K`` (6) nearest transparent hits, the walk visits those
  columns with no further cast and the exact cast walk goes on past them;
  else the cast walk. The route is the same on the CPU and the card (the
  JAX package takes the dense walk by default off its chip; the port
  does not). With ``PT_BVH_KERNEL=tree`` (``ops/intersect.py``) the
  partition stands down and the whole-scene walks run. Every knob is read
  at call time.
- Emissive adds throughput*emissive each bounce, and AGAIN inside
  eval_direct scaled by light radiance (reference quirk).
- Point lights: radiance = color/(4*pi*r^2).
- Lights whose radiance is exactly zero are skipped (masked, so NaNs from
  eval_direct cannot leak through a zero light).
- Indirect bounce: new origin = hit + geometric_normal*1e-5,
  throughput *= eval_indirect (pdf == 1).
- Throughput cutoff ||T||^2 < 1e-5 terminates.
- Russian roulette only when bounce > 3: p = max(T), T /= p
  unconditionally, kill when rand > p.
- Shading normal: barycentric-interpolated vertex normal (NOT normalized),
  TBN normal mapping when the material has a normal texture, then backface
  flip. The geometric normal used for ray bias is the unflipped
  interpolated normal.

The RNG site layout (``rng.site_layout``) is the JAX package's, so the
port draws the same uniforms for every (pixel, sample, bounce, walk step)
and renders the same image up to float rounding.

Gradients (``IntegratorSpec.differentiable``; ``parallel/train.py``) use
detached sampling, as the JAX package does: they flow through shading
(positions, light falloff, the BRDF, texture gathers, the camera and the
reparameterized hit point) into the scene's tensors, and never through
intersection, walk decisions, sampled directions or RR kills. Where the
JAX package calls ``stop_gradient`` the port runs the discrete section
under ``torch.no_grad()``: every cast and any-hit (``ops/intersect.py``),
both walks (the alpha walk whole; the shadow walks up to their
transmittance, which multiplies the light colour outside so the colour's
gradient flows around it) and the direction sample. Nothing else is
detached: RR's ``p`` keeps its gradient. With ``differentiable`` the walk
kernels run their live variants: they read the opacity-factor row and the
f32 opacity page plane rebuilt from the live ``mat_opacity_factor`` and
``tex_data`` (``trwalk.live_tables``, built once per ``render_wavefront``
call), as the JAX package's training mode does.
"""
from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple, Optional

import torch

from path_tracer_torch.ops import (
    brdf,
    cuda_khit,
    cuda_shadow,
    cuda_trwalk,
    rng,
    texturing,
    trwalk,
)
from path_tracer_torch.ops.cuda_spheres import occluded_spheres_cuda
from path_tracer_torch.ops.intersect import (
    KIND_NONE,
    KIND_TRIANGLE,
    HitRecord,
    _miss_record,
    _walk_variant,
    closest_hit,
    mt_rows,
    occluded_multi,
    shadow_t_max,
)
from path_tracer_torch.ops.trwalk import ALPHA_MIN_OPACITY
from path_tracer_torch.scene.device_scene import (
    TorchScene,
    opaque_view,
    partitioned,
    transparent_view,
)

NORMAL_BIAS = 1e-5
THROUGHPUT_CUTOFF = 1e-5
PI = 3.14159265358979323846


@dataclasses.dataclass(frozen=True)
class IntegratorSpec:
    """Static integrator parameters."""

    bounces: int = 4
    # None = auto: the scene's num_transparent_hits + 1 (exactly the
    # reference's unbounded walk); an int truncates the walk.
    alpha_walk_steps: Optional[int] = None
    shadow_walk_steps: Optional[int] = None
    seed: int = 0
    # True: the hit point's reparameterization (its gradient slides along
    # the surface) and the walk kernels' live variants; the training path
    # sets it. Unlike the JAX package's (default True), the port's default
    # is False: every other caller renders forward and is held against the
    # JAX package's differentiable=False. Radiance is the same up to the
    # rounding of the reparameterized hit point.
    differentiable: bool = False


class Surface(NamedTuple):
    """Shading data at the selected hit of one bounce."""

    pos: torch.Tensor  # [R,3]
    geom_normal: torch.Tensor  # [R,3] (unflipped interp normal / sphere normal)
    normal: torch.Tensor  # [R,3] shading normal (normal map + backface flip)
    uv: torch.Tensor  # [R,2]
    model: torch.Tensor  # [R] int32
    simple: torch.Tensor  # [R] bool — sphere hits sample factors only


def _dot(a, b):
    return (a * b).sum(-1)


def _tri_index(scene, prim):
    """Triangle gather index of clamped prims [R]: a sphere lane's prim may
    exceed the triangle count; clamped as the JAX package's gathers clamp
    (those lanes' values are discarded)."""
    return torch.clamp(prim, max=scene.tri_v0.shape[0] - 1)


def _hit_model_uv(scene, hit: HitRecord):
    """(model_id [R], uv [R,2], simple [R]) for any hit record. Scenes with a
    single primitive class skip the other class's gathers."""
    prim = torch.clamp(hit.prim, min=0).long()
    if scene.num_real_triangles == 0:
        sph_i = torch.clamp(prim, max=scene.sph_model.shape[0] - 1)
        r = prim.shape[0]
        return (scene.sph_model[sph_i],
                torch.zeros((r, 2), device=prim.device),
                torch.ones((r,), dtype=torch.bool, device=prim.device))
    is_tri = hit.kind == KIND_TRIANGLE
    tri_i = _tri_index(scene, prim)
    w = hit.u[:, None]
    ww = hit.v[:, None]
    uv0 = scene.tri_uv0[tri_i]
    uv = (uv0 + w * (scene.tri_uv1[tri_i] - uv0)
          + ww * (scene.tri_uv2[tri_i] - uv0))
    tri_model = scene.tri_model[tri_i]
    if scene.num_real_spheres == 0:
        return tri_model, uv, torch.zeros_like(is_tri)
    sph_i = torch.clamp(prim, max=scene.sph_model.shape[0] - 1)
    model = torch.where(is_tri, tri_model, scene.sph_model[sph_i])
    uv = torch.where(is_tri[:, None], uv, 0.0)
    return model, uv, ~is_tri


def _reparam_t(scene, hit: HitRecord, o, d, t_safe, is_tri, tri_i, sph_i):
    """[R] the hit distance as a function of the live o, d and sphere
    tables (the JAX package's ``_surface`` with ``differentiable``). hit.t
    is a detached intersector output, so o + t d alone would move the hit
    point OFF the surface when o or d depend on a parameter.

    Triangles: t = ((p0 - o).n) / (d.n) with the anchor p0 = o + t d and
    the face normal detached: equal to t up to rounding, its derivative
    slides the hit point along the plane. Grazing lanes keep the detached
    t. Spheres: the quadratic root from the live centre and radius (the
    near or far root as hit.backface says), straight through: the value is
    t, the derivative the root's."""
    p0 = (o + d * t_safe[:, None]).detach()
    finite = torch.isfinite(hit.t)
    t_tri = t_sph = None
    if scene.num_real_triangles != 0:
        plane_n = torch.linalg.cross(scene.tri_e1[tri_i],
                                     scene.tri_e2[tri_i]).detach()
        dn = _dot(d, plane_n)
        ok_plane = dn.abs() > 1e-12 * (_dot(p0 - o, plane_n).abs()
                                       + 1.0).detach()
        t_plane = _dot(p0 - o, plane_n) / torch.where(ok_plane, dn, 1.0)
        t_tri = torch.where(ok_plane & finite, t_plane, t_safe)
    if scene.num_real_spheres != 0:
        oc = o - scene.sph_center[sph_i]
        radius = scene.sph_radius[sph_i]
        aq = _dot(d, d)
        bq = _dot(oc, d)  # half-b form of the quadratic
        cq = _dot(oc, oc) - radius * radius
        disc = bq * bq - aq * cq
        ok_sph = disc > 0.0
        sq = torch.sqrt(torch.where(ok_sph, disc, 1.0))
        root = (-bq + torch.where(hit.backface, sq, -sq)) / aq
        t_quad = torch.where(ok_sph & finite, root, t_safe)
        t_sph = t_safe + (t_quad - t_quad.detach())
    if t_tri is None:
        return t_sph
    if t_sph is None:
        return t_tri
    return torch.where(is_tri, t_tri, t_sph)


def _surface(scene, hit: HitRecord, o, d,
             differentiable: bool = False) -> Surface:
    """Shading geometry at the selected hits. Forward rendering takes the
    hit point o + t d; ``differentiable`` the reparameterized t
    (``_reparam_t``), the same point up to rounding."""
    is_tri = hit.kind == KIND_TRIANGLE
    prim = torch.clamp(hit.prim, min=0).long()
    sph_i = torch.clamp(prim, max=scene.sph_center.shape[0] - 1)
    tri_i = _tri_index(scene, prim)
    # Miss lanes carry t = +inf; their Surface is masked out downstream,
    # but inf would still poison a gradient through torch.where (0 * inf).
    t_safe = torch.where(torch.isfinite(hit.t), hit.t, 0.0)
    if differentiable:
        t_safe = _reparam_t(scene, hit, o, d, t_safe, is_tri, tri_i, sph_i)
    pos = o + d * t_safe[:, None]
    model, uv, simple = _hit_model_uv(scene, hit)

    # Triangle: barycentric vertex-normal interpolation (NOT normalized).
    n_interp = None
    if scene.num_real_triangles != 0:
        w1 = hit.u[:, None]
        w2 = hit.v[:, None]
        n_interp = ((1.0 - w1 - w2) * scene.tri_n0[tri_i]
                    + w1 * scene.tri_n1[tri_i] + w2 * scene.tri_n2[tri_i])

    # Sphere geometric normal: outward, negated for far-root (inside) hits.
    sph_n = None
    if scene.num_real_spheres != 0:
        sph_n = pos - scene.sph_center[sph_i]
        sph_n = sph_n * torch.rsqrt(torch.clamp(
            (sph_n * sph_n).sum(-1, keepdim=True), min=1e-24))
        sph_n = torch.where(hit.backface[:, None], -sph_n, sph_n)

    if n_interp is None:
        return Surface(pos=pos, geom_normal=sph_n, normal=sph_n, uv=uv,
                       model=model, simple=simple)
    geom_n = (n_interp if sph_n is None
              else torch.where(is_tri[:, None], n_interp, sph_n))
    # Normal mapping (triangles with a normal texture): TBN*map, normed.
    nm, has_map = texturing.sample_normal_map(scene, model, uv)
    if nm is None:
        tri_shading_n = n_interp
    else:
        tangent = scene.tri_tangent[tri_i]
        bitangent = torch.linalg.cross(n_interp, tangent)
        mapped = (tangent * nm[:, 0:1] + bitangent * nm[:, 1:2]
                  + n_interp * nm[:, 2:3])
        mapped = mapped * torch.rsqrt(torch.clamp(
            (mapped * mapped).sum(-1, keepdim=True), min=1e-24))
        tri_shading_n = torch.where((has_map & is_tri)[:, None], mapped,
                                    n_interp)
    # Backface flip applies to triangles only (sphere normals pre-negate).
    tri_shading_n = torch.where((hit.backface & is_tri)[:, None],
                                -tri_shading_n, tri_shading_n)
    normal = (tri_shading_n if sph_n is None
              else torch.where(is_tri[:, None], tri_shading_n, sph_n))
    return Surface(pos=pos, geom_normal=geom_n, normal=normal, uv=uv,
                   model=model, simple=simple)


def _select(mask, a: HitRecord, b: HitRecord) -> HitRecord:
    """Per lane, record ``a`` where ``mask`` else ``b``."""
    return HitRecord(*[torch.where(mask, x, y) for x, y in zip(a, b)])


def _alpha_cast_walk(scene, cast_scene, o, d, pix, sample_id, bounce, spec,
                     steps, k0, state, t_op=None, prim_base: int = 0):
    """Steps k0 .. steps-1 of the alpha re-cast walk, stopping when no lane
    walks. ``state`` = (sel, seen, accepted, t_prev, active). Step k casts
    against ``cast_scene`` past t_prev, takes the hit (within t_op, when
    given: the partitioned walk's opaque terminator, whose transparent
    view holds no spheres) and accepts it with uniform site SITE_ALPHA + k.
    ``prim_base`` is added to the cast's prims (a view whose triangles
    start there, ``_transparent_mt_view``). Returns (sel, seen,
    accepted)."""
    sel, seen, accepted, t_prev, active = state
    stride = rng.site_layout(steps)[3]
    for k in range(k0, steps):
        if not bool(active.any()):
            break
        hit = closest_hit(o, d, t_prev, cast_scene, active=active,
                          include_spheres=t_op is None)
        hit = hit._replace(prim=hit.prim + prim_base)
        found = active & hit.valid
        if t_op is not None:
            found = found & (hit.t < t_op)
        model, uv, simple = _hit_model_uv(scene, hit)
        op = texturing.sample_opacity(scene, model, uv, simple)
        rnd = rng.uniform(pix, sample_id, rng.SITE_ALPHA + k + stride * bounce,
                          spec.seed)
        accept = (op >= 1.0) | ((op > ALPHA_MIN_OPACITY) & (rnd < op))
        # The walk records every visited hit; the last one shades if none
        # accepts.
        sel = _select(found, hit, sel)
        seen = seen | found
        accepted = accepted | (found & accept)
        active = found & ~accept
        t_prev = torch.where(active, hit.t, t_prev)
    return sel, seen, accepted


@torch.no_grad()
def _alpha_walk(scene, o, d, walking, pix, sample_id, bounce, spec,
                steps: int, live=None):
    """The stochastic alpha walk. Returns (sel: the shading hit, seen [R],
    first_missed [R]); first_missed = the walk found nothing → background
    path. Dead lanes are cast as t_prev = +inf (the kernels skip them).
    A discrete event: it runs under no_grad, so its outputs carry no
    gradient (the JAX package's stop_gradient of the walk).

    All-opaque scenes (``steps`` 1): one closest-hit cast, the first hit
    always accepts. Partitioned scenes: ``_alpha_walk_partitioned`` (its
    kernel walk on ``live``, the ``trwalk.LiveTables`` of a
    differentiable render, when given). Otherwise the re-cast walk over
    the whole scene."""
    r = o.shape[0]
    miss = _miss_record(r, o.device)
    t_prev = torch.full((r,), -1.0, device=o.device)
    if steps == 1 and scene.all_opaque:
        hit = closest_hit(o, d, t_prev, scene, active=walking)
        found = walking & hit.valid
        return _select(found, hit, miss), found, walking & ~found
    if partitioned(scene):
        return _alpha_walk_partitioned(scene, o, d, walking, pix, sample_id,
                                       bounce, spec, steps, live)
    no = torch.zeros_like(walking)
    sel, seen, _ = _alpha_cast_walk(scene, scene, o, d, pix, sample_id,
                                    bounce, spec, steps, 0,
                                    (miss, no, no, t_prev, walking))
    return sel, seen, walking & ~seen


def _use_tr_kernel(scene) -> bool:
    """The walk kernels serve the partitioned walks: the scene has their
    tables, unless ``PT_NO_TRWALK_KERNEL=1`` (the JAX package's
    ``_use_tr_kernel``; the port has no interpret mode)."""
    return (os.environ.get("PT_NO_TRWALK_KERNEL") != "1"
            and scene.tr_kernel_ok)


def _use_dense_tr(scene) -> bool:
    """The dense transparent walk serves the partitioned walks where the
    walk kernels do not: only with ``PT_DENSE_TR=1``, never with
    ``PT_NO_DENSE_TR=1``, and only for 0 < T <= ``PT_DENSE_TR_MAX`` (4,096)
    triangles past ``n_tris_opaque`` (padding rows included, as the JAX
    package counts them). The JAX package's ``_use_dense_tr`` also turns it
    on by default off its chip; the port routes the same way on the CPU as
    on the card."""
    if os.environ.get("PT_NO_DENSE_TR") == "1":
        return False
    t = scene.tri_v0.shape[0] - scene.n_tris_opaque
    if not 0 < t <= int(os.environ.get("PT_DENSE_TR_MAX", "4096")):
        return False
    return os.environ.get("PT_DENSE_TR") == "1"


def _dense_k(scene, steps: int) -> int:
    """Columns the dense producer yields per lane: min(steps, T,
    ``PT_DENSE_TR_K`` (6)); walks deeper go on in the cast walk."""
    return min(steps, scene.tri_v0.shape[0] - scene.n_tris_opaque,
               int(os.environ.get("PT_DENSE_TR_K", "6")))


def _dense_tr_hits(scene, o, d, steps: int, active, t_max):
    """(ts, pos) [kk, R]: each lane's kk = ``_dense_k`` nearest transparent
    hits, ascending, duplicate ts visited once, +inf past the end: one
    ``k_nearest_tr_hits`` launch on the card, its plain version on the
    CPU."""
    return cuda_khit.k_nearest_tr_hits(o, d, active, scene,
                                       _dense_k(scene, steps), t_max=t_max)


def _dense_hit_columns(scene, o, d, ts, pos) -> HitRecord:
    """The flat [kk*R] HitRecord of every precomputed hit (column k of lane
    i at k*R + i): u, v and backface recomputed by MT from
    ``tri_packed_t``, the global prim ``n_tris_opaque + pos``; exhausted
    entries (t = +inf) carry kind NONE."""
    kk, r = ts.shape
    prim = (scene.n_tris_opaque + pos).reshape(kk * r)
    tf = ts.reshape(kk * r)
    fin = torch.isfinite(tf)
    tri9 = scene.tri_packed_t[:, torch.clamp(
        prim, max=scene.tri_packed_t.shape[1] - 1).long()]
    _, u, v, det, _ = mt_rows([o[:, k].repeat(kk) for k in range(3)],
                              [d[:, k].repeat(kk) for k in range(3)], tri9)
    return HitRecord(t=tf, kind=torch.where(fin, KIND_TRIANGLE, KIND_NONE).to(
        torch.int32), prim=prim.to(torch.int32), u=u, v=v, backface=det < 0.0)


def _transparent_mt_view(scene) -> TorchScene:
    """A brute-force view of the transparent slice (triangles
    ``n_tris_opaque`` on, zero rows padding it to a multiple of 256): its
    casts go through the MT kernel (``cuda_intersect``) in the dense
    producer's arithmetic, and report prims from 0 (add
    ``n_tris_opaque``)."""
    c = scene.n_tris_opaque
    pad = (-(scene.tri_v0.shape[0] - c)) % 256

    def cut(x):
        return torch.nn.functional.pad(x[c:], (0, 0, 0, pad)).contiguous()

    return dataclasses.replace(
        scene, use_bvh=False, tri_v0=cut(scene.tri_v0),
        tri_e1=cut(scene.tri_e1), tri_e2=cut(scene.tri_e2),
        tri_packed_t=cut(scene.tri_packed_t.T).T.contiguous(),
        num_real_triangles=scene.num_real_triangles - c)


def _residual_view(scene) -> tuple[TorchScene, int]:
    """(cast scene, prim base) of the exact cast walk that goes on past
    the first steps of a partitioned walk: the transparent view (the flat
    or flat2 walk, Baldwin-Weber, as the walk kernels test), or after the
    dense walk's columns the brute-force MT view of the same triangles, so
    that the strict t > t_prev hand-off skips exactly the hits the
    producer's MT gave (a Baldwin-Weber t can lie an ulp past the MT t of
    the same triangle and visit it twice)."""
    if not _use_tr_kernel(scene) and _use_dense_tr(scene):
        return _transparent_mt_view(scene), scene.n_tris_opaque
    return transparent_view(scene), 0


def _alpha_walk_partitioned(scene, o, d, walking, pix, sample_id, bounce,
                            spec, steps: int, live=None):
    """The alpha walk of a partitioned scene: one closest-hit cast against
    the opaque view (all spheres included) gives the terminator t_op; the
    walk visits only transparent triangles in front of it, at the same
    step indices as the whole-scene walk (the opaque hit accepts without
    drawing). With the walk kernels (``_use_tr_kernel``) the first
    ``TRWALK_K`` steps run in the alpha walk kernel; else with the dense
    walk (``_use_dense_tr``) the first kk steps visit the producer's
    columns, their opacities sampled in one batch; lanes still walking go
    on in the exact cast walk over the transparent view, which otherwise
    does every step. If no hit accepts, the opaque hit shades where there
    is one, else the farthest transparent hit visited."""
    r = o.shape[0]
    dev = o.device
    hit_op = closest_hit(o, d, torch.full((r,), -1.0, device=dev),
                         opaque_view(scene), active=walking)
    t_op = torch.where(hit_op.valid, hit_op.t, float("inf"))
    # Lanes whose segment to the terminator misses every transparent
    # cluster skip the walk (``walking`` still drives the background).
    walk_active = walking & trwalk.hits_transparent_bounds(scene, o, d, t_op)
    sel = _miss_record(r, dev)
    no = torch.zeros_like(walking)
    seen, accepted, still = no, no, walk_active
    t_prev = torch.full((r,), -1.0, device=dev)
    k0 = 0
    stride = rng.site_layout(steps)[3]
    if _use_tr_kernel(scene):
        k0 = min(steps, trwalk.TRWALK_K)
        still = no
        if bool(walk_active.any()):
            uniforms = [rng.uniform(pix, sample_id,
                                    rng.SITE_ALPHA + k + stride * bounce,
                                    spec.seed) for k in range(k0)]
            rnd = (torch.stack(uniforms) if uniforms
                   else torch.empty((0, r), device=dev))
            w = cuda_trwalk.alpha_walk(
                scene, o, d, torch.where(walk_active, t_op, -1.0), rnd, k0,
                live=live)
            found = w.col >= 0
            slot = scene.tr_colmap[torch.clamp(w.col, min=0).long()]
            prim = torch.where(found, scene.sl_map[slot.long()], 0)
            sel = HitRecord(
                t=w.t, kind=torch.where(found, KIND_TRIANGLE, 0).to(
                    torch.int32),
                prim=prim.to(torch.int32), u=w.u, v=w.v, backface=w.dn > 0.0)
            seen, accepted, still, t_prev = (w.seen, w.accepted, w.still,
                                             w.t_prev)
    elif _use_dense_tr(scene):
        k0 = _dense_k(scene, steps)
        if bool(walk_active.any()):
            ts, pos = _dense_tr_hits(scene, o, d, steps, walk_active, t_op)
            cols = _dense_hit_columns(scene, o, d, ts, pos)
            op = texturing.sample_opacity(scene, *_hit_model_uv(scene, cols))
            for k in range(k0):
                hit = HitRecord(*[f[k * r:(k + 1) * r] for f in cols])
                found = still & hit.valid & (hit.t < t_op)
                rnd = rng.uniform(pix, sample_id,
                                  rng.SITE_ALPHA + k + stride * bounce,
                                  spec.seed)
                opk = op[k * r:(k + 1) * r]
                accept = (opk >= 1.0) | ((opk > ALPHA_MIN_OPACITY)
                                         & (rnd < opk))
                sel = _select(found, hit, sel)
                seen = seen | found
                accepted = accepted | (found & accept)
                still = found & ~accept
                t_prev = torch.where(still, hit.t, t_prev)
    if k0 < steps:
        view, base = _residual_view(scene)
        sel, seen, accepted = _alpha_cast_walk(
            scene, view, o, d, pix, sample_id, bounce, spec, steps, k0,
            (sel, seen, accepted, t_prev, still), t_op, prim_base=base)
    op_found = walking & hit_op.valid
    sel = _select(op_found & ~accepted, hit_op, sel)
    seen = seen | op_found
    return sel, seen, walking & ~seen


def _occluder_dist(s_o, s_d, t, surf_pos):
    """[R] distance from the surface point to the occluder at t (0 on a
    miss's +inf)."""
    t = torch.where(torch.isfinite(t), t, 0.0)
    oc = s_o + s_d * t[:, None] - surf_pos
    return torch.sqrt(oc[:, 0] * oc[:, 0] + oc[:, 1] * oc[:, 1]
                      + oc[:, 2] * oc[:, 2])


@torch.no_grad()
def _trans_cast_walk(scene, cast_scene, s_o, s_d, pd, is_pt, surf_pos,
                     orig_uv, orig_simple, steps, k0, trans, t_prev,
                     walking, include_spheres: bool, prim_base: int = 0):
    """Steps k0 .. steps-1 of the transmittance re-cast walk, stopping when
    no lane walks: trans *= 1 - op per occluder in distance order, until
    trans == 0. Point lanes (``is_pt``) stop at the first occluder farther
    from the surface point than pd and sample the occluder's material at
    the ORIGINAL hit's uv and type; other lanes at the occluder's own.
    ``prim_base`` as for ``_alpha_cast_walk``."""
    for _ in range(k0, steps):
        if not bool(walking.any()):
            break
        hit = closest_hit(s_o, s_d, t_prev, cast_scene, active=walking,
                          include_spheres=include_spheres)
        hit = hit._replace(prim=hit.prim + prim_base)
        found = walking & hit.valid
        model, uv, simple = _hit_model_uv(scene, hit)
        found = found & ~(is_pt & (_occluder_dist(s_o, s_d, hit.t, surf_pos)
                                   > pd))
        uv = torch.where(is_pt[:, None], orig_uv, uv)
        simple = torch.where(is_pt, orig_simple, simple)
        op = texturing.sample_opacity(scene, model, uv, simple)
        trans = torch.where(found, trans * (1.0 - op), trans)
        walking = found & (trans != 0.0)
        t_prev = torch.where(walking, hit.t, t_prev)
    return trans


def _light_att0(active, light_color):
    """[R,3] the light colour on active lanes, else 0."""
    return torch.where(active[:, None],
                       torch.as_tensor(light_color, dtype=torch.float32,
                                       device=active.device)
                       .expand(active.shape[0], 3), 0.0)


def _shadow_attenuation(scene, s_o, s_d, active, light_color, steps,
                        point_dist=None, surf_pos=None, orig_uv=None,
                        orig_simple=None):
    """One light's attenuation in a scene that is neither all opaque nor
    partitioned: the transmittance re-cast walk over the whole scene
    (spheres included). Pass point_dist [R], surf_pos [R,3] and the
    original hit's uv [R,2] and simple [R] for a point light. The walk
    carries no gradient; the light colour multiplies outside it."""
    att0 = _light_att0(active, light_color)
    r = s_o.shape[0]
    dev = s_o.device
    is_pt = torch.full((r,), point_dist is not None, device=dev)
    if point_dist is None:
        point_dist = torch.full((r,), float("inf"), device=dev)
        surf_pos, orig_uv = s_o, torch.zeros((r, 2), device=dev)
        orig_simple = torch.zeros_like(active)
    trans = _trans_cast_walk(
        scene, scene, s_o, s_d, point_dist, is_pt, surf_pos, orig_uv,
        orig_simple, steps, 0, torch.ones((r,), device=dev),
        torch.full((r,), -1.0, device=dev),
        active & (att0.abs().sum(-1) != 0.0), include_spheres=True)
    return att0 * trans[:, None]


def _stack_lights(s_o, dirs, point_dists, surf_pos, orig_uv, orig_simple):
    """The [L*R] stacked lanes of L lights' transmittance walks, light by
    light: (o, d, pd, is_pt, surf_pos, orig_uv, orig_simple); pd = +inf
    for a directional light."""
    n_l, r, dev = len(dirs), s_o.shape[0], s_o.device
    inf = torch.full((r,), float("inf"), device=dev)
    return (s_o.repeat(n_l, 1), torch.cat(dirs),
            torch.cat([inf if pd is None else pd for pd in point_dists]),
            torch.cat([torch.full((r,), pd is not None, device=dev)
                       for pd in point_dists]),
            surf_pos.repeat(n_l, 1), orig_uv.repeat(n_l, 1),
            orig_simple.repeat(n_l))


def _shadow_attenuation_multi(scene, s_o, dirs, actives, colors, steps,
                              point_dists, surf_pos, orig_uv, orig_simple,
                              blockeds, live=None):
    """All L lights' attenuations in a partitioned scene. ``blockeds``: the
    lights' any-hit results against the opaque view (an opaque occluder
    in range zeroes the product whatever the order); the transparent
    transmittance walks of all lights run as one stacked [L*R] walk: the
    transmittance walk kernel for the first ``TRWALK_K`` steps
    (``_use_tr_kernel``), else the dense walk's kk columns
    (``_use_dense_tr``; point lanes sample the original hit's uv and type
    over them too), then the exact cast walk over the transparent view.
    Directional lanes have pd = +inf; point lanes stop behind the light
    and sample the original hit's uv (see ``_trans_cast_walk``). One light
    (L = 1) gives the JAX package's single-light partitioned form. The
    walk carries no gradient and reads ``live`` (``trwalk.LiveTables``)
    when given; the light colours multiply outside it."""
    att0s = [_light_att0(a, c) for a, c in zip(actives, colors)]
    n_l = len(dirs)
    r = s_o.shape[0]
    dev = s_o.device
    with torch.no_grad():
        o3, d3, pd3, is_pt, sp3, ouv3, os3 = _stack_lights(
            s_o, dirs, point_dists, surf_pos, orig_uv, orig_simple)
        walking0 = torch.cat([a & ~b & (att0.abs().sum(-1) != 0.0)
                              for a, b, att0 in zip(actives, blockeds, att0s)])
        # Segments that miss every transparent cluster keep trans 1 (t_max
        # the distance to the light, with a margin for the shadow bias).
        walking0 = walking0 & trwalk.hits_transparent_bounds(
            scene, o3, d3, pd3 * 1.0001 + 1e-3)
        n = n_l * r
        trans = torch.ones((n,), device=dev)
        t_prev = torch.full((n,), -1.0, device=dev)
        still = walking0
        k0 = 0
        if _use_tr_kernel(scene):
            k0 = min(steps, trwalk.TRWALK_K)
            still = torch.zeros_like(walking0)
            if bool(walking0.any()):
                trans, t_prev, still = cuda_trwalk.trans_walk(
                    scene, o3, d3, pd3, is_pt, sp3, ouv3, os3, walking0, k0,
                    live=live)
        elif _use_dense_tr(scene):
            k0 = _dense_k(scene, steps)
            if bool(walking0.any()):
                trans, t_prev, still = _trans_dense_walk(
                    scene, o3, d3, pd3, is_pt, sp3, ouv3, os3, walking0,
                    steps)
        if k0 < steps:
            view, base = _residual_view(scene)
            trans = _trans_cast_walk(scene, view, o3, d3, pd3, is_pt, sp3,
                                     ouv3, os3, steps, k0, trans, t_prev,
                                     still, include_spheres=False,
                                     prim_base=base)
    return [torch.where(b[:, None], 0.0, att0 * trans[i * r:(i + 1) * r, None])
            for i, (att0, b) in enumerate(zip(att0s, blockeds))]


def _trans_dense_walk(scene, o3, d3, pd3, is_pt, sp3, ouv3, os3, walking0,
                      steps: int):
    """The first kk steps of the stacked transmittance walk over the dense
    producer's columns (t_max the distance to the light with the
    prefilter's margin): (trans, t_prev, still walking)."""
    n = o3.shape[0]
    ts, pos = _dense_tr_hits(scene, o3, d3, steps, walking0,
                             pd3 * 1.0001 + 1e-3)
    kk = ts.shape[0]
    cols = _dense_hit_columns(scene, o3, d3, ts, pos)
    model, uv, simple = _hit_model_uv(scene, cols)
    pt = is_pt.repeat(kk)
    uv = torch.where(pt[:, None], ouv3.repeat(kk, 1), uv)
    simple = torch.where(pt, os3.repeat(kk), simple)
    op = texturing.sample_opacity(scene, model, uv, simple)
    trans = torch.ones((n,), device=o3.device)
    t_prev = torch.full((n,), -1.0, device=o3.device)
    walking = walking0
    for k in range(kk):
        tk = ts[k]
        found = walking & torch.isfinite(tk)
        found = found & ~(is_pt & (_occluder_dist(o3, d3, tk, sp3) > pd3))
        trans = torch.where(found, trans * (1.0 - op[k * n:(k + 1) * n]),
                            trans)
        walking = found & (trans != 0.0)
        t_prev = torch.where(walking, tk, t_prev)
    return trans, t_prev, walking


def _use_fused_shadow(scene) -> bool:
    """Whether the bounce loop takes the fused shadow kernel: only with
    ``PT_FUSED_SHADOW=1`` (the JAX package's opt-in, ``integrator.py``
    ``_use_fused_shadow``), for a partitioned scene with the walk kernels'
    tables whose whole-scene walk is flat (the kernel's any-hit is the
    flat walk)."""
    return (os.environ.get("PT_FUSED_SHADOW") == "1" and partitioned(scene)
            and _use_tr_kernel(scene) and scene.num_real_triangles != 0
            and _walk_variant(scene) == "flat")


def _shadow_attenuation_fused(scene, s_o, dirs, actives, colors, steps,
                              point_dists, surf_pos, orig_uv, orig_simple,
                              live=None):
    """All L lights' attenuations in a partitioned scene through the fused
    shadow kernel: the opaque any-hit (the exact t_max of
    ``occluded_multi``) and the first ``TRWALK_K`` transmittance steps in
    one launch, then the exact cast walk over the transparent view for
    lanes still walking, and the opaque spheres' any-hit. The same values
    as ``occluded_multi`` + ``_shadow_attenuation_multi``, the same
    gradient (through the light colours alone); ``live`` as there."""
    att0s = [_light_att0(a, c) for a, c in zip(actives, colors)]
    n_l = len(dirs)
    r = s_o.shape[0]
    with torch.no_grad():
        t_maxes, pds = [], []
        for d, a, att0, md in zip(dirs, actives, att0s, point_dists):
            t_maxes.append(torch.where(a, shadow_t_max(s_o, d, surf_pos, md),
                                       -1.0))
            pd = (torch.full((r,), float("inf"), device=s_o.device)
                  if md is None else md)
            # The prefilter of _shadow_attenuation_multi; the any-hit result
            # gates the walk inside the kernel.
            walk = a & (att0.abs().sum(-1) != 0.0) & \
                trwalk.hits_transparent_bounds(scene, s_o, d,
                                               pd * 1.0001 + 1e-3)
            pds.append(torch.where(walk, pd, -1.0))
        k0 = min(steps, trwalk.TRWALK_K)
        trans, t_prev, still = cuda_shadow.fused_shadow(
            scene, s_o, dirs, t_maxes, pds,
            [md is not None for md in point_dists], surf_pos, orig_uv,
            orig_simple, k0, live=live)
        if k0 < steps and bool(still.any()):
            o3, d3, pd3, is_pt, sp3, ouv3, os3 = _stack_lights(
                s_o, dirs, point_dists, surf_pos, orig_uv, orig_simple)
            trans = _trans_cast_walk(
                scene, transparent_view(scene), o3, d3, pd3, is_pt, sp3, ouv3,
                os3, steps, k0, trans.reshape(n_l * r),
                t_prev.reshape(n_l * r), still.reshape(n_l * r),
                include_spheres=False).view(n_l, r)
        if scene.num_real_spheres != 0:
            sph = occluded_spheres_cuda(s_o, dirs, t_maxes, scene)
            trans = torch.where(sph, 0.0, trans)
    return [att0 * trans[i][:, None] for i, att0 in enumerate(att0s)]


def render_wavefront(scene, pixel_ids, width: int, height: int,
                     sample_id: int, spec: IntegratorSpec) -> torch.Tensor:
    """Trace one sample for a wavefront of pixels. Returns radiance [R,3].
    pixel_ids: [R] int32 (y*width+x) on the scene's device. With
    ``spec.differentiable`` the radiance is differentiable with respect to
    the scene's tensors (module docstring)."""
    from path_tracer_torch.ops.camera import generate_rays

    o, d = generate_rays(pixel_ids, width, height, scene, sample_id, spec.seed)
    r = o.shape[0]
    dev = o.device
    color = torch.zeros((r, 3), device=dev)
    throughput = torch.ones((r, 3), device=dev)
    alive = torch.ones((r,), dtype=torch.bool, device=dev)
    pix = pixel_ids
    # Fully opaque scenes collapse both walks to one cast each.
    auto_steps = scene.num_transparent_hits + 1
    alpha_steps = 1 if scene.all_opaque else (
        spec.alpha_walk_steps if spec.alpha_walk_steps is not None
        else auto_steps)
    shadow_steps = 1 if scene.all_opaque else (
        spec.shadow_walk_steps if spec.shadow_walk_steps is not None
        else auto_steps)
    s_g1, s_g2, s_rr, s_stride = rng.site_layout(alpha_steps)
    part = partitioned(scene)
    # The walk kernels' live tables, built once per call.
    live = (trwalk.live_tables(scene) if spec.differentiable and part
            and _use_tr_kernel(scene) else None)

    for bounce in range(spec.bounces + 1):
        sel, _, first_missed = _alpha_walk(scene, o, d, alive, pix, sample_id,
                                           bounce, spec, alpha_steps, live)

        # Background: only rays whose first cast this bounce missed.
        color = torch.where(first_missed[:, None],
                            color + throughput * scene.background, color)
        alive = alive & ~first_missed

        surf = _surface(scene, sel, o, d, spec.differentiable)
        mat = texturing.sample_material(scene, surf.model, surf.uv,
                                        surf.simple)
        f0 = brdf.compute_f0(mat.metalness, mat.albedo)
        view = -d

        color = torch.where(alive[:, None], color + throughput * mat.emissive,
                            color)
        shadow_o = surf.pos + surf.geom_normal * NORMAL_BIAS

        # A lane facing AWAY from a light contributes exactly zero unless
        # its material is emissive (both BRDF terms carry max(n.l, 0)), so
        # its shadow cast is skipped.
        emissive_lane = (None if scene.no_emissive
                         else mat.emissive.abs().sum(-1) != 0.0)

        def shadow_active(l_dir):
            facing = _dot(surf.normal, l_dir) > 0.0
            if emissive_lane is not None:
                facing = facing | emissive_lane
            return alive & facing

        # Every light's shadow, directional lights (raw, unnormalized
        # direction) first, then point lights (toward the light).
        n_dir = scene.num_dir_lights
        dists = []
        to_lights = [(-scene.dir_dir[li]).expand_as(d) for li in range(n_dir)]
        for li in range(scene.num_point_lights):
            to_surf = surf.pos - scene.point_pos[li]
            dist = torch.sqrt((to_surf * to_surf).sum(-1))
            to_lights.append(-(to_surf / dist[:, None]))
            dists.append(dist)
        actives = [shadow_active(ld) for ld in to_lights]
        max_dists = [None] * n_dir + dists
        colors = ([scene.dir_color[li] for li in range(n_dir)]
                  + [1.0] * scene.num_point_lights)
        if part and to_lights and _use_fused_shadow(scene):
            # Both halves of every light's shadow in one launch.
            atts = _shadow_attenuation_fused(
                scene, shadow_o, to_lights, actives, colors, shadow_steps,
                max_dists, surf.pos, surf.uv, surf.simple, live)
        elif scene.all_opaque or part:
            # One any-hit launch for all lights (against the opaque view of
            # a partitioned scene: any opaque occluder in range zeroes the
            # product whatever the order).
            blocked = (occluded_multi(
                shadow_o, to_lights, opaque_view(scene) if part else scene,
                surf_pos=surf.pos, max_dists=max_dists, actives=actives)
                if to_lights else [])
            if scene.all_opaque:
                atts = [torch.where(b[:, None], 0.0, _light_att0(a, c))
                        for a, b, c in zip(actives, blocked, colors)]
            else:
                atts = (_shadow_attenuation_multi(
                    scene, shadow_o, to_lights, actives, colors, shadow_steps,
                    max_dists, surf.pos, surf.uv, surf.simple, blocked, live)
                    if to_lights else [])
        else:
            atts = [_shadow_attenuation(scene, shadow_o, ld, a, c,
                                        shadow_steps, md, surf.pos, surf.uv,
                                        surf.simple)
                    for ld, a, c, md in zip(to_lights, actives, colors,
                                            max_dists)]

        for li, to_light in enumerate(to_lights):
            radiance = atts[li]
            if li >= n_dir:
                dist = dists[li - n_dir]
                radiance = radiance * (scene.point_color[li - n_dir]
                                       / (4.0 * PI * dist * dist)[:, None])
            lit = alive & (radiance.sum(-1) != 0.0)
            ev = brdf.eval_direct(mat, f0, surf.normal, view, to_light)
            color = torch.where(lit[:, None],
                                color + throughput * ev * radiance, color)

        # Indirect bounce, masked out on the last bounce.
        indirect = alive & (bounce < spec.bounces)
        r1 = rng.uniform(pix, sample_id, s_g1 + s_stride * bounce, spec.seed)
        r2 = rng.uniform(pix, sample_id, s_g2 + s_stride * bounce, spec.seed)
        # Detached sampling: the direction is a discrete event.
        with torch.no_grad():
            new_d, wm = brdf.sample(mat, surf.normal, view, r1, r2)
        ind = brdf.eval_indirect(mat, f0, surf.normal, view, new_d, wm)
        throughput = torch.where(indirect[:, None], throughput * ind,
                                 throughput)
        o = torch.where(indirect[:, None],
                        surf.pos + surf.geom_normal * NORMAL_BIAS, o)
        d = torch.where(indirect[:, None], new_d, d)
        alive = alive & (bounce < spec.bounces)

        # Throughput cutoff.
        alive = alive & (_dot(throughput, throughput) >= THROUGHPUT_CUTOFF)

        # Russian roulette for bounce > 3: T /= p unconditionally, kill when
        # rand > p (masked with alive, already false past the last bounce).
        # p keeps its gradient; amax splits it among tied channels, as
        # jnp.max does (Tensor.max(dim) would give it all to one).
        rr = alive & (bounce > 3)
        p = torch.amax(throughput, dim=-1)
        p_safe = torch.where(rr, torch.clamp(p, min=1e-30), 1.0)
        throughput = torch.where(rr[:, None], throughput / p_safe[:, None],
                                 throughput)
        rnd = rng.uniform(pix, sample_id, s_rr + s_stride * bounce, spec.seed)
        alive = alive & ~(rr & (rnd > p))
    return color
