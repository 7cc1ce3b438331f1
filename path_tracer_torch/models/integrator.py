"""Wavefront unidirectional Monte Carlo path-tracing integrator.

Port of ``path_tracer_tpu/models/integrator.py`` for fully opaque scenes
(brute-force and flat-BVH intersection). Path state lives in [R]-batched
tensors over a ray wavefront; the JAX package's ``lax.scan`` over bounces
is a Python loop here (PyTorch runs eagerly).

Semantics reproduced exactly (reference quirks included):

- Bounce loop runs bounces+1 iterations.
- A ray that hits nothing on the FIRST cast of a bounce returns
  color + throughput*background.
- All-opaque alpha walk: every visited hit accepts (op >= 1 short-circuits
  the stochastic test), so the walk is exactly ONE closest-hit cast with no
  opacity sampling or rng draw; shadow attenuation is a binary any-hit,
  cast for every light at once per bounce (``occluded_multi``: one
  any-hit launch on BVH scenes, light by light on brute-force scenes),
  directional lights first, then point lights, as in the JAX package.
- Emissive adds throughput*emissive each bounce, and AGAIN inside
  eval_direct scaled by light radiance (reference quirk).
- Point lights: radiance = color/(4*pi*r^2); only occluders nearer to the
  surface than the light count.
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
port draws the same uniforms for every (pixel, sample, bounce) and renders
the same image up to float rounding.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from path_tracer_torch.ops import brdf, rng, texturing
from path_tracer_torch.ops.intersect import (
    KIND_TRIANGLE,
    HitRecord,
    closest_hit,
    occluded_multi,
)

NORMAL_BIAS = 1e-5
THROUGHPUT_CUTOFF = 1e-5
PI = 3.14159265358979323846


@dataclasses.dataclass(frozen=True)
class IntegratorSpec:
    """Static integrator parameters (forward rendering only; the walk
    bounds of the JAX package's spec come with the transparency slice)."""

    bounces: int = 4
    seed: int = 0


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


def _require_opaque(scene):
    """The alpha and shadow-transmittance walks are a later slice (the
    intersection dispatch refuses the flat2-sized BVH and sphere-block
    scenes)."""
    if not scene.all_opaque:
        raise NotImplementedError(
            "scene has non-opaque materials; the alpha and shadow-"
            "transmittance walks come with the transparency slice of the port")


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
    w = hit.u[:, None]
    ww = hit.v[:, None]
    uv0 = scene.tri_uv0[prim]
    uv = uv0 + w * (scene.tri_uv1[prim] - uv0) + ww * (scene.tri_uv2[prim] - uv0)
    tri_model = scene.tri_model[prim]
    if scene.num_real_spheres == 0:
        return tri_model, uv, torch.zeros_like(is_tri)
    sph_i = torch.clamp(prim, max=scene.sph_model.shape[0] - 1)
    model = torch.where(is_tri, tri_model, scene.sph_model[sph_i])
    uv = torch.where(is_tri[:, None], uv, 0.0)
    return model, uv, ~is_tri


def _surface(scene, hit: HitRecord, o, d) -> Surface:
    """Shading geometry at the selected hits (forward rendering: the hit
    point is o + t d)."""
    is_tri = hit.kind == KIND_TRIANGLE
    prim = torch.clamp(hit.prim, min=0).long()
    sph_i = torch.clamp(prim, max=scene.sph_center.shape[0] - 1)
    # Miss lanes carry t = +inf; their Surface is masked out downstream.
    t_safe = torch.where(torch.isfinite(hit.t), hit.t, 0.0)
    pos = o + d * t_safe[:, None]
    model, uv, simple = _hit_model_uv(scene, hit)

    # Triangle: barycentric vertex-normal interpolation (NOT normalized).
    n_interp = None
    if scene.num_real_triangles != 0:
        w1 = hit.u[:, None]
        w2 = hit.v[:, None]
        n_interp = ((1.0 - w1 - w2) * scene.tri_n0[prim]
                    + w1 * scene.tri_n1[prim] + w2 * scene.tri_n2[prim])

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
        tangent = scene.tri_tangent[prim]
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


def _alpha_walk(scene, o, d, walking):
    """The all-opaque alpha walk: one closest-hit cast (the first hit always
    accepts). Returns (sel: the shading hit, found [R], first_missed [R]);
    first_missed = the cast found nothing → background path. Dead lanes are
    cast as t_prev = +inf (the kernels skip them); their records are
    replaced by the miss record either way."""
    r = o.shape[0]
    t_prev = torch.full((r,), -1.0, device=o.device)
    hit = closest_hit(o, d, t_prev, scene, active=walking)
    found = walking & hit.valid
    miss = (float("inf"), 0, 0, 0.0, 0.0, False)
    sel = HitRecord(*[torch.where(found, h, m) for h, m in zip(hit, miss)])
    return sel, found, walking & ~found


def _shadow_attenuation(active, light_color, blocked):
    """All-opaque shadow attenuation: every occluder multiplies by
    (1 - 1) = 0, so it is the light color where no occluder (within range,
    for point lights) blocks the ray, else 0. ``blocked`` is the light's
    any-hit result from ``occluded_multi``."""
    att0 = torch.where(active[:, None],
                       torch.as_tensor(light_color, dtype=torch.float32,
                                       device=active.device)
                       .expand(active.shape[0], 3), 0.0)
    return torch.where(blocked[:, None], 0.0, att0)


def render_wavefront(scene, pixel_ids, width: int, height: int,
                     sample_id: int, spec: IntegratorSpec) -> torch.Tensor:
    """Trace one sample for a wavefront of pixels. Returns radiance [R,3].
    pixel_ids: [R] int32 (y*width+x) on the scene's device."""
    from path_tracer_torch.ops.camera import generate_rays

    _require_opaque(scene)
    o, d = generate_rays(pixel_ids, width, height, scene, sample_id, spec.seed)
    r = o.shape[0]
    dev = o.device
    color = torch.zeros((r, 3), device=dev)
    throughput = torch.ones((r, 3), device=dev)
    alive = torch.ones((r,), dtype=torch.bool, device=dev)
    pix = pixel_ids
    # All-opaque: the alpha walk is one cast, so the historical site layout.
    s_g1, s_g2, s_rr, s_stride = rng.site_layout(1)

    for bounce in range(spec.bounces + 1):
        sel, _, first_missed = _alpha_walk(scene, o, d, alive)

        # Background: only rays whose first cast this bounce missed.
        color = torch.where(first_missed[:, None],
                            color + throughput * scene.background, color)
        alive = alive & ~first_missed

        surf = _surface(scene, sel, o, d)
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

        # Every light's shadow cast in one call: directional lights (raw,
        # unnormalized direction), then point lights (toward the light).
        n_dir = scene.num_dir_lights
        dists = []
        to_lights = [(-scene.dir_dir[li]).expand_as(d) for li in range(n_dir)]
        for li in range(scene.num_point_lights):
            to_surf = surf.pos - scene.point_pos[li]
            dist = torch.sqrt((to_surf * to_surf).sum(-1))
            to_lights.append(-(to_surf / dist[:, None]))
            dists.append(dist)
        actives = [shadow_active(ld) for ld in to_lights]
        blocked = (occluded_multi(shadow_o, to_lights, scene,
                                  surf_pos=surf.pos,
                                  max_dists=[None] * n_dir + dists,
                                  actives=actives) if to_lights else [])

        for li, to_light in enumerate(to_lights):
            if li < n_dir:
                radiance = _shadow_attenuation(actives[li],
                                               scene.dir_color[li],
                                               blocked[li])
            else:
                dist = dists[li - n_dir]
                dissipated = (scene.point_color[li - n_dir]
                              / (4.0 * PI * dist * dist)[:, None])
                radiance = _shadow_attenuation(actives[li], 1.0,
                                               blocked[li]) * dissipated
            lit = alive & (radiance.sum(-1) != 0.0)
            ev = brdf.eval_direct(mat, f0, surf.normal, view, to_light)
            color = torch.where(lit[:, None],
                                color + throughput * ev * radiance, color)

        # Indirect bounce, masked out on the last bounce.
        indirect = alive & (bounce < spec.bounces)
        r1 = rng.uniform(pix, sample_id, s_g1 + s_stride * bounce, spec.seed)
        r2 = rng.uniform(pix, sample_id, s_g2 + s_stride * bounce, spec.seed)
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
        rr = alive & (bounce > 3)
        p = throughput.max(dim=-1).values
        p_safe = torch.where(rr, torch.clamp(p, min=1e-30), 1.0)
        throughput = torch.where(rr[:, None], throughput / p_safe[:, None],
                                 throughput)
        rnd = rng.uniform(pix, sample_id, s_rr + s_stride * bounce, spec.seed)
        alive = alive & ~(rr & (rnd > p))
    return color
