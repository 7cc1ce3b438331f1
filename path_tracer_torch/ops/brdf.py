"""Cook-Torrance microfacet BRDF with GGX importance sampling.

Port of ``path_tracer_tpu/ops/brdf.py``; the same formulas in the same
order, reference quirks included:
- F0 = 0.04*(1-metalness) + albedo*metalness
- Fresnel-Schlick on the halfway angle
- Smith-Schlick geometry with k = (roughness+1)^2 / 8
- GGX NDF with alpha = roughness^2
- eval_direct = spec*cos + lambertian-diffuse + EMISSIVE (the emissive term
  inside eval_direct is a reference quirk, reproduced)
- importance sampling: theta = acos(sqrt((1-r1)/(r1*(a^2-1)+1))),
  phi = 2*pi*r2, y-up local frame, reflected about the view dir; the sample
  pdf is folded into eval_indirect so pdf() == 1
- reflection clamps i.n to >= 0

All functions take [R]-batched inputs; vectors are [R,3].
"""
from __future__ import annotations

import torch

PI = 3.14159265358979323846


def _dot(a, b):
    return (a * b).sum(-1)


def _normalize(v):
    n2 = (v * v).sum(-1, keepdim=True)
    return v * torch.rsqrt(torch.clamp(n2, min=1e-24))


def compute_f0(metalness, albedo):
    return 0.04 * (1.0 - metalness)[:, None] + albedo * metalness[:, None]


def fresnel_schlick(f0, cos_theta):
    return f0 + (1.0 - f0) * ((1.0 - cos_theta) ** 5)[:, None]


def _geometry_schlick_ggx(n_dot_x, k):
    return n_dot_x / (n_dot_x * (1.0 - k) + k)


def geometry_smith(roughness, n, v, l):
    n_dot_v = torch.clamp(_dot(n, v), min=0.0)
    n_dot_l = torch.clamp(_dot(n, l), min=0.0)
    k = (roughness + 1.0) ** 2 / 8.0
    return _geometry_schlick_ggx(n_dot_v, k) * _geometry_schlick_ggx(n_dot_l, k)


def distribution_ggx(roughness, n, h):
    a2 = roughness ** 4
    n_dot_h = torch.clamp(_dot(n, h), min=0.0)
    denom = n_dot_h * n_dot_h * (a2 - 1.0) + 1.0
    return a2 / (PI * denom * denom)


def _diffuse(ks, metalness, albedo, n, l):
    """Lambertian diffuse with energy split."""
    kd = (1.0 - ks) * (1.0 - metalness)[:, None]
    cos = torch.clamp(_dot(n, l), min=0.0)
    return kd * albedo / PI * cos[:, None]


def transform_to_world(vec, n):
    """Y-up local frame → world, branch on |n.x| > |n.y|."""
    use_x = n[:, 0].abs() > n[:, 1].abs()
    inv_a = 1.0 / torch.sqrt(torch.where(use_x, n[:, 0] ** 2 + n[:, 2] ** 2,
                                         n[:, 1] ** 2 + n[:, 2] ** 2))
    zeros = torch.zeros_like(inv_a)
    nt = torch.where(
        use_x[:, None],
        torch.stack([n[:, 2], zeros, -n[:, 0]], -1),
        torch.stack([zeros, -n[:, 2], n[:, 1]], -1),
    ) * inv_a[:, None]
    nb = torch.linalg.cross(n, nt)
    return vec[:, 0:1] * nb + vec[:, 1:2] * n + vec[:, 2:3] * nt


def reflection(i, n):
    """2*max(i.n,0)*n - i."""
    return 2.0 * torch.clamp(_dot(i, n), min=0.0)[:, None] * n - i


def sample_microfacet_normal(roughness, n, r1, r2):
    """GGX-NDF importance-sampled microfacet normal in world space."""
    a2 = roughness ** 4
    # arg <= 1 analytically; clamp fp rounding.
    arg = torch.clamp((1.0 - r1) / (r1 * (a2 - 1.0) + 1.0), 0.0, 1.0)
    theta = torch.arccos(torch.sqrt(arg))
    phi = 2.0 * PI * r2
    sin_t = torch.sin(theta)
    local = torch.stack([sin_t * torch.cos(phi), torch.cos(theta),
                         sin_t * torch.sin(phi)], -1)
    local = _normalize(local)
    return _normalize(transform_to_world(local, n))


def sample(mat, n, v, r1, r2):
    """BRDF direction sample. Returns (direction [R,3], microfacet wm [R,3])."""
    wm = sample_microfacet_normal(mat.roughness, n, r1, r2)
    return _normalize(reflection(v, wm)), wm


def eval_direct(mat, f0, n, v, l):
    """Direct-light BRDF eval. l = direction hit→light."""
    h = _normalize(v + l)
    d = distribution_ggx(mat.roughness, n, h)
    f = fresnel_schlick(f0, torch.clamp(_dot(h, v), min=0.0))
    g = geometry_smith(mat.roughness, n, v, l)
    denom = torch.clamp(4.0 * torch.clamp(_dot(n, v), min=0.0)
                        * torch.clamp(_dot(n, l), min=0.0), min=1e-4)
    cos = torch.clamp(_dot(n, l), min=0.0)
    specular = (d * g / denom * cos)[:, None] * f
    return _diffuse(f, mat.metalness, mat.albedo, n, l) + specular + mat.emissive


def eval_indirect(mat, f0, n, v, l, wm):
    """Indirect eval with the NDF/cos terms canceled by the sample pdf
    (pdf() == 1, so the caller multiplies throughput directly)."""
    h = _normalize(v + l)
    f = fresnel_schlick(f0, torch.clamp(_dot(h, v), min=0.0))
    g = geometry_smith(mat.roughness, n, v, l)
    # Denominator floor at 1e-20 as in the JAX package (horizon lanes).
    weight = _dot(v, wm).abs() / torch.clamp(
        _dot(v, n).abs() * _dot(wm, n).abs(), min=1e-20)
    above = _dot(n, l) > 0.0
    specular = torch.where(above[:, None], (g * weight)[:, None] * f, 0.0)
    return _diffuse(f, mat.metalness, mat.albedo, n, l) + specular
