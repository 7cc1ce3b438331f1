"""Texture fetch + material sampling for a hit wavefront.

Port of the table path of ``path_tracer_tpu/ops/texturing.py`` (the baked
``sl_attr`` row path belongs to the BVH slices). Reference semantics:
- Nearest-neighbor fetch: texel = (trunc(u*W) rem_euclid W,
  trunc(v*H) rem_euclid H) — Rust ``as i64`` truncates toward zero.
- Albedo texture is sRGB→linear via pow 2.2 then multiplied by the factor;
  the emissive texture is NOT linearized (reference quirk).
- Gray channels multiply texel by factor; normal maps decode texel*2-1.
- Sphere hits use factor-only "simple" samples.
- roughness is clamped to >= 1e-4.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

# has_tex tuple positions (TorchScene.has_tex)
_ALBEDO, _EMISSIVE, _OPACITY, _METAL, _ROUGH, _NORMAL = range(6)


def _texel_index(uv, w, h):
    """Flat texel offset for nearest-neighbor wrap sampling (w/h [R] i32)."""
    ix = (uv[:, 0] * w.to(torch.float32)).to(torch.int32)  # trunc toward 0
    iy = (uv[:, 1] * h.to(torch.float32)).to(torch.int32)
    return torch.remainder(iy, h) * w + torch.remainder(ix, w)


def _fetch(scene, tex_id, uv):
    """Raw texel [R,3] via the offset/size tables."""
    tid = torch.clamp(tex_id, min=0).long()
    w = scene.tex_width[tid]
    h = scene.tex_height[tid]
    off = scene.tex_offset[tid]
    return scene.tex_data[(off + _texel_index(uv, w, h)).long()]


def _has(scene, channel: int) -> bool:
    return not scene.no_textures and bool(scene.has_tex[channel])


def sample_rgb(scene, tex_id, uv, factor, simple, linearize: bool):
    """Channel3 sample [R,3]. simple: [R] bool — factor-only (sphere hits)."""
    texel = _fetch(scene, tex_id, uv)
    if linearize:
        texel = torch.pow(texel, 2.2)
    textured = texel * factor
    use_factor = simple | (tex_id < 0)
    return torch.where(use_factor[:, None], factor, textured)


def sample_gray(scene, tex_id, uv, factor, simple):
    """Channel1 sample [R]."""
    texel = _fetch(scene, tex_id, uv)
    use_factor = simple | (tex_id < 0)
    return torch.where(use_factor, factor, texel[:, 0] * factor)


class MaterialSample(NamedTuple):
    """Point-sampled material."""

    albedo: torch.Tensor  # [R,3]
    emissive: torch.Tensor  # [R,3]
    opacity: torch.Tensor  # [R]
    metalness: torch.Tensor  # [R]
    roughness: torch.Tensor  # [R] clamped >= 1e-4
    ior: torch.Tensor  # [R]


def sample_opacity(scene, model_id, uv, simple):
    """Opacity [R] alone (what the alpha and transmittance walks read)."""
    m = model_id.long()
    if not _has(scene, _OPACITY):
        return scene.mat_opacity_factor[m]
    return sample_gray(scene, scene.mat_opacity_tex[m], uv,
                       scene.mat_opacity_factor[m], simple)


def sample_material(scene, model_id, uv, simple) -> MaterialSample:
    """Full material sample through the per-model factor/texture tables."""
    m = model_id.long()

    def rgb(tex_tab, fac_tab, channel, linearize):
        factor = fac_tab[m]
        if not _has(scene, channel):
            return factor
        return sample_rgb(scene, tex_tab[m], uv, factor, simple,
                          linearize=linearize)

    def gray(tex_tab, fac_tab, channel):
        factor = fac_tab[m]
        if not _has(scene, channel):
            return factor
        return sample_gray(scene, tex_tab[m], uv, factor, simple)

    return MaterialSample(
        albedo=rgb(scene.mat_albedo_tex, scene.mat_albedo_factor, _ALBEDO,
                   True),
        emissive=rgb(scene.mat_emissive_tex, scene.mat_emissive_factor,
                     _EMISSIVE, False),
        opacity=gray(scene.mat_opacity_tex, scene.mat_opacity_factor,
                     _OPACITY),
        metalness=gray(scene.mat_metalness_tex, scene.mat_metalness_factor,
                       _METAL),
        roughness=torch.clamp(
            gray(scene.mat_roughness_tex, scene.mat_roughness_factor, _ROUGH),
            min=1e-4),
        ior=scene.mat_ior[m],
    )


def sample_normal_map(scene, model_id, uv):
    """Decoded normal-map vector [R,3] (texel*2-1) and a has-map mask, or
    (None, None) when no material has a normal texture."""
    if not _has(scene, _NORMAL):
        return None, None
    tex_id = scene.mat_normal_tex[model_id.long()]
    texel = _fetch(scene, tex_id, uv)
    return texel * 2.0 - 1.0, tex_id >= 0
