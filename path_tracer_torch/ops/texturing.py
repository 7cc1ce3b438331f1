"""Texture fetch + material sampling for a hit wavefront.

Port of ``path_tracer_tpu/ops/texturing.py``: the per-model table path,
and the wide-row path (``rows=``: a forward BVH render's ``sl_attr`` rows
gathered once per hit, whose material columns replace every model-indexed
gather, and ``tex_wide``, from which one gather fetches every channel
``scene.wide_covered`` flags; the same values). Reference semantics:
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

from path_tracer_torch.scene.device_scene import (
    ATTR_ALBEDO_F,
    ATTR_ALBEDO_T,
    ATTR_EMISSIVE_F,
    ATTR_EMISSIVE_T,
    ATTR_IOR,
    ATTR_METAL_F,
    ATTR_METAL_T,
    ATTR_NORMAL_T,
    ATTR_OPACITY_F,
    ATTR_OPACITY_T,
    ATTR_ROUGH_F,
    ATTR_ROUGH_T,
    ATTR_WIDE_G,
    WIDE_ALBEDO,
    WIDE_EMISSIVE,
    WIDE_METAL,
    WIDE_NORMAL,
    WIDE_OPACITY,
    WIDE_ROUGH,
)

# has_tex tuple positions (TorchScene.has_tex)
_ALBEDO, _EMISSIVE, _OPACITY, _METAL, _ROUGH, _NORMAL = range(6)
_WIDE_COL = {_ALBEDO: WIDE_ALBEDO, _EMISSIVE: WIDE_EMISSIVE,
             _OPACITY: WIDE_OPACITY, _METAL: WIDE_METAL, _ROUGH: WIDE_ROUGH,
             _NORMAL: WIDE_NORMAL}


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


def _wide(scene, channel: int) -> bool:
    """The channel rides the one tex_wide gather (a build-time static)."""
    return not scene.no_textures and bool(scene.wide_covered[channel])


def _wide_texels(scene, rows, uv):
    """[R, WIDE_COLS]: every covered channel's texel in one gather, at the
    (offset, width, height) of the row's ``tex_wide`` block."""
    off = rows[:, ATTR_WIDE_G].to(torch.int32)
    w = rows[:, ATTR_WIDE_G + 1].to(torch.int32)
    h = rows[:, ATTR_WIDE_G + 2].to(torch.int32)
    return scene.tex_wide[(off + _texel_index(uv, w, h)).long()]


def _has(scene, channel: int) -> bool:
    return not scene.no_textures and bool(scene.has_tex[channel])


def sample_rgb(scene, tex_id, uv, factor, simple, linearize: bool,
               texel=None):
    """Channel3 sample [R,3]. simple: [R] bool — factor-only (sphere hits).
    ``texel``: the raw texel, when the rows path fetched it."""
    if texel is None:
        texel = _fetch(scene, tex_id, uv)
    if linearize:
        texel = torch.pow(texel, 2.2)
    textured = texel * factor
    use_factor = simple | (tex_id < 0)
    return torch.where(use_factor[:, None], factor, textured)


def sample_gray(scene, tex_id, uv, factor, simple, texel=None):
    """Channel1 sample [R]."""
    if texel is None:
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


def sample_opacity(scene, model_id, uv, simple, rows=None):
    """Opacity [R] alone (what the alpha and transmittance walks read).
    ``rows``: the hits' ``sl_attr`` rows (forward renders), whose opacity
    columns replace the model-indexed gathers."""
    if rows is not None:
        factor = rows[:, ATTR_OPACITY_F]
        if not _has(scene, _OPACITY):
            return factor
        texel = (_wide_texels(scene, rows, uv)[:, WIDE_OPACITY:
                                               WIDE_OPACITY + 3]
                 if _wide(scene, _OPACITY) else None)
        return sample_gray(scene, rows[:, ATTR_OPACITY_T].to(torch.int32),
                           uv, factor, simple, texel=texel)
    m = model_id.long()
    if not _has(scene, _OPACITY):
        return scene.mat_opacity_factor[m]
    return sample_gray(scene, scene.mat_opacity_tex[m], uv,
                       scene.mat_opacity_factor[m], simple)


def _sample_material_rows(scene, rows, uv, simple) -> MaterialSample:
    """``sample_material`` from the hits' ``sl_attr`` rows: factors and
    texture ids from their material columns, the covered channels' texels
    from one ``tex_wide`` gather."""
    texw = (_wide_texels(scene, rows, uv)
            if any(_has(scene, c) and _wide(scene, c)
                   for c in (_ALBEDO, _EMISSIVE, _OPACITY, _METAL, _ROUGH))
            else None)

    def texel_of(channel):
        """The covered channel's texel (None: the sampler fetches it
        through the row's texture id)."""
        if not _wide(scene, channel):
            return None
        c = _WIDE_COL[channel]
        # c:c+3 serves both kinds: a gray sampler reads column 0 only.
        return texw[:, c:c + 3]

    def rgb(tcol, fcol, channel, linearize):
        factor = rows[:, fcol:fcol + 3]
        if not _has(scene, channel):
            return factor
        return sample_rgb(scene, rows[:, tcol].to(torch.int32), uv, factor,
                          simple, linearize=linearize,
                          texel=texel_of(channel))

    def gray(tcol, fcol, channel):
        factor = rows[:, fcol]
        if not _has(scene, channel):
            return factor
        return sample_gray(scene, rows[:, tcol].to(torch.int32), uv, factor,
                           simple, texel=texel_of(channel))

    return MaterialSample(
        albedo=rgb(ATTR_ALBEDO_T, ATTR_ALBEDO_F, _ALBEDO, True),
        emissive=rgb(ATTR_EMISSIVE_T, ATTR_EMISSIVE_F, _EMISSIVE, False),
        opacity=gray(ATTR_OPACITY_T, ATTR_OPACITY_F, _OPACITY),
        metalness=gray(ATTR_METAL_T, ATTR_METAL_F, _METAL),
        roughness=torch.clamp(
            gray(ATTR_ROUGH_T, ATTR_ROUGH_F, _ROUGH), min=1e-4),
        ior=rows[:, ATTR_IOR],
    )


def sample_material(scene, model_id, uv, simple, rows=None) -> MaterialSample:
    """Full material sample through the per-model factor/texture tables,
    or, given ``rows`` (the hits' ``sl_attr`` rows, forward renders),
    through their material columns and ``tex_wide``: the same values."""
    if rows is not None:
        return _sample_material_rows(scene, rows, uv, simple)
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


def sample_normal_map(scene, model_id, uv, rows=None):
    """Decoded normal-map vector [R,3] (texel*2-1) and a has-map mask, or
    (None, None) when no material has a normal texture. ``rows`` as for
    ``sample_material``."""
    if not _has(scene, _NORMAL):
        return None, None
    if rows is not None:
        tex_id = rows[:, ATTR_NORMAL_T].to(torch.int32)
        texel = (_wide_texels(scene, rows, uv)[:, WIDE_NORMAL:
                                               WIDE_NORMAL + 3]
                 if _wide(scene, _NORMAL) else _fetch(scene, tex_id, uv))
    else:
        tex_id = scene.mat_normal_tex[model_id.long()]
        texel = _fetch(scene, tex_id, uv)
    return texel * 2.0 - 1.0, tex_id >= 0
