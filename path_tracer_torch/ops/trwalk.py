"""The transparent walks over the compact transparent table: their plain
PyTorch versions, the contract the CUDA kernels (``ops/cuda_trwalk.py``)
are held to, and the segment prefilter of the partitioned walks
(``hits_transparent_bounds``: the plain version of
``csrc/tr_prefilter.cu``, which ``cuda_trwalk.prefilter`` launches on a
CUDA tensor; on a CPU tensor it runs this function).

Port of ``path_tracer_tpu/ops/pallas_trwalk.py`` (``alpha_walk_kernel``,
``trans_walk_kernel``) and ``_hits_transparent_bounds`` of the JAX
package's integrator. The tables are the scene's ``tr_*`` fields
(``scene/device_scene.py``): ``tr_bw`` [16, T] Baldwin-Weber rows of the
real transparent triangles as compact columns (Morton order), ``tr_rows``
[9, T] (uv0, uv1-uv0, uv2-uv0, opacity factor, has-texture, page), the
uint8 page plane ``tr_tex8``, ``tr_lut`` and the page table.

Candidates of a lane are the columns whose Baldwin-Weber test passes (as
the flat walk's: |d.n| >= 1e-6, t = (c - o.n) * (1 / d.n), t >= 1e-6,
u >= 0, v >= 0, u + v <= 1) with t below the lane's window end.

- **Alpha walk** (``alpha_walk_plain``): a lane is dead when t_op < 0;
  else its window ends at t_op. Step k takes the nearest candidate with
  t > t_prev (t_prev starts at -1; ties go to the lowest compact column,
  equal-t duplicates are skipped by the strict advance), samples its
  opacity (op = texel * factor where it has a texture, else the factor;
  uv = uv0 + u (uv1-uv0) + v (uv2-uv0)) and accepts when
  op >= 1 or (op > 0.001 and rnd[k] < op). A lane walks on while it
  rejects, for at most ``steps_cap`` steps; it records the last candidate
  it took.
- **Transmittance walk** (``trans_walk_plain``): a lane is dead when pd
  (the distance to its light, +inf for a directional light) is < 0 or
  ``walking0`` is False; its window is unbounded. In a scene with
  opacity textures, a directional lane walks in ascending t with the
  strict advance, multiplying trans by (1 - op) of each candidate at the
  candidate's own uv and page, until trans == 0 or ``steps_cap`` steps.
  Every other lane (point lights, and every lane of a factor-only scene)
  takes the loop-free product: cut = the least t of candidates farther
  from the surface point than pd (point lanes only), and trans is the
  product of (1 - op) over all candidates with t < cut, equal-t
  duplicates included, in ascending column order; point lanes sample the
  texel at the ORIGINAL hit's uv with the occluder's page, and take the
  factor alone where the original hit was a sphere (``orig_simple``).
  These lanes finish (still walking = False).

The Pallas kernel chose between the two forms per 256-lane tile: the
loop-free product when every live lane of the tile is a point lane, the
loop otherwise. The integrator stacks one light's lanes per tile, so the
per-lane rule here gives the same result. The Pallas kernel multiplies
in a butterfly order; the plain versions and the CUDA kernel multiply in
ascending column order, so parity with JAX is to rounding on lanes with
two or more fractional occluders.

Texel index: uv * size truncated toward zero to int32 (saturating, NaN to
0, as the card converts), then taken modulo the size (Euclidean), plus
the page's first row.

Training mode (the JAX package's ``live``): a differentiable render may
have replaced ``mat_opacity_factor`` or ``tex_data`` since the tables were
built, so its walks read ``LiveTables`` (``live_tables``, the counterpart
of ``pallas_trwalk._tables`` and ``_tex_plane``): ``tr_rows`` with the
factor row rebuilt from the live factor table, and an f32 page plane of
the live texel values, read directly instead of u8 codes through the LUT.
Both are values only (built under ``no_grad``): the walks are detached
discrete events, and gradients reach ``tex_data`` through shading.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from path_tracer_torch.ops.intersect import DET_EPS, T_MIN
from path_tracer_torch.ops.slab import pad_boxes, pad_slab
from path_tracer_torch.utils.telemetry import sync_any

ALPHA_MIN_OPACITY = 0.001
# Steps the walk kernels take at most; lanes past it continue in the cast
# walk outside (the JAX package's TRWALK_K).
TRWALK_K = 8
# Candidate-matrix elements per slice of the plain versions' lanes.
_PLAIN_ELEMS = 1 << 24


class AlphaWalk(NamedTuple):
    """Per-lane result of the alpha walk ([R] each)."""

    t: torch.Tensor  # f32 t of the last candidate taken (+inf: none)
    u: torch.Tensor  # f32 its barycentrics (0 for none)
    v: torch.Tensor
    dn: torch.Tensor  # f32 its d.n (backface = dn > 0)
    seen: torch.Tensor  # bool: took a candidate
    accepted: torch.Tensor  # bool: accepted one
    still: torch.Tensor  # bool: would walk on past steps_cap
    t_prev: torch.Tensor  # f32 where a further step would start
    col: torch.Tensor  # int32 compact column of that candidate (-1: none)


class LiveTables(NamedTuple):
    """The walk tables of a differentiable render (values only)."""

    rows: torch.Tensor  # [9, T] f32: tr_rows, row 6 the live factors
    plane: torch.Tensor  # [Hp, Wp] f32: the pages' live texel values


@torch.no_grad()
def live_rows(scene) -> torch.Tensor:
    """``tr_rows`` with the opacity-factor row rebuilt from the live
    ``mat_opacity_factor`` (``pallas_trwalk._tables(scene, live=True)``)."""
    rows = scene.tr_rows.clone()
    rows[6] = scene.mat_opacity_factor[scene.tr_model.long()]
    return rows


@torch.no_grad()
def live_plane(scene) -> torch.Tensor:
    """[Hp, Wp] f32: each opacity page of ``tr_pages`` rebuilt from the
    live ``tex_data`` at its place in ``tr_tex8``, zero elsewhere
    (``pallas_trwalk._tex_plane(scene, live=True)``). On an atlas the
    tables were built from it holds exactly ``tr_lut[tr_tex8]`` on the
    pages."""
    plane = torch.zeros(scene.tr_tex8.shape, device=scene.tr_tex8.device)
    for off, w, h, yb in scene.tr_pages:
        plane[yb:yb + h, :w] = scene.tex_data[off:off + w * h, 0].view(h, w)
    return plane


def live_tables(scene) -> LiveTables:
    """The live rows and plane; build them once per render call."""
    return LiveTables(live_rows(scene), live_plane(scene))


class TransWalk(NamedTuple):
    """Per-lane result of the transmittance walk ([R] each)."""

    trans: torch.Tensor  # f32
    t_prev: torch.Tensor  # f32 (-1 unless still walking)
    still: torch.Tensor  # bool: would walk on past steps_cap


def hits_transparent_bounds(scene, o, d, t_max) -> torch.Tensor:
    """[R] bool: can the segment o + t d, t in [0, t_max], enter any of
    the scene's ``tr_prefilter`` boxes? A zero direction component inverts
    to IEEE inf; a NaN slab bound counts as open. The plain version of the
    ``tr_prefilter`` kernel (``cuda_trwalk.prefilter``)."""
    boxes = scene.tr_prefilter  # [P, 6]
    inv = 1.0 / d
    t0 = (boxes[None, :, 0:3] - o[:, None, :]) * inv[:, None, :]
    t1 = (boxes[None, :, 3:6] - o[:, None, :]) * inv[:, None, :]
    lo = torch.minimum(t0, t1)
    hi = torch.maximum(t0, t1)
    inf = float("inf")
    tn = torch.where(torch.isnan(lo), -inf, lo).amax(dim=-1)
    tf = torch.where(torch.isnan(hi), inf, hi).amin(dim=-1)
    ok = (tf >= torch.clamp(tn, min=0.0)) & (tn <= t_max[:, None])
    return ok.any(dim=-1)


def pad_groups(grp) -> torch.Tensor:
    """``tr_grp`` [7, GP] with every box widened as the walk kernels stage
    it (``slab.pad_boxes``); the valid row kept."""
    return torch.cat([pad_boxes(grp), grp[6:7]])


def group_gate(o, d, t_hi, grp, pad_t: bool = False) -> torch.Tensor:
    """[N, GP] bool: the 128-column groups whose box (``grp`` [7, GP]: min
    xyz, max xyz, valid flag) each lane's segment [0, t_hi] enters, the
    walk kernels' gate in plain torch (``pallas_trwalk._slab_groups`` per
    lane: a zero direction component inverts to 1e30, NaN-propagating
    min and max), with ``pad_t`` each lane's slab interval widened
    (``slab.pad_slab``). The kernels gate as ``resident_gate``."""
    inv = torch.where(d == 0.0, 1e30, 1.0 / torch.where(d == 0.0, 1.0, d))
    t0 = (grp[None, 0:3, :] - o[:, :, None]) * inv[:, :, None]
    t1 = (grp[None, 3:6, :] - o[:, :, None]) * inv[:, :, None]
    lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
    tn = torch.maximum(torch.maximum(lo[:, 0], lo[:, 1]), lo[:, 2])
    tf = torch.minimum(torch.minimum(hi[:, 0], hi[:, 1]), hi[:, 2])
    if pad_t:
        tn, tf = pad_slab(tn, tf)
    th = t_hi[:, None]
    return ((tf >= torch.clamp(tn, min=0.0)) & (tn <= th) & (th >= 0.0)
            & (grp[6] > 0.0)[None, :])


def resident_gate(o, d, t_hi, tr_grp) -> torch.Tensor:
    """[N, GP] bool: the resident walk kernels' gate, ``group_gate`` on the
    boxes they stage (``pad_groups``) with the slab interval widened."""
    return group_gate(o, d, t_hi, pad_groups(tr_grp), pad_t=True)


def _eval_cols(o, d, t_hi, bw):
    """Every candidate of [N] lanes against the [16, T] table: (t, u, v,
    dn), each [N, T], t = +inf where the column is no candidate."""
    def dot(v, r0):
        return (v[:, 0:1] * bw[r0] + v[:, 1:2] * bw[r0 + 1]
                + v[:, 2:3] * bw[r0 + 2])

    dn = dot(d, 0)
    ok = dn.abs() >= DET_EPS
    invdn = 1.0 / torch.where(ok, dn, 1.0)
    t = (bw[3] - dot(o, 0)) * invdn
    ok = ok & (t >= T_MIN) & (t < t_hi[:, None])
    h = [o[:, k:k + 1] + t * d[:, k:k + 1] for k in range(3)]
    u = h[0] * bw[4] + h[1] * bw[5] + h[2] * bw[6] + bw[7]
    v = h[0] * bw[8] + h[1] * bw[9] + h[2] * bw[10] + bw[11]
    ok = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    return torch.where(ok, t, float("inf")), u, v, dn


def _next_candidate(t_mat, t_prev):
    """(tmin, col): the nearest candidate past t_prev, ties to the lowest
    column (col is 0 where there is none)."""
    masked = torch.where(t_mat > t_prev[:, None], t_mat, float("inf"))
    tmin = masked.amin(dim=1)
    cols = torch.arange(t_mat.shape[1], device=t_mat.device)
    col = torch.where(masked == tmin[:, None], cols, t_mat.shape[1]).amin(dim=1)
    return tmin, torch.clamp(col, max=t_mat.shape[1] - 1)


def _trunc_i32(x):
    """float32 → int32 toward zero, saturating, NaN → 0 (the card's cvt)."""
    big = x >= 2147483648.0
    small = x < -2147483648.0
    safe = torch.where(big | small | torch.isnan(x), 0.0, x)
    i = safe.to(torch.int32)
    return torch.where(big, 2147483647, torch.where(small, -2147483648, i))


def texel(scene, uvx, uvy, page, plane=None):
    """Opacity texel values at (uvx, uvy) on page ``page`` (int64 [N]):
    the u8 code through the LUT, or the value of the f32 ``plane`` when
    given (``LiveTables.plane``)."""
    pt = scene.tr_page_table[page]  # [N, 3] (w, h, ybase)
    w, h = pt[:, 0], pt[:, 1]
    ix = torch.remainder(_trunc_i32(uvx * w.to(torch.float32)), w)
    iy = torch.remainder(_trunc_i32(uvy * h.to(torch.float32)), h) + pt[:, 2]
    if plane is not None:
        return plane[iy.long(), ix.long()]
    codes = scene.tr_tex8[iy.long(), ix.long()]
    return scene.tr_lut[0][codes.long()]


def _slices(n: int, t: int):
    step = max(1, _PLAIN_ELEMS // max(t, 1))
    return [slice(a, min(n, a + step)) for a in range(0, max(n, 1), step)]


def _pick(mat, col):
    return mat.gather(1, col[:, None])[:, 0]


def alpha_walk_plain(scene, o, d, t_op, rnd, steps_cap: int,
                     live=None) -> AlphaWalk:
    """Plain version of the alpha walk kernel. o, d: [R,3]; t_op: [R] (< 0
    marks a dead lane); rnd: [>= steps_cap, R] the steps' uniforms;
    ``live``: the ``LiveTables`` of a differentiable render, or None for
    the build-time tables."""
    rows = scene.tr_rows if live is None else live.rows
    plane = None if live is None else live.plane
    parts = []
    for rs in _slices(o.shape[0], scene.tr_bw.shape[1]):
        top = t_op[rs]
        t_hi = torch.where(top < 0.0, -1.0, top)
        t_mat, u_mat, v_mat, dn_mat = _eval_cols(o[rs], d[rs], t_hi,
                                                 scene.tr_bw)
        n = t_mat.shape[0]
        sel_t = torch.full((n,), float("inf"), device=o.device)
        sel_col = torch.full((n,), -1, dtype=torch.int64, device=o.device)
        seen = torch.zeros((n,), dtype=torch.bool, device=o.device)
        accepted = torch.zeros_like(seen)
        t_prev = torch.full((n,), -1.0, device=o.device)
        # A lane without any candidate never walks (it matters only to
        # still_walking at steps_cap 0).
        active = (top >= 0.0) & torch.isfinite(t_mat.amin(dim=1))
        for k in range(steps_cap):
            if not sync_any(active, "alpha_walk_plain"):
                break
            tmin, col = _next_candidate(t_mat, t_prev)
            found = active & torch.isfinite(tmin)
            fac = rows[6][col]
            if scene.tr_textured:
                uvx = rows[0][col] + _pick(u_mat, col) * rows[2][col] \
                    + _pick(v_mat, col) * rows[4][col]
                uvy = rows[1][col] + _pick(u_mat, col) * rows[3][col] \
                    + _pick(v_mat, col) * rows[5][col]
                tex = texel(scene, uvx, uvy, rows[8][col].long(), plane)
                op = torch.where(rows[7][col] > 0.0, tex * fac, fac)
            else:
                op = fac
            accept = (op >= 1.0) | ((op > ALPHA_MIN_OPACITY)
                                    & (rnd[k][rs] < op))
            sel_t = torch.where(found, tmin, sel_t)
            sel_col = torch.where(found, col, sel_col)
            seen = seen | found
            accepted = accepted | (found & accept)
            active = found & ~accept
            t_prev = torch.where(active, tmin, t_prev)
        safe = torch.clamp(sel_col, min=0)
        has = sel_col >= 0
        pick = lambda m: torch.where(has, _pick(m, safe), 0.0)
        parts.append(AlphaWalk(sel_t, pick(u_mat), pick(v_mat), pick(dn_mat),
                               seen, accepted, active, t_prev,
                               sel_col.to(torch.int32)))
    return AlphaWalk(*(torch.cat(x) for x in zip(*parts)))


def trans_walk_plain(scene, o, d, pd, is_pt, surf_pos, orig_uv, orig_simple,
                     walking0, steps_cap: int, live=None) -> TransWalk:
    """Plain version of the transmittance walk kernel. o, d, surf_pos:
    [R,3]; pd: [R] distance to the light (+inf directional); is_pt,
    orig_simple, walking0: [R] bool; orig_uv: [R,2]; ``live`` as for
    ``alpha_walk_plain``."""
    rows = scene.tr_rows if live is None else live.rows
    plane = None if live is None else live.plane
    n_cols = scene.tr_bw.shape[1]
    pd = torch.where(walking0, pd, -1.0)
    parts = []
    for rs in _slices(o.shape[0], n_cols):
        oc, dc, pdc, ptc = o[rs], d[rs], pd[rs], is_pt[rs]
        live = pdc >= 0.0
        t_mat, u_mat, v_mat, _ = _eval_cols(
            oc, dc, torch.where(live, float("inf"), -1.0), scene.tr_bw)
        n = t_mat.shape[0]
        trans = torch.ones((n,), device=o.device)
        t_prev = torch.full((n,), -1.0, device=o.device)
        loop = live & ~ptc if scene.tr_textured else torch.zeros_like(live)
        dense = live & ~loop
        if sync_any(dense, "trans_walk_plain_dense"):
            finite = torch.isfinite(t_mat)
            tc = torch.where(finite, t_mat, 0.0)
            sp = surf_pos[rs]
            oc3 = [oc[:, k:k + 1] + tc * dc[:, k:k + 1] - sp[:, k:k + 1]
                   for k in range(3)]
            occ = torch.sqrt(oc3[0] * oc3[0] + oc3[1] * oc3[1]
                             + oc3[2] * oc3[2])
            behind = finite & ptc[:, None] & (occ > pdc[:, None])
            cut = torch.where(behind, t_mat, float("inf")).amin(dim=1)
            include = finite & (t_mat < cut[:, None])
            fac = rows[6][None, :]
            if scene.tr_textured:
                ouv = orig_uv[rs]
                n_pages = scene.tr_page_table.shape[0]
                per_page = torch.stack([
                    texel(scene, ouv[:, 0], ouv[:, 1],
                          torch.full((n,), p, dtype=torch.int64,
                                     device=o.device), plane)
                    for p in range(n_pages)], dim=1)  # [N, P]
                tex = per_page[:, rows[8].long()]  # [N, T]
                use_factor = (rows[7] <= 0.0)[None, :] \
                    | orig_simple[rs][:, None]
                op = torch.where(use_factor, fac, tex * fac)
            else:
                op = fac.expand(n, n_cols)
            f = torch.where(include, 1.0 - op, 1.0)
            prod = torch.ones((n,), device=o.device)
            for c in range(n_cols):  # ascending column order
                prod = prod * f[:, c]
            trans = torch.where(dense, prod, trans)
        walking = loop & torch.isfinite(t_mat.amin(dim=1))
        for _ in range(steps_cap):
            if not sync_any(walking, "trans_walk_plain"):
                break
            tmin, col = _next_candidate(t_mat, t_prev)
            found = walking & torch.isfinite(tmin)
            fac = rows[6][col]
            uvx = rows[0][col] + _pick(u_mat, col) * rows[2][col] \
                + _pick(v_mat, col) * rows[4][col]
            uvy = rows[1][col] + _pick(u_mat, col) * rows[3][col] \
                + _pick(v_mat, col) * rows[5][col]
            tex = texel(scene, uvx, uvy, rows[8][col].long(), plane)
            op = torch.where(rows[7][col] <= 0.0, fac, tex * fac)
            trans = torch.where(found, trans * (1.0 - op), trans)
            walking = found & (trans != 0.0)
            t_prev = torch.where(walking, tmin, t_prev)
        parts.append(TransWalk(trans, t_prev, walking))
    return TransWalk(*(torch.cat(x) for x in zip(*parts)))
