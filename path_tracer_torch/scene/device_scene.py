"""Device scene: flat SoA tensors for the wavefront renderer.

Port of the parts of ``path_tracer_tpu/scene/device_scene.py`` that the
brute-force and flat-BVH walks, opaque and transparent, read:

- all mesh triangles in ONE global array (v0, edges, vertex normals, UVs,
  tangent, model id), padded to a multiple of 256 with degenerate rows
  (det = 0 rejects them), plus the component-major [9, N] table
  ``tri_packed_t`` the MT kernel reads;
- analytic spheres, padded to >= 1 with a far-away zero-radius entry, plus
  the [4, S] table ``sph_packed_t`` (S a multiple of 128 up to 384, of 512
  above) whose padding spheres (center 1e30) never hit; above 512 spheres
  (``sph_use_blocks``) the sphere block walk's tables (``sph_*``, below);
- per-model material factor + texture-id tables and the flat RGB atlas;
- lights split by type, camera, background;
- the superleaf block tables of the flat BVH walk (``sl_*``, below);
- the opacity partition and the transparent walks' tables (``tr_*``,
  below);
- the statics the integrator branches on.

Triangle order: the JAX builder stores every triangle array in the leaf
order of its C++ binned-SAH BVH (leaf size 4), even for scenes that never
walk the BVH. ``build_scene`` builds the same ``bvh.cpp`` with the same
flags (``native.build_bvh``), so prim ids and tie-breaks match the JAX
package exactly.

Opacity partition: a triangle is "possibly transparent" when its model's
opacity factor is < 1 or it has an opacity texture, unless the texture's
footprint over the triangle's wrapped UV box (one texel wider each way) is
>= 1 everywhere. When a scene has both kinds, the triangles are stored
opaque first (``n_tris_opaque`` of them), and each partition gets its own
leaf-4 BVH and superleaf BVH.

Superleaf tables: per partition, a second SAH BVH with leaf size
``sl_block`` over the leaf-4-permuted triangles; each of its leaves is one
block of ``sl_block`` packed slots, numbered opaque partition first (block
b owns slots [b*sl_block, (b+1)*sl_block), unused slots are zero rows):

- ``sl_bw_t`` [16, n_blocks*sl_block]: Baldwin-Weber rows n.xyz, c, Au.xyz,
  au, Av.xyz, av, then 4 zero rows (computed in float64, stored float32);
- ``sl_blkflat`` [8, Bpad]: rows 0-2 block AABB min, 3-5 max, 6-7 zero;
  opaque blocks fill columns [0, sl_cols_opaque), transparent blocks
  start at ``sl_cols_opaque`` (each partition's column count rounded up
  to a multiple of 128; Bpad >= 128);
- ``sl_blkid`` [1, Bpad]: block id per column, -1 on pad columns;
- ``sl_sbflat`` [8, SBpad] / ``sl_sbid`` [1, SBpad]: the flat2 walk's
  superblocks, one per group of 128 block columns: rows 0-2 the union of
  the group's block minima, 3-5 of its maxima (pad columns are the
  identities, so they never widen a union), id = the group's index; an
  all-pad group has id -1 and zero bounds (SBpad a multiple of 128; the
  128-aligned partition offsets keep every group in one partition);
- ``sl_map`` [n_blocks*sl_block]: packed slot -> global triangle id;
- ``sl_inv`` [N]: global triangle id -> packed slot;
- ``sph_row_base``: n_blocks*sl_block (the JAX package's first sphere row
  of its wide attribute table; fused sphere hits report this + index);
- ``tr_prefilter`` [32, 6]: up to 32 AABBs (min, max) over the
  transparent triangles, padding boxes at 1e30;
- the superleaf tree walk's tables (``PT_BVH_KERNEL=tree``): the
  partitions' superleaf BVHs as one forest in six direction-ordered
  skip-pointer layouts (``scene/bvh_layouts.py``), ``sl_nodes6`` [6, 8,
  Npad] (rows 0-2 node min, 3-5 max, 6-7 zero) and ``sl_meta6`` [6, 2,
  Npad] (escape index, global block id + 1 on a leaf, 0 inside), escape
  indices global across the forest; ``sl_n_nodes`` the real node count,
  where every walk ends; and ``sl_tris_t`` [9, n_blocks*sl_block], the
  plain MT rows (v0, e1, e2) of the packed slots (the JAX package's
  first 9 of 16 rows). A scene without triangles gets one
  never-entered node.

Sphere block-walk tables (``_sphere_blocks``; 128-column placeholders at
512 spheres or fewer): the spheres grouped into blocks of 128 slots by the
leaves of a binned-SAH BVH (leaf size 128) over their AABBs:

- ``sph_sorted_t`` [4, nblk*128]: center xyz and radius per sorted slot;
  pad slots have center 1e30 and radius 0 (guaranteed misses);
- ``sph_blk`` [8, SBpad]: block AABBs (rows 0-2 min, 3-5 max);
- ``sph_blkid`` [1, SBpad]: block id per column, -1 on pad columns;
- ``sph_smap`` [nblk*128]: sorted slot -> sphere index.

Transparent-walk tables (``_build_tr_walk_tables``; ``tr_kernel_ok``
False leaves placeholders): the real transparent slots as compact columns
in Morton order of their centroids:

- ``tr_bw`` [16, Tp]: their Baldwin-Weber rows (Tp >= 256, a multiple of
  128; pad columns all zero);
- ``tr_rows`` [9, Tp]: uv0.xy, (uv1-uv0).xy, (uv2-uv0).xy, opacity
  factor, has-opacity-texture, page index;
- ``tr_grp`` [7, GP]: AABB of each 128-column group and a valid flag;
- ``tr_colmap`` / ``tr_model`` [Tp]: packed slot and model of a column;
- ``tr_tex8`` [Hp, Wp] uint8: the distinct opacity textures stacked as
  pages (``tr_pages``: (atlas offset, w, h, ybase) each;
  ``tr_page_table`` [P, 3] int32 (w, h, ybase) on the device, a 1x1
  dummy page for factor-only scenes); ``tr_lut`` [1, 256]: v/255 as the
  atlas rounds it.

The dense transparent walk's table (``khit_table``, made on the device
with the scene; ``PT_DENSE_TR=1``): ``khit_tris`` [9, Tp], the transparent
slice of ``tri_packed_t`` (triangles ``n_tris_opaque`` on) padded with
zero rows to a multiple of 128 columns, ``khit_gbox`` [6, Tp / 128],
each 128-column group's AABB over its real (nonzero-edge) rows, an
all-padding group at min = max = 1e30, and ``khit_sbox`` [6, Tp / 32],
the same of each 32-column sub-group (row 3's finer gate).

Wide shading rows (forward BVH renders; ``models/integrator.py``
``_tri_attr``): ``sl_attr`` [n_blocks*sl_block + S', ATTR_W], one row per
packed slot (zero on unused slots), then one per sphere from
``sph_row_base`` on. Columns 0-26 hold the slot's v0, e1, e2, n0, n1, n2,
tangent, uv0, uv1, uv2; 27 the model id and 28 the global triangle id (as
float32, exact below 2^24); 29 on the model's material (``ATTR_*``:
factors, texture ids as float, each channel's atlas offset, width and
height, and its ``tex_wide`` block's). A sphere row holds only its model
and material. ``tex_wide`` [Nw, WIDE_COLS] holds, for each material whose
textured channels share one size, all those channels' texels side by side
(``WIDE_*`` columns; row 0 a dummy texel), copied from the atlas, so one
gather fetches every covered channel; ``wide_covered`` flags the channels
every texture of which rides it. A channel that ``tex_wide`` does not
cover is fetched through the row's texture id. ``attr_tex_baked`` is the
JAX package's flag for reading the ``ATTR_*_G`` atlas columns instead
(its ``PT_BAKED_TEX`` sweep knob, not ported): always False here, and
``from_numpy`` refuses a scene that sets it.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from path_tracer_torch.scene import isf
from path_tracer_torch.utils import telemetry

_TRI_PAD = 256  # triangle count padded to a multiple of this
BVH_MIN_TRIANGLES = 4096  # the JAX package's use_bvh threshold
SPH_BLOCKS_MIN = 512  # more spheres than this take the sphere block walk
SPH_BLOCK = 128  # spheres per block of the sphere block walk
KHIT_GRP = 128  # columns per group of the dense walk's table (one AABB each)
KHIT_SUB = 32  # columns per sub-group of a group (one AABB each)

# Wide shading-row layout (``sl_attr``): geometry in columns 0-28, then the
# row's material: factors, texture ids (float), each channel's atlas
# (offset, width, height), and its tex_wide block's.
ATTR_W = 68
ATTR_ALBEDO_F = 29      # 29:32 albedo factor rgb
ATTR_EMISSIVE_F = 32    # 32:35 emissive factor rgb
ATTR_OPACITY_F = 35
ATTR_METAL_F = 36
ATTR_ROUGH_F = 37
ATTR_IOR = 38
ATTR_ALBEDO_T = 39
ATTR_EMISSIVE_T = 40
ATTR_OPACITY_T = 41
ATTR_METAL_T = 42
ATTR_ROUGH_T = 43
ATTR_NORMAL_T = 44
# (offset, width, height) triples; texture-free channels hold (0, 1, 1).
ATTR_ALBEDO_G = 45
ATTR_EMISSIVE_G = 48
ATTR_OPACITY_G = 51
ATTR_METAL_G = 54
ATTR_ROUGH_G = 57
ATTR_NORMAL_G = 60
ATTR_WIDE_G = 64  # the row's tex_wide block: offset, width, height
# tex_wide's columns.
WIDE_ALBEDO = 0   # 0:3
WIDE_EMISSIVE = 3  # 3:6
WIDE_NORMAL = 6   # 6:9
WIDE_OPACITY = 9
WIDE_METAL = 10
WIDE_ROUGH = 11
WIDE_COLS = 12
# tex_wide's budget: a block that would take the table past it is left
# out, and its channels keep their own atlas fetches.
WIDE_TEX_MAX_MB = 96

_FLOAT_FIELDS = (
    "tri_v0", "tri_e1", "tri_e2", "tri_n0", "tri_n1", "tri_n2",
    "tri_uv0", "tri_uv1", "tri_uv2", "tri_tangent", "tri_packed_t",
    "sph_center", "sph_radius", "sph_packed_t",
    "mat_albedo_factor", "mat_emissive_factor", "mat_opacity_factor",
    "mat_metalness_factor", "mat_roughness_factor", "mat_ior",
    "tex_data", "point_pos", "point_color", "dir_dir", "dir_color",
    "cam_to_world", "cam_fov", "background", "sl_bw_t", "sl_blkflat",
    "sl_sbflat", "sl_nodes6", "sl_tris_t", "sph_sorted_t", "sph_blk",
    "tr_prefilter", "tr_bw", "tr_rows", "tr_grp", "tr_lut", "sl_attr",
    "tex_wide",
)
_INT_FIELDS = (
    "tri_model", "sph_model",
    "mat_albedo_tex", "mat_emissive_tex", "mat_opacity_tex",
    "mat_metalness_tex", "mat_roughness_tex", "mat_normal_tex",
    "tex_offset", "tex_width", "tex_height", "sl_blkid", "sl_map", "sl_inv",
    "sl_sbid", "sl_meta6", "sph_blkid", "sph_smap", "tr_colmap", "tr_model",
)
# Fields the port keeps fewer leading rows of than the JAX package: its
# sl_tris_t pads the 9 MT rows to 16.
_ROWS_KEPT = {"sl_tris_t": 9}
_U8_FIELDS = ("tr_tex8",)
ARRAY_FIELDS = _FLOAT_FIELDS + _INT_FIELDS + _U8_FIELDS
STATIC_FIELDS = ("all_opaque", "no_textures", "no_emissive", "has_tex",
                 "num_real_triangles", "num_real_spheres", "use_bvh",
                 "sph_use_blocks", "sl_block", "sl_n_blocks", "sl_n_nodes",
                 "sph_row_base",
                 "n_tris_opaque", "sl_n_blocks_opaque", "sl_cols_opaque",
                 "num_transparent_hits", "sph_all_opaque", "tr_kernel_ok",
                 "tr_textured", "tr_pages", "attr_tex_baked",
                 "wide_covered")


@dataclasses.dataclass(frozen=True)
class TorchScene:
    """Scene tensors on one device, plus static facts.

    Shapes: triangles [N,3] / [N,2] / [N] with N a multiple of 256;
    ``tri_packed_t`` [9,N] (v0, e1, e2 rows); spheres [S',3] / [S'];
    ``sph_packed_t`` [4,S]; materials [M,3] / [M]; atlas ``tex_data`` [P,3]
    with [T] offset/width/height tables; lights [L,3]; ``cam_to_world``
    [4,4] row-major world-from-camera; ``cam_fov`` [] vertical radians;
    superleaf tables ``sl_*`` and sphere-block tables ``sph_sorted_t`` /
    ``sph_blk`` / ``sph_blkid`` / ``sph_smap`` as in the module docstring."""

    tri_v0: torch.Tensor
    tri_e1: torch.Tensor
    tri_e2: torch.Tensor
    tri_n0: torch.Tensor
    tri_n1: torch.Tensor
    tri_n2: torch.Tensor
    tri_uv0: torch.Tensor
    tri_uv1: torch.Tensor
    tri_uv2: torch.Tensor
    tri_tangent: torch.Tensor
    tri_packed_t: torch.Tensor
    sph_center: torch.Tensor
    sph_radius: torch.Tensor
    sph_packed_t: torch.Tensor
    mat_albedo_factor: torch.Tensor
    mat_emissive_factor: torch.Tensor
    mat_opacity_factor: torch.Tensor
    mat_metalness_factor: torch.Tensor
    mat_roughness_factor: torch.Tensor
    mat_ior: torch.Tensor
    tex_data: torch.Tensor
    point_pos: torch.Tensor
    point_color: torch.Tensor
    dir_dir: torch.Tensor
    dir_color: torch.Tensor
    cam_to_world: torch.Tensor
    cam_fov: torch.Tensor
    background: torch.Tensor
    tri_model: torch.Tensor
    sph_model: torch.Tensor
    mat_albedo_tex: torch.Tensor
    mat_emissive_tex: torch.Tensor
    mat_opacity_tex: torch.Tensor
    mat_metalness_tex: torch.Tensor
    mat_roughness_tex: torch.Tensor
    mat_normal_tex: torch.Tensor
    tex_offset: torch.Tensor
    tex_width: torch.Tensor
    tex_height: torch.Tensor
    sl_bw_t: torch.Tensor
    sl_blkflat: torch.Tensor
    sl_blkid: torch.Tensor
    sl_map: torch.Tensor
    sl_inv: torch.Tensor
    sl_sbflat: torch.Tensor
    sl_sbid: torch.Tensor
    sl_nodes6: torch.Tensor
    sl_meta6: torch.Tensor
    sl_tris_t: torch.Tensor
    sph_sorted_t: torch.Tensor
    sph_blk: torch.Tensor
    sph_blkid: torch.Tensor
    sph_smap: torch.Tensor
    tr_prefilter: torch.Tensor
    tr_bw: torch.Tensor
    tr_rows: torch.Tensor
    tr_grp: torch.Tensor
    tr_lut: torch.Tensor
    tr_colmap: torch.Tensor
    tr_model: torch.Tensor
    tr_tex8: torch.Tensor
    tr_page_table: torch.Tensor
    khit_tris: torch.Tensor
    khit_gbox: torch.Tensor
    khit_sbox: torch.Tensor
    sl_attr: torch.Tensor
    tex_wide: torch.Tensor
    # --- statics ---
    all_opaque: bool  # every material has opacity factor >= 1, no texture
    no_textures: bool
    no_emissive: bool
    has_tex: tuple  # (albedo, emissive, opacity, metal, rough, normal)
    num_real_triangles: int
    num_real_spheres: int
    use_bvh: bool
    sph_use_blocks: bool  # more than 512 spheres: the sphere block walk
    sl_block: int  # triangles per superleaf block
    sl_n_blocks: int  # real blocks (columns of sl_blkflat with id >= 0)
    sl_n_nodes: int  # real nodes of the superleaf forest (sl_nodes6)
    sph_row_base: int
    n_tris_opaque: int  # triangles [0, n_tris_opaque) are certainly opaque
    sl_n_blocks_opaque: int
    sl_cols_opaque: int  # first transparent column of sl_blkflat
    # Bound on the possibly-transparent hits of one ray line (transparent
    # triangles once, transparent spheres twice); walks take this + 1 steps.
    num_transparent_hits: int
    sph_all_opaque: bool
    tr_kernel_ok: bool  # the tr_* tables are valid for the walk kernels
    tr_textured: bool  # some transparent column samples an opacity texture
    tr_pages: tuple  # (atlas offset, w, h, ybase) per opacity texture
    attr_tex_baked: bool  # always False: PT_BAKED_TEX is not ported
    wide_covered: tuple  # per has_tex channel: every texture in tex_wide

    @property
    def device(self) -> torch.device:
        return self.tri_v0.device

    @property
    def num_point_lights(self) -> int:
        return self.point_pos.shape[0]

    @property
    def num_dir_lights(self) -> int:
        return self.dir_dir.shape[0]


def from_numpy(fields: dict, statics: dict, device) -> TorchScene:
    """Carry numpy arrays (e.g. ``np.asarray`` of each field of the JAX
    package's ``DeviceScene``) onto ``device``. Reads the names in
    ``ARRAY_FIELDS`` and ``STATIC_FIELDS`` and ignores other keys, so any
    scene's tables can be carried across, except one built under the JAX
    package's ``PT_BAKED_TEX`` (``attr_tex_baked``), which raises
    ValueError: the port's rows path reads no baked atlas columns."""
    if statics["attr_tex_baked"]:
        raise ValueError("a scene with attr_tex_baked (PT_BAKED_TEX) cannot "
                         "be carried across: the port fetches through the "
                         "texture ids")
    kw = {}
    for name in ARRAY_FIELDS:
        if name in _U8_FIELDS:  # the JAX package keeps these values in bf16
            arr = np.array(np.asarray(fields[name], np.float32), np.uint8)
        else:
            dtype = np.float32 if name in _FLOAT_FIELDS else np.int32
            arr = np.asarray(fields[name])
            if name in _ROWS_KEPT:
                arr = arr[:_ROWS_KEPT[name]]
            arr = np.array(arr, dtype=dtype, order="C")  # a copy
        kw[name] = torch.from_numpy(arr).to(device)
    for name in STATIC_FIELDS:
        value = statics[name]
        if name in ("has_tex", "wide_covered"):
            value = tuple(bool(x) for x in value)
        elif name == "tr_pages":
            value = tuple(tuple(int(x) for x in p) for p in value)
        kw[name] = value
    pages = [p[1:] for p in kw["tr_pages"]] or [(1, 1, 0)]
    kw["tr_page_table"] = torch.tensor(pages, dtype=torch.int32,
                                       device=device)
    kw["khit_tris"], kw["khit_gbox"], kw["khit_sbox"] = khit_table(
        kw["tri_packed_t"], kw["n_tris_opaque"])
    return TorchScene(**kw)


def khit_table(tri_packed_t, n_tris_opaque: int):
    """(khit_tris [9, Tp], khit_gbox [6, Tp / 128], khit_sbox [6, Tp / 32])
    of the dense walk (the module docstring); the first two as the JAX
    package's ``k_nearest_tr_hits`` builds them per call."""
    tris = tri_packed_t[:, n_tris_opaque:]
    t_n = tris.shape[1]
    t_pad = -(-t_n // KHIT_GRP) * KHIT_GRP
    tris = torch.nn.functional.pad(tris, (0, t_pad - t_n)).contiguous()
    v0 = tris[0:3]
    p1 = v0 + tris[3:6]
    p2 = v0 + tris[6:9]
    valid = tris[3:9].abs().sum(0) > 0
    big = 1e30
    mn = torch.where(valid[None], torch.minimum(torch.minimum(v0, p1), p2),
                     big)
    mx = torch.where(valid[None], torch.maximum(torch.maximum(v0, p1), p2),
                     -big)

    def boxes(width: int):
        g = t_pad // width
        has = valid.view(g, width).any(1)
        gmin = torch.where(has[None], mn.view(3, g, width).amin(2), big)
        gmax = torch.where(has[None], mx.view(3, g, width).amax(2), big)
        return torch.cat([gmin, gmax]).contiguous()

    return tris, boxes(KHIT_GRP), boxes(KHIT_SUB)


class _AtlasBuilder:
    """Packs textures into one flat RGB array, deduplicating by path+kind
    (the same file loaded as RGB and as gray are distinct entries)."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.chunks = [np.zeros((1, 3), np.float32)]  # dummy texel at offset 0
        self.offsets = [0]
        self.widths = [1]
        self.heights = [1]
        self.next_offset = 1
        self.cache = {}

    def add(self, rel_path: Optional[str], kind: str) -> int:
        """Texture id, or -1 if rel_path is None. kind: 'rgb' | 'gray'."""
        from path_tracer_torch.utils.image_io import (
            load_texture_gray,
            load_texture_rgb,
        )

        if rel_path is None:
            return -1
        key = (kind, rel_path)
        if key in self.cache:
            return self.cache[key]
        path = self.root / rel_path
        if kind == "rgb":
            img = load_texture_rgb(path)
        else:
            img = np.repeat(load_texture_gray(path)[:, :, None], 3, axis=2)
        h, w = img.shape[:2]
        tex_id = len(self.offsets)
        self.chunks.append(img.reshape(h * w, 3).astype(np.float32))
        self.offsets.append(self.next_offset)
        self.widths.append(w)
        self.heights.append(h)
        self.next_offset += h * w
        self.cache[key] = tex_id
        return tex_id


def _pad_to(n: int, m: int) -> int:
    return max(m, ((n + m - 1) // m) * m)


def _pack_spheres(centers: np.ndarray, radii: np.ndarray) -> np.ndarray:
    """[4, S_pad] sphere table padded with guaranteed misses (128-multiple
    up to 384 spheres, 512-multiple above)."""
    s = centers.shape[0]
    s_pad = _pad_to(s, 128) if s <= 384 else _pad_to(s, 512)
    out = np.full((4, s_pad), 1e30, np.float32)
    out[3, :] = 0.0
    out[0:3, :s] = centers.T
    out[3, :s] = radii
    return out


def _sphere_blocks(centers: np.ndarray, radii: np.ndarray) -> dict:
    """The sphere block walk's tables (``_sphere_blocks`` of the JAX
    package): 128-slot blocks from the leaves of a binned-SAH BVH (leaf
    size 128) over the sphere AABBs. At most SPH_BLOCKS_MIN spheres give
    128-column placeholders and ``sph_use_blocks`` False."""
    s = centers.shape[0]
    if s <= SPH_BLOCKS_MIN:
        return dict(sph_sorted_t=np.zeros((4, SPH_BLOCK), np.float32),
                    sph_blk=np.zeros((8, 128), np.float32),
                    sph_blkid=np.full((1, 128), -1, np.int32),
                    sph_smap=np.zeros(SPH_BLOCK, np.int32),
                    sph_use_blocks=False)
    from path_tracer_torch.native import build_bvh

    lo = centers - radii[:, None]
    hi = centers + radii[:, None]
    b = build_bvh(lo, hi, leaf_size=SPH_BLOCK)
    leaves = np.nonzero(b.prim_count > 0)[0]
    nblk = len(leaves)
    packed = np.full((4, nblk * SPH_BLOCK), 1e30, np.float32)
    packed[3, :] = 0.0  # pad slots: far, zero radius, never hit
    smap = np.zeros(nblk * SPH_BLOCK, np.int32)
    sb_pad = max(128, ((nblk + 127) // 128) * 128)
    blk = np.zeros((8, sb_pad), np.float32)
    blkid = np.full((1, sb_pad), -1, np.int32)
    for i, node in enumerate(leaves):
        f, c = int(b.first_prim[node]), int(b.prim_count[node])
        ids = b.prim_order[f:f + c]
        base = i * SPH_BLOCK
        packed[0:3, base:base + c] = centers[ids].T
        packed[3, base:base + c] = radii[ids]
        smap[base:base + c] = ids
        blk[0:3, i] = lo[ids].min(axis=0)
        blk[3:6, i] = hi[ids].max(axis=0)
    blkid[0, :nblk] = np.arange(nblk)
    return dict(sph_sorted_t=packed, sph_blk=blk, sph_blkid=blkid,
                sph_smap=smap, sph_use_blocks=True)


_TEX_KEYS = ("albedo_t", "emissive_t", "opacity_t", "metal_t", "rough_t",
             "normal_t")  # has_tex order


def _build_wide_tex(mats, atlas_data, offsets, widths, heights):
    """(tex_wide [Nw, WIDE_COLS], woff, ww, wh per model, covered 6-tuple),
    as ``_build_wide_tex`` of the JAX package builds them. A model's
    channels at its primary texture size (the size most of its textured
    channels share; ties to the smaller area) form one block of w*h rows,
    their texels copied side by side; blocks are shared by models with the
    same texture ids on those channels, and a block that would take the
    table past ``WIDE_TEX_MAX_MB`` (read at call time) is left out.
    covered[c]: every model textured on channel c has it in its block."""
    cols = (WIDE_ALBEDO, WIDE_EMISSIVE, WIDE_OPACITY, WIDE_METAL,
            WIDE_ROUGH, WIDE_NORMAL)
    n_models = len(mats["albedo_t"])
    tids = np.stack([np.asarray(mats[k], np.int64) for k in _TEX_KEYS],
                    axis=1).reshape(n_models, 6)
    woff = np.zeros(n_models, np.int64)
    ww = np.ones(n_models, np.int64)
    wh = np.ones(n_models, np.int64)
    in_wide = np.zeros((n_models, 6), bool)
    blocks: dict = {}
    chunks = [np.zeros((1, WIDE_COLS), np.float32)]  # row 0: dummy texel
    nxt = 1
    budget = int(WIDE_TEX_MAX_MB * (1 << 20) / (4 * WIDE_COLS))
    for m in range(n_models):
        tex = [(c, int(t)) for c, t in enumerate(tids[m]) if t >= 0]
        if not tex:
            continue
        by_size: dict = {}
        for c, t in tex:
            by_size.setdefault((int(widths[t]), int(heights[t])),
                               []).append((c, t))
        (w, h), grp = max(by_size.items(),
                          key=lambda kv: (len(kv[1]), -kv[0][0] * kv[0][1]))
        key = tuple(t if (c, t) in grp else -1
                    for c, t in zip(range(6), tids[m]))
        if key not in blocks:
            if nxt + w * h > budget:
                continue
            blk = np.zeros((w * h, WIDE_COLS), np.float32)
            for c, t in grp:
                off = int(offsets[t])
                plane = atlas_data[off:off + w * h]
                if c in (0, 1, 5):  # rgb channels
                    blk[:, cols[c]:cols[c] + 3] = plane
                else:  # gray channels read texel[:, 0]
                    blk[:, cols[c]] = plane[:, 0]
            blocks[key] = (nxt, w, h)
            chunks.append(blk)
            nxt += w * h
        woff[m], ww[m], wh[m] = blocks[key]
        for c, _ in grp:
            in_wide[m, c] = True
    covered = tuple(bool(np.any(tids[:, c] >= 0))
                    and bool(np.all(in_wide[tids[:, c] >= 0, c]))
                    for c in range(6))
    return np.concatenate(chunks, axis=0), woff, ww, wh, covered


def _bake_material_rows(attr: np.ndarray, model_ids: np.ndarray, mats,
                        atlas, wide) -> None:
    """Fill ``attr``'s ATTR_* material columns from the per-model tables
    (``_bake_material_rows`` of the JAX package): factors, texture ids,
    each channel's atlas (offset, width, height) from ``atlas`` = (offsets,
    widths, heights) by texture id, (0, 1, 1) where untextured, and the
    model's tex_wide block from ``wide`` = (woff, ww, wh)."""
    af = np.asarray(mats["albedo_f"], np.float32).reshape(-1, 3)
    ef = np.asarray(mats["emissive_f"], np.float32).reshape(-1, 3)
    attr[:, ATTR_ALBEDO_F:ATTR_ALBEDO_F + 3] = af[model_ids]
    attr[:, ATTR_EMISSIVE_F:ATTR_EMISSIVE_F + 3] = ef[model_ids]
    for col, key in ((ATTR_OPACITY_F, "opacity_f"), (ATTR_METAL_F, "metal_f"),
                     (ATTR_ROUGH_F, "rough_f"), (ATTR_IOR, "ior")):
        attr[:, col] = np.asarray(mats[key], np.float32)[model_ids]
    offs, ws, hs = (np.asarray(a) for a in atlas)
    for tcol, gcol, key in ((ATTR_ALBEDO_T, ATTR_ALBEDO_G, "albedo_t"),
                            (ATTR_EMISSIVE_T, ATTR_EMISSIVE_G, "emissive_t"),
                            (ATTR_OPACITY_T, ATTR_OPACITY_G, "opacity_t"),
                            (ATTR_METAL_T, ATTR_METAL_G, "metal_t"),
                            (ATTR_ROUGH_T, ATTR_ROUGH_G, "rough_t"),
                            (ATTR_NORMAL_T, ATTR_NORMAL_G, "normal_t")):
        tids = np.asarray(mats[key], np.int32)[model_ids]
        attr[:, tcol] = tids.astype(np.float32)
        safe = np.maximum(tids, 0)
        has = tids >= 0
        attr[:, gcol] = np.where(has, offs[safe], 0)
        attr[:, gcol + 1] = np.where(has, ws[safe], 1)
        attr[:, gcol + 2] = np.where(has, hs[safe], 1)
    woff, ww, wh = wide
    attr[:, ATTR_WIDE_G] = woff[model_ids]
    attr[:, ATTR_WIDE_G + 1] = ww[model_ids]
    attr[:, ATTR_WIDE_G + 2] = wh[model_ids]


def _attr_rows(sl: dict, geom: dict, tri_model, sph_model, n_real_sph: int,
               mats, atlas, wide) -> np.ndarray:
    """``sl_attr``: the packed slots' rows (geometry of the slot's triangle
    from ``geom``, its model and id, the model's material; unused slots
    zero, and no material at all in a scene without triangles), then one
    material row per sphere (padding spheres zero)."""
    n_slots = sl["sl_map"].shape[0]
    attr = np.zeros((n_slots, ATTR_W), np.float32)
    if sl["sl_n_blocks"]:
        used = sl["slot_used"]
        ids = sl["sl_map"][used]
        for c0, key in ((0, "v0"), (3, "e1"), (6, "e2"), (9, "n0"),
                        (12, "n1"), (15, "n2"), (18, "tangent"), (21, "uv0"),
                        (23, "uv1"), (25, "uv2")):
            arr = geom[key]
            attr[used, c0:c0 + arr.shape[1]] = arr[ids]
        attr[used, 27] = tri_model[ids]
        attr[used, 28] = ids
        _bake_material_rows(attr, attr[:, 27].astype(np.int32), mats, atlas,
                            wide)
    sph = np.zeros((sph_model.shape[0], ATTR_W), np.float32)
    if n_real_sph:
        sph[:n_real_sph, 27] = sph_model[:n_real_sph]
        _bake_material_rows(sph[:n_real_sph], sph_model[:n_real_sph], mats,
                            atlas, wide)
    return np.concatenate([attr, sph], axis=0)


def _baldwin_weber_rows(sl_tris: np.ndarray) -> np.ndarray:
    """[16, n] Baldwin-Weber rows from packed (v0, e1, e2) rows [n, 9], as
    the JAX builder computes them (``_baldwin_weber_rows``).

    t = (c - o.n)/(d.n) with n = e1 x e2, c = v0.n (so d.n = -MT det: the
    same DET_EPS reject and backface sign); u = Au.h + au, v = Av.h + av on
    the hit point h = o + t d, with Au = (e2 x n)/(n.n), Av = (n x e1)/(n.n).
    Computed in float64 and rounded once to float32; all-zero (unused)
    slots give all-zero rows, which d.n = 0 rejects. Rows 12-15 are zero."""
    v0 = sl_tris[:, 0:3].astype(np.float64)
    e1 = sl_tris[:, 3:6].astype(np.float64)
    e2 = sl_tris[:, 6:9].astype(np.float64)
    n = np.cross(e1, e2)
    nn = (n * n).sum(axis=1, keepdims=True)
    inv = np.where(nn > 0.0, 1.0 / np.where(nn > 0.0, nn, 1.0), 0.0)
    au3 = np.cross(e2, n) * inv
    av3 = np.cross(n, e1) * inv
    out = np.zeros((16, sl_tris.shape[0]), np.float32)
    out[0:3] = n.T
    out[3] = (v0 * n).sum(axis=1)
    out[4:7] = au3.T
    out[7] = -(au3 * v0).sum(axis=1)
    out[8:11] = av3.T
    out[11] = -(av3 * v0).sum(axis=1)
    return out


def _superleaf_tables(v0, e1, e2, ranges: list, n_pad: int,
                      sl_block: int) -> dict:
    """The flat walk's block tables over the (leaf-4-permuted) triangles,
    one superleaf BVH per opacity partition in ``ranges`` ([start, end)
    triangle ranges, opaque first), as ``device_scene.py:1035-1138`` of
    the JAX package builds them, with the tree walk's forest
    (``device_scene.py:1071-1112``, placeholders ``:1186-1192``). Also
    returns the packed (v0, e1, e2) rows ``sl_tris`` [n_blocks*sl_block, 9]
    and each partition's block count."""
    from path_tracer_torch.native import build_bvh
    from path_tracer_torch.scene.bvh_layouts import (
        build_directional_layouts_forest,
    )

    if sl_block <= 0 or sl_block % 128:
        raise ValueError(f"sl_block must be a positive multiple of 128, "
                         f"got {sl_block}")
    if not ranges:  # the JAX builder's placeholders
        sl_tris = np.zeros((sl_block, 9), np.float32)
        nodes6 = np.zeros((6, 8, 128), np.float32)
        nodes6[:, 0:3, 0] = np.inf
        nodes6[:, 3:6, 0] = -np.inf
        meta6 = np.zeros((6, 2, 128), np.int32)
        meta6[:, 0, 0] = 1
        return dict(sl_tris=sl_tris, sl_bw_t=_baldwin_weber_rows(sl_tris),
                    sl_tris_t=np.ascontiguousarray(sl_tris.T),
                    sl_nodes6=nodes6, sl_meta6=meta6, sl_n_nodes=1,
                    sl_map=np.zeros(sl_block, np.int32),
                    sl_inv=np.zeros(n_pad, np.int32),
                    sl_blkflat=np.zeros((8, 128), np.float32),
                    sl_blkid=np.full((1, 128), -1, np.int32),
                    sl_sbflat=np.zeros((8, 128), np.float32),
                    sl_sbid=np.full((1, 128), -1, np.int32),
                    part_blocks=[], sl_n_blocks=0, sph_row_base=sl_block,
                    slot_used=np.zeros(sl_block, bool))
    n_tris = ranges[-1][1]
    q0 = v0[:n_tris]
    q1 = q0 + e1[:n_tris]
    q2 = q0 + e2[:n_tris]
    qmin = np.minimum(np.minimum(q0, q1), q2)
    qmax = np.maximum(np.maximum(q0, q1), q2)
    trees = [build_bvh(qmin[a:b], qmax[a:b], leaf_size=sl_block)
             for a, b in ranges]
    leaves = [np.nonzero(t.prim_count > 0)[0] for t in trees]
    part_blocks = [len(lv) for lv in leaves]
    n_blocks = sum(part_blocks)
    sl_tris = np.zeros((n_blocks * sl_block, 9), np.float32)
    sl_map = np.zeros(n_blocks * sl_block, np.int32)
    sl_inv = np.zeros(n_pad, np.int32)
    slot_used = np.zeros(n_blocks * sl_block, bool)
    # Opaque blocks fill columns [0, cols_op), transparent ones follow at
    # the next multiple of 128; pad columns carry block id -1.
    col0 = [0]
    if len(ranges) == 2:
        col0.append(((part_blocks[0] + 127) // 128) * 128)
    b_pad = max(128, sum(((n + 127) // 128) * 128 for n in part_blocks))
    sl_blkflat = np.zeros((8, b_pad), np.float32)
    sl_blkid = np.full((1, b_pad), -1, np.int32)
    bg = 0
    forest = []
    for (a, _), slp, lv, c0 in zip(ranges, trees, leaves, col0):
        meta_leaf = np.zeros(slp.skip.shape[0], np.int32)
        meta_leaf[lv] = bg + 1 + np.arange(len(lv), dtype=np.int32)
        forest.append((slp.node_min, slp.node_max, slp.prim_count, slp.skip,
                       meta_leaf))
        for k, node in enumerate(lv):
            f, c = int(slp.first_prim[node]), int(slp.prim_count[node])
            ids = a + slp.prim_order[f:f + c]
            base = (bg + k) * sl_block
            sl_tris[base:base + c] = np.concatenate([v0[ids], e1[ids],
                                                     e2[ids]], axis=1)
            sl_map[base:base + c] = ids
            slot_used[base:base + c] = True
            sl_inv[ids] = np.arange(base, base + c, dtype=np.int32)
        sl_blkflat[0:3, c0:c0 + len(lv)] = slp.node_min[lv].T
        sl_blkflat[3:6, c0:c0 + len(lv)] = slp.node_max[lv].T
        sl_blkid[0, c0:c0 + len(lv)] = np.arange(bg, bg + len(lv))
        bg += len(lv)
    nodes6, meta6 = build_directional_layouts_forest(forest)
    return dict(sl_tris=sl_tris, sl_bw_t=_baldwin_weber_rows(sl_tris),
                sl_tris_t=np.ascontiguousarray(sl_tris.T), sl_nodes6=nodes6,
                sl_meta6=meta6,
                sl_n_nodes=sum(t.skip.shape[0] for t in trees),
                sl_map=sl_map, sl_inv=sl_inv, sl_blkflat=sl_blkflat,
                sl_blkid=sl_blkid, **_superblocks(sl_blkflat, sl_blkid),
                part_blocks=part_blocks, sl_n_blocks=n_blocks,
                sph_row_base=n_blocks * sl_block, slot_used=slot_used)


def _superblocks(sl_blkflat, sl_blkid) -> dict:
    """``sl_sbflat`` / ``sl_sbid``: the union of each group of 128 block
    columns (``device_scene.py:1139-1157`` of the JAX package). Pad columns
    enter as the identities (+inf minima, -inf maxima); an all-pad group
    gets zero bounds and id -1."""
    nsb = sl_blkflat.shape[1] // 128
    col_valid = sl_blkid[0] >= 0
    gm = np.where(col_valid[:, None], 0.0, np.inf).astype(np.float32)
    gx = np.where(col_valid[:, None], 0.0, -np.inf).astype(np.float32)
    gm = gm + sl_blkflat[0:3].T
    gx = gx + sl_blkflat[3:6].T
    sb_pad = ((nsb + 127) // 128) * 128
    sl_sbflat = np.zeros((8, sb_pad), np.float32)
    sl_sbid = np.full((1, sb_pad), -1, np.int32)
    valid = col_valid.reshape(nsb, 128).any(axis=1)
    sl_sbflat[0:3, :nsb] = np.where(valid[None, :],
                                    gm.reshape(nsb, 128, 3).min(axis=1).T, 0.0)
    sl_sbflat[3:6, :nsb] = np.where(valid[None, :],
                                    gx.reshape(nsb, 128, 3).max(axis=1).T, 0.0)
    sl_sbid[0, :nsb] = np.where(valid, np.arange(nsb), -1)
    return dict(sl_sbflat=sl_sbflat, sl_sbid=sl_sbid)


def _tr_prefilter(v0, e1, e2, a: int, b: int) -> np.ndarray:
    """[32, 6] boxes (min, max) covering triangles [a, b): the leaves of a
    BVH with about 32 leaves, overflow leaves merged into the last box;
    padding boxes are degenerate points at 1e30."""
    from path_tracer_torch.native import build_bvh

    out = np.full((32, 6), 1e30, np.float32)
    if b <= a:
        return out
    q0 = v0[a:b]
    q1, q2 = q0 + e1[a:b], q0 + e2[a:b]
    tb = build_bvh(np.minimum(np.minimum(q0, q1), q2),
                   np.maximum(np.maximum(q0, q1), q2),
                   leaf_size=max(4, (b - a + 31) // 32))
    leaf = np.nonzero(tb.prim_count > 0)[0]
    lmin, lmax = tb.node_min[leaf], tb.node_max[leaf]
    if len(leaf) > 32:
        lmin = np.concatenate([lmin[:31], lmin[31:].min(axis=0, keepdims=True)])
        lmax = np.concatenate([lmax[:31], lmax[31:].max(axis=0, keepdims=True)])
    out[:len(lmin), 0:3] = lmin
    out[:len(lmin), 3:6] = lmax
    return out


# The JAX package's routing limits of the walk kernels' tables: at most
# this many transparent columns, distinct opacity textures and page-plane
# texels (the kernels here have no such cap; the limits keep both
# packages on the same path).
TRWALK_MAX_COLUMNS = 4096
TRWALK_MAX_PAGES = 8
TRWALK_MAX_TEXELS = 1 << 21


def _spread10(b):
    """Interleave the low 10 bits of b with 2-bit gaps (Morton)."""
    b = (b | (b << 16)) & 0x030000FF
    b = (b | (b << 8)) & 0x0300F00F
    b = (b | (b << 4)) & 0x030C30C3
    return (b | (b << 2)) & 0x09249249


def _build_tr_walk_tables(sl_bw, sl_tris, slot_tri, uv0, uv1, uv2,
                          tri_model, opacity_f, opacity_t, lo: int, hi: int,
                          atlas_data, offsets, widths, heights) -> dict:
    """The transparent walks' compact tables over packed slots [lo, hi)
    (``_build_tr_walk_tables`` of the JAX package, fed from the per-slot
    triangle ids ``slot_tri`` instead of its wide attribute table).
    ``tr_kernel_ok`` False returns placeholders."""
    lut = (np.arange(256).astype(np.float64) / 255.0).astype(np.float32)
    out = dict(tr_bw=np.zeros((16, 128), np.float32),
               tr_rows=np.zeros((9, 128), np.float32),
               tr_grp=np.zeros((7, 128), np.float32),
               tr_colmap=np.zeros(128, np.int32),
               tr_model=np.zeros(128, np.int32),
               tr_tex8=np.zeros((8, 128), np.uint8), tr_lut=lut[None, :],
               tr_pages=(), tr_textured=False, tr_kernel_ok=False)
    if hi - lo <= 0:
        return out
    # Real slots: nonzero edges (pad slots are all-zero rows).
    real = np.abs(sl_tris[lo:hi, 3:9]).sum(axis=1) > 0
    idx = np.nonzero(real)[0]
    tp = len(idx)
    if tp == 0 or tp > TRWALK_MAX_COLUMNS:
        return out
    tris = sl_tris[lo:hi][idx]
    v0 = tris[:, 0:3]
    v1 = v0 + tris[:, 3:6]
    v2 = v0 + tris[:, 6:9]
    cen = (v0 + v1 + v2) / 3.0
    mn = cen.min(axis=0)
    ext = max(float((cen.max(axis=0) - mn).max()), 1e-12)
    q = np.clip((cen - mn) / ext * 1023.0, 0, 1023).astype(np.int64)
    code = (_spread10(q[:, 0]) | (_spread10(q[:, 1]) << 1)
            | (_spread10(q[:, 2]) << 2))
    order = np.argsort(code, kind="stable")  # ties keep slot order
    idx = idx[order]
    v0, v1, v2 = v0[order], v1[order], v2[order]

    tp_pad = max(256, ((tp + 127) // 128) * 128)
    tr_bw = np.zeros((16, tp_pad), np.float32)
    tr_bw[:, :tp] = sl_bw[:, lo:hi][:, idx]
    tmin = np.minimum(np.minimum(v0, v1), v2)
    tmax = np.maximum(np.maximum(v0, v1), v2)
    tr_grp = np.zeros((7, max(128, ((tp_pad // 128 + 127) // 128) * 128)),
                      np.float32)
    for g in range((tp + 127) // 128):
        sl = slice(g * 128, min((g + 1) * 128, tp))
        tr_grp[0:3, g] = tmin[sl].min(axis=0)
        tr_grp[3:6, g] = tmax[sl].max(axis=0)
        tr_grp[6, g] = 1.0
    tri = slot_tri[lo + idx]
    model = tri_model[tri]
    colmap = np.zeros(tp_pad, np.int32)
    colmap[:tp] = lo + idx
    modelmap = np.zeros(tp_pad, np.int32)
    modelmap[:tp] = model
    rows = np.zeros((9, tp_pad), np.float32)
    u0, u1, u2 = uv0[tri], uv1[tri], uv2[tri]
    rows[0:2, :tp] = u0.T
    rows[2:4, :tp] = (u1 - u0).T  # f32 differences, as shading takes them
    rows[4:6, :tp] = (u2 - u0).T
    rows[6, :tp] = np.asarray(opacity_f, np.float32)[model]
    tids = np.asarray(opacity_t, np.int32)[model]
    used = np.unique(tids[tids >= 0])
    if len(used) > TRWALK_MAX_PAGES:
        return out
    pages = []
    tex8 = np.zeros((8, 128), np.uint8)
    if len(used):
        planes, ybase, wp = [], 0, 128
        for t in (int(t) for t in used):
            w, h, off = int(widths[t]), int(heights[t]), int(offsets[t])
            plane = atlas_data[off:off + w * h, 0]
            r255 = plane.astype(np.float64) * 255.0
            ru = np.round(r255)
            if (np.abs(r255 - ru).max() > 1e-3
                    or not np.array_equal(plane, lut[ru.astype(np.int32)])):
                return out  # not u8/255 exactly: the LUT fetch would differ
            planes.append(ru.astype(np.uint8).reshape(h, w))
            pages.append((off, w, h, ybase))
            ybase += h
            wp = max(wp, ((w + 127) // 128) * 128)
        hp = ((ybase + 127) // 128) * 128
        if hp * wp > TRWALK_MAX_TEXELS:
            return out
        tex8 = np.zeros((hp, wp), np.uint8)
        for (_, w, h, yb), pl in zip(pages, planes):
            tex8[yb:yb + h, :w] = pl
        rows[7, :tp] = (tids >= 0).astype(np.float32)
        page_of = {int(t): p for p, t in enumerate(used)}
        rows[8, :tp] = [float(page_of[int(t)]) if t >= 0 else 0.0
                        for t in tids]
    out.update(tr_bw=tr_bw, tr_rows=rows, tr_grp=tr_grp, tr_colmap=colmap,
               tr_model=modelmap, tr_tex8=tex8, tr_pages=tuple(pages),
               tr_textured=bool(len(used)), tr_kernel_ok=True)
    return out


def _certainly_opaque(model, gray: Optional[np.ndarray]) -> list:
    """Per triangle of a transparent-material mesh: True when the opacity
    texture's minimum over the triangle's wrapped UV box, one texel wider
    each way, times the factor is >= 1 (the walks then accept it without a
    random number, so it behaves as opaque geometry). ``gray``: the
    opacity texture's texels (``load_texture_gray``)."""
    m = model.material
    if m.opacity.factor < 1.0 or m.opacity.texture is None:
        return [False] * len(model.triangles)
    th, tw = gray.shape
    out = []
    for tri in model.triangles:
        us = [v.tex_coords[0] for v in tri]
        vs = [v.tex_coords[1] for v in tri]
        x0 = int(np.floor(min(us) * tw)) - 1
        x1 = int(np.floor(max(us) * tw)) + 1
        y0 = int(np.floor(min(vs) * th)) - 1
        y1 = int(np.floor(max(vs) * th)) + 1
        xs = np.arange(x0, min(x1, x0 + tw) + 1) % tw
        ys = np.arange(y0, min(y1, y0 + th) + 1) % th
        out.append(float(gray[np.ix_(ys, xs)].min()) * m.opacity.factor
                   >= 1.0)
    return out


def build_scene(scene: isf.Scene, root, device, use_bvh: Optional[bool] = None,
                sl_block: int = 512) -> TorchScene:
    """Flatten an ISF scene into device tensors, as ``build_device_scene``
    of the JAX package does for the fields above (same signature:
    ``use_bvh=None`` walks the BVH from 4,096 triangles on; ``sl_block``
    triangles per superleaf block, a multiple of 128). The build records
    the spans ``scene.build``, ``scene.textures`` (the atlas: reading and
    decoding the images), ``scene.flatten`` (the triangle rows in the
    leaf-4 BVH's order), ``scene.bvh`` (each ``native.build_bvh``),
    ``scene.tables`` (superleaf, flat2, wide-texture, walk and shading-row
    tables) and ``scene.upload`` (``from_numpy``), ``utils.telemetry``."""
    with telemetry.span("scene.build", device):
        return _build_scene(scene, Path(root), device, use_bvh, sl_block)


def _build_scene(scene: isf.Scene, root: Path, device, use_bvh, sl_block):
    """The body of ``build_scene``."""
    from path_tracer_torch.utils.image_io import load_texture_gray

    meshes = [m for m in scene.models if isinstance(m, isf.Mesh)]
    n_tris = sum(len(m.triangles) for m in meshes)
    n_real_sph = len(scene.models) - len(meshes)

    atlas = _AtlasBuilder(root)
    mats = {k: [] for k in (
        "albedo_f", "emissive_f", "opacity_f", "metal_f", "rough_f", "ior",
        "albedo_t", "emissive_t", "opacity_t", "metal_t", "rough_t",
        "normal_t")}
    # The opacity textures _certainly_opaque reads, by path.
    opacity_gray = {}
    with telemetry.span("scene.textures"):
        for model in scene.models:
            m = model.material
            mats["albedo_f"].append(m.albedo.factor)
            mats["emissive_f"].append(m.emissive.factor)
            mats["opacity_f"].append(m.opacity.factor)
            mats["metal_f"].append(m.metalness.factor)
            mats["rough_f"].append(m.roughness.factor)
            mats["ior"].append(m.ior)
            mats["albedo_t"].append(atlas.add(m.albedo.texture, "rgb"))
            mats["emissive_t"].append(atlas.add(m.emissive.texture, "rgb"))
            mats["opacity_t"].append(atlas.add(m.opacity.texture, "gray"))
            mats["metal_t"].append(atlas.add(m.metalness.texture, "gray"))
            mats["rough_t"].append(atlas.add(m.roughness.texture, "gray"))
            mats["normal_t"].append(atlas.add(m.normal_texture, "rgb"))
            tex = m.opacity.texture
            if (isinstance(model, isf.Mesh) and m.opacity.factor >= 1.0
                    and tex is not None and tex not in opacity_gray):
                opacity_gray[tex] = load_texture_gray(root / tex)
    with telemetry.span("scene.flatten"):
        flat = _flatten(scene, n_tris, opacity_gray)
    with telemetry.span("scene.tables"):
        fields, statics = _tables(scene, flat, atlas, mats, n_tris,
                                  n_real_sph, use_bvh, sl_block)
    with telemetry.span("scene.upload", device):
        return from_numpy(fields, statics, device)


def _flatten(scene: isf.Scene, n_tris: int, opacity_gray: dict) -> dict:
    """The triangle rows of every mesh, padded to ``_TRI_PAD``, opaque
    triangles first and each partition in its leaf-4 BVH's order, and the
    spheres' rows."""
    keys = ("v0", "v1", "v2", "n0", "n1", "n2", "uv0", "uv1", "uv2")
    tri_rows = {k: [] for k in keys}
    tri_model, tri_transparent = [], []
    sph_center, sph_radius, sph_model = [], [], []
    sph_all_opaque = True
    n_transparent_hits = 0
    for model_id, model in enumerate(scene.models):
        m = model.material
        transparent = m.opacity.factor < 1.0 or m.opacity.texture is not None
        if isinstance(model, isf.Mesh):
            certain = (_certainly_opaque(model,
                                         opacity_gray.get(m.opacity.texture))
                       if transparent else [True] * len(model.triangles))
            for (v0, v1, v2), sure in zip(model.triangles, certain):
                for k, vert in (("0", v0), ("1", v1), ("2", v2)):
                    tri_rows["v" + k].append(vert.position)
                    tri_rows["n" + k].append(vert.normal)
                    tri_rows["uv" + k].append(vert.tex_coords)
                tri_model.append(model_id)
                tri_transparent.append(not sure)
                n_transparent_hits += int(not sure)
        else:
            if transparent:  # near and far root on a re-cast
                n_transparent_hits += 2
                sph_all_opaque = False
            sph_center.append(model.center)
            sph_radius.append(model.radius)
            sph_model.append(model_id)

    # Opacity partition: opaque triangles first (stable within each kind).
    tr_mask = np.asarray(tri_transparent, np.bool_)
    n_op = int((~tr_mask).sum())
    if 0 < n_op < n_tris:
        order = np.concatenate([np.nonzero(~tr_mask)[0],
                                np.nonzero(tr_mask)[0]])
        tri_rows = {k: [rows[i] for i in order] for k, rows in tri_rows.items()}
        tri_model = [tri_model[i] for i in order]
        ranges = [(0, n_op), (n_op, n_tris)]
    else:
        ranges = [(0, n_tris)] if n_tris else []

    n_pad = _pad_to(n_tris, _TRI_PAD)

    def pad(rows, dim):
        arr = np.zeros((n_pad, dim), np.float32)
        if rows:
            arr[:n_tris] = np.asarray(rows, np.float32)
        return arr

    v0, v1, v2 = pad(tri_rows["v0"], 3), pad(tri_rows["v1"], 3), pad(tri_rows["v2"], 3)
    e1 = v1 - v0
    e2 = v2 - v0
    uv0, uv1, uv2 = (pad(tri_rows[k], 2) for k in ("uv0", "uv1", "uv2"))
    n0, n1, n2 = (pad(tri_rows[k], 3) for k in ("n0", "n1", "n2"))
    # Per-triangle tangent from UV deltas; NaN (degenerate UVs) → 0.
    du1 = uv1 - uv0
    du2 = uv2 - uv0
    with np.errstate(divide="ignore", invalid="ignore"):
        f = 1.0 / (du1[:, 0] * du2[:, 1] - du2[:, 0] * du1[:, 1])
        tangent = f[:, None] * (du2[:, 1:2] * e1 - du1[:, 1:2] * e2)
        tangent = tangent / np.sqrt((tangent * tangent).sum(-1, keepdims=True))
    tangent = np.where(np.isfinite(tangent), tangent, 0.0).astype(np.float32)
    tri_model_arr = np.zeros(n_pad, np.int32)
    tri_model_arr[:n_tris] = np.asarray(tri_model, np.int32).reshape(-1)

    if n_tris:
        from path_tracer_torch.native import build_bvh

        p0, p1, p2 = v0[:n_tris], v0[:n_tris] + e1[:n_tris], v0[:n_tris] + e2[:n_tris]
        bmin = np.minimum(np.minimum(p0, p1), p2)
        bmax = np.maximum(np.maximum(p0, p1), p2)
        # One leaf-4 BVH per partition; each permutes within its range.
        perm = np.concatenate([
            a + build_bvh(bmin[a:b], bmax[a:b], leaf_size=4).prim_order
            for a, b in ranges])
        for arr in (v0, e1, e2, uv0, uv1, uv2, tangent, n0, n1, n2):
            arr[:n_tris] = arr[:n_tris][perm]
        tri_model_arr[:n_tris] = tri_model_arr[:n_tris][perm]
    return dict(v0=v0, e1=e1, e2=e2, uv0=uv0, uv1=uv1, uv2=uv2, n0=n0, n1=n1,
                n2=n2, tangent=tangent, tri_model=tri_model_arr, ranges=ranges,
                n_pad=n_pad, n_op=n_op, sph_center=sph_center,
                sph_radius=sph_radius, sph_model=sph_model,
                sph_all_opaque=sph_all_opaque,
                n_transparent_hits=n_transparent_hits)


def _tables(scene: isf.Scene, flat: dict, atlas: _AtlasBuilder, mats: dict,
            n_tris: int, n_real_sph: int, use_bvh, sl_block: int):
    """(fields, statics), ``from_numpy``'s arguments, from the flattened
    rows (``_flatten``) and the atlas: the superleaf and flat2 tables, the
    wide textures, the walk tables, the sphere blocks and the shading
    rows."""
    v0, e1, e2 = flat["v0"], flat["e1"], flat["e2"]
    uv0, uv1, uv2 = flat["uv0"], flat["uv1"], flat["uv2"]
    n0, n1, n2 = flat["n0"], flat["n1"], flat["n2"]
    tangent, tri_model_arr = flat["tangent"], flat["tri_model"]
    ranges, n_op = flat["ranges"], flat["n_op"]
    sl = _superleaf_tables(v0, e1, e2, ranges, flat["n_pad"], sl_block)
    part_blocks = sl["part_blocks"]
    if len(ranges) == 2 or n_op == n_tris:
        nblk_op = part_blocks[0] if part_blocks else 0
    else:  # every triangle possibly transparent
        nblk_op = 0
    atlas_data = np.concatenate(atlas.chunks, axis=0)
    atlas_geom = (atlas.offsets, atlas.widths, atlas.heights)
    tex_wide, woff, ww, wh, wide_covered = _build_wide_tex(
        mats, atlas_data, *atlas_geom)
    tr = _build_tr_walk_tables(
        sl["sl_bw_t"], sl["sl_tris"], sl["sl_map"], uv0, uv1, uv2,
        tri_model_arr, mats["opacity_f"], mats["opacity_t"],
        nblk_op * sl_block, sl["sl_n_blocks"] * sl_block, atlas_data,
        atlas.offsets, atlas.widths, atlas.heights)

    n_sph = max(1, n_real_sph)
    centers = np.full((n_sph, 3), 1e30, np.float32)
    radii = np.zeros(n_sph, np.float32)
    sph_model_arr = np.zeros(n_sph, np.int32)
    if n_real_sph:
        centers[:n_real_sph] = np.asarray(flat["sph_center"], np.float32)
        radii[:n_real_sph] = np.asarray(flat["sph_radius"], np.float32)
        sph_model_arr[:n_real_sph] = np.asarray(flat["sph_model"], np.int32)
    sph_blocks = _sphere_blocks(centers, radii)
    sl_attr = _attr_rows(
        sl, dict(v0=v0, e1=e1, e2=e2, n0=n0, n1=n1, n2=n2, tangent=tangent,
                 uv0=uv0, uv1=uv1, uv2=uv2),
        tri_model_arr, sph_model_arr, n_real_sph, mats, atlas_geom,
        (woff, ww, wh))

    points = [l for l in scene.lights if isinstance(l, isf.PointLight)]
    dirs = [l for l in scene.lights if isinstance(l, isf.DirectionalLight)]
    f32 = lambda x: np.asarray(x, np.float32)
    fields = dict(
        tri_v0=v0, tri_e1=e1, tri_e2=e2, tri_n0=n0, tri_n1=n1, tri_n2=n2,
        tri_uv0=uv0, tri_uv1=uv1, tri_uv2=uv2, tri_tangent=tangent,
        tri_model=tri_model_arr,
        tri_packed_t=np.concatenate([v0, e1, e2], axis=1).T,
        sph_center=centers, sph_radius=radii, sph_model=sph_model_arr,
        sph_packed_t=_pack_spheres(centers, radii),
        mat_albedo_factor=f32(mats["albedo_f"]).reshape(-1, 3),
        mat_emissive_factor=f32(mats["emissive_f"]).reshape(-1, 3),
        mat_opacity_factor=f32(mats["opacity_f"]),
        mat_metalness_factor=f32(mats["metal_f"]),
        mat_roughness_factor=f32(mats["rough_f"]),
        mat_ior=f32(mats["ior"]),
        mat_albedo_tex=mats["albedo_t"], mat_emissive_tex=mats["emissive_t"],
        mat_opacity_tex=mats["opacity_t"], mat_metalness_tex=mats["metal_t"],
        mat_roughness_tex=mats["rough_t"], mat_normal_tex=mats["normal_t"],
        tex_data=atlas_data,
        tex_offset=atlas.offsets, tex_width=atlas.widths,
        tex_height=atlas.heights,
        point_pos=f32([l.position for l in points]).reshape(-1, 3),
        point_color=f32([l.color for l in points]).reshape(-1, 3),
        dir_dir=f32([l.direction for l in dirs]).reshape(-1, 3),
        dir_color=f32([l.color for l in dirs]).reshape(-1, 3),
        # ISF stores the COLUMN-major matrix: transpose to row-major.
        cam_to_world=f32(scene.camera.transform).T,
        cam_fov=f32(scene.camera.fov),
        background=f32(scene.background),
        tr_prefilter=_tr_prefilter(v0, e1, e2, n_op, n_tris),
        **{k: sl[k] for k in ("sl_bw_t", "sl_blkflat", "sl_blkid", "sl_map",
                              "sl_inv", "sl_sbflat", "sl_sbid", "sl_nodes6",
                              "sl_meta6", "sl_tris_t")},
        **{k: sph_blocks[k] for k in ("sph_sorted_t", "sph_blk", "sph_blkid",
                                      "sph_smap")},
        **{k: tr[k] for k in ("tr_bw", "tr_rows", "tr_grp", "tr_colmap",
                              "tr_model", "tr_tex8", "tr_lut")},
        sl_attr=sl_attr, tex_wide=tex_wide,
    )
    statics = dict(
        all_opaque=all(m.material.opacity.factor >= 1.0
                       and m.material.opacity.texture is None
                       for m in scene.models),
        no_textures=len(atlas.offsets) == 1,
        no_emissive=all(
            tuple(m.material.emissive.factor) == (0.0, 0.0, 0.0)
            and m.material.emissive.texture is None for m in scene.models),
        has_tex=tuple(any(t >= 0 for t in mats[k]) for k in (
            "albedo_t", "emissive_t", "opacity_t", "metal_t", "rough_t",
            "normal_t")),
        num_real_triangles=n_tris,
        num_real_spheres=n_real_sph,
        use_bvh=(n_tris >= BVH_MIN_TRIANGLES if use_bvh is None
                 else bool(use_bvh)),
        sph_use_blocks=sph_blocks["sph_use_blocks"],
        sl_block=sl_block,
        sl_n_blocks=sl["sl_n_blocks"],
        sl_n_nodes=sl["sl_n_nodes"],
        sph_row_base=sl["sph_row_base"],
        n_tris_opaque=n_op,
        sl_n_blocks_opaque=nblk_op,
        sl_cols_opaque=((nblk_op + 127) // 128) * 128,
        num_transparent_hits=flat["n_transparent_hits"],
        sph_all_opaque=flat["sph_all_opaque"],
        tr_kernel_ok=tr["tr_kernel_ok"],
        tr_textured=tr["tr_textured"],
        tr_pages=tr["tr_pages"],
        # The JAX package bakes the atlas geometry's use only under its
        # PT_BAKED_TEX knob (off by default), which the port does not carry.
        attr_tex_baked=False,
        wide_covered=wide_covered,
    )
    return fields, statics


# ---------------------------------------------------------------------------
# Opacity-partition views
# ---------------------------------------------------------------------------


def partitioned(scene) -> bool:
    """True when the partitioned walks apply: a BVH scene with both opaque
    and possibly-transparent triangles and only opaque spheres, walked by
    the flat or flat2 walk. The walks then cast once against the opaque
    blocks (the terminator, or a binary any-hit) and walk only the
    transparent blocks. The views scope the flat-family tables, not the
    superleaf forest, so under ``PT_BVH_KERNEL=tree`` the partition stands
    down and the whole-scene walks run (the JAX package's rule on its
    chip)."""
    from path_tracer_torch.ops.intersect import _use_flat_walk

    return bool(scene.use_bvh and not scene.all_opaque
                and scene.sph_all_opaque
                and scene.sl_n_blocks_opaque > 0
                and scene.sl_n_blocks > scene.sl_n_blocks_opaque
                and _use_flat_walk(scene))


def opaque_view(scene) -> TorchScene:
    """The scene with its block and superblock tables cut to the opaque
    partition's columns (block and triangle ids stay global; spheres
    unchanged). The partition offset is 128-aligned, so the opaque
    superblocks are exactly the first ``sl_cols_opaque // 128``."""
    c = scene.sl_cols_opaque
    return dataclasses.replace(
        scene, sl_blkflat=scene.sl_blkflat[:, :c].contiguous(),
        sl_blkid=scene.sl_blkid[:, :c].contiguous(),
        sl_sbflat=_pad_cols(scene.sl_sbflat[:, :c // 128], 0.0),
        sl_sbid=_pad_cols(scene.sl_sbid[:, :c // 128], -1),
        sl_n_blocks=scene.sl_n_blocks_opaque)


def transparent_view(scene) -> TorchScene:
    """The scene with its block and superblock tables cut to the
    possibly-transparent partition's columns."""
    c = scene.sl_cols_opaque
    nsb = max(1, (scene.sl_blkflat.shape[1] - c) // 128)
    return dataclasses.replace(
        scene, sl_blkflat=scene.sl_blkflat[:, c:].contiguous(),
        sl_blkid=scene.sl_blkid[:, c:].contiguous(),
        sl_sbflat=_pad_cols(scene.sl_sbflat[:, c // 128:c // 128 + nsb], 0.0),
        sl_sbid=_pad_cols(scene.sl_sbid[:, c // 128:c // 128 + nsb], -1),
        sl_n_blocks=scene.sl_n_blocks - scene.sl_n_blocks_opaque)


def _pad_cols(t: torch.Tensor, fill) -> torch.Tensor:
    """``t`` padded along its last dimension with ``fill`` to a multiple
    of 128 (at least 128), contiguous."""
    n = t.shape[-1]
    target = max(128, ((n + 127) // 128) * 128)
    return torch.nn.functional.pad(t, (0, target - n), value=fill).contiguous()
