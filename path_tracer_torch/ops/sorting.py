"""Wavefront ray sorting (port of ``path_tracer_tpu/ops/sorting.py``).

``morton_pixel_order`` is the host's coherent pixel order, which the
renderer feeds every wavefront in. ``ray_sort_keys`` and
``sort_permutation`` order a cast's rays by an origin-cell and
direction-octant Morton key, so that similar rays share a warp, and put
the result back in lane order by the inverse permutation. No cast sorts
its rays: on the H100 a sorted route (the JAX package's
``PT_DEVICE_SORT=1``) cost more in its own launches and per-light any-hit
launches than it saved inside the walks (PERF.md, PR 21).

Keys are int64 with the JAX package's uint32 bits: torch's uint32
arithmetic is partial, and an int32 key with bit 31 set (a dead lane)
would go negative and sort first instead of last.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def _part1by2(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of x over 30 (Morton interleave helper)."""
    x = x.to(torch.int64) & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton3(ix, iy, iz) -> torch.Tensor:
    return _part1by2(ix) | (_part1by2(iy) << 1) | (_part1by2(iz) << 2)


def ray_sort_keys(o, d, bbox_lo, bbox_hi, origin_bits: int = 5,
                  dir_bits: int = 3) -> torch.Tensor:
    """[R] int64 sort keys: origin Morton (high) | direction Morton (low).

    o, d: [R,3]. Origins quantize against the box [bbox_lo, bbox_hi];
    directions against [-1,1]. Rays from the same region with similar
    directions sort together."""
    span = torch.clamp(bbox_hi - bbox_lo, min=1e-6)
    oq = torch.clamp((o - bbox_lo) / span, 0.0, 1.0)
    mo = morton3(*(oq * float((1 << origin_bits) - 1)).unbind(1))
    dq = torch.clamp((d + 1.0) * 0.5, 0.0, 1.0)
    md = morton3(*(dq * float((1 << dir_bits) - 1)).unbind(1))
    return (mo << (3 * dir_bits)) | md


def sort_permutation(keys: torch.Tensor):
    """(perm, inv): x[perm] sorts by key (stable, as ``jnp.argsort``);
    y[inv] undoes it. The inverse is one scatter."""
    perm = torch.sort(keys, stable=True).indices
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], device=perm.device)
    return perm, inv


def morton_pixel_order(width: int, height: int, tile: int = 16) -> np.ndarray:
    """Pixel ids [W*H] int32 grouped into tile x tile screen blocks
    (tile-major, raster within a block), so consecutive lanes of a wavefront
    cover a screen square. Cached per (width, height, tile); read-only."""
    return _morton_pixel_order_cached(width, height, tile)


@functools.lru_cache(maxsize=8)
def _morton_pixel_order_cached(width: int, height: int, tile: int):
    ids = np.arange(width * height, dtype=np.int64)
    x = ids % width
    y = ids // width
    key = ((y // tile).astype(np.int64) << 40) \
        | ((x // tile).astype(np.int64) << 20) \
        | ((y % tile) << 10) | (x % tile)
    out = ids[np.argsort(key, kind="stable")].astype(np.int32)
    out.flags.writeable = False  # cached: callers must copy to mutate
    return out
