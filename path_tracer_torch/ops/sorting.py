"""Host-side coherent pixel ordering (port of the numpy part of
``path_tracer_tpu/ops/sorting.py``)."""
from __future__ import annotations

import functools

import numpy as np


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
