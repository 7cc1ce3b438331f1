"""Checkpoints of a render's accumulation buffer, for resuming it.

Port of ``path_tracer_tpu/utils/checkpoint.py``. A checkpoint holds the
radiance sums [W*H,3] (linear pixel order), the samples done and a
fingerprint of the render. The RNG is counter-based per (pixel, sample),
so a render resumed at the next sample id sums the same terms in the same
order as one that ran straight through: the two images are equal bit for
bit. The port's files are its own: they need not load in the JAX package,
nor the JAX package's here (the fingerprints hash different tables).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

_VERSION = 1

# Tables derived from the hashed inputs (acceleration structures, packed
# copies, the walk kernels' and the dense walk's tables): deterministic in
# what is hashed, so skipping them loses nothing and saves copying tens of
# MB off the card.
_DERIVED_PREFIXES = ("sl_", "tr_", "khit_")
_DERIVED = {"tri_packed_t", "sph_packed_t", "sph_sorted_t", "sph_blk",
            "sph_blkid", "sph_smap", "sph_use_blocks", "sph_row_base"}


def fingerprint(width: int, height: int, bounces: int, seed: int, scene,
                profile=None) -> str:
    """A digest of every input that affects the radiance: the render's size,
    bounces and seed, the profile's tonemap and walk depths (when given),
    and every input tensor and static fact of the ``TorchScene`` (camera,
    lights, materials, textures, geometry), derived tables skipped."""
    h = hashlib.sha1()
    h.update(f"{_VERSION}|{width}x{height}|b{bounces}|s{seed}".encode())
    if profile is not None:
        h.update(f"|tm{profile.tonemap}|aw{profile.alpha_walk_steps}"
                 f"|sw{profile.shadow_walk_steps}".encode())
    for f in dataclasses.fields(scene):
        if f.name.startswith(_DERIVED_PREFIXES) or f.name in _DERIVED:
            continue
        leaf = getattr(scene, f.name)
        if isinstance(leaf, torch.Tensor):
            h.update(f.name.encode())
            h.update(leaf.detach().cpu().contiguous().numpy().tobytes())
        else:  # static facts (ints, bools, tuples) affect radiance too
            h.update(f"|{f.name}={leaf}".encode())
    return h.hexdigest()[:16]


def save(path, accum: np.ndarray, samples_done: int, fp: str) -> None:
    """Write the checkpoint atomically: a crash mid-write leaves the last
    checkpoint whole."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        np.savez_compressed(
            f, accum=np.asarray(accum, np.float32),
            samples_done=np.int64(samples_done),
            meta=json.dumps({"version": _VERSION, "fingerprint": fp}))
    tmp.replace(path)


def load(path, fp: str) -> Optional[Tuple[np.ndarray, int]]:
    """(sums [W*H,3], samples done), or None when there is no file; raises
    ValueError when the file was written by a different render."""
    path = Path(path)
    if not path.exists():
        return None
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        if meta.get("fingerprint") != fp:
            raise ValueError(
                f"checkpoint {path} was written by a different render config "
                f"({meta.get('fingerprint')} != {fp})")
        return z["accum"].copy(), int(z["samples_done"])
