"""Render driver: tiles x samples loop around the wavefront integrator.

Port of ``path_tracer_tpu/models/renderer.py`` for one device: pixels are
fed in the host-computed Morton (16x16 screen tile) order, cut into tiles
of ``tile_rays`` lanes (the last tile padded with pixel 0, discarded), and
each tile's float32 radiance sum is accumulated sample by sample in sample
order, exactly as the JAX package sums. Accumulators stay on the device;
the only host transfer is the final [W*H,3] sum.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from path_tracer_torch.config import Profile
from path_tracer_torch.models.integrator import IntegratorSpec, render_wavefront
from path_tracer_torch.ops import tonemap as tm
from path_tracer_torch.ops.sorting import morton_pixel_order


def integrator_spec(profile: Profile) -> IntegratorSpec:
    """The forward-rendering spec of a profile (never differentiable, as
    the JAX package's renderer sets it)."""
    return IntegratorSpec(bounces=profile.bounces,
                          alpha_walk_steps=profile.alpha_walk_steps,
                          shadow_walk_steps=profile.shadow_walk_steps,
                          seed=profile.seed, differentiable=False)


def render_pixel_sums(scene, width: int, height: int, sample_start: int,
                      n_samples: int, spec: IntegratorSpec,
                      tile_rays: int = 1 << 16) -> np.ndarray:
    """Radiance sums [W*H, 3] (float32, linear pixel order) over n_samples
    consecutive sample ids starting at ``sample_start``, rendered on the
    scene's device."""
    n_pix = width * height
    tile = min(tile_rays, max(1, n_pix))
    n_tiles = (n_pix + tile - 1) // tile
    morton = morton_pixel_order(width, height)
    all_pix = np.zeros(n_tiles * tile, dtype=np.int32)
    all_pix[:n_pix] = morton  # padded lanes re-render pixel 0; discarded
    dev = scene.device
    tile_ids = [torch.from_numpy(all_pix[t * tile:(t + 1) * tile]).to(dev)
                for t in range(n_tiles)]
    accs = [torch.zeros((tile, 3), device=dev) for _ in range(n_tiles)]
    for sample in range(sample_start, sample_start + n_samples):
        for ti in range(n_tiles):
            accs[ti] += render_wavefront(scene, tile_ids[ti], width, height,
                                         sample, spec)
    rows = torch.cat(accs).cpu().numpy()[:n_pix]
    out = np.empty_like(rows)
    out[morton] = rows  # back to linear pixel order
    return out


def render(scene, profile: Profile, progress: bool = False) -> np.ndarray:
    """Render a scene → [H,W,3] uint8, accumulating radiance over sample ids
    1..=profile.samples (as the reference does)."""
    if profile.samples_per_wavefront != 1:
        raise NotImplementedError("samples_per_wavefront > 1 is not ported")
    width, height = profile.resolution.width, profile.resolution.height
    t0 = time.time()
    accum = render_pixel_sums(scene, width, height, 1, profile.samples,
                              integrator_spec(profile),
                              tile_rays=profile.tile_rays)
    elapsed = time.time() - t0
    if progress:
        n_rays = width * height * profile.samples * (profile.bounces + 1)
        print(f"Done: {elapsed:.1f}s ({n_rays / max(elapsed, 1e-9) / 1e6:.1f} "
              f"Mray/s)", flush=True)
    return finalize(accum, profile.samples, profile, width, height)


def finalize(accum: np.ndarray, samples: int, profile: Profile, width,
             height) -> np.ndarray:
    """Radiance sums [W*H,3] → [H,W,3] uint8 (mean, tonemap, gamma)."""
    mean = torch.from_numpy(np.asarray(accum, np.float32)) / float(samples)
    u8 = tm.to_u8(tm.post_process(profile.tonemap, mean)).numpy()
    return u8.reshape(height, width, 3)
