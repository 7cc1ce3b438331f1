"""Camera ray generation over a pixel-id wavefront.

Port of ``path_tracer_tpu/ops/camera.py`` (reference semantics):
  screen_x = ((x + jitter_x)/W*2 - 1) * tan(fov/2) * aspect
  screen_y = (1 - (y + jitter_y)/H*2) * tan(fov/2)
  dir_cam  = normalize([screen_x, screen_y, -1])
  dir_world = M[:3,:3] @ dir_cam   (not re-normalized)
  origin    = M[:3,3]
fov is the VERTICAL field of view in radians. The rotation is written as
three float32 dot products, never a matmul, so no TF32 path can touch it.
"""
from __future__ import annotations

import numpy as np
import torch

from path_tracer_torch.ops import rng


def generate_rays(pixel_ids, width: int, height: int, scene, sample_id: int,
                  seed: int):
    """pixel_ids: [R] int32 flattened as y*width + x. Returns (origins [R,3],
    dirs [R,3])."""
    x = (pixel_ids % width).to(torch.float32)
    y = torch.div(pixel_ids, width, rounding_mode="floor").to(torch.float32)
    jx = rng.uniform(pixel_ids, sample_id, rng.SITE_CAM_X, seed)
    jy = rng.uniform(pixel_ids, sample_id, rng.SITE_CAM_Y, seed)

    aspect = float(np.float32(width) / np.float32(height))
    tan_half = torch.tan(scene.cam_fov * 0.5)

    sx = ((x + jx) / width * 2.0 - 1.0) * tan_half * aspect
    sy = (1.0 - (y + jy) / height * 2.0) * tan_half

    d_cam = torch.stack([sx, sy, -torch.ones_like(sx)], dim=-1)
    d_cam = d_cam / torch.sqrt((d_cam * d_cam).sum(-1, keepdim=True))
    m = scene.cam_to_world
    d_world = torch.stack([(d_cam * m[k, :3]).sum(-1) for k in range(3)], -1)
    origin = m[:3, 3].expand_as(d_world)
    return origin, d_world
