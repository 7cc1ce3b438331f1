"""AOV debug renderer: one ray through each pixel's centre, nearest hit only.

Port of ``path_tracer_tpu/models/debug_aov.py`` (the reference's debug
renderer): one PNG per feature buffer — normal (0.5n + 0.5), albedo,
opacity, metalness, roughness, emissive, ior (divided by 3) — each value
times 255, truncated to u8. Misses stay black.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from path_tracer_torch.config import Resolution
from path_tracer_torch.models.integrator import _surface
from path_tracer_torch.ops import texturing
from path_tracer_torch.ops.camera import generate_rays
from path_tracer_torch.ops.intersect import closest_hit
from path_tracer_torch.utils.image_io import save_png

AOV_NAMES = ("normal", "albedo", "opacity", "metalness", "roughness",
             "emissive", "ior")


@torch.no_grad()
def compute_aovs(scene, resolution: Resolution) -> dict:
    """name → [H,W,3] float32 numpy buffer, rendered on the scene's
    device."""
    w, h = resolution.width, resolution.height
    dev = scene.device
    ids = torch.arange(w * h, dtype=torch.int32, device=dev)
    o, d = generate_rays(ids, w, h, scene, 0, 0, jitter=False)
    hit = closest_hit(o, d, torch.full((w * h,), -1.0, device=dev), scene)
    surf = _surface(scene, hit, o, d)
    mat = texturing.sample_material(scene, surf.model, surf.uv, surf.simple)
    valid = hit.valid[:, None]
    one = torch.ones((w * h, 3), device=dev)
    bufs = {
        "normal": surf.normal * 0.5 + 0.5,
        "albedo": mat.albedo,
        "opacity": one * mat.opacity[:, None],
        "metalness": one * mat.metalness[:, None],
        "roughness": one * mat.roughness[:, None],
        "emissive": mat.emissive,
        "ior": one * mat.ior[:, None] / 3.0,
    }
    return {k: torch.where(valid, v, 0.0).cpu().numpy().reshape(h, w, 3)
            for k, v in bufs.items()}


def debug_render(scene, resolution: Resolution, out_dir=".") -> None:
    """Write the seven AOV PNGs into ``out_dir``."""
    for name, buf in compute_aovs(scene, resolution).items():
        u8 = np.clip(buf * 255.0, 0, 255).astype(np.uint8)
        save_png(u8, Path(out_dir) / f"{name}.png")
