"""Procedural scenes built in code, numpy-free and file-free.

Port of ``path_tracer_tpu/scene/procedural.py``'s sphere grid: an n x n
grid of analytic spheres varying metalness along one axis and roughness
along the other, lit by two point lights. ``sphere_grid_scene(70)`` (4,900
spheres) takes the sphere block walk, as it does in the JAX package.
"""
from __future__ import annotations

import math

from path_tracer_torch.scene import isf


def _mat(albedo=(1.0, 1.0, 1.0), emissive=(0.0, 0.0, 0.0), opacity=1.0,
         metalness=0.0, roughness=1.0) -> isf.Material:
    return isf.Material(
        albedo=isf.Channel3(factor=albedo),
        emissive=isf.Channel3(factor=emissive),
        opacity=isf.Channel1(factor=opacity),
        metalness=isf.Channel1(factor=metalness),
        roughness=isf.Channel1(factor=roughness),
    )


def _camera(pos=(0.0, 1.0, 3.2), fov_deg=60.0) -> isf.Camera:
    """Identity rotation looking down -z, translated to ``pos`` (ISF's
    column-major matrix: transform[3] is the translation column)."""
    t = [
        [1.0, 0.0, 0.0, 0.0],
        [0.0, 1.0, 0.0, 0.0],
        [0.0, 0.0, 1.0, 0.0],
        [float(pos[0]), float(pos[1]), float(pos[2]), 1.0],
    ]
    return isf.Camera(transform=t, fov=math.radians(fov_deg), zfar=100.0,
                      znear=0.01)


def sphere_grid_scene(n: int = 5) -> isf.Scene:
    """n x n analytic-sphere metalness x roughness grid with two point
    lights, the shape of the reference's ``spheres`` scene."""
    models = []
    for i in range(n):
        for j in range(n):
            metal = i / max(1, n - 1)
            rough = max(0.05, j / max(1, n - 1))
            models.append(
                isf.Sphere(
                    radius=0.4,
                    center=(1.1 * (i - (n - 1) / 2), 1.1 * (j - (n - 1) / 2),
                            0.0),
                    material=_mat(albedo=(0.8, 0.3, 0.3), metalness=metal,
                                  roughness=rough),
                )
            )
    lights = [
        isf.PointLight(position=(3.0, 3.0, 4.0), color=(400.0, 400.0, 400.0)),
        isf.PointLight(position=(-3.0, -3.0, 4.0), color=(200.0, 200.0, 250.0)),
    ]
    return isf.Scene(models=models, camera=_camera(pos=(0.0, 0.0, 7.0)),
                     lights=lights, background=(0.05, 0.05, 0.08))


def sphere_grid_device_scene(n: int = 5, device="cuda"):
    """``sphere_grid_scene(n)`` built on ``device``."""
    from path_tracer_torch.scene.device_scene import build_scene

    return build_scene(sphere_grid_scene(n), root=".", device=device)
