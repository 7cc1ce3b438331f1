"""Procedural showcase scene (~100k triangles), numpy only.

Port of the plain half of ``path_tracer_tpu/scene/showcase.py``: a
fractal-noise terrain mesh (2*G*G triangles), 48 glossy/metal spheres
(every 11th emissive), one directional and two point lights. It is the
JAX package's bench scene ``showcase_plain`` (``bench.py``), built here
from the same seeds into the same ``isf.Scene``.

``textured=True`` (terrain textures, alpha-cutout foliage cards, an
emissive billboard) needs the alpha and shadow-transmittance walks and
textures written with Pillow; it comes with the transparency slice.
"""
from __future__ import annotations

import math
from pathlib import Path

import numpy as np

from path_tracer_torch.scene import isf


def _value_noise(grid: int, octaves: int, seed: int) -> np.ndarray:
    """[grid+1, grid+1] fractal value noise in [0, 1]."""
    rng = np.random.default_rng(seed)
    h = np.zeros((grid + 1, grid + 1))
    for o in range(octaves):
        step = max(1, grid >> o)
        n = grid // step + 2
        coarse = rng.standard_normal((n, n))
        # bilinear upsample to grid+1
        ys = np.linspace(0, n - 1.001, grid + 1)
        xs = np.linspace(0, n - 1.001, grid + 1)
        y0 = ys.astype(int)
        x0 = xs.astype(int)
        fy = (ys - y0)[:, None]
        fx = (xs - x0)[None, :]
        c = (coarse[np.ix_(y0, x0)] * (1 - fy) * (1 - fx)
             + coarse[np.ix_(y0 + 1, x0)] * fy * (1 - fx)
             + coarse[np.ix_(y0, x0 + 1)] * (1 - fy) * fx
             + coarse[np.ix_(y0 + 1, x0 + 1)] * fy * fx)
        h += c * (0.5 ** o)
    h -= h.min()
    h /= max(h.max(), 1e-9)
    return h


def _require_plain(textured: bool) -> None:
    if textured:
        raise NotImplementedError(
            "the textured showcase needs the alpha and shadow-transmittance "
            "walks; it comes with the transparency slice of the port")


def showcase_scene(grid: int = 224, seed: int = 7,
                   textured: bool = False) -> isf.Scene:
    """~2*grid^2 terrain triangles + 48 spheres (default 100,352 + 48)."""
    _require_plain(textured)
    size = 40.0
    height = 6.0
    h = _value_noise(grid, octaves=6, seed=seed) * height

    xs = np.linspace(-size / 2, size / 2, grid + 1)
    zs = np.linspace(-size / 2, size / 2, grid + 1)
    px, pz = np.meshgrid(xs, zs, indexing="ij")
    pos = np.stack([px, h, pz], axis=-1)  # [G+1,G+1,3]

    # Vertex normals from central differences.
    gy, gx = np.gradient(h)
    n = np.stack([-gx, np.ones_like(h) * (size / grid), -gy], axis=-1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)

    uu, vv = np.meshgrid(np.linspace(0, 8, grid + 1),
                         np.linspace(0, 8, grid + 1), indexing="ij")

    def vert(i, j):
        return isf.Vertex(
            position=tuple(float(c) for c in pos[i, j]),
            normal=tuple(float(c) for c in n[i, j]),
            tex_coords=(float(uu[i, j]), float(vv[i, j])),
        )

    tris = []
    for i in range(grid):
        for j in range(grid):
            v00, v10 = vert(i, j), vert(i + 1, j)
            v01, v11 = vert(i, j + 1), vert(i + 1, j + 1)
            # Wound so the geometric normal (e1 x e2) points up (+y).
            tris.append((v00, v11, v10))
            tris.append((v00, v01, v11))

    terrain_mat = isf.Material(
        albedo=isf.Channel3(factor=(0.45, 0.38, 0.30)),
        emissive=isf.Channel3(factor=(0.0, 0.0, 0.0)),
        opacity=isf.Channel1(factor=1.0),
        metalness=isf.Channel1(factor=0.0),
        roughness=isf.Channel1(factor=0.85),
    )
    models: list = [isf.Mesh(triangles=tris, material=terrain_mat)]

    rng = np.random.default_rng(seed + 1)
    for k in range(48):
        x, z = rng.uniform(-size / 2.5, size / 2.5, 2)
        gi = int((x + size / 2) / size * grid)
        gj = int((z + size / 2) / size * grid)
        r = float(rng.uniform(0.4, 1.4))
        y = float(h[min(gi, grid), min(gj, grid)]) + r
        metal = float(rng.uniform(0, 1) > 0.5)
        rough = float(rng.uniform(0.02, 0.6))
        emis = (0.0, 0.0, 0.0)
        if k % 11 == 0:
            emis = tuple(float(c) for c in rng.uniform(2, 8, 3))
        models.append(isf.Sphere(
            radius=r, center=(float(x), y, float(z)),
            material=isf.Material(
                albedo=isf.Channel3(factor=tuple(
                    float(c) for c in rng.uniform(0.3, 0.95, 3))),
                emissive=isf.Channel3(factor=emis),
                opacity=isf.Channel1(factor=1.0),
                metalness=isf.Channel1(factor=metal),
                roughness=isf.Channel1(factor=rough),
            ),
        ))

    cam_pos = (0.0, height + 6.0, size / 2 + 6.0)
    pitch = -0.45
    cp, sp = math.cos(pitch), math.sin(pitch)
    # Column-major: columns are the camera basis vectors; look down -z
    # tilted toward the terrain.
    transform = [
        [1.0, 0.0, 0.0, 0.0],
        [0.0, cp, sp, 0.0],
        [0.0, -sp, cp, 0.0],
        [cam_pos[0], cam_pos[1], cam_pos[2], 1.0],
    ]
    camera = isf.Camera(transform=transform, fov=math.radians(55),
                        zfar=200.0, znear=0.01)
    lights = [
        isf.DirectionalLight(direction=(-0.4, -1.0, -0.3),
                             color=(2.2, 2.0, 1.8)),
        isf.PointLight(position=(8.0, height + 8.0, 0.0),
                       color=(600.0, 500.0, 420.0)),
        isf.PointLight(position=(-10.0, height + 5.0, 6.0),
                       color=(220.0, 280.0, 420.0)),
    ]
    return isf.Scene(models=models, camera=camera, lights=lights,
                     background=(0.35, 0.45, 0.65))


def write_showcase_scene_dir(out_dir, grid: int = 224,
                             textured: bool = False) -> Path:
    """Write the showcase as ``out_dir/scene.isf`` for the CLI
    (``path-tracer-torch render out_dir/scene.isf``). Returns the path."""
    _require_plain(textured)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / "scene.isf"
    isf.save(showcase_scene(grid), path)
    return path
