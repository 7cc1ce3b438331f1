"""Procedural showcase scene (~100k triangles), numpy only.

Port of ``path_tracer_tpu/scene/showcase.py``: a fractal-noise terrain
mesh (2*G*G triangles), 48 glossy/metal spheres (every 11th emissive),
one directional and two point lights, built from the same seeds into the
same ``isf.Scene``. Plain, it is the JAX package's bench scene
``showcase_plain``; ``textured=True`` (the JAX bench's default
``showcase``) adds a 1024^2 sRGB terrain albedo, a 512^2 normal map and
512^2 roughness, 300 alpha-cutout foliage cards (256^2 leaf albedo and
alpha) and an emissive billboard (256x128).

The textures are generated from fixed seeds and written as PNGs by the
port's own writer into ``default_texture_dir()`` (under the git-ignored
``build/``), holding exactly the u8 values the JAX package's files hold.
"""
from __future__ import annotations

import math
import os
from pathlib import Path

import numpy as np

from path_tracer_torch.scene import isf

TEX_VERSION = "v2"


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


def _tile_noise(size: int, octaves: int, seed: int) -> np.ndarray:
    """[size, size] fractal value noise in [0, 1] that wraps."""
    rng = np.random.default_rng(seed)
    h = np.zeros((size, size))
    for o in range(octaves):
        n = min(size, 4 << o)
        coarse = rng.standard_normal((n, n))
        reps = size // n
        # nearest-neighbour tile + box blur for cheap periodic smoothness
        up = np.repeat(np.repeat(coarse, reps, axis=0), reps, axis=1)
        k = max(1, reps // 2)
        if k > 1:
            up = sum(np.roll(up, s, axis=0) for s in range(-k, k + 1)) / (2 * k + 1)
            up = sum(np.roll(up, s, axis=1) for s in range(-k, k + 1)) / (2 * k + 1)
        h += up * (0.55 ** o)
    h -= h.min()
    h /= max(h.max(), 1e-9)
    return h


def _save(arr01: np.ndarray, path: Path) -> None:
    """Quantize [0,1] values to u8 (round half up) and write a PNG (gray
    for [H,W], RGB for [H,W,3]). The file appears whole or not at all, so
    processes generating the same textures side by side never read a
    partial one."""
    from path_tracer_torch.utils.image_io import encode_png

    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    tmp.write_bytes(encode_png(
        np.clip(arr01 * 255.0 + 0.5, 0, 255).astype(np.uint8)))
    os.replace(tmp, path)


def leaf_alpha_mask(s: int = 256) -> np.ndarray:
    """[s,s] leaf alpha-cutout mask in [0,1] (the texture writer stores
    exactly this array, u8-quantized; the card builder culls with it)."""
    yy, xx = np.mgrid[0:s, 0:s].astype(np.float64) / (s - 1)
    cx, cy = xx - 0.5, yy - 0.55
    r_ell = np.sqrt((cx / 0.38) ** 2 + (cy / 0.45) ** 2)
    jag = 0.08 * np.sin(np.arctan2(cy, cx) * 9.0)
    mask = np.clip((1.0 + jag - r_ell) / 0.12, 0.0, 1.0)
    stem = (np.abs(cx) < 0.02) & (cy > 0.2) & (cy < 0.52)
    return np.maximum(mask, stem * 1.0)


def generate_showcase_textures(out_dir) -> None:
    """Write the showcase's texture set into ``out_dir`` (skipped when the
    version marker exists)."""
    out = Path(out_dir)
    marker = out / f".done_{TEX_VERSION}"
    if marker.exists():
        return
    out.mkdir(parents=True, exist_ok=True)

    # Terrain albedo 1024^2: grass/rock blend by low-frequency noise.
    n1 = _tile_noise(1024, 6, 101)
    n2 = _tile_noise(1024, 8, 102)
    grass = np.array([0.13, 0.30, 0.10])
    rock = np.array([0.42, 0.39, 0.34])
    base = grass[None, None] * (1 - n1[..., None]) + rock[None, None] * n1[..., None]
    albedo = np.clip(base * (0.75 + 0.5 * n2[..., None]), 0.0, 1.0)
    # sRGB: the sampler linearizes albedo texels with pow 2.2.
    _save(albedo ** (1 / 2.2), out / "terrain_albedo.png")

    # Tangent-space normal map 512^2 from a noise heightfield.
    hf = _tile_noise(512, 7, 103)
    gx = (np.roll(hf, -1, axis=1) - np.roll(hf, 1, axis=1)) * 0.5
    gy = (np.roll(hf, -1, axis=0) - np.roll(hf, 1, axis=0)) * 0.5
    amp = 24.0
    nrm = np.stack([-gx * amp, -gy * amp, np.ones_like(hf)], axis=-1)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    _save(nrm * 0.5 + 0.5, out / "terrain_normal.png")

    # Terrain roughness 512^2 gray in [0.45, 0.95].
    _save(0.45 + 0.5 * _tile_noise(512, 5, 104), out / "terrain_rough.png")

    # Leaf albedo + alpha cutout 256^2: a mostly hard mask with a soft rim,
    # so the stochastic accept test runs on edge texels.
    s = 256
    yy, xx = np.mgrid[0:s, 0:s].astype(np.float64) / (s - 1)
    cx, cy = xx - 0.5, yy - 0.55
    _save(leaf_alpha_mask(), out / "leaf_alpha.png")
    vein = np.clip(1.0 - 6.0 * np.abs(cx - 0.25 * cy * np.sin(cy * 7)), 0, 1)
    leaf_rgb = np.stack([
        0.10 + 0.12 * vein, 0.34 + 0.25 * vein * (1 - yy * 0.5),
        0.06 + 0.08 * vein], axis=-1)
    _save(np.clip(leaf_rgb, 0, 1) ** (1 / 2.2), out / "leaf_albedo.png")

    # Emissive billboard 256x128 (emissive texels are not linearized).
    bh, bw = 128, 256
    yy2, xx2 = np.mgrid[0:bh, 0:bw].astype(np.float64)
    stripe = 0.5 + 0.5 * np.sin((xx2 + 2 * yy2) * 0.12)
    emis = np.stack([stripe, 0.4 + 0.6 * stripe ** 2,
                     1.0 - 0.7 * stripe], axis=-1)
    _save(np.clip(emis, 0, 1), out / "billboard_emissive.png")
    marker.touch()


def default_texture_dir() -> Path:
    """The showcase textures' directory, under the checkout's build/."""
    from path_tracer_torch.native import BUILD_DIR

    return BUILD_DIR / f"showcase_tex_{TEX_VERSION}"


def showcase_scene(grid: int = 224, seed: int = 7,
                   textured: bool = False) -> isf.Scene:
    """~2*grid^2 terrain triangles + 48 spheres (default 100,352 + 48);
    ``textured`` adds 600 card and 2 billboard triangles and the textures
    (paths relative to ``default_texture_dir()``)."""
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

    # One Vertex per grid point, shared by the (up to six) triangles that
    # use it: 2*grid^2 triangles cost (grid+1)^2 objects.
    verts = [[isf.Vertex(position=tuple(p), normal=tuple(q),
                         tex_coords=(u, v))
              for p, q, u, v in zip(prow, nrow, urow, vrow)]
             for prow, nrow, urow, vrow in zip(pos.tolist(), n.tolist(),
                                               uu.tolist(), vv.tolist())]
    tris = []
    for i in range(grid):
        row, nxt = verts[i], verts[i + 1]
        for j in range(grid):
            v00, v10 = row[j], nxt[j]
            v01, v11 = row[j + 1], nxt[j + 1]
            # Wound so the geometric normal (e1 x e2) points up (+y).
            tris.append((v00, v11, v10))
            tris.append((v00, v01, v11))

    if textured:
        terrain_mat = isf.Material(
            albedo=isf.Channel3(factor=(1.0, 1.0, 1.0),
                                texture="terrain_albedo.png"),
            emissive=isf.Channel3(factor=(0.0, 0.0, 0.0)),
            opacity=isf.Channel1(factor=1.0),
            metalness=isf.Channel1(factor=0.0),
            roughness=isf.Channel1(factor=1.0, texture="terrain_rough.png"),
            normal_texture="terrain_normal.png",
        )
    else:
        terrain_mat = isf.Material(
            albedo=isf.Channel3(factor=(0.45, 0.38, 0.30)),
            emissive=isf.Channel3(factor=(0.0, 0.0, 0.0)),
            opacity=isf.Channel1(factor=1.0),
            metalness=isf.Channel1(factor=0.0),
            roughness=isf.Channel1(factor=0.85),
        )
    models: list = [isf.Mesh(triangles=tris, material=terrain_mat)]
    rng = np.random.default_rng(seed + 1)
    if textured:
        models += _cards_and_billboard(h, grid, size, seed)
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


def _cards_and_billboard(h, grid: int, size: float, seed: int) -> list:
    """300 alpha-cutout foliage cards (one Mesh) standing on the terrain,
    and an emissive-textured billboard (another Mesh)."""

    def terrain_y(x, z):
        gi = min(int((x + size / 2) / size * grid), grid)
        gj = min(int((z + size / 2) / size * grid), grid)
        return float(h[gi, gj])

    card_rng = np.random.default_rng(seed + 2)
    card_tris = []
    # One cell per card (the JAX package's CELLS = 1); its alpha footprint
    # is not all 0, so every card is authored.
    for _ in range(300):
        x, z = card_rng.uniform(-size / 2.2, size / 2.2, 2)
        y0 = terrain_y(x, z) - 0.05
        ch = float(card_rng.uniform(0.8, 2.2))  # card height
        cw = ch * 0.75
        yaw = float(card_rng.uniform(0, math.pi))
        rx, rz = math.cos(yaw), math.sin(yaw)
        nx, nz = -rz, rx  # horizontal normal

        def cvert(u, v):
            # u across the card width, v down the texture (v=1 bottom).
            off = (u - 0.5) * cw
            return isf.Vertex(
                position=(float(x + rx * off), float(y0 + (1.0 - v) * ch),
                          float(z + rz * off)),
                normal=(nx, 0.0, nz), tex_coords=(float(u), float(v)))

        a, b, c, e = cvert(0.0, 1.0), cvert(1.0, 1.0), cvert(1.0, 0.0), \
            cvert(0.0, 0.0)
        card_tris.append((a, b, c))
        card_tris.append((a, c, e))
    cards = isf.Mesh(
        triangles=card_tris,
        material=isf.Material(
            albedo=isf.Channel3(factor=(1.0, 1.0, 1.0),
                                texture="leaf_albedo.png"),
            emissive=isf.Channel3(factor=(0.0, 0.0, 0.0)),
            opacity=isf.Channel1(factor=1.0, texture="leaf_alpha.png"),
            metalness=isf.Channel1(factor=0.0),
            roughness=isf.Channel1(factor=0.9),
        ))

    bx, bz = 6.0, -8.0
    by = terrain_y(bx, bz) + 1.0
    bw_, bh_ = 6.0, 3.0

    def bvert(p, u, v):
        return isf.Vertex(position=tuple(float(q) for q in p),
                          normal=(0.0, 0.0, 1.0), tex_coords=(u, v))

    b00 = bvert((bx - bw_ / 2, by, bz), 0.0, 1.0)
    b10 = bvert((bx + bw_ / 2, by, bz), 1.0, 1.0)
    b11 = bvert((bx + bw_ / 2, by + bh_, bz), 1.0, 0.0)
    b01 = bvert((bx - bw_ / 2, by + bh_, bz), 0.0, 0.0)
    billboard = isf.Mesh(
        triangles=[(b00, b10, b11), (b00, b11, b01)],
        material=isf.Material(
            albedo=isf.Channel3(factor=(0.05, 0.05, 0.05)),
            emissive=isf.Channel3(factor=(6.0, 6.0, 6.0),
                                  texture="billboard_emissive.png"),
            opacity=isf.Channel1(factor=1.0),
            metalness=isf.Channel1(factor=0.0),
            roughness=isf.Channel1(factor=0.8),
        ))
    return [cards, billboard]


def showcase_device_scene(grid: int = 224, device="cuda", use_bvh=None,
                          sl_block: int = 512, textured: bool = False):
    """The showcase built on ``device`` (textures generated on first use);
    bench.py's workload is ``grid=224, sl_block=256, textured=True``."""
    from path_tracer_torch.scene.device_scene import build_scene

    root = "."
    if textured:
        root = default_texture_dir()
        generate_showcase_textures(root)
    return build_scene(showcase_scene(grid, textured=textured), root, device,
                       use_bvh=use_bvh, sl_block=sl_block)


def write_showcase_scene_dir(out_dir, grid: int = 224,
                             textured: bool = False) -> Path:
    """Write the showcase as ``out_dir/scene.isf`` (and, textured, its
    PNGs) for the CLI (``path-tracer-torch render out_dir/scene.isf``).
    Returns the path."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    if textured:
        generate_showcase_textures(out)
    path = out / "scene.isf"
    isf.save(showcase_scene(grid, textured=textured), path)
    return path
