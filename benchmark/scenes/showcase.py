"""The ``showcase`` scene generator: a frozen copy of the procedural
showcase (the JAX bench's default scene, ``bench.py``).

Fractal-noise terrain of 2*grid^2 triangles, 48 spheres (every 11th
emissive), a directional and two point lights; ``textured`` adds a 1024^2
terrain albedo, a 512^2 normal map and 512^2 roughness, 300 alpha-cutout
foliage cards and an emissive billboard. The same seeds give the same
arrays as the program's own generator, written again here so that a
later change there cannot move the benchmark's input.
"""
from __future__ import annotations

import hashlib
import math
import os
from pathlib import Path

import numpy as np

from benchmark.scenes import Material, Mesh, RawScene, Sphere


def _value_noise(grid: int, octaves: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    h = np.zeros((grid + 1, grid + 1))
    for o in range(octaves):
        step = max(1, grid >> o)
        n = grid // step + 2
        coarse = rng.standard_normal((n, n))
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
    rng = np.random.default_rng(seed)
    h = np.zeros((size, size))
    for o in range(octaves):
        n = min(size, 4 << o)
        coarse = rng.standard_normal((n, n))
        reps = size // n
        up = np.repeat(np.repeat(coarse, reps, axis=0), reps, axis=1)
        k = max(1, reps // 2)
        if k > 1:
            up = sum(np.roll(up, s, axis=0) for s in range(-k, k + 1)) / (2 * k + 1)
            up = sum(np.roll(up, s, axis=1) for s in range(-k, k + 1)) / (2 * k + 1)
        h += up * (0.55 ** o)
    h -= h.min()
    h /= max(h.max(), 1e-9)
    return h


def _u8(arr01: np.ndarray) -> np.ndarray:
    """[0,1] values quantized to u8, round half up."""
    return np.clip(arr01 * 255.0 + 0.5, 0, 255).astype(np.uint8)


def leaf_alpha_mask(s: int = 256) -> np.ndarray:
    yy, xx = np.mgrid[0:s, 0:s].astype(np.float64) / (s - 1)
    cx, cy = xx - 0.5, yy - 0.55
    r_ell = np.sqrt((cx / 0.38) ** 2 + (cy / 0.45) ** 2)
    jag = 0.08 * np.sin(np.arctan2(cy, cx) * 9.0)
    mask = np.clip((1.0 + jag - r_ell) / 0.12, 0.0, 1.0)
    stem = (np.abs(cx) < 0.02) & (cy > 0.2) & (cy < 0.52)
    return np.maximum(mask, stem * 1.0)


def showcase_textures(cache_dir: Path | None = None) -> dict:
    """The textured showcase's texels, name -> u8 array; with
    ``cache_dir``, kept there after the first call (an ``.npz`` whose
    name carries this file's hash, so a changed generator makes anew)."""
    if cache_dir is not None:
        digest = hashlib.sha1(Path(__file__).read_bytes()).hexdigest()[:16]
        path = Path(cache_dir) / f"showcase_texels_{digest}.npz"
        if path.exists():
            with np.load(path) as z:
                return {k: z[k] for k in z.files}
        tex = showcase_textures()
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp.npz")
        np.savez(tmp, **tex)
        os.replace(tmp, path)
        return tex
    tex = {}
    n1 = _tile_noise(1024, 6, 101)
    n2 = _tile_noise(1024, 8, 102)
    grass = np.array([0.13, 0.30, 0.10])
    rock = np.array([0.42, 0.39, 0.34])
    base = grass[None, None] * (1 - n1[..., None]) + rock[None, None] * n1[..., None]
    albedo = np.clip(base * (0.75 + 0.5 * n2[..., None]), 0.0, 1.0)
    tex["terrain_albedo.png"] = _u8(albedo ** (1 / 2.2))
    hf = _tile_noise(512, 7, 103)
    gx = (np.roll(hf, -1, axis=1) - np.roll(hf, 1, axis=1)) * 0.5
    gy = (np.roll(hf, -1, axis=0) - np.roll(hf, 1, axis=0)) * 0.5
    amp = 24.0
    nrm = np.stack([-gx * amp, -gy * amp, np.ones_like(hf)], axis=-1)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    tex["terrain_normal.png"] = _u8(nrm * 0.5 + 0.5)
    tex["terrain_rough.png"] = _u8(0.45 + 0.5 * _tile_noise(512, 5, 104))
    s = 256
    yy, xx = np.mgrid[0:s, 0:s].astype(np.float64) / (s - 1)
    cx, cy = xx - 0.5, yy - 0.55
    tex["leaf_alpha.png"] = _u8(leaf_alpha_mask())
    vein = np.clip(1.0 - 6.0 * np.abs(cx - 0.25 * cy * np.sin(cy * 7)), 0, 1)
    leaf_rgb = np.stack([
        0.10 + 0.12 * vein, 0.34 + 0.25 * vein * (1 - yy * 0.5),
        0.06 + 0.08 * vein], axis=-1)
    tex["leaf_albedo.png"] = _u8(np.clip(leaf_rgb, 0, 1) ** (1 / 2.2))
    bh, bw = 128, 256
    yy2, xx2 = np.mgrid[0:bh, 0:bw].astype(np.float64)
    stripe = 0.5 + 0.5 * np.sin((xx2 + 2 * yy2) * 0.12)
    emis = np.stack([stripe, 0.4 + 0.6 * stripe ** 2,
                     1.0 - 0.7 * stripe], axis=-1)
    tex["billboard_emissive.png"] = _u8(np.clip(emis, 0, 1))
    return tex


def _terrain(grid: int, size: float, h: np.ndarray):
    """(pos, nrm, uv) [2*grid^2, 3, k] of the terrain, two triangles a
    cell in row order (i outer, j inner), wound so e1 x e2 points up."""
    xs = np.linspace(-size / 2, size / 2, grid + 1)
    zs = np.linspace(-size / 2, size / 2, grid + 1)
    px, pz = np.meshgrid(xs, zs, indexing="ij")
    pos = np.stack([px, h, pz], axis=-1)
    gy, gx = np.gradient(h)
    n = np.stack([-gx, np.ones_like(h) * (size / grid), -gy], axis=-1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    uu, vv = np.meshgrid(np.linspace(0, 8, grid + 1),
                         np.linspace(0, 8, grid + 1), indexing="ij")
    uv = np.stack([uu, vv], axis=-1)
    i, j = np.meshgrid(np.arange(grid), np.arange(grid), indexing="ij")
    i, j = i.reshape(-1), j.reshape(-1)
    # Per cell: (v00, v11, v10), (v00, v01, v11).
    corners = np.stack([
        np.stack([i, i + 1, i + 1], -1), np.stack([i, i, i + 1], -1)], 1)
    cols = np.stack([
        np.stack([j, j + 1, j], -1), np.stack([j, j + 1, j + 1], -1)], 1)
    ci, cj = corners.reshape(-1, 3), cols.reshape(-1, 3)
    return pos[ci, cj], n[ci, cj], uv[ci, cj]


def _cards_and_billboard(h, grid: int, size: float, seed: int) -> list:
    def terrain_y(x, z):
        gi = min(int((x + size / 2) / size * grid), grid)
        gj = min(int((z + size / 2) / size * grid), grid)
        return float(h[gi, gj])

    card_rng = np.random.default_rng(seed + 2)
    pos, nrm, uv = [], [], []
    for _ in range(300):
        x, z = card_rng.uniform(-size / 2.2, size / 2.2, 2)
        y0 = terrain_y(x, z) - 0.05
        ch = float(card_rng.uniform(0.8, 2.2))
        cw = ch * 0.75
        yaw = float(card_rng.uniform(0, math.pi))
        rx, rz = math.cos(yaw), math.sin(yaw)
        nx, nz = -rz, rx

        def cvert(u, v):
            off = (u - 0.5) * cw
            return ((float(x + rx * off), float(y0 + (1.0 - v) * ch),
                     float(z + rz * off)), (nx, 0.0, nz), (float(u), float(v)))

        a, b, c, e = cvert(0.0, 1.0), cvert(1.0, 1.0), cvert(1.0, 0.0), \
            cvert(0.0, 0.0)
        for tri in ((a, b, c), (a, c, e)):
            pos.append([p for p, _, _ in tri])
            nrm.append([q for _, q, _ in tri])
            uv.append([t for _, _, t in tri])
    cards = Mesh(np.asarray(pos), np.asarray(nrm), np.asarray(uv), Material(
        albedo=(1.0, 1.0, 1.0), albedo_tex="leaf_albedo.png",
        opacity=1.0, opacity_tex="leaf_alpha.png", metalness=0.0,
        roughness=0.9))

    bx, bz = 6.0, -8.0
    by = terrain_y(bx, bz) + 1.0
    bw_, bh_ = 6.0, 3.0
    b00 = ((bx - bw_ / 2, by, bz), (0.0, 1.0))
    b10 = ((bx + bw_ / 2, by, bz), (1.0, 1.0))
    b11 = ((bx + bw_ / 2, by + bh_, bz), (1.0, 0.0))
    b01 = ((bx - bw_ / 2, by + bh_, bz), (0.0, 0.0))
    tris = ((b00, b10, b11), (b00, b11, b01))
    billboard = Mesh(
        np.asarray([[p for p, _ in t] for t in tris], np.float64),
        np.asarray([[(0.0, 0.0, 1.0)] * 3 for _ in tris]),
        np.asarray([[q for _, q in t] for t in tris], np.float64),
        Material(albedo=(0.05, 0.05, 0.05), emissive=(6.0, 6.0, 6.0),
                 emissive_tex="billboard_emissive.png", opacity=1.0,
                 metalness=0.0, roughness=0.8))
    return [cards, billboard]


def generate(grid: int = 224, seed: int = 7, textured: bool = True,
             cache_dir: Path | None = None) -> RawScene:
    """The procedural showcase: 2*grid^2 terrain triangles, 48 spheres,
    three lights; ``textured`` adds the cards, the billboard and the
    textures (kept in ``cache_dir`` once made)."""
    size = 40.0
    height = 6.0
    h = _value_noise(grid, octaves=6, seed=seed) * height
    tpos, tnrm, tuv = _terrain(grid, size, h)
    if textured:
        terrain_mat = Material(
            albedo=(1.0, 1.0, 1.0), albedo_tex="terrain_albedo.png",
            opacity=1.0, metalness=0.0, roughness=1.0,
            roughness_tex="terrain_rough.png",
            normal_tex="terrain_normal.png")
    else:
        terrain_mat = Material(albedo=(0.45, 0.38, 0.30), opacity=1.0,
                               metalness=0.0, roughness=0.85)
    models: list = [Mesh(tpos, tnrm, tuv, terrain_mat)]
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
        albedo = tuple(float(c) for c in rng.uniform(0.3, 0.95, 3))
        models.append(Sphere((float(x), y, float(z)), r, Material(
            albedo=albedo, emissive=emis, opacity=1.0, metalness=metal,
            roughness=rough)))

    cam_pos = (0.0, height + 6.0, size / 2 + 6.0)
    pitch = -0.45
    cp, sp = math.cos(pitch), math.sin(pitch)
    transform = [
        [1.0, 0.0, 0.0, 0.0],
        [0.0, cp, sp, 0.0],
        [0.0, -sp, cp, 0.0],
        [cam_pos[0], cam_pos[1], cam_pos[2], 1.0],
    ]
    return RawScene(
        models=models,
        textures=showcase_textures(cache_dir) if textured else {},
        dir_lights=[((-0.4, -1.0, -0.3), (2.2, 2.0, 1.8))],
        point_lights=[((8.0, height + 8.0, 0.0), (600.0, 500.0, 420.0)),
                      ((-10.0, height + 5.0, 6.0), (220.0, 280.0, 420.0))],
        cam_transform=transform, fov=math.radians(55),
        background=(0.35, 0.45, 0.65))
