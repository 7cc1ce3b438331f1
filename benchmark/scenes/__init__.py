"""The benchmark's scenes, as raw arrays.

A configuration file names a scene generator and its arguments
(``"scene": {"generator": "showcase", ...}``). Each generator is a file of
its own, ``scenes/<generator>.py``, found by that name: it defines
``generate(cache_dir=None, **args)`` returning a ``RawScene`` (triangles,
spheres, materials, texture texels (u8), lights and camera, with nothing
derived from them). A new kind of scene is a new file there; no file
here changes. The harness hands the same ``RawScene`` to the program
(``port_scene``: an ISF scene in memory and its textures as PNG files)
and to the plain reference (``reference/``), which works out everything
else again.
"""
from __future__ import annotations

import dataclasses
import hashlib
import importlib
import os
import struct
import zlib
from pathlib import Path

import numpy as np


@dataclasses.dataclass
class Material:
    albedo: tuple
    emissive: tuple = (0.0, 0.0, 0.0)
    opacity: float = 1.0
    metalness: float = 0.0
    roughness: float = 1.0
    ior: float = 1.0
    # texture names (keys of RawScene.textures) or None
    albedo_tex: str | None = None
    emissive_tex: str | None = None
    opacity_tex: str | None = None
    metalness_tex: str | None = None
    roughness_tex: str | None = None
    normal_tex: str | None = None


@dataclasses.dataclass
class Mesh:
    pos: np.ndarray  # [T,3,3] float64 vertex positions
    nrm: np.ndarray  # [T,3,3] vertex normals
    uv: np.ndarray  # [T,3,2]
    material: Material


@dataclasses.dataclass
class Sphere:
    center: tuple
    radius: float
    material: Material


@dataclasses.dataclass
class RawScene:
    models: list  # Mesh | Sphere, in model order
    textures: dict  # name -> u8 [H,W,3] (rgb) or [H,W] (gray)
    dir_lights: list  # (direction, color)
    point_lights: list  # (position, color)
    cam_transform: list  # 4x4 column-major, as an ISF file stores it
    fov: float  # vertical, radians
    background: tuple


def generate(spec: dict, cache_dir: Path | None = None) -> RawScene:
    """The scene a configuration's ``"scene"`` entry names, made by
    ``scenes/<generator>.py`` (generated data kept in ``cache_dir``)."""
    args = {k: v for k, v in spec.items() if k != "generator"}
    name = spec["generator"]
    if not (Path(__file__).parent / f"{name}.py").is_file():
        raise KeyError(f"no scene generator benchmark/scenes/{name}.py")
    mod = importlib.import_module(f"benchmark.scenes.{name}")
    return mod.generate(cache_dir=cache_dir, **args)


# --- handing the scene to the program --------------------------------------

def encode_png(u8: np.ndarray) -> bytes:
    """[H,W] gray or [H,W,3] RGB u8 as an 8-bit PNG (no filter)."""
    h, w = u8.shape[:2]
    ctype = 0 if u8.ndim == 2 else 2
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          u8.reshape(h, -1)], axis=1).tobytes()

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def write_textures(raw: RawScene, out_dir: Path) -> None:
    """Each texture as a PNG in ``out_dir``, written once: a file whose
    name carries its texels' hash is reused by every later run."""
    out_dir.mkdir(parents=True, exist_ok=True)
    for name, texels in raw.textures.items():
        path = out_dir / name
        stamp = out_dir / (name + "." + hashlib.sha1(texels.tobytes()).hexdigest()[:16])
        if path.exists() and stamp.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        tmp.write_bytes(encode_png(texels))
        os.replace(tmp, path)
        stamp.touch()


def port_scene(raw: RawScene):
    """The scene as the program's in-memory ISF scene (its textures by
    file name, relative to the directory ``write_textures`` filled)."""
    from path_tracer_torch.scene import isf

    def material(m: Material) -> "isf.Material":
        return isf.Material(
            albedo=isf.Channel3(factor=tuple(m.albedo), texture=m.albedo_tex),
            emissive=isf.Channel3(factor=tuple(m.emissive),
                                  texture=m.emissive_tex),
            opacity=isf.Channel1(factor=m.opacity, texture=m.opacity_tex),
            metalness=isf.Channel1(factor=m.metalness,
                                   texture=m.metalness_tex),
            roughness=isf.Channel1(factor=m.roughness,
                                   texture=m.roughness_tex),
            ior=m.ior, normal_texture=m.normal_tex)

    models = []
    for m in raw.models:
        if isinstance(m, Sphere):
            models.append(isf.Sphere(radius=m.radius, center=tuple(m.center),
                                     material=material(m.material)))
            continue
        pos, nrm, uv = m.pos.tolist(), m.nrm.tolist(), m.uv.tolist()
        tris = [tuple(isf.Vertex(position=tuple(p), normal=tuple(q),
                                 tex_coords=tuple(t))
                      for p, q, t in zip(pt, nt, ut))
                for pt, nt, ut in zip(pos, nrm, uv)]
        models.append(isf.Mesh(triangles=tris, material=material(m.material)))
    lights = ([isf.DirectionalLight(direction=tuple(d), color=tuple(c))
               for d, c in raw.dir_lights]
              + [isf.PointLight(position=tuple(p), color=tuple(c))
                 for p, c in raw.point_lights])
    return isf.Scene(models=models,
                     camera=isf.Camera(transform=raw.cam_transform,
                                       fov=raw.fov, zfar=200.0, znear=0.01),
                     lights=lights, background=tuple(raw.background))
