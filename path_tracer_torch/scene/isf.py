"""ISF ("Internal Scene Format") loader and writer — JSON scene files,
stdlib only.

Port of ``path_tracer_tpu/scene/isf.py``: ``load``/``from_dict`` parse,
``to_dict``/``save`` write (what ``scene.showcase`` uses to put a scene on
disk for the CLI). A scene is one JSON object::

    {
      "models":  [ {"type": "Mesh", "triangles": [...], "material": {...}}
                 | {"type": "Sphere", "radius": r, "center": [x,y,z],
                    "material": {...}} ],
      "camera":  {"transform": [[..4],[..4],[..4],[..4]],   # COLUMN-major
                  "fov": radians_vertical, "zfar": f, "znear": f},
      "lights":  [ {"type": "Point", "position": [..], "color": [..], "size": s}
                 | {"type": "Directional", "direction": [..], "color": [..]} ],
      "background": [r, g, b]
    }

Material defaults follow the reference's serde defaults:

- ``albedo``    — required; factor defaults to [1,1,1] inside the object.
- ``emissive``  — field missing → [0,0,0]; object without factor → [1,1,1].
- ``opacity``   — missing → 1.0; present without factor → 1.0.
- ``metalness`` — field missing → 0.0; present without factor → 1.0.
- ``roughness`` — missing → 1.0; present without factor → 1.0.
- ``ior``       — defaults to 1.0.
- every channel's ``texture`` is an optional path relative to the scene dir.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import List, Optional, Tuple, Union

Vec3 = Tuple[float, float, float]
Vec2 = Tuple[float, float]


@dataclasses.dataclass
class Channel3:
    """RGB factor x optional RGB texture (albedo/emissive)."""

    factor: Vec3 = (1.0, 1.0, 1.0)
    texture: Optional[str] = None


@dataclasses.dataclass
class Channel1:
    """Scalar factor x optional gray texture (opacity/metalness/roughness)."""

    factor: float = 1.0
    texture: Optional[str] = None


@dataclasses.dataclass
class Material:
    albedo: Channel3
    emissive: Channel3
    opacity: Channel1
    metalness: Channel1
    roughness: Channel1
    ior: float = 1.0
    normal_texture: Optional[str] = None


@dataclasses.dataclass
class Vertex:
    position: Vec3
    normal: Vec3
    tex_coords: Vec2


@dataclasses.dataclass
class Mesh:
    triangles: List[Tuple[Vertex, Vertex, Vertex]]
    material: Material


@dataclasses.dataclass
class Sphere:
    radius: float
    center: Vec3
    material: Material


Model = Union[Mesh, Sphere]


@dataclasses.dataclass
class PointLight:
    position: Vec3
    color: Vec3
    size: float = 0.1  # unused by the renderer


@dataclasses.dataclass
class DirectionalLight:
    direction: Vec3
    color: Vec3


Light = Union[PointLight, DirectionalLight]


@dataclasses.dataclass
class Camera:
    transform: List[List[float]]  # 4x4, column-major
    fov: float  # VERTICAL field of view, radians
    zfar: float
    znear: float


@dataclasses.dataclass
class Scene:
    models: List[Model]
    camera: Camera
    lights: List[Light]
    background: Vec3


def _vec3(x) -> Vec3:
    return (float(x[0]), float(x[1]), float(x[2]))


def _channel3(raw: Optional[dict], missing_factor: Vec3) -> Channel3:
    if raw is None:
        return Channel3(factor=missing_factor, texture=None)
    factor = _vec3(raw["factor"]) if "factor" in raw else (1.0, 1.0, 1.0)
    return Channel3(factor=factor, texture=raw.get("texture"))


def _channel1(raw: Optional[dict], missing_factor: float) -> Channel1:
    if raw is None:
        return Channel1(factor=missing_factor, texture=None)
    factor = float(raw["factor"]) if "factor" in raw else 1.0
    return Channel1(factor=factor, texture=raw.get("texture"))


def _material(raw: dict) -> Material:
    return Material(
        albedo=_channel3(raw["albedo"], missing_factor=(1.0, 1.0, 1.0)),
        emissive=_channel3(raw.get("emissive"), missing_factor=(0.0, 0.0, 0.0)),
        opacity=_channel1(raw.get("opacity"), missing_factor=1.0),
        metalness=_channel1(raw.get("metalness"), missing_factor=0.0),
        roughness=_channel1(raw.get("roughness"), missing_factor=1.0),
        ior=float(raw.get("ior", 1.0)),
        normal_texture=raw.get("normal_texture"),
    )


def _vertex(raw: dict) -> Vertex:
    return Vertex(
        position=_vec3(raw["position"]),
        normal=_vec3(raw["normal"]),
        tex_coords=(float(raw["tex_coords"][0]), float(raw["tex_coords"][1])),
    )


def _model(raw: dict) -> Model:
    kind = raw["type"]
    if kind == "Mesh":
        tris = [
            (_vertex(t[0]), _vertex(t[1]), _vertex(t[2])) for t in raw["triangles"]
        ]
        return Mesh(triangles=tris, material=_material(raw["material"]))
    if kind == "Sphere":
        return Sphere(
            radius=float(raw["radius"]),
            center=_vec3(raw["center"]),
            material=_material(raw["material"]),
        )
    raise ValueError(f"unknown model type {kind!r}")


def _light(raw: dict) -> Light:
    kind = raw["type"]
    if kind == "Point":
        return PointLight(
            position=_vec3(raw["position"]),
            color=_vec3(raw["color"]),
            size=float(raw.get("size", 0.1)),
        )
    if kind == "Directional":
        return DirectionalLight(direction=_vec3(raw["direction"]), color=_vec3(raw["color"]))
    raise ValueError(f"unknown light type {kind!r}")


def from_dict(raw: dict) -> Scene:
    return Scene(
        models=[_model(m) for m in raw["models"]],
        camera=Camera(
            transform=[[float(v) for v in col] for col in raw["camera"]["transform"]],
            fov=float(raw["camera"]["fov"]),
            zfar=float(raw["camera"]["zfar"]),
            znear=float(raw["camera"]["znear"]),
        ),
        lights=[_light(l) for l in raw["lights"]],
        background=_vec3(raw["background"]),
    )


def load(path: Union[str, Path]) -> Scene:
    with open(path) as f:
        return from_dict(json.load(f))


def _channel3_dict(c: Channel3) -> dict:
    return {"factor": list(c.factor), "texture": c.texture}


def _channel1_dict(c: Channel1) -> dict:
    return {"factor": c.factor, "texture": c.texture}


def _material_dict(m: Material) -> dict:
    return {
        "albedo": _channel3_dict(m.albedo),
        "emissive": _channel3_dict(m.emissive),
        "opacity": _channel1_dict(m.opacity),
        "metalness": _channel1_dict(m.metalness),
        "roughness": _channel1_dict(m.roughness),
        "ior": m.ior,
        "normal_texture": m.normal_texture,
    }


def _vertex_dict(v: Vertex) -> dict:
    return {"position": list(v.position), "normal": list(v.normal),
            "tex_coords": list(v.tex_coords)}


def _model_dict(model: Model) -> dict:
    if isinstance(model, Mesh):
        return {"type": "Mesh",
                "triangles": [[_vertex_dict(v) for v in tri]
                              for tri in model.triangles],
                "material": _material_dict(model.material)}
    return {"type": "Sphere", "radius": model.radius,
            "center": list(model.center),
            "material": _material_dict(model.material)}


def _light_dict(light: Light) -> dict:
    if isinstance(light, PointLight):
        return {"type": "Point", "position": list(light.position),
                "color": list(light.color), "size": light.size}
    return {"type": "Directional", "direction": list(light.direction),
            "color": list(light.color)}


def to_dict(scene: Scene) -> dict:
    """The JSON object ``save`` writes (the JAX package's ``to_dict``)."""
    return {
        "models": [_model_dict(m) for m in scene.models],
        "camera": {
            "transform": scene.camera.transform,
            "fov": scene.camera.fov,
            "zfar": scene.camera.zfar,
            "znear": scene.camera.znear,
        },
        "lights": [_light_dict(l) for l in scene.lights],
        "background": list(scene.background),
    }


def save(scene: Scene, path: Union[str, Path]) -> None:
    with open(path, "w") as f:
        json.dump(to_dict(scene), f)
