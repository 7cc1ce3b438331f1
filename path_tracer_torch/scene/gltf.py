"""glTF 2.0 → ISF converter (offline tooling, host-side).

Port of ``path_tracer_tpu/scene/gltf.py`` without Pillow on its path:
images decode through ``utils/image_io.decode_image_rgba`` (every PNG, and
every 8-bit JPEG Pillow decodes through ``utils/jpeg.py``: the two image
types glTF 2.0 allows, to the texels Pillow gives; any other image through
Pillow, as the JAX converter opens it) and textures are written with
``encode_png``.
The ISF JSON, the texture file names and their texels are the JAX
converter's; the PNG bytes may differ.

Behaviour of the reference converter (src/scene/gltf.rs:146-198 plus the
easy_gltf crate semantics it consumes):

- scenes[0] only; error "No scenes found in gltf file" when empty
  (gltf.rs:159-161); error "No camera found" without a camera (gltf.rs:163-166).
- Perspective cameras only — orthographic raises (gltf.rs:204-206); fov is the
  vertical yfov in radians; the ISF camera transform is the camera node's
  world transform, serialized COLUMN-major (cgmath convention).
- One ISF Mesh per (node, mesh-primitive) pair with vertices pre-transformed
  into world space (easy_gltf model semantics); triangles mode only.
- Lights (KHR_lights_punctual): Directional {world -Z direction}, Point, and
  Spot→Point (gltf.rs:233-265); color is color*intensity; Point size
  hardcoded 0.1.
- Material mapping (gltf.rs:79-130): base_color_factor.rgb → albedo factor,
  [3] → opacity factor; base_color_texture → albedo RGB texture AND a
  separate gray alpha texture; metallic/roughness textures are the B and G
  channels of the metallicRoughness texture (glTF packing, easy_gltf
  behavior); emissive texture RGB; normal texture RGB; ior hardcoded 1.0.
- Texture dedup by image content with per-category counters and the exact
  reference naming: albedo_tex_N.png, alpha_tex_N.png, vec_tex_N.png,
  gray_tex_N.png (gltf.rs:47-77).
- Output: ``<out>/scene.isf`` JSON + PNGs; background defaults to [0,0,0]
  (isf.rs Scene derive Default).
"""
from __future__ import annotations

import base64
import hashlib
import json
import struct
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from path_tracer_torch.scene import isf

_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_COUNTS = {
    "SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
    "MAT2": 4, "MAT3": 9, "MAT4": 16,
}


class _Gltf:
    """Minimal glTF 2.0 document reader (JSON + GLB, data URIs, .bin)."""

    def __init__(self, path: Path):
        self.path = Path(path)
        self.bin_chunk: Optional[bytes] = None
        data = self.path.read_bytes()
        if data[:4] == b"glTF":
            _, version, _length = struct.unpack_from("<III", data, 0)
            if version != 2:
                raise ValueError(f"unsupported glTF version {version}")
            offset = 12
            doc = None
            while offset < len(data):
                chunk_len, chunk_type = struct.unpack_from("<II", data, offset)
                chunk = data[offset + 8 : offset + 8 + chunk_len]
                if chunk_type == 0x4E4F534A:  # JSON
                    doc = json.loads(chunk)
                elif chunk_type == 0x004E4942:  # BIN
                    self.bin_chunk = chunk
                offset += 8 + chunk_len
            if doc is None:
                raise ValueError("GLB file has no JSON chunk")
            self.doc = doc
        else:
            self.doc = json.loads(data)
        self._buffers: Dict[int, bytes] = {}

    def buffer(self, index: int) -> bytes:
        if index in self._buffers:
            return self._buffers[index]
        buf = self.doc["buffers"][index]
        uri = buf.get("uri")
        if uri is None:
            if self.bin_chunk is None:
                raise ValueError("buffer without uri outside GLB")
            data = self.bin_chunk
        elif uri.startswith("data:"):
            data = base64.b64decode(uri.split(",", 1)[1])
        else:
            from urllib.parse import unquote

            data = (self.path.parent / unquote(uri)).read_bytes()
        self._buffers[index] = data
        return data

    def accessor(self, index: int) -> np.ndarray:
        """Decode an accessor to [count, components] (denormalized floats for
        normalized integer types; raw ints otherwise)."""
        acc = self.doc["accessors"][index]
        count = acc["count"]
        ncomp = _TYPE_COUNTS[acc["type"]]
        dtype = _COMPONENT_DTYPES[acc["componentType"]]
        itemsize = np.dtype(dtype).itemsize

        if "bufferView" not in acc:
            out = np.zeros((count, ncomp), dtype)
        else:
            view = self.doc["bufferViews"][acc["bufferView"]]
            data = self.buffer(view["buffer"])
            start = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
            stride = view.get("byteStride") or ncomp * itemsize
            if stride == ncomp * itemsize:
                out = np.frombuffer(
                    data, dtype, count * ncomp, start
                ).reshape(count, ncomp).copy()
            else:
                raw = np.frombuffer(
                    data, np.uint8, count * stride, start
                ).reshape(count, stride)
                out = raw[:, : ncomp * itemsize].copy().view(dtype)

        sparse = acc.get("sparse")
        if sparse:
            n = sparse["count"]
            iview = self.doc["bufferViews"][sparse["indices"]["bufferView"]]
            idt = _COMPONENT_DTYPES[sparse["indices"]["componentType"]]
            ioff = iview.get("byteOffset", 0) + sparse["indices"].get("byteOffset", 0)
            idx = np.frombuffer(self.buffer(iview["buffer"]), idt, n, ioff)
            vview = self.doc["bufferViews"][sparse["values"]["bufferView"]]
            voff = vview.get("byteOffset", 0) + sparse["values"].get("byteOffset", 0)
            vals = np.frombuffer(
                self.buffer(vview["buffer"]), dtype, n * ncomp, voff
            ).reshape(n, ncomp)
            out[idx] = vals

        if acc.get("normalized") and dtype != np.float32:
            info = np.iinfo(dtype)
            out = out.astype(np.float32) / float(info.max)
        return out

    def image_bytes(self, index: int) -> bytes:
        img = self.doc["images"][index]
        uri = img.get("uri")
        if uri is None:
            view = self.doc["bufferViews"][img["bufferView"]]
            data = self.buffer(view["buffer"])
            start = view.get("byteOffset", 0)
            return data[start : start + view["byteLength"]]
        if uri.startswith("data:"):
            return base64.b64decode(uri.split(",", 1)[1])
        from urllib.parse import unquote

        return (self.path.parent / unquote(uri)).read_bytes()


def _trs_matrix(node: dict) -> np.ndarray:
    """Node local transform, row-major 4x4."""
    if "matrix" in node:
        # glTF stores column-major flat 16.
        return np.asarray(node["matrix"], np.float64).reshape(4, 4).T
    m = np.eye(4)
    if "scale" in node:
        m[:3, :3] = np.diag(node["scale"])
    if "rotation" in node:
        x, y, z, w = node["rotation"]
        r = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ])
        m[:3, :3] = r @ m[:3, :3]
    if "translation" in node:
        m[:3, 3] = node["translation"]
    return m


class _TextureWriter:
    """Content-deduplicating texture emitter with reference naming
    (ref: gltf.rs:18-77). One counter per category; N = insertion order."""

    def __init__(self):
        self.images: Dict[Tuple[str, str], Tuple[str, np.ndarray]] = {}
        self.counters = {"albedo": 0, "alpha": 0, "vec": 0, "gray": 0}

    def _get(self, category: str, img: np.ndarray) -> str:
        digest = hashlib.sha1(
            img.tobytes() + bytes(str(img.shape), "ascii")
        ).hexdigest()
        key = (category, digest)
        if key not in self.images:
            n = self.counters[category]
            self.counters[category] = n + 1
            self.images[key] = (f"{category}_tex_{n}.png", img)
        return self.images[key][0]

    def albedo(self, rgba: np.ndarray) -> str:
        return self._get("albedo", rgba[:, :, :3])

    def alpha(self, rgba: np.ndarray) -> str:
        return self._get("alpha", rgba[:, :, 3])

    def rgb(self, rgb: np.ndarray) -> str:
        return self._get("vec", rgb[:, :, :3])

    def gray(self, gray: np.ndarray) -> str:
        return self._get("gray", gray)

    def save(self, out_dir: Path) -> None:
        from path_tracer_torch.utils.image_io import save_png

        for path, img in self.images.values():
            save_png(img, out_dir / path)


def _decode_image(gltf: _Gltf, texture_index: int) -> np.ndarray:
    """Texture index → RGBA uint8 array."""
    from path_tracer_torch.utils.image_io import decode_image_rgba

    tex = gltf.doc["textures"][texture_index]
    raw = gltf.image_bytes(tex["source"])
    return decode_image_rgba(raw, f"image {tex['source']}")


def _convert_material(gltf: _Gltf, mat_index: Optional[int],
                      writer: _TextureWriter) -> isf.Material:
    mat = gltf.doc.get("materials", [])[mat_index] if mat_index is not None else {}
    pbr = mat.get("pbrMetallicRoughness", {})
    base_factor = pbr.get("baseColorFactor", [1.0, 1.0, 1.0, 1.0])

    albedo_tex = opacity_tex = None
    if "baseColorTexture" in pbr:
        rgba = _decode_image(gltf, pbr["baseColorTexture"]["index"])
        albedo_tex = writer.albedo(rgba)
        opacity_tex = writer.alpha(rgba)

    metal_tex = rough_tex = None
    if "metallicRoughnessTexture" in pbr:
        rgba = _decode_image(gltf, pbr["metallicRoughnessTexture"]["index"])
        # glTF packs roughness in G, metalness in B (easy_gltf splits them
        # into separate gray textures).
        metal_tex = writer.gray(rgba[:, :, 2])
        rough_tex = writer.gray(rgba[:, :, 1])

    emissive_tex = None
    if "emissiveTexture" in mat:
        emissive_tex = writer.rgb(
            _decode_image(gltf, mat["emissiveTexture"]["index"])
        )

    normal_tex = None
    if "normalTexture" in mat:
        normal_tex = writer.rgb(
            _decode_image(gltf, mat["normalTexture"]["index"])
        )

    return isf.Material(
        albedo=isf.Channel3(factor=tuple(base_factor[:3]), texture=albedo_tex),
        emissive=isf.Channel3(
            factor=tuple(mat.get("emissiveFactor", [0.0, 0.0, 0.0])),
            texture=emissive_tex,
        ),
        opacity=isf.Channel1(factor=float(base_factor[3]), texture=opacity_tex),
        metalness=isf.Channel1(factor=float(pbr.get("metallicFactor", 1.0)),
                               texture=metal_tex),
        roughness=isf.Channel1(factor=float(pbr.get("roughnessFactor", 1.0)),
                               texture=rough_tex),
        ior=1.0,  # hardcoded, ref gltf.rs:122
        normal_texture=normal_tex,
    )


def _convert_primitive(gltf: _Gltf, prim: dict, world: np.ndarray,
                       writer: _TextureWriter) -> isf.Mesh:
    if prim.get("mode", 4) != 4:
        raise ValueError("only TRIANGLES primitives are supported")
    attrs = prim["attributes"]
    pos = gltf.accessor(attrs["POSITION"]).astype(np.float64)
    n_verts = pos.shape[0]

    if "indices" in prim:
        idx = gltf.accessor(prim["indices"]).reshape(-1).astype(np.int64)
    else:
        idx = np.arange(n_verts, dtype=np.int64)

    normal_mat = np.linalg.inv(world[:3, :3]).T
    pos_w = pos @ world[:3, :3].T + world[:3, 3]

    if "NORMAL" in attrs:
        nrm = gltf.accessor(attrs["NORMAL"]).astype(np.float64)
    else:
        # Flat normals from face winding when absent.
        nrm = np.zeros_like(pos)
        tri_idx = idx.reshape(-1, 3)
        fn = np.cross(pos[tri_idx[:, 1]] - pos[tri_idx[:, 0]],
                      pos[tri_idx[:, 2]] - pos[tri_idx[:, 0]])
        for k in range(3):
            nrm[tri_idx[:, k]] += fn
    nrm_w = nrm @ normal_mat.T
    norms = np.linalg.norm(nrm_w, axis=-1, keepdims=True)
    nrm_w = np.divide(nrm_w, norms, out=np.zeros_like(nrm_w), where=norms > 0)

    if "TEXCOORD_0" in attrs:
        uv = gltf.accessor(attrs["TEXCOORD_0"]).astype(np.float64)
    else:
        uv = np.zeros((n_verts, 2))

    tris = []
    tri_idx = idx.reshape(-1, 3)
    for i0, i1, i2 in tri_idx:
        verts = tuple(
            isf.Vertex(
                position=tuple(float(x) for x in pos_w[i]),
                normal=tuple(float(x) for x in nrm_w[i]),
                tex_coords=(float(uv[i][0]), float(uv[i][1])),
            )
            for i in (i0, i1, i2)
        )
        tris.append(verts)

    return isf.Mesh(
        triangles=tris,
        material=_convert_material(gltf, prim.get("material"), writer),
    )


def _convert_light(gltf: _Gltf, light_def: dict, world: np.ndarray):
    color = np.asarray(light_def.get("color", [1.0, 1.0, 1.0]), np.float64)
    intensity = float(light_def.get("intensity", 1.0))
    c = tuple(float(x) for x in color * intensity)
    kind = light_def["type"]
    if kind == "directional":
        d = world[:3, :3] @ np.array([0.0, 0.0, -1.0])
        d = d / np.linalg.norm(d)
        return isf.DirectionalLight(direction=tuple(float(x) for x in d),
                                    color=c)
    # point and spot both map to Point with size 0.1 (ref gltf.rs:247-264)
    return isf.PointLight(position=tuple(float(x) for x in world[:3, 3]),
                          color=c, size=0.1)


def load_gltf_scene(input_path) -> Tuple[isf.Scene, _TextureWriter]:
    """Parse a glTF/GLB file into an in-memory ISF scene + pending textures."""
    gltf = _Gltf(Path(input_path))
    doc = gltf.doc
    scenes = doc.get("scenes", [])
    if not scenes:
        raise ValueError("No scenes found in gltf file")
    scene_def = scenes[doc.get("scene", 0)]

    writer = _TextureWriter()
    models: List[isf.Model] = []
    cameras: List[isf.Camera] = []
    lights: List = []

    def visit(node_index: int, parent: np.ndarray):
        node = doc["nodes"][node_index]
        world = parent @ _trs_matrix(node)
        if "mesh" in node:
            mesh = doc["meshes"][node["mesh"]]
            for prim in mesh["primitives"]:
                models.append(_convert_primitive(gltf, prim, world, writer))
        if "camera" in node:
            cam = doc["cameras"][node["camera"]]
            if cam["type"] != "perspective":
                raise ValueError("Orthographic camera not supported")
            persp = cam["perspective"]
            # ISF serializes the cgmath matrix column-major: transform[i]
            # is column i of the world-from-camera matrix.
            cols = world.T.astype(np.float32).tolist()
            cameras.append(isf.Camera(
                transform=[[float(v) for v in col] for col in cols],
                fov=float(persp["yfov"]),
                zfar=float(persp.get("zfar", 100.0)),
                znear=float(persp["znear"]),
            ))
        ext = node.get("extensions", {}).get("KHR_lights_punctual")
        if ext is not None:
            light_defs = doc["extensions"]["KHR_lights_punctual"]["lights"]
            lights.append(_convert_light(gltf, light_defs[ext["light"]], world))
        for child in node.get("children", []):
            visit(child, world)

    for root in scene_def.get("nodes", []):
        visit(root, np.eye(4))

    if not cameras:
        raise ValueError("No camera found")

    return isf.Scene(models=models, camera=cameras[0], lights=lights,
                     background=(0.0, 0.0, 0.0)), writer


def convert_gltf_to_isf(input_path, output_dir) -> None:
    """glTF/GLB → ``<output_dir>/scene.isf`` + PNG textures
    (ref: src/scene/gltf.rs:146-198)."""
    out = Path(output_dir)
    if out.exists() and not out.is_dir():
        raise ValueError(f"'{out}' is not a directory")
    out.mkdir(parents=True, exist_ok=True)

    scene, writer = load_gltf_scene(input_path)
    isf.save(scene, out / "scene.isf")
    writer.save(out)
