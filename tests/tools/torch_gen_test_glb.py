"""Author a real-mesh GLB for the converter end-to-end test, without
Pillow.

The PyTorch port's copy of ``tests/tools/gen_test_glb.py``: the same
document, meshes and texels, its PNGs written by the port's
``encode_png`` (standard library and numpy), so it runs where Pillow is
not installed. The PNG bytes differ from the Pillow-written ones; their
decoded texels do not.

Writes a self-contained binary glTF (GLB 2.0): a ~12k-triangle sinusoidal
terrain mesh with normals/UVs and a checkered baseColor texture, a
translucent dome mesh (baseColorFactor alpha < 1 -> ISF opacity factor), a
perspective camera node and a KHR_lights_punctual point light — everything
the reference converter consumes from a production scene
(ref: src/scene/gltf.rs:146-265). Deterministic; built at test time so no
binary asset lives in the repo.
"""
from __future__ import annotations

import json
import struct
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
from path_tracer_torch.utils.image_io import encode_png  # noqa: E402


def _checker_png(n: int = 64) -> bytes:
    yy, xx = np.mgrid[0:n, 0:n]
    c = ((xx // 8 + yy // 8) % 2).astype(np.uint8)
    img = np.stack([40 + 180 * c, 120 + 60 * c, 60 + 40 * (1 - c)],
                   axis=-1).astype(np.uint8)
    return encode_png(img)


def _terrain(n: int = 80):
    """Grid mesh: positions [V,3], normals [V,3], uvs [V,2], indices [T,3]."""
    xs = np.linspace(-20.0, 20.0, n, dtype=np.float32)
    zs = np.linspace(-20.0, 20.0, n, dtype=np.float32)
    gx, gz = np.meshgrid(xs, zs)
    gy = (1.5 * np.sin(gx * 0.4) * np.cos(gz * 0.35)
          + 0.6 * np.sin(gx * 1.1 + 2.0)).astype(np.float32)
    pos = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)
    # Analytic-ish normals via central differences.
    dy_dx = np.gradient(gy, xs[1] - xs[0], axis=1)
    dy_dz = np.gradient(gy, zs[1] - zs[0], axis=0)
    nrm = np.stack([-dy_dx, np.ones_like(gy), -dy_dz], axis=-1).reshape(-1, 3)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    uv = np.stack([gx / 40.0 + 0.5, gz / 40.0 + 0.5], axis=-1).reshape(-1, 2)

    idx = []
    for r in range(n - 1):
        for c in range(n - 1):
            a = r * n + c
            idx.append([a, a + n, a + 1])
            idx.append([a + 1, a + n, a + n + 1])
    return (pos.astype(np.float32), nrm.astype(np.float32),
            uv.astype(np.float32), np.asarray(idx, np.uint32))


def _dome(n_seg: int = 24):
    """Half-sphere shell above the terrain (translucent material)."""
    verts = []
    norms = []
    uvs = []
    for i in range(n_seg + 1):
        theta = (i / n_seg) * (np.pi / 2)
        for j in range(n_seg):
            phi = (j / n_seg) * 2 * np.pi
            p = np.array([np.sin(theta) * np.cos(phi), np.cos(theta),
                          np.sin(theta) * np.sin(phi)], np.float32)
            verts.append(p * 6.0 + np.float32([0, 2.0, 0]))
            norms.append(p)
            uvs.append([i / n_seg, j / n_seg])
    idx = []
    for i in range(n_seg):
        for j in range(n_seg):
            a = i * n_seg + j
            b = i * n_seg + (j + 1) % n_seg
            c = (i + 1) * n_seg + j
            d = (i + 1) * n_seg + (j + 1) % n_seg
            idx.append([a, c, b])
            idx.append([b, c, d])
    return (np.asarray(verts, np.float32), np.asarray(norms, np.float32),
            np.asarray(uvs, np.float32), np.asarray(idx, np.uint32))


def _cutout_png(n: int, kind: str) -> bytes:
    """RGBA base-color texture whose ALPHA carries a cutout pattern — the
    converter splits it into a separate gray opacity texture (ref
    gltf.rs:79-130). Two kinds so a multi-material GLB yields two DISTINCT
    opacity textures."""
    yy, xx = np.mgrid[0:n, 0:n]
    cx, cy = (xx / n) * 2 - 1, (yy / n) * 2 - 1
    if kind == "holes":
        r = np.sqrt(((xx % 16) - 8.0) ** 2 + ((yy % 16) - 8.0) ** 2)
        a = np.where(r < 6.0, 40, 255).astype(np.uint8)
        rgb = np.stack([60 + 0 * xx, 140 + 40 * ((xx // 16) % 2),
                        60 + 0 * yy], axis=-1).astype(np.uint8)
    else:  # "stripes": soft diagonal alpha ramp bands
        a = (255 * (0.15 + 0.85 * (np.sin((cx + cy) * 9.0) * 0.5 + 0.5))
             ).astype(np.uint8)
        rgb = np.stack([180 + 0 * xx, 120 + 0 * xx, 70 + 0 * yy],
                       axis=-1).astype(np.uint8)
    img = np.concatenate([rgb, a[..., None]], axis=-1)
    return encode_png(img)


def _wall(x0, z0, x1, z1, y0, y1, nx: int = 6, ny: int = 3):
    """Vertical quad-grid wall between (x0,z0) and (x1,z1)."""
    verts, norms, uvs, idx = [], [], [], []
    dx, dz = x1 - x0, z1 - z0
    ln = float(np.hypot(dx, dz))
    n = np.float32([dz / ln, 0.0, -dx / ln])
    for j in range(ny + 1):
        for i in range(nx + 1):
            t = i / nx
            s = j / ny
            verts.append([x0 + dx * t, y0 + (y1 - y0) * s, z0 + dz * t])
            norms.append(n)
            uvs.append([t * 2.0, s])
    for j in range(ny):
        for i in range(nx):
            a = j * (nx + 1) + i
            b = a + 1
            c = a + (nx + 1)
            d = c + 1
            idx.append([a, c, b])
            idx.append([b, c, d])
    return (np.asarray(verts, np.float32), np.asarray(norms, np.float32),
            np.asarray(uvs, np.float32), np.asarray(idx, np.uint32))


def write_glb(path, multi_opacity: bool = False, textures=None) -> int:
    """Write the GLB; returns the total triangle count.

    ``multi_opacity`` adds two cutout walls whose RGBA base-color textures
    carry DIFFERENT alpha patterns: the converted ISF then holds two
    distinct opacity textures (the walk kernels' multi-page path).
    ``textures``: image files' bytes (PNG or JPEG): the first replaces the
    terrain's checker, each other is the base colour of an opaque wall of
    its own in a row behind the terrain's middle.
    """
    tpos, tnrm, tuv, tidx = _terrain()
    dpos, dnrm, duv, didx = _dome()
    textures = list(textures or [])
    png = textures.pop(0) if textures else _checker_png()

    bin_parts = []
    views = []
    accessors = []

    def add_blob(data: bytes, target=None):
        offset = sum(len(b) for b in bin_parts)
        pad = (-offset) % 4
        if pad:
            bin_parts.append(b"\0" * pad)
            offset += pad
        bin_parts.append(data)
        view = {"buffer": 0, "byteOffset": offset, "byteLength": len(data)}
        if target:
            view["target"] = target
        views.append(view)
        return len(views) - 1

    def add_accessor(arr: np.ndarray, ctype: int, atype: str, target):
        v = add_blob(arr.tobytes(), target)
        acc = {"bufferView": v, "componentType": ctype,
               "count": int(arr.shape[0]), "type": atype}
        if atype == "VEC3":
            acc["min"] = [float(x) for x in arr.min(axis=0)]
            acc["max"] = [float(x) for x in arr.max(axis=0)]
        accessors.append(acc)
        return len(accessors) - 1

    prims = [(tpos, tnrm, tuv, tidx, 0), (dpos, dnrm, duv, didx, 1)]
    if multi_opacity:
        prims.append((*_wall(-12.0, -4.0, 12.0, -10.0, 0.5, 6.5), 2))
        prims.append((*_wall(-10.0, 8.0, 10.0, 3.0, 0.5, 6.0), 3))

    n_mats = 4 if multi_opacity else 2
    for k in range(len(textures)):
        x0 = -18.0 + 36.0 * k / len(textures)
        x1 = -18.0 + 36.0 * (k + 1) / len(textures) - 0.5
        prims.append((*_wall(x0, -14.0, x1, -14.0, 0.5, 7.0), n_mats + k))

    meshes = []
    for pos, nrm, uv, idx, mat in prims:
        p = add_accessor(pos, 5126, "VEC3", 34962)
        n = add_accessor(nrm, 5126, "VEC3", 34962)
        u = add_accessor(uv, 5126, "VEC2", 34962)
        i = add_accessor(idx.reshape(-1), 5125, "SCALAR", 34963)
        meshes.append({"primitives": [{
            "attributes": {"POSITION": p, "NORMAL": n, "TEXCOORD_0": u},
            "indices": i, "material": mat, "mode": 4}]})

    def mime(data: bytes) -> str:
        return "image/jpeg" if data[:2] == b"\xff\xd8" else "image/png"

    img_view = add_blob(png)

    tex_docs = [{"source": 0}]
    images = [{"bufferView": img_view, "mimeType": mime(png)}]
    materials = [
        {"pbrMetallicRoughness": {
            "baseColorTexture": {"index": 0},
            "metallicFactor": 0.1, "roughnessFactor": 0.9}},
        {"pbrMetallicRoughness": {
            "baseColorFactor": [0.7, 0.8, 1.0, 0.35],
            "metallicFactor": 0.0, "roughnessFactor": 0.3},
         "alphaMode": "BLEND"},
    ]
    node_meshes = [0, 1]
    if multi_opacity:
        for k, kind in enumerate(("holes", "stripes")):
            v = add_blob(_cutout_png(64, kind))
            images.append({"bufferView": v, "mimeType": "image/png"})
            tex_docs.append({"source": len(images) - 1})
            materials.append({"pbrMetallicRoughness": {
                "baseColorTexture": {"index": len(tex_docs) - 1},
                "metallicFactor": 0.0, "roughnessFactor": 0.8},
                "alphaMode": "BLEND", "doubleSided": True})
            node_meshes.append(2 + k)
    for data in textures:
        images.append({"bufferView": add_blob(data), "mimeType": mime(data)})
        tex_docs.append({"source": len(images) - 1})
        materials.append({"pbrMetallicRoughness": {
            "baseColorTexture": {"index": len(tex_docs) - 1},
            "metallicFactor": 0.0, "roughnessFactor": 0.7}})
        node_meshes.append(len(node_meshes))

    mesh_nodes = [{"mesh": m} for m in node_meshes]
    doc = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": list(range(len(mesh_nodes) + 2))}],
        "nodes": mesh_nodes + [
            # Camera looking down at the terrain from (0, 18, 34).
            {"camera": 0, "translation": [0.0, 18.0, 34.0],
             "rotation": [-0.2164396, 0.0, 0.0, 0.9762960]},
            {"extensions": {"KHR_lights_punctual": {"light": 0}},
             "translation": [10.0, 25.0, 10.0]},
        ],
        "cameras": [{"type": "perspective",
                     "perspective": {"yfov": 0.7, "znear": 0.1,
                                     "zfar": 200.0}}],
        "materials": materials,
        "meshes": meshes,
        "textures": tex_docs,
        "images": images,
        "extensions": {"KHR_lights_punctual": {"lights": [
            {"type": "point", "color": [1.0, 0.95, 0.9],
             "intensity": 1200.0}]}},
        "extensionsUsed": ["KHR_lights_punctual"],
        "bufferViews": views,
        "accessors": accessors,
        "buffers": [{"byteLength": sum(len(b) for b in bin_parts)}],
    }

    bin_chunk = b"".join(bin_parts)
    bin_chunk += b"\0" * ((-len(bin_chunk)) % 4)
    json_chunk = json.dumps(doc).encode()
    json_chunk += b" " * ((-len(json_chunk)) % 4)

    total = 12 + 8 + len(json_chunk) + 8 + len(bin_chunk)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, total))
        f.write(struct.pack("<II", len(json_chunk), 0x4E4F534A))
        f.write(json_chunk)
        f.write(struct.pack("<II", len(bin_chunk), 0x004E4942))
        f.write(bin_chunk)
    return int(sum(p[3].shape[0] for p in prims))


if __name__ == "__main__":
    out = sys.argv[1] if len(sys.argv) > 1 else "terrain.glb"
    n = write_glb(out)
    print(f"wrote {out}: {n} triangles")
