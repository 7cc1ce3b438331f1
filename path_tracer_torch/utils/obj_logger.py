"""Wavefront-OBJ ray dumper for looking at rays in a 3D tool.

Port of ``path_tracer_tpu/utils/obj_logger.py``: any batch of rays, or the
camera wavefront of a scene, as OBJ line primitives (two ``v`` rows and
one ``l`` row per ray, vertex indices 1-based), to open in Blender or
MeshLab. The text is the JAX package's, float for float.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch


class ObjRayLogger:
    """Accumulates line segments; ``write`` emits one OBJ file."""

    def __init__(self):
        self._verts: list[np.ndarray] = []

    def line(self, start, end) -> None:
        self._verts.append(np.asarray(start, np.float32).reshape(3))
        self._verts.append(np.asarray(end, np.float32).reshape(3))

    def ray(self, origin, direction, length: float = 1.0) -> None:
        o = np.asarray(origin, np.float32).reshape(3)
        d = np.asarray(direction, np.float32).reshape(3)
        self.line(o, o + d * length)

    def rays(self, origins, directions, length: float = 1.0) -> None:
        """Batch form: origins, directions [N,3] (arrays or tensors)."""
        o = _host(origins).reshape(-1, 3)
        d = _host(directions).reshape(-1, 3)
        for i in range(o.shape[0]):
            self.ray(o[i], d[i], length)

    def write(self, path="log.obj") -> None:
        with open(Path(path), "w") as f:
            for v in self._verts:
                f.write(f"v {v[0]} {v[1]} {v[2]}\n")
            for i in range(0, len(self._verts), 2):
                f.write(f"l {i + 1} {i + 2}\n")


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def dump_camera_rays(scene, width: int, height: int, path="log.obj",
                     stride: int = 16, length: float = 5.0) -> None:
    """Dump every stride-th camera ray (through the pixel centre) of a scene
    to OBJ."""
    from path_tracer_torch.ops.camera import generate_rays

    ids = torch.arange(0, width * height, stride, dtype=torch.int32,
                       device=scene.device)
    o, d = generate_rays(ids, width, height, scene, 0, 0, jitter=False)
    logger = ObjRayLogger()
    logger.rays(o, d, length)
    logger.write(path)
