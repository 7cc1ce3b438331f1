"""Scene layer: ISF loader and the device scene."""

from path_tracer_torch.scene import isf  # noqa: F401
from path_tracer_torch.scene.device_scene import (  # noqa: F401
    TorchScene,
    build_scene,
    from_numpy,
)


def load_scene(path, device, use_bvh=None, sl_block: int = 512):
    """Load an ISF scene file and build its tensors on ``device``; texture
    paths resolve relative to the scene file's directory. ``use_bvh`` and
    ``sl_block`` are ``build_scene``'s (None: the BVH from 4,096
    triangles on)."""
    import pathlib

    path = pathlib.Path(path)
    return build_scene(isf.load(path), root=path.parent, device=device,
                       use_bvh=use_bvh, sl_block=sl_block)
