"""Scene layer: ISF loader and the device scene."""

from path_tracer_torch.scene import isf  # noqa: F401
from path_tracer_torch.scene.device_scene import (  # noqa: F401
    TorchScene,
    build_scene,
    from_numpy,
)


def load_scene(path, device):
    """Load an ISF scene file and build its tensors on ``device``; texture
    paths resolve relative to the scene file's directory."""
    import pathlib

    path = pathlib.Path(path)
    return build_scene(isf.load(path), root=path.parent, device=device)
