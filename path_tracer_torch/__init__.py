"""path_tracer_torch — the path tracer in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper (sm_90a).

A port of ``path_tracer_tpu`` (JAX/Pallas), which stays beside it as the
reference. Module names follow the JAX package so a reader finds each
counterpart:

- ``config``  — render profile + resolution
- ``scene``   — ISF loader (stdlib) and the device scene (``TorchScene``)
- ``ops``     — RNG, camera, BRDF, texturing, tonemap, intersection and
                the transparent walks; the CUDA kernels' wrappers live in
                ``ops/cuda_*.py`` and their sources in ``csrc/``
- ``models``  — the wavefront integrator and the render driver
- ``parallel``— the differentiable render step (scene-parameter gradients,
                one device)
- ``utils``   — PNG and JPEG readers (other formats through Pillow), the
                PNG writer
- ``cli``     — ``path-tracer-torch render`` and ``convert``

At package level, as in the JAX package: ``Profile``, ``Resolution``,
``load_scene(path, device="cuda")`` and ``render(scene, profile=None,
**kwargs)``, the last two importing the scene and render modules at their
first call.

Importing the package imports nothing but the standard library; the scene
and render modules import ``torch`` and ``numpy``, PyYAML is imported only
where a profile file is read (images are decoded with the standard
library's zlib and numpy), and the kernels are built with ``nvcc`` at
their first launch.
"""

__version__ = "0.1.0"

from path_tracer_torch.config import Profile, Resolution  # noqa: F401


def load_scene(path, device="cuda", **kwargs):
    """Load an ISF scene file onto ``device`` (``scene.load_scene``;
    ``use_bvh`` and ``sl_block`` pass through)."""
    from path_tracer_torch.scene import load_scene as _load

    return _load(path, device, **kwargs)


def render(scene, profile=None, **kwargs):
    """Render a scene → [H,W,3] uint8 (``models.renderer.render``; the
    default ``Profile()`` when none is given)."""
    from path_tracer_torch.models.renderer import render as _render

    return _render(scene, profile or Profile(), **kwargs)
