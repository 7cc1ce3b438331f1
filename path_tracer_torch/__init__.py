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
- ``utils``   — PNG reader and writers
- ``cli``     — ``path-tracer-torch render``

Importing the package imports nothing but ``torch`` and ``numpy``; PyYAML
is imported only where a profile file is read (textures are decoded with
the standard library's zlib), and the kernels are built with ``nvcc`` at
their first launch.
"""

__version__ = "0.1.0"
