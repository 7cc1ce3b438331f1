"""Device milliseconds per traced sample of the program's hand-written
kernels (``csrc/``: the BVH walks, the sphere kernels, the transparent
walks), from the profiler's device trace."""
from benchmark.trace import PORT_KERNEL

NAME = "hit_kernel_ms_per_sample.frame"
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "intersection and walks"
MOVES = "frame_mray_per_s"


def read(ctx):
    ms = ctx["timeline"].device_seconds(PORT_KERNEL) * 1e3
    return ms / ctx["traced_samples"] if ms > 0 else None
