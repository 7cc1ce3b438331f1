"""Device milliseconds per traced sample of everything that is not one of
the program's hand-written kernels: ATen's shading, texturing, RNG,
gathers and reductions, and the copies and sets."""
from benchmark.trace import PORT_KERNEL

NAME = "aten_ms_per_sample.frame"
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "integrator"
MOVES = "frame_mray_per_s"


def read(ctx):
    tl = ctx["timeline"]
    ms = (tl.device_seconds() - tl.device_seconds(PORT_KERNEL)) * 1e3
    return ms / ctx["traced_samples"] if ms > 0 else None
