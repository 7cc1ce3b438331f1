"""Device activities (kernel launches, copies and sets) per traced sample,
from the profiler's device trace: the eager integrator's launch count,
which paces the host."""
NAME = "launches_per_sample.frame"
UNIT = "launches"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "integrator"
MOVES = "frame_mray_per_s"


def read(ctx):
    n = len(ctx["timeline"].device)
    return n / ctx["traced_samples"] if n else None
