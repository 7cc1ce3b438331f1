"""Device milliseconds per traced sample of the program's
``shadow.prefilter`` spans: the shadow segments' slab test against the
transparent clusters' boxes (``trwalk.hits_transparent_bounds``), from
the spans' CUDA events (``program_spans.py``)."""
from benchmark.program_spans import device_ms_per_sample

NAME = "prefilter_ms_per_sample.frame"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "integrator"
MOVES = "frame_mray_per_s"


def read(ctx):
    return device_ms_per_sample(ctx, "shadow.prefilter")
