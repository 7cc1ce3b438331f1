"""Device milliseconds per traced sample of the program's ``hit`` spans:
each bounce's alpha walk (the opaque closest hit, its slab prefilter, the
alpha walk kernel and the cast walk after it), from the spans' CUDA
events (``program_spans.py``)."""
from benchmark.program_spans import device_ms_per_sample

NAME = "hit_ms_per_sample.frame"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "intersection and walks"
MOVES = "frame_mray_per_s"


def read(ctx):
    return device_ms_per_sample(ctx, "hit")
