"""Device milliseconds per traced sample of the program's ``shadow``
spans: each bounce's shadows of every light (the any-hit, the slab
prefilter, the transmittance walks), from the spans' CUDA events
(``program_spans.py``)."""
from benchmark.program_spans import device_ms_per_sample

NAME = "shadow_ms_per_sample.frame"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "intersection and walks"
MOVES = "frame_mray_per_s"


def read(ctx):
    return device_ms_per_sample(ctx, "shadow")
