"""Device milliseconds per traced sample of the program's ``shade`` spans:
the surface, the material and texture fetches, emission, the direct
lights' BRDF, the scattering and the roulette of each bounce, from the
spans' CUDA events (``program_spans.py``)."""
from benchmark.program_spans import device_ms_per_sample

NAME = "shade_ms_per_sample.frame"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "integrator"
MOVES = "frame_mray_per_s"


def read(ctx):
    return device_ms_per_sample(ctx, "shade")
