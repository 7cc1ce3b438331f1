"""The share of the wavefront's lanes alive at the start of a bounce,
over the traced window: 100 x the sum of the ``bounce`` spans' ``live``
over the sum, per bounce, of its ``wavefront``'s ``lanes``."""
from benchmark.program_spans import traced

NAME = "live_lane_share.frame"
UNIT = "%"
BETTER = "higher"
SOURCE = "program_span"
LAYER = "integrator"
MOVES = "frame_mray_per_s"


def read(ctx):
    bounces = [r for r in traced(ctx) or () if r.name == "bounce"
               and r.parent is not None and r.parent.name == "wavefront"]
    lanes = sum(r.parent.attrs["lanes"] for r in bounces)
    if lanes <= 0:
        return None
    return 100.0 * sum(r.attrs["live"] for r in bounces) / lanes
