"""The transparent walks' share of their roofline (rows 13 and 14,
``csrc/alpha_walk.cu`` and ``trans_walk.cu``): the least time their
launches in the traced sample need (``counts/work.py``, from the inputs
each launch was given) over those launches' device time. Nothing when
the sample launched neither."""
import re

from benchmark.counts.capture import kernels_of

NAME = "walks_roofline.frame"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "kernels"
MOVES = "frame_mray_per_s"
FAMILY = "walks"


def read(ctx):
    least, n = ctx["least"].get(FAMILY, (0.0, 0))
    pat = re.compile(r"\b(" + "|".join(kernels_of(FAMILY)) + r")\b")
    dev = ctx["timeline"].device_seconds(pat)
    if n == 0 or dev <= 0.0 or least <= 0.0:
        return None
    return 100.0 * least / dev
