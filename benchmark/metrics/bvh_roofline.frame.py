"""The triangle BVH walks' share of their roofline: rows 9 and 10 (the
flat closest hit with the dense sphere pass fused, the flat any-hit) on a
scene of at most 2,048 blocks, rows 11 and 12 (flat2) above: the least
time their launches in the traced sample need (``counts/work.py``, from
the inputs each launch was given) over those launches' device time."""
import re

from benchmark.counts.capture import kernels_of

NAME = "bvh_roofline.frame"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "kernels"
MOVES = "frame_mray_per_s"
FAMILY = "bvh"


def read(ctx):
    least, n = ctx["least"].get(FAMILY, (0.0, 0))
    pat = re.compile(r"\b(" + "|".join(kernels_of(FAMILY)) + r")\b")
    dev = ctx["timeline"].device_seconds(pat)
    if n == 0 or dev <= 0.0 or least <= 0.0:
        return None
    return 100.0 * least / dev
