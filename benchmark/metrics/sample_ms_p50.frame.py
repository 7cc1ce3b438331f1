"""The median time of one pass of the frame window (one sample of the
whole frame), host clock from one pass callback to the next, each after
a synchronize: a steadier reading of the render loop's pace than the
window's rate."""
import statistics

NAME = "sample_ms_p50.frame"
UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"
LAYER = "render loop"
MOVES = "frame_mray_per_s"


def read(ctx):
    times = ctx["pass_times"]
    return statistics.median(times) * 1e3 if times else None
