"""The share of the traced window in which the device idles because of
the program's host syncs: for each ``sync.*`` span, the time with no
device activity from its start to the first device activity after it
ends, the spans' host times against ``Timeline.busy_intervals()`` (both
on the epoch clock)."""
import bisect

from benchmark.program_spans import traced

NAME = "sync_idle_share.frame"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "device"
MOVES = "frame_mray_per_s"


def read(ctx):
    tl = ctx["timeline"]
    syncs = [r for r in traced(ctx) or () if r.name.startswith("sync.")]
    if tl.window_s <= 0.0 or not tl.device or not syncs:
        return None
    lo, hi = tl.window
    busy = tl.busy_intervals()
    starts = [a for a, _ in busy]
    # Each sync's reach: its start to the first device activity after its
    # end (the window's end where none follows), merged.
    reach = []
    for r in sorted(syncs, key=lambda r: r.start_ns):
        a, e = max(r.start_ns * 1e-9, lo), min(r.end_ns * 1e-9, hi)
        i = bisect.bisect_left(starts, e)
        b = starts[i] if i < len(starts) else hi
        if b <= a:
            continue
        if reach and a <= reach[-1][1]:
            reach[-1][1] = max(reach[-1][1], b)
        else:
            reach.append([a, b])
    idle = 0.0
    for a, b in reach:
        covered = sum(max(0.0, min(b, y) - max(a, x)) for x, y in busy
                      if x < b and y > a)
        idle += (b - a) - covered
    return 100.0 * idle / tl.window_s
