"""The share of the traced window in which no operation ran on the
device: 1 - the union of device activity over the window."""
NAME = "idle_share.frame"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "device"
MOVES = "frame_mray_per_s"


def read(ctx):
    tl = ctx["timeline"]
    if tl.window_s <= 0.0 or not tl.device:
        return None
    return 100.0 * (1.0 - tl.busy_s() / tl.window_s)
