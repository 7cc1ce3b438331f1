"""Seconds of the benchmark's span around ``native.kernels()``: loading
the hand-written kernels' library, built by nvcc at the first run in a
checkout and found in its cache by every later run."""
NAME = "kernel_load_s"
UNIT = "s"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "native build"
MOVES = "setup_s"


def read(ctx):
    return ctx["spans"].get("kernel_load")
