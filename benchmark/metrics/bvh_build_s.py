"""Seconds of the program's ``scene.bvh`` spans: every binned-SAH build
of ``native.build_bvh`` in the scene build (the leaf-4 order of each
partition, the superleaf trees, the transparent prefilter's tree, the
sphere blocks)."""
from benchmark.program_spans import setup_seconds

NAME = "bvh_build_s"
UNIT = "s"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "scene set-up"
MOVES = "setup_s"


def read(ctx):
    return setup_seconds(ctx, "scene.bvh")
