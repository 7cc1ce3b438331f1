"""Seconds the program takes to build the device scene from the raw scene:
the benchmark's span around ``scene.device_scene.build_scene`` (the ISF
flattening, the texture atlas, the BVH from ``native.build_bvh``, the
superleaf, walk and shading-row tables) and its handing over as an ISF
scene in memory."""
NAME = "scene_build_s"
UNIT = "s"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "scene set-up"
MOVES = "setup_s"


def read(ctx):
    return ctx["spans"].get("scene_build")
