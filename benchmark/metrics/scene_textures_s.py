"""Seconds of the program's ``scene.textures`` spans: the scene build's
texture atlas, reading and decoding every image."""
from benchmark.program_spans import setup_seconds

NAME = "scene_textures_s"
UNIT = "s"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "scene set-up"
MOVES = "setup_s"


def read(ctx):
    return setup_seconds(ctx, "scene.textures")
