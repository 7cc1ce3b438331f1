"""Self seconds of the program's ``scene.tables`` spans: the superleaf and
flat2 tables, the wide textures, the walk tables and the shading rows of
the scene build, less the ``scene.bvh`` builds nested in them."""
from benchmark.program_spans import records

NAME = "scene_tables_s"
UNIT = "s"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "scene set-up"
MOVES = "setup_s"


def read(ctx):
    recs = records(ctx) or ()
    tables = [r for r in recs if r.name == "scene.tables"]
    if not tables:
        return None
    nested = sum(r.seconds for r in recs if r.name == "scene.bvh"
                 and any(r.parent is t for t in tables))
    return sum(t.seconds for t in tables) - nested
