"""Host syncs per traced sample: the program's ``sync.*`` spans (each
``bool(x.any())`` or ``.tolist()`` of the render path that waits for the
device, ``utils.telemetry.sync_any``) in the traced window."""
from benchmark.program_spans import traced

NAME = "host_syncs_per_sample.frame"
UNIT = "syncs"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "integrator"
MOVES = "frame_mray_per_s"


def read(ctx):
    recs = traced(ctx)
    if not recs or not any(r.name == "wavefront" for r in recs):
        return None
    n = sum(1 for r in recs if r.name.startswith("sync."))
    return n / ctx["traced_samples"]
