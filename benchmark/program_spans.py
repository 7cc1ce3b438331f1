"""The program's own spans, for the per-layer metrics that read them.

``path_tracer_torch.utils.telemetry`` keeps the program's span records in
memory: the scene build's spans always, the render path's (one per bounce
phase, each with its device milliseconds from CUDA events) while a
``torch.profiler`` records, which in a run of the benchmark is the traced
pass alone. Host times are ``time.time_ns()``, the clock of the traced
pass's ``trace.Timeline``. A program without that module records nothing,
and every reader built on this file then reads nothing (None).
"""
from __future__ import annotations


def records(ctx):
    """The program's records: ``ctx["records"]`` where the caller gives
    them, else the program's own, or None where it keeps none."""
    if "records" in ctx:
        return ctx["records"]
    try:
        import path_tracer_torch.utils.telemetry as telemetry
    except ImportError:
        return None
    return telemetry.records()


def traced(ctx):
    """The records of the spans opened inside the traced window, or
    None."""
    recs = records(ctx)
    if recs is None:
        return None
    lo, hi = ctx["timeline"].window
    return [r for r in recs if lo <= r.start_ns * 1e-9 <= hi]


def device_ms_per_sample(ctx, name: str):
    """Device milliseconds of the traced window's spans named ``name``
    per traced sample; None where there is none, or one has no device
    time (off a CUDA device)."""
    recs = traced(ctx)
    ms = [r.device_ms for r in recs or () if r.name == name]
    if not ms or any(m is None for m in ms):
        return None
    return sum(ms) / ctx["traced_samples"]


def setup_seconds(ctx, name: str):
    """Summed host seconds of the spans named ``name``, or None."""
    recs = records(ctx)
    secs = [r.seconds for r in recs or () if r.name == name]
    return sum(secs) if secs else None
