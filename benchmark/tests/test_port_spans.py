"""CPU tests of the per-layer metrics read from the program's own spans
(``program_spans.py``, ``path_tracer_torch.utils.telemetry``): each
reader on a hand-built context of records and a hand-built timeline, its
names against its ``BENCHMARK.json`` entry, and nothing read, with no
error, from a program that keeps no spans.

    python -m pytest benchmark/tests -q
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402
from benchmark.trace import Timeline  # noqa: E402
from path_tracer_torch.utils.telemetry import Record  # noqa: E402

NEW = ("hit_ms_per_sample.frame", "shadow_ms_per_sample.frame",
       "prefilter_ms_per_sample.frame", "shade_ms_per_sample.frame",
       "host_syncs_per_sample.frame", "live_lane_share.frame",
       "sync_idle_share.frame", "bvh_build_s", "scene_tables_s",
       "scene_textures_s")
T0 = 1_800_000_000.0  # the traced window's start, epoch seconds


def rec(name, parent, a, b, device_ms=None, **attrs):
    """A record from a to b, seconds after T0."""
    return Record(name, parent, int((T0 + a) * 1e9), int((T0 + b) * 1e9),
                  attrs, device_ms)


def context(samples=1):
    """Set-up spans before the window; in it one wavefront of 100 lanes,
    two bounces (live 100 and 40) with their phases, two host syncs. The
    device is busy over [0, 10], [30, 50] and [70, 100] ms."""
    build = rec("scene.build", None, -9.0, -5.0)
    tables = rec("scene.tables", build, -7.0, -5.0)
    flatten = rec("scene.flatten", build, -8.0, -7.0)
    recs = [build, rec("scene.textures", build, -9.0, -8.0), flatten,
            rec("scene.bvh", flatten, -7.75, -7.5), tables,
            rec("scene.bvh", tables, -6.5, -6.0),
            rec("sync.outside", None, -4.0, -3.9)]
    wave = rec("wavefront", None, 0.0, 0.1, 90.0, lanes=100, sample=1)
    recs += [wave, rec("camera", wave, 0.0, 0.001, 1.0)]
    for i, (live, hit_ms, shadow_ms, pre_ms) in enumerate(
            ((100, 20.0, 40.0, 10.0), (40, 10.0, 8.0, 2.0))):
        b = rec("bounce", wave, 0.001 + 0.05 * i, 0.05 + 0.05 * i, 44.5,
                index=i, live=live)
        shadow = rec("shadow", b, 0.01 + 0.05 * i, 0.02 + 0.05 * i,
                     shadow_ms)
        recs += [b, rec("hit", b, 0.001 + 0.05 * i, 0.01 + 0.05 * i, hit_ms),
                 rec("shade", b, 0.01, 0.01, 3.0), shadow,
                 rec("shadow.prefilter", shadow, 0.011, 0.012, pre_ms),
                 rec("shade", b, 0.02, 0.02, 3.0)]
    recs += [rec("sync.trans_walk_kernel", wave, 0.005, 0.020),
             rec("sync.trans_cast_walk", wave, 0.055, 0.060)]
    tl = Timeline(device=[("k", T0 + 0.0, T0 + 0.010),
                          ("k", T0 + 0.030, T0 + 0.050),
                          ("k", T0 + 0.070, T0 + 0.100)],
                  host=[], window=(T0, T0 + 0.1))
    return dict(timeline=tl, records=recs, traced_samples=samples, spans={},
                pass_times=[0.1], least={})


def read(name, ctx):
    return harness.metric_module(name).read(ctx)


def test_entries_match_their_modules():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    cells = [w["name"] for w in bench["workloads"]]
    for name in NEW:
        m, mod = entries[name], harness.metric_module(name)
        assert (mod.NAME, mod.UNIT, mod.BETTER, mod.SOURCE, mod.LAYER,
                mod.MOVES) == (m["name"], m["unit"], m["better"], m["source"],
                               m["layer"], m["moves"])
        assert m["workloads"] == cells


@pytest.mark.parametrize("samples", [1, 2])
def test_phase_device_ms_per_sample(samples):
    ctx = context(samples)
    assert read("hit_ms_per_sample.frame", ctx) == pytest.approx(
        30.0 / samples)
    assert read("shadow_ms_per_sample.frame", ctx) == pytest.approx(
        48.0 / samples)
    assert read("prefilter_ms_per_sample.frame", ctx) == pytest.approx(
        12.0 / samples)
    assert read("shade_ms_per_sample.frame", ctx) == pytest.approx(
        12.0 / samples)
    # The sync outside the window (set-up) is not counted.
    assert read("host_syncs_per_sample.frame", ctx) == pytest.approx(
        2.0 / samples)


def test_live_lane_share():
    assert read("live_lane_share.frame", context()) == pytest.approx(70.0)


def test_sync_idle_share_on_known_gaps():
    # Sync 1 from 5 ms reaches the activity at 30 ms: idle 10..30 ms. Sync
    # 2 from 55 ms reaches 70 ms: idle 55..70 ms. 35 of 100 ms.
    # (Epoch nanoseconds as floats: about 0.25 us of rounding.)
    assert read("sync_idle_share.frame", context()) == pytest.approx(
        35.0, abs=1e-3)
    ctx = context()
    ctx["records"] = [r for r in ctx["records"]
                      if r.name != "sync.trans_cast_walk"]
    assert read("sync_idle_share.frame", ctx) == pytest.approx(20.0,
                                                               abs=1e-3)


def test_setup_seconds():
    ctx = context()
    assert read("bvh_build_s", ctx) == pytest.approx(0.75)
    assert read("scene_tables_s", ctx) == pytest.approx(1.5)  # 2 - 0.5
    assert read("scene_textures_s", ctx) == pytest.approx(1.0)


def test_no_device_time_reads_nothing():
    """Off a CUDA device the spans have no device ms: the phase metrics
    read nothing, never 0; the counts still read."""
    ctx = context()
    for r in ctx["records"]:
        r.device_ms = None
    for name in ("hit_ms_per_sample.frame", "shadow_ms_per_sample.frame",
                 "prefilter_ms_per_sample.frame",
                 "shade_ms_per_sample.frame"):
        assert read(name, ctx) is None
    assert read("host_syncs_per_sample.frame", ctx) == 2.0


def test_program_without_spans_reads_nothing(monkeypatch):
    """A program with no ``utils.telemetry`` (a parent commit): every new
    reader returns None and raises nothing."""
    monkeypatch.setitem(sys.modules, "path_tracer_torch.utils.telemetry",
                        None)
    ctx = context()
    del ctx["records"]
    for name in NEW:
        assert read(name, ctx) is None
