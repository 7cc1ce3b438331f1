"""``path_tracer_torch.utils.telemetry``: the port's counters and spans.

Spans nest on a per-thread stack and carry their attributes; the render
path's spans are recorded only while a ``torch.profiler`` records, and
otherwise every span site returns the one shared no-op context; under a
profiler every bounce of a render has its ``bounce``, ``hit``, ``shade``
and ``shadow`` records, ``bounce.live`` is ``collect_live_counts``'s
count, every host sync is counted at its site, the profiler sees each
span as a FUNCTION-scope CPU range ``ptt.<name>`` (never a user
annotation, which the profiler would mirror onto the device timeline),
and the radiance is bit-equal with the spans on and off. The scene build
records its set-up spans always.
"""
import threading
from collections import Counter

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from path_tracer_torch.models.integrator import IntegratorSpec, render_wavefront
from path_tracer_torch.models.renderer import render_pixel_sums
from path_tracer_torch.scene.device_scene import partitioned
from path_tracer_torch.scene.showcase import showcase_device_scene
from path_tracer_torch.utils import telemetry

W, H = 32, 18
SPEC = IntegratorSpec(bounces=4)


@pytest.fixture(scope="module")
def scene():
    """The textured showcase at grid 48 (5,210 triangles): a partitioned
    BVH scene, so the walks, the prefilters and their syncs all run."""
    sc = showcase_device_scene(48, "cpu", sl_block=256, textured=True)
    assert partitioned(sc)
    return sc


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _traced_render(scene, **kw):
    """(pixel sums, the render's records, the profiler) of one traced
    render of W x H pixels."""
    telemetry.clear()
    with _cpu_profile() as prof:
        sums = render_pixel_sums(scene, W, H, 1, 1, SPEC, **kw)
    return sums, telemetry.records(), prof


def test_span_nesting_parent_and_attributes():
    telemetry.clear()
    with telemetry.span("outer", attrs={"k": 1}) as outer:
        with telemetry.span("inner") as inner:
            inner.attrs["x"] = torch.tensor(7)
        with telemetry.span("second"):
            pass
    recs = telemetry.records()
    assert [r.name for r in recs] == ["outer", "inner", "second"]
    assert recs[0] is outer and recs[1] is inner
    assert outer.parent is None
    assert inner.parent is outer and recs[2].parent is outer
    assert outer.attrs == {"k": 1}
    assert inner.attrs == {"x": 7}  # a device value resolved at records()
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert all(r.device_ms is None for r in recs)  # no CUDA device
    telemetry.clear()
    assert telemetry.records() == []


def test_spans_nest_per_thread():
    telemetry.clear()
    seen = {}

    def work(name):
        with telemetry.span(name):
            with telemetry.span(name + ".child") as child:
                seen[name] = child.parent.name

    threads = [threading.Thread(target=work, args=(f"t{i}",))
               for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert seen == {f"t{i}": f"t{i}" for i in range(8)}
    recs = telemetry.records()
    assert all(r.parent is None for r in recs if "." not in r.name)
    telemetry.clear()


def test_no_profiler_records_no_render_span(scene):
    assert telemetry.traced("hit") is telemetry.NOOP
    assert telemetry.traced("bounce", None, {"index": 0}) is telemetry.NOOP
    with telemetry.NOOP as rec:
        assert rec is None
    telemetry.clear()
    render_pixel_sums(scene, W, H, 1, 1, SPEC)
    assert telemetry.records() == []


def test_every_bounce_has_its_phases_under_a_profiler(scene):
    _, recs, _ = _traced_render(scene)
    names = Counter(r.name for r in recs)
    assert names["render"] == names["render.setup"] == 1
    assert names["render.pass"] == 1
    outer = next(r for r in recs if r.name == "render")
    assert all(r.parent is outer for r in recs
               if r.name in ("render.setup", "render.pass"))
    waves = [r for r in recs if r.name == "wavefront"]
    assert len(waves) == 1 and waves[0].attrs == {"lanes": W * H,
                                                  "sample": 1}
    cams = [r for r in recs if r.name == "camera"]
    assert len(cams) == 1 and cams[0].parent is waves[0]
    bounces = [r for r in recs if r.name == "bounce"]
    assert [b.attrs["index"] for b in bounces] == list(range(SPEC.bounces
                                                             + 1))
    for b in bounces:
        assert b.parent is waves[0]
        kids = Counter(r.name for r in recs if r.parent is b)
        assert kids["hit"] == 1 and kids["shadow"] == 1
        assert kids["shade"] == 2  # before and after the shadows
        assert set(kids) == {"hit", "shade", "shadow"}
        shadow = next(r for r in recs if r.parent is b and r.name == "shadow")
        subs = {r.name for r in recs if r.parent is shadow}
        # A partitioned scene: the any-hit, the prefilter, the walks.
        assert {"shadow.anyhit", "shadow.prefilter", "shadow.walk"} <= subs


def test_bounce_live_equals_collect_live_counts(scene):
    pix = torch.arange(W * H, dtype=torch.int32)
    telemetry.clear()
    with _cpu_profile():
        _, live = render_wavefront(scene, pix, W, H, 3, SPEC,
                                   collect_live_counts=True)
    got = [r.attrs["live"] for r in telemetry.records()
           if r.name == "bounce"]
    assert got == live.tolist()
    assert got[0] == W * H and got[-1] < got[0]


def test_sync_counts_match_the_sites_reached(scene):
    before = Counter(telemetry.counters)
    render_pixel_sums(scene, W, H, 1, 1, SPEC)
    off = Counter(telemetry.counters) - before
    before = Counter(telemetry.counters)
    _, recs, _ = _traced_render(scene)
    on = Counter(telemetry.counters) - before
    spans = Counter(r.name for r in recs if r.name.startswith("sync."))
    syncs = Counter({k: v for k, v in on.items() if k.startswith("sync.")})
    assert syncs and syncs == spans == off
    # Each sync span sits inside a bounce's hit or shadow phase.
    for r in recs:
        if r.name.startswith("sync."):
            chain = []
            p = r.parent
            while p is not None:
                chain.append(p.name)
                p = p.parent
            assert "bounce" in chain and ("hit" in chain or "shadow" in chain)


def test_sync_helpers_return_what_they_replace():
    x = torch.tensor([False, True, False, True])
    before = telemetry.counters["sync.t_any"]
    assert telemetry.sync_any(x, "t_any") is True
    assert telemetry.sync_any(x & ~x, "t_any") is False
    assert telemetry.counters["sync.t_any"] == before + 2
    assert telemetry.sync_nonzero(x, "t_nz") == [1, 3]
    with _cpu_profile():
        telemetry.clear()
        assert telemetry.sync_nonzero(x, "t_nz") == [1, 3]
    assert [r.name for r in telemetry.records()] == ["sync.t_nz"]
    telemetry.counters.pop("sync.t_any")
    telemetry.counters.pop("sync.t_nz")


def test_profiler_sees_function_scope_cpu_ranges(scene):
    _, recs, prof = _traced_render(scene)
    ours = [e for e in prof.profiler.kineto_results.events()
            if e.name().startswith("ptt.")]
    assert len(ours) == len(recs)
    assert Counter(e.name() for e in ours) == Counter(
        "ptt." + r.name for r in recs)
    assert all(e.device_type() == DeviceType.CPU for e in ours)
    assert not any(e.is_user_annotation() for e in ours)


def test_radiance_bit_equal_with_spans_on_and_off(scene):
    off = render_pixel_sums(scene, W, H, 1, 2, SPEC)
    telemetry.clear()
    with _cpu_profile():
        on = render_pixel_sums(scene, W, H, 1, 2, SPEC)
    assert sum(r.name == "wavefront" for r in telemetry.records()) == 2
    np.testing.assert_array_equal(off, on)


def test_scene_build_records_its_setup_spans():
    telemetry.clear()
    showcase_device_scene(8, "cpu", sl_block=256, textured=True)
    recs = telemetry.records()
    build = [r for r in recs if r.name == "scene.build"]
    assert len(build) == 1 and build[0].parent is None
    kids = [r.name for r in recs if r.parent is build[0]]
    assert kids == ["scene.textures", "scene.flatten", "scene.tables",
                    "scene.upload"]
    bvh = [r for r in recs if r.name == "scene.bvh"]
    assert bvh and all(r.parent.name in ("scene.flatten", "scene.tables")
                       for r in bvh)
    assert all(r.attrs["prims"] > 0 for r in bvh)
    assert sum(r.seconds for r in recs if r.parent is build[0]) \
        <= build[0].seconds
    telemetry.clear()
