"""CPU tests of the benchmark's harness (``benchmark/``), at a tiny size.

The program runs its kernels' plain versions on the CPU; the harness's
own look for a card is skipped by handing ``harness.run`` the CPU device.
The card-only test is marked ``gpu`` and decides inside itself whether a
card is there.

    python -m pytest benchmark/tests -q
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import check, harness, scenes  # noqa: E402
from benchmark.counts import work  # noqa: E402
from benchmark.trace import Timeline  # noqa: E402

CELL = "showcase_tex.frame"


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.fixture(scope="module")
def tiny_bench(tmp_path_factory) -> dict:
    """BENCHMARK.json with the showcase_tex configuration cut to a tiny
    size: the terrain at grid 48 (5,210 triangles, still on the BVH and
    the opacity partition), a 64 x 36 frame in one wavefront."""
    cfg = json.loads((ROOT / "benchmark/configs/showcase_tex.json").read_text())
    cfg["name"] = "tiny_showcase_tex"
    cfg["scene"]["grid"] = 48
    cfg["profile"]["resolution"] = {"width": 64, "height": 36}
    cfg["profile"]["tile_rays"] = 4096
    cfg["check_pixels"] = 96
    path = tmp_path_factory.mktemp("cfg") / "tiny.json"
    path.write_text(json.dumps(cfg))
    b = bench()
    for c in b["configs"]:
        c["file"] = str(path)
    return b


def tiny_run(b, seed=20261018, trace=0, seconds=2.0):
    args = harness.parse(["--workload", CELL, "--seed", str(seed),
                          "--seconds", str(seconds), "--trace", str(trace)])
    return harness.run(args, time.perf_counter(), device=torch.device("cpu"),
                       bench=b)


# --- names and files ---------------------------------------------------------

def test_cells_configs_mixes_metrics_resolve():
    b = bench()
    for w in b["workloads"]:
        cell = harness.Cell(w["name"], b)
        assert hasattr(harness.runner_class(cell.mix["runner"]), "window")
        gen = cell.config["scene"]["generator"]
        assert (ROOT / "benchmark/scenes" / f"{gen}.py").is_file()
        assert set(check.limits_of(w["name"])) == {"err_mean", "off_share"}
        assert cell.config["name"] == w["config"]
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert cell.per_layer
    for m in b["per_layer"]:
        mod = harness.metric_module(m["name"])
        assert (mod.NAME, mod.UNIT, mod.BETTER, mod.SOURCE, mod.LAYER,
                mod.MOVES) == (m["name"], m["unit"], m["better"], m["source"],
                               m["layer"], m["moves"])
    with pytest.raises(KeyError):
        harness.Cell("no_such.cell", b)


def test_pieces_found_by_name_from_files():
    """Runners, scene generators and metrics are files found by name:
    a name with no file is refused, and no table in a file lists them."""
    with pytest.raises(KeyError, match="runners/no_such.py"):
        harness.runner_class("no_such")
    with pytest.raises(KeyError, match="metrics/no_such.py"):
        harness.metric_module("no_such")
    with pytest.raises(KeyError, match="scenes/no_such.py"):
        scenes.generate({"generator": "no_such"})
    tiny = scenes.generate({"generator": "showcase", "grid": 4,
                            "textured": False})
    assert len(tiny.models) == 49 and tiny.models[0].pos.shape == (32, 3, 3)


def test_profile_keys_the_runner_does_not_run_are_refused():
    cfg = json.loads((ROOT / "benchmark/configs/showcase_tex.json").read_text())
    mix = json.loads((ROOT / "benchmark/mixes/frame.json").read_text())
    cfg["profile"]["tonemap"] = "ACES"
    with pytest.raises(ValueError, match="tonemap"):
        harness.runner_class("frame")(CELL, cfg, mix, 1, torch.device("cpu"),
                                      harness.Spans(), harness.BUILD)


def test_benchmark_json_shape():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert all(name.match(n) for n in names)
    assert len(names) == len(set(names))
    for c in b["configs"]:
        assert Path(ROOT / c["file"]).is_file()
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"


# --- arithmetic -------------------------------------------------------------

def test_ray_accounting():
    cfg = json.loads((ROOT / "benchmark/configs/showcase_tex.json").read_text())
    mix = json.loads((ROOT / "benchmark/mixes/frame.json").read_text())
    drv = harness.runner_class("frame")(CELL, cfg, mix, 1, torch.device("cpu"),
                                        harness.Spans(), harness.BUILD)
    # W*H*(bounces+1) rays a sample.
    assert drv.rays(1) == 1920 * 1080 * 6
    assert drv.rays(37) == 1920 * 1080 * 6 * 37


def test_roofline_arithmetic_on_fixed_counts():
    # 67e9 operations take 1 ms at 67 TFLOP/s; 3.35e9 bytes 1 ms at
    # 3.35 TB/s: the larger bounds.
    assert work.least_seconds(67e9, 1.0) == pytest.approx(1e-3)
    assert work.least_seconds(1.0, 3.35e9) == pytest.approx(1e-3)
    assert work.least_seconds(134e9, 3.35e9) == pytest.approx(2e-3)
    tl = Timeline(
        device=[("void flat_closest_hit_kernel<true>(float*)", 0.0, 0.004),
                ("void at::native::elementwise_kernel<128>", 0.004, 0.005),
                ("void alpha_walk_kernel<float>(float*)", 0.007, 0.009)],
        host=[("aten::nonzero", 0.0049, 0.0071)], window=(0.0, 0.010))
    ctx = dict(timeline=tl, least={"bvh": (1e-3, 2), "walks": (5e-4, 1)},
               traced_samples=1, spans={}, pass_times=[0.5, 0.3, 0.4])
    read = lambda n: harness.metric_module(n).read(ctx)
    assert read("bvh_roofline.frame") == pytest.approx(25.0)
    assert read("walks_roofline.frame") == pytest.approx(25.0)
    assert read("idle_share.frame") == pytest.approx(30.0)
    assert read("hit_kernel_ms_per_sample.frame") == pytest.approx(6.0)
    assert read("aten_ms_per_sample.frame") == pytest.approx(1.0)
    assert read("launches_per_sample.frame") == 3
    assert read("sample_ms_p50.frame") == pytest.approx(400.0)
    assert read("scene_build_s") is None
    # A family the sample never launched reads nothing, never 0.
    ctx["least"] = {}
    assert read("bvh_roofline.frame") is None
    assert tl.idle_gaps()[0] == ["aten::nonzero", pytest.approx(0.002)]
    assert tl.top_ops()[0] == ["flat_closest_hit_kernel", 0.004]


def test_check_numbers():
    ref = np.ones((4, 3), np.float32)
    prog = ref.copy()
    assert check.numbers(prog, ref, 10) == {"err_mean": 0.0, "off_share": 0.0}
    prog[0] = np.nan
    prog[1] *= 2.0
    nums = check.numbers(prog, ref, 10)
    assert nums["off_share"] == 0.5
    assert nums["err_mean"] == pytest.approx((1.0 + 3.0 / 3.1) / 4)
    ok, checked = check.judge(nums, {"err_mean": 1.0, "off_share": 0.4})
    assert not ok and list(checked) == ["err_mean", "off_share"]


# --- the import check ---------------------------------------------------------

def test_forbidden_modules_by_whole_top_level_name():
    mods = {"path_tracer_torch": 0, "path_tracer_torch.ops": 0,
            "benchmark.tests.x": 0, "jaxtyping": 0, "jax.numpy": 0,
            "path_tracer_tpu.ops": 0, "tests.oracle": 0, "chip_smoke": 0}
    assert harness.forbidden_modules(mods) == [
        "chip_smoke", "jax.numpy", "path_tracer_tpu.ops", "tests.oracle"]


def test_run_and_reference_load_nothing_forbidden():
    code = (
        "import sys, time, torch; sys.path.insert(0, %r)\n"
        "from benchmark.reference import tracer\n"
        "assert not [m for m in sys.modules if m.split('.')[0] =="
        " 'path_tracer_torch'], 'the reference imports the program'\n"
        "from benchmark import harness, scenes, check, trace\n"
        "from benchmark.counts import capture, work\n"
        "import benchmark.scenes.showcase\n"
        "harness.runner_class('frame')\n"
        "import path_tracer_torch.models.renderer\n"
        "import path_tracer_torch.scene.device_scene\n"
        "print(harness.forbidden_modules())\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


# --- tiny runs ------------------------------------------------------------------

def test_tiny_run_result_keys_and_correct(tiny_bench):
    r = tiny_run(tiny_bench)
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device",
                       "checked"]
    assert r["correct"] is True and r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["metrics"]) == {"frame_mray_per_s", "setup_s"}
    assert all(m["value"] > 0 for m in r["metrics"].values())
    assert set(r["checked"]) == {"err_mean", "off_share"}


def test_tiny_traced_run(tiny_bench):
    r = tiny_run(tiny_bench, seed=4242, trace=1, seconds=1.0)
    assert r["correct"] is True
    assert "scene_build_s" in r["metrics"]
    assert "sample_ms_p50.frame" in r["metrics"]
    # No device on the CPU: no device-trace metric is reported.
    assert "idle_share.frame" not in r["metrics"]
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert r["device"]["window_s"] > 0
    assert list(r)[-1] == "checked"


def test_tiny_window_of_two_samples_a_pass(tiny_bench):
    """With two samples a pass the window counts samples, not passes, in
    its rate and in what it checks."""
    cell = harness.Cell(CELL, tiny_bench)
    mix = dict(cell.mix, samples_per_pass=2)
    drv = harness.runner_class("frame")(CELL, cell.config, mix, 77,
                                        torch.device("cpu"), harness.Spans(),
                                        harness.BUILD)
    drv.setup()
    win = drv.window(0.5)
    assert drv.samples == 2 * win["attempted"]
    rate = win["metrics"]["frame_mray_per_s"]
    assert rate == pytest.approx(drv.rays(drv.samples) / win["window_s"] / 1e6)
    ok, _ = check.judge(drv.check(), check.limits_of(CELL))
    assert ok


# --- the control and the faults: correct must come out false -------------------

def _patched_run(tiny_bench, monkeypatch, fault):
    from path_tracer_torch.models import renderer

    real = renderer.render_wavefront

    def broken(*a, **kw):
        return fault(real(*a, **kw))

    monkeypatch.setattr(renderer, "render_wavefront", broken)
    return tiny_run(tiny_bench, seed=99, seconds=1.0)


def test_fault_pass_leaves_sums_unchanged(tiny_bench, monkeypatch):
    r = _patched_run(tiny_bench, monkeypatch, torch.zeros_like)
    assert r["correct"] is False


def test_fault_half_the_lanes_left_out(tiny_bench, monkeypatch):
    def half(rad):
        out = rad * 2.0
        out[1::2] = 0.0  # the other half carries the mean
        return out

    assert _patched_run(tiny_bench, monkeypatch, half)["correct"] is False


def test_fault_answer_altered_where_produced(tiny_bench, monkeypatch):
    # Each lane's radiance lands on its neighbour's pixel.
    r = _patched_run(tiny_bench, monkeypatch,
                     lambda rad: torch.roll(rad, 1, dims=0))
    assert r["correct"] is False


def test_control_bfloat16_reference_fails(tiny_bench, monkeypatch):
    """The control: the reference in bfloat16 in the program's place, on
    three seeds, against the cell's limits."""
    for seed in (5, 6, 7):
        args = harness.parse(["--workload", CELL, "--seed", str(seed),
                              "--seconds", "0.5", "--trace", "0"])
        cell = harness.Cell(CELL, tiny_bench)
        drv = harness.runner_class("frame")(
            CELL, cell.config, cell.mix, args.seed, torch.device("cpu"),
            harness.Spans(), harness.BUILD)
        drv.setup()
        drv.window(args.seconds)
        ok, _ = check.judge(drv.check(dtype=torch.bfloat16),
                            check.limits_of(CELL))
        assert ok is False


# --- on the card ------------------------------------------------------------

@pytest.mark.gpu
def test_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELL, "--seed",
         "31", "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] is True and r["device"]["platform"] == "gpu"
