"""The benchmark's harness: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is looked up in ``BENCHMARK.json``: its configuration file, its
traffic mix (``mixes/<traffic>.json``, data that names a runner,
``runners/<runner>.py``) and the metrics it reports. Every piece is found
by its name, so a new cell, mix, runner, scene generator or metric is a
new file and edits none. A run sets up (the span from
the process's start to the window is ``setup_s``), drives the window for
``--seconds``, and checks what the window produced against the plain
reference (``check.py``). With ``--trace 0`` it reports the cell's
end-to-end metrics; with ``--trace 1`` its per-layer metrics, each read by
its own file ``metrics/<name>.py`` from the run's spans, pass times,
device timeline and kernel counts. The last line of standard output is
the result as one JSON object.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
BUILD = ROOT / "build" / "benchmark"
# Top-level modules that must not be loaded in a run: JAX and the JAX
# package, and the repository's scripts and tests.
FORBIDDEN = ("jax", "jaxlib", "flax", "path_tracer_tpu", "bench",
             "chip_smoke", "tests")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is forbidden, compared whole
    (``path_tracer_torch`` is not ``path_tracer_tpu``)."""
    modules = sys.modules if modules is None else modules
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


class Cell:
    """A workload of ``BENCHMARK.json`` and what it names."""

    def __init__(self, name: str, bench: dict | None = None):
        bench = bench or load_json(ROOT / "BENCHMARK.json")
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = cells[name]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = load_json(ROOT / configs[self.entry["config"]]["file"])
        self.config.setdefault("name", self.entry["config"])
        self.mix = load_json(BENCH / "mixes" / f"{self.entry['traffic']}.json")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        e2e_names = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [])
                          or ("workloads" not in m and m["moves"] in e2e_names)]

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])


def load_file(kind: str, name: str):
    """The module ``<kind>/<name>.py`` of the benchmark (names may hold
    dots)."""
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no file benchmark/{kind}/{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_module(name: str):
    """The reader ``metrics/<name>.py``."""
    return load_file("metrics", name)


def runner_class(name: str):
    """The ``Runner`` of ``runners/<name>.py``."""
    return load_file("runners", name).Runner


class Spans:
    """Named host-clock spans of the benchmark's own calls into the
    program's layers (seconds, kept in memory)."""

    def __init__(self):
        self.seconds = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] = (self.seconds.get(name, 0.0)
                                  + time.perf_counter() - t0)


def log(msg: str) -> None:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def set_environment() -> None:
    """Before torch is imported: every build and kernel cache inside the
    checkout, at fixed paths (the program's own nvcc and g++ builds live
    in build/path_tracer_torch of the checkout already), and one CPU
    thread for torch's and OpenMP's pools, so that idle pool threads do
    not take the core of the thread that launches the kernels (runs
    spread less)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["OMP_NUM_THREADS"] = "1"


def device_info(torch, chips: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(i)
                                         for i in range(chips)))}


def run(args, t_start: float, device=None, bench=None, spans=None) -> dict:
    """One run; returns the result object. ``device`` None: the first
    CUDA device, which must be there (tests pass the CPU, with the
    kernels' plain versions, and ``bench``, a BENCHMARK.json object of
    their own). ``spans``: the run's spans so far."""
    import torch

    from benchmark.check import judge, limits_of
    from benchmark.trace import profiled

    cell = Cell(args.workload, bench)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            raise SystemExit(f"benchmark: {cell.chips} CUDA device(s) needed, "
                             f"{torch.cuda.device_count()} found")
        device = torch.device("cuda", 0)
    spans = spans or Spans()
    runner = runner_class(cell.mix["runner"])
    drv = runner(cell.name, cell.config, cell.mix, args.seed, device, spans,
                 BUILD)
    drv.setup()
    setup_s = time.perf_counter() - t_start
    win = drv.window(args.seconds)
    dev = (device_info(torch, cell.chips) if device.type == "cuda"
           else {"platform": "cpu", "kind": "cpu", "count": 1,
                 "memory_peak_bytes": 0})
    result = {"correct": False, "attempted": win["attempted"], "failed": 0,
              "metrics": {}, "device": dev}
    if args.trace:
        ctx = dict(spans=spans.seconds, window=win, **drv.trace(profiled))
        tl = ctx["timeline"]
        for m in cell.per_layer:
            value = metric_module(m["name"]).read(ctx)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}
        dev["busy_s"] = tl.busy_s()
        dev["window_s"] = tl.window_s
        result["breakdown"] = {"device_ops": tl.top_ops(),
                               "idle_gaps": tl.idle_gaps()}
    else:
        e2e = dict(win["metrics"], setup_s=setup_s)
        for m in cell.end_to_end:
            result["metrics"][m["name"]] = {"value": e2e[m["name"]],
                                            "unit": m["unit"]}
    t_check = time.perf_counter()
    ok, checked = judge(drv.check(), limits_of(cell.name))
    pt = sorted(win["unit_times"]) or [0.0]
    log(f"spans {json.dumps(spans.seconds)}; window {win['window_s']:.3f} s, "
        f"{win['attempted']} units (s a unit: min {pt[0]:.4f}, median "
        f"{pt[len(pt) // 2]:.4f}, max {pt[-1]:.4f}); check "
        f"{time.perf_counter() - t_check:.1f} s")
    result["correct"] = ok
    result["checked"] = checked
    return result


def main(argv, t_start: float) -> int:
    args = parse(argv)
    set_environment()
    spans = Spans()
    with spans("import_torch"):
        import torch
    torch.set_num_threads(1)
    result = run(args, t_start, spans=spans)
    found = forbidden_modules()
    if found:
        print("benchmark: loaded forbidden modules: " + ", ".join(found),
              file=sys.stderr)
        return 4
    for name, c in result["checked"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0

