"""Readings that a cell's limits are set from, in one process on the card.

    python3 benchmark/calibrate.py --workload showcase_tex.frame \
        --units 120 --seeds 1,2,3 --control-seeds 4,5,6 --out readings.json

Sets the cell up once through its runner (``runners/<runner>.py``). For
each of ``--seeds``: the program does ``--units`` units of the window's
work (samples of the frame runner) from the seed through the window's
own call, and the runner's compared numbers are read against the plain
reference (``Runner.reading``). For each of ``--control-seeds``: the
control, the reference in the precision below the configuration's in the
program's place (``Runner.control_reading``). Writes every reading, with
the card's name and power limit, to ``--out``. The benchmark's runs never
run this.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--units", type=int, required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from benchmark import harness

    harness.set_environment()
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        raise SystemExit("calibrate: no CUDA device")
    cell = harness.Cell(args.workload)
    drv = harness.runner_class(cell.mix["runner"])(
        cell.name, cell.config, cell.mix, 0, torch.device("cuda", 0),
        harness.Spans(), harness.BUILD)
    drv.setup()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    out = {"workload": cell.name, "units": args.units, "card": smi,
           "program": [], "control": []}
    for key, read, seeds in (("program", drv.reading, args.seeds),
                             ("control", drv.control_reading,
                              args.control_seeds)):
        for seed in [int(s) for s in seeds.split(",") if s]:
            out[key].append(dict(seed=seed, **read(seed, args.units)))
            print(json.dumps(out[key][-1]), flush=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
