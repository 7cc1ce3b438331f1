"""Run one cell of the benchmark of ``path_tracer_torch``.

    python3 benchmark/run.py --workload showcase_tex.frame --seed 7 \
        --seconds 20 --trace 0

Needs a CUDA device (it exits non-zero without one, printing no result).
See ``benchmark/README.md``.
"""
import sys
import time

T_START = time.perf_counter()

if __name__ == "__main__":
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from benchmark.harness import main

    sys.exit(main(sys.argv[1:], T_START))
