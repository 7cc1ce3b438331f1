"""Lint gate for the port: the repo's stdlib linter (tests/tools/lint.py,
whose own roots predate the port) over ``path_tracer_torch`` and
``chip_smoke.py``."""
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def test_port_is_lint_clean():
    sys.path.insert(0, str(REPO / "tests" / "tools"))
    from lint import lint_file, lint_tree

    problems = lint_tree(REPO / "path_tracer_torch")
    problems += lint_file(REPO / "chip_smoke.py")
    assert problems == [], "\n".join(problems)
