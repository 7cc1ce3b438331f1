"""The comparison that decides a run's ``correct``.

A frame cell's timed path leaves each pixel's radiance summed over the
window's sample ids. Once the window has closed and the program's state is
freed, the frame runner's ``check`` takes a sample of pixels drawn from
the seed, traces the same (pixel, sample id) paths with the plain
reference (``reference/tracer.py``: brute-force intersection, no table
of the program's), sums them sample by sample, and compares:

- ``err_mean``: the mean over the pixels of the relative gap
  |program - reference|_1 / (|reference|_1 + 0.01 n), clipped to 1
  (a missing or NaN value counts 1), n the samples summed;
- ``off_share``: the share of those pixels whose gap passes ``OFF``.

A path whose hit, alpha or shadow decision flips on a rounding (a ray
through an edge, a uniform against an opacity) ends elsewhere, so a few
pixels differ by a whole path; the rest agree to float rounding. The
limits of each cell (``limits/<cell>.json``) were set from the program's
readings and the control's. The precision is float32: the program and
the reference compute in it. The control is the reference in bfloat16,
the precision below float32 (TF32 would touch only matmuls, and the path
has none), in the program's place.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

OFF = 0.01
LIMITS = Path(__file__).resolve().parent / "limits"


def pixel_gaps(prog: np.ndarray, ref: np.ndarray, n_samples: int) -> np.ndarray:
    """[P] relative gap of each pixel's sums, in [0, 1]."""
    prog = np.asarray(prog, np.float64)
    ref = np.asarray(ref, np.float64)
    with np.errstate(invalid="ignore", over="ignore"):
        gap = np.abs(prog - ref).sum(1) / (np.abs(ref).sum(1)
                                           + 0.01 * n_samples)
    return np.where(np.isfinite(gap), np.minimum(gap, 1.0), 1.0)


def numbers(prog, ref, n_samples: int) -> dict:
    gap = pixel_gaps(prog, ref, n_samples)
    return {"err_mean": float(gap.mean()),
            "off_share": float((gap > OFF).mean())}


def check_pixels(seed: int, n_pix: int, count: int) -> np.ndarray:
    """The pixels a run compares, drawn from its seed, ascending."""
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(n_pix, size=min(count, n_pix), replace=False))


def limits_of(cell: str) -> dict:
    """{number: limit} of a cell."""
    return json.loads((LIMITS / f"{cell}.json").read_text())["limits"]


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): each number at or under its
    limit."""
    checked = {k: {"value": values[k], "limit": limits[k]} for k in limits}
    ok = all(np.isfinite(v["value"]) and v["value"] <= v["limit"]
             for v in checked.values())
    return ok, checked
