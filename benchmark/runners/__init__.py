"""The runners: what a cell's window drives.

A mix file (``mixes/<traffic>.json``) is data: it names a runner and
gives its parameters. Each runner is a file of its own,
``runners/<runner>.py``, found by that name (``harness.runner_class``).
A new kind of traffic is a new file here; no file that is already there
changes. A runner's file defines ``Runner``, built as
``Runner(cell, config, mix, seed, device, spans, build_dir)``, with:

- ``setup()``: the scene, the kernels, a warm-up of every shape the
  window uses (timed by the harness as set-up);
- ``window(seconds)``: drives the window and returns ``window_s`` (its
  host-clock length, ending in a synchronize), ``attempted`` (units of
  work started), ``unit_times`` (host seconds of each unit) and
  ``metrics`` (the mix's end-to-end metrics but ``setup_s``, by name);
- ``trace(profiled)``: after the window, the traced units under
  ``profiled`` (``trace.py``); returns the per-layer metrics' context:
  ``timeline``, ``least`` (``counts/capture.py``) and the runner's own
  keys;
- ``check(dtype=None)``: the compared numbers of what the window
  produced, against the plain reference, once the program's state is
  freed; ``dtype`` puts the reference in that precision in the
  program's place (the control);
- ``reading(seed, units)`` and ``control_reading(seed, units)``: the
  same numbers for a fresh seed, for ``calibrate.py``.
"""
