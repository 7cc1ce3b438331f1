"""Capture the inputs of the hand-written kernels' launches in a traced pass.

``Capture`` wraps the program's kernel entry points (``ops/cuda_bvh.py``'s
flat and flat2 closest hit and any-hit, ``ops/cuda_trwalk.py``'s two walks)
for the length of a ``with`` block and keeps each launch's inputs and
outputs; the wrappers add no device work. ``least_seconds()`` then counts
each family's least time (``work.py``) after the traced pass. Only the
traced run installs it.
"""
from __future__ import annotations

from benchmark.counts import work

# Family of each wrapped entry point, and the kernel it launches (the
# identifier in the profiler's kernel name).
ENTRIES = {
    ("cuda_bvh", "closest_hit_triangles_flat"): ("bvh", "flat_closest_hit_kernel"),
    ("cuda_bvh", "occluded_triangles_flat_multi"): ("bvh", "flat_occluded_kernel"),
    ("cuda_bvh", "closest_hit_triangles_flat2"): ("bvh", "flat2_closest_hit_kernel"),
    ("cuda_bvh", "occluded_triangles_flat2_multi"): ("bvh", "flat2_occluded_kernel"),
    ("cuda_trwalk", "alpha_walk"): ("walks", "alpha_walk_kernel"),
    ("cuda_trwalk", "trans_walk"): ("walks", "trans_walk_kernel"),
}


def kernels_of(family: str) -> tuple:
    return tuple(k for f, k in ENTRIES.values() if f == family)


class Capture:
    def __init__(self):
        self.calls = []  # (entry name, args, kwargs, result)
        self._saved = []

    def __enter__(self):
        import importlib

        for (mod_name, fn_name) in ENTRIES:
            mod = importlib.import_module(f"path_tracer_torch.ops.{mod_name}")
            orig = getattr(mod, fn_name)
            self._saved.append((mod, fn_name, orig))
            setattr(mod, fn_name, self._wrap(fn_name, orig))
        return self

    def __exit__(self, *exc):
        for mod, fn_name, orig in self._saved:
            setattr(mod, fn_name, orig)
        self._saved.clear()
        return False

    def _wrap(self, name, orig):
        def wrapped(*args, **kwargs):
            out = orig(*args, **kwargs)
            self.calls.append((name, args, kwargs, out))
            return out
        return wrapped

    def least_seconds(self) -> dict:
        """{family: (least seconds summed over its launches, launches)}."""
        import torch

        from path_tracer_torch.ops.intersect import stacked

        out = {}

        def add(family, sec):
            s, n = out.get(family, (0.0, 0))
            out[family] = (s + sec, n + 1)

        with torch.no_grad():
            for name, a, kw, res in self.calls:
                if name.startswith("closest_hit_triangles_flat"):
                    o, d, t_prev, sc = a[:4]
                    spheres = bool(kw.get("spheres", a[4] if len(a) > 4
                                          else False))
                    add("bvh", work.closest_least(
                        o, d, t_prev, sc, res.t, spheres,
                        two_level=name.endswith("flat2")))
                elif name.startswith("occluded_triangles_flat"):
                    o, ds, tms, sc = a[:4]
                    add("bvh", work.occluded_least(
                        o, stacked(ds), stacked(tms), sc, res,
                        two_level=name.endswith("flat2_multi")))
                elif name == "alpha_walk":
                    sc, o, d, t_op, rnd, cap = a[:6]
                    add("walks", work.alpha_least(sc, o, d, t_op,
                                                  rnd[:cap]))
                elif name == "trans_walk":
                    sc, o, d, pd = a[:4]
                    add("walks", work.trans_least(sc, o, d, pd, a[8]))
        return out
