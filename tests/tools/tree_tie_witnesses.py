"""The superleaf tree walk (rows 7 and 8) on tie rays against brute-force
Moller-Trumbore and, with --jax, the JAX package's packet kernels, on the
CPU.

The scene is ``duplicate_grid_scene()`` in 128-slot blocks, the rays
``tie_rays(R, seed=S)`` with every 9th lane dead: phase 3n's tie rays
(R = 2^16 - 37, S = 0). Four cases share each lane's brute-force hit:
the closest hit from t_prev -1, from that hit's t (a nearer copy cannot
win; a neighbour an ulp farther can) and the any-hit at t_max 1.5 t and
0.5 t (5 on a miss). The brute force (``intersect.closest_hit_triangles``)
runs the walks' MT arithmetic on every triangle, so a walk that tests the
leaf holding a hit finds it: a lane off the brute force in hit/miss or t
is a leaf its walk did not test (the prim may be another copy at the same
t, which the tie rules decide).

Prints each design's lanes off the brute force per case and, with --jax,
every lane where the port and JAX's packet kernels (``closest_hit_
triangles_packet``, ``occluded_triangles_packet``, interpret mode, in a
fresh interpreter held to SSE4.2 as the CPU tests run them) differ, with
both values, the brute force's and the side it takes; --out writes those
lanes as JSON. --exact-boxes runs the port's walks on the exact node
boxes and intervals (``slab.BOX_PAD_*`` = 0), --cut-widen sets
``native.TREE_WALK_CUT_WIDEN``: the checks that the widenings are needed.

    python tests/tools/tree_tie_witnesses.py --jax --out witnesses.json
    python tests/tools/tree_tie_witnesses.py --exact-boxes --cut-widen 1
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

KINDS = ("centroid", "stack", "edge", "vertex")  # tie_rays' quarters

_JAX_PACKETS = """
import sys
from pathlib import Path
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from path_tracer_tpu.ops.pallas_bvh import (
    closest_hit_triangles_packet, occluded_triangles_packet)
from path_tracer_tpu.scene import isf
from path_tracer_tpu.scene.device_scene import build_device_scene
path, z = Path(sys.argv[1]), np.load(sys.argv[2])
o, d = jnp.asarray(z["o"]), jnp.asarray(z["d"])
scene = build_device_scene(isf.load(path), path.parent, use_bvh=True,
                           sl_block=128)
out = {}
for k in ("tp", "tp_hit"):
    h = closest_hit_triangles_packet(o, d, jnp.asarray(z[k]), scene,
                                     interpret=True)
    out.update({f"{k}_{f}": np.asarray(getattr(h, f))
                for f in ("t", "prim", "kind")})
for k in ("tm_15", "tm_05"):
    out[k] = np.asarray(occluded_triangles_packet(
        o, d, jnp.asarray(z[k]), scene, interpret=True))
np.savez(sys.argv[3], **out)
"""


def _jax_side(path: Path, rays: dict, tmp: Path) -> dict:
    np.savez(tmp / "in.npz", **rays)
    env = dict(os.environ, XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                                      + " --xla_cpu_max_isa=SSE4_2").strip())
    subprocess.run([sys.executable, "-c", _JAX_PACKETS, str(path),
                    str(tmp / "in.npz"), str(tmp / "out.npz")], cwd=REPO,
                   env=env, check=True)
    z = np.load(tmp / "out.npz")
    rec = lambda k: (z[f"{k}_kind"] != 0, z[f"{k}_t"], z[f"{k}_prim"])
    return {"closest": rec("tp"), "from the hit": rec("tp_hit"),
            "any-hit 1.5 t": z["tm_15"], "any-hit 0.5 t": z["tm_05"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rays", type=int, default=2**16 - 37)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--jax", action="store_true")
    ap.add_argument("--exact-boxes", action="store_true")
    ap.add_argument("--cut-widen", type=float, default=None)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)

    from path_tracer_torch import native
    from path_tracer_torch.ops import slab

    if args.exact_boxes:
        slab.BOX_PAD_EXT = slab.BOX_PAD_MAG = slab.BOX_PAD_T = 0.0
    if args.cut_widen is not None:
        native.TREE_WALK_CUT_WIDEN = args.cut_widen
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        return _run(args, Path(tmp), t0)


def _run(args, tmp: Path, t0: float) -> int:
    from path_tracer_torch import native
    from path_tracer_torch.ops import cuda_bvh, intersect
    from path_tracer_torch.scene import isf, load_scene
    from path_tracer_torch.scene.procedural import (
        duplicate_grid_scene,
        tie_rays,
    )

    path = tmp / "scene.isf"
    isf.save(duplicate_grid_scene(), path)
    sc = load_scene(path, "cpu", use_bvh=True, sl_block=128)
    o, d = tie_rays(args.rays, seed=args.seed)
    r = o.shape[0]
    tp = np.full(r, -1.0, np.float32)
    tp[::9] = np.inf
    T = torch.from_numpy
    brute = intersect.closest_hit_triangles(T(o), T(d), T(tp), sc)
    hit, t_hit = brute.valid.numpy(), brute.t.numpy()
    rays = {"o": o, "d": d, "tp": tp,
            "tp_hit": np.where(hit, t_hit, tp).astype(np.float32)}
    for key, k in (("tm_15", 1.5), ("tm_05", 0.5)):
        rays[key] = np.where(np.isfinite(tp), np.where(hit, t_hit * k, 5.0),
                             -1.0).astype(np.float32)
    want, port = {}, {}
    for case, g in (("closest", "tp"), ("from the hit", "tp_hit")):
        b = intersect.closest_hit_triangles(T(o), T(d), T(rays[g]), sc)
        w = cuda_bvh.closest_hit_triangles_tree_plain(T(o), T(d),
                                                      T(rays[g]), sc)
        want[case] = (b.valid.numpy(), b.t.numpy(), b.prim.numpy())
        port[case] = (w.valid.numpy(), w.t.numpy(), w.prim.numpy())
    for case, g in (("any-hit 1.5 t", "tm_15"), ("any-hit 0.5 t", "tm_05")):
        tm = rays[g]
        want[case] = (hit & (t_hit <= tm)) | (tm < 0)
        port[case] = cuda_bvh.occluded_triangles_tree_plain(
            T(o), T(d), T(tm), sc).numpy()
    designs = {"port": port}
    if args.jax:
        designs["jax"] = _jax_side(path, rays, tmp)

    def off(x, w) -> np.ndarray:
        if isinstance(w, tuple):
            return (x[0] != w[0]) | (w[0] & (x[1] != w[1]))
        return x != w

    def value(x, i):
        if isinstance(x, tuple):
            return (f"hit t={float(x[1][i])!r} prim={int(x[2][i])}"
                    if x[0][i] else "miss")
        return "occluded" if x[i] else "open"

    print(f"tie rays: {r} lanes (seed {args.seed}, every 9th dead), "
          f"exact boxes {args.exact_boxes}, cut widen "
          f"{native.TREE_WALK_CUT_WIDEN!r}")
    for case in want:
        print(f"  {case}: lanes off brute force " + ", ".join(
            f"{k} {int(off(v[case], want[case]).sum())}"
            for k, v in designs.items()))
    witnesses = []
    if args.jax:
        for case in want:
            p, j, w = port[case], designs["jax"][case], want[case]
            # Another copy at the same t is no difference.
            diff = ((p[0] != j[0]) | (p[0] & (p[1] != j[1]))
                    if isinstance(p, tuple) else p != j)
            for i in np.nonzero(diff)[0]:
                po, jo = bool(off(p, w)[i]), bool(off(j, w)[i])
                side = "both off" if po and jo else (
                    "jax" if po else "port")
                witnesses.append({
                    "case": case, "lane": int(i),
                    "kind": KINDS[min(3, i // (r // 4))],
                    "port": value(p, i), "jax": value(j, i),
                    "brute": value(w, i), "brute force sides with": side})
        print(f"  lanes where the port and JAX's packet kernels differ: "
              f"{len(witnesses)}")
        for w in witnesses:
            print(f"    {w['case']}, lane {w['lane']} ({w['kind']}): port "
                  f"{w['port']}; JAX {w['jax']}; brute force {w['brute']}"
                  f" -> {w['brute force sides with']}")
    if args.out:
        args.out.write_text(json.dumps(witnesses, indent=1))
    print(f"  ({time.perf_counter() - t0:.1f} s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
