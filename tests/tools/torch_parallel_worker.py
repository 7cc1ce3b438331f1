"""One rank of a world running the port's multi-device paths
(``path_tracer_torch.parallel``), for tests/test_torch_parallel.py (gloo
on the CPU) and tests/test_torch_cuda.py (on the card).

    python tests/tools/torch_parallel_worker.py RANK WORLD RENDEZVOUS \
        SCENE CUBE_ISF OUT_DIR [DEVICE BACKEND]

Joins the group through ``multihost.initialize`` with a ``file://``
rendezvous at RENDEZVOUS on DEVICE (``cpu``, the default, or ``cuda:0``,
which every rank then shares) with BACKEND (``gloo``, the default, or
``nccl``). SCENE is a pickle ({"fields": arrays, "statics": values},
carried across with ``scene.from_numpy``) or ``cornell``, the port's own
Cornell box. Writes OUT_DIR/rank{RANK}.npz: the sharded render (rebalance
off and on), the exchange on a skewed state, ``live_lane_counts`` on
CUBE_ISF, two sharded train steps, ``render_multihost`` and the render
driver's multi-rank route, the errors the paths raise, and the transports
the collectives took. Every rank runs every computation; the test
compares.
"""
from __future__ import annotations

import contextlib
import io
import pickle
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

# tests/test_parallel.py's size and spec.
W, H = 8, 16
BOUNCES = 2


def _spec(**kw):
    from path_tracer_torch.models.integrator import IntegratorSpec

    return IntegratorSpec(bounces=BOUNCES, alpha_walk_steps=2,
                          shadow_walk_steps=2, **kw)


def profile(**kw):
    """The render_multihost profile: three tiles of 48 lanes (the last
    padded), 4 samples in batches of 2."""
    from path_tracer_torch.config import Profile, Resolution

    return Profile(resolution=Resolution(W, H), samples=4, bounces=BOUNCES,
                   alpha_walk_steps=2, shadow_walk_steps=2, tile_rays=48,
                   samples_per_launch=2, **kw)


def skewed_state(rank: int, device="cpu"):
    """tests/test_parallel.py's skewed exchange state in its 4-shard form:
    8 lanes a shard, shard j alive on its first j lanes; every field
    carries the lane's global index so the dealt lanes can be followed."""
    lanes = torch.arange(8 * rank, 8 * rank + 8, dtype=torch.int32,
                         device=device)
    alive = (lanes % 8) < (lanes // 8)
    f3 = lanes.float()[:, None] + torch.tensor([0.0, 0.25, 0.5],
                                               device=device)
    return (f3, f3 + 100.0, f3 + 200.0, f3 + 300.0, alive, lanes, lanes + 1000)


def run(rank: int, world: int, scene, cube) -> dict:
    from path_tracer_torch.models.integrator import IntegratorSpec
    from path_tracer_torch.models.renderer import render
    from path_tracer_torch.parallel import default_mesh, render_sharded
    from path_tracer_torch.parallel.multihost import (
        local_pixel_slice,
        render_multihost,
    )
    from path_tracer_torch.parallel.render import (
        _alive_first_all_to_all,
        live_lane_counts,
    )
    from path_tracer_torch.parallel.train import get_params, make_train_step
    from path_tracer_torch.utils import telemetry

    out = {}
    dev = scene.device
    mesh = default_mesh(world)
    per = W * H // world
    ids = torch.arange(rank * per, (rank + 1) * per, dtype=torch.int32,
                       device=dev)
    spec = _spec()
    out["sharded1"] = render_sharded(scene, mesh, ids, W, H, 1, 1, spec)
    out["sharded2"] = render_sharded(scene, mesh, ids, W, H, 1, 2, spec)
    out["rebalanced2"] = render_sharded(scene, mesh, ids, W, H, 1, 2, spec,
                                        rebalance=True)

    state = skewed_state(rank, dev)
    ex = _alive_first_all_to_all(mesh.get_group(), rank, world)(state)
    for i, x in enumerate(ex):
        out[f"ex{i}"] = x

    cw, ch = 32, 24
    cper = cw * ch // world
    cids = torch.arange(rank * cper, (rank + 1) * cper, dtype=torch.int32,
                        device=dev)
    out["live"] = live_lane_counts(cube, mesh, cids, cw, ch, 3,
                                   IntegratorSpec(bounces=5))

    step = make_train_step(W, H, _spec(differentiable=True), n_samples=1,
                           lr=1e-4, mesh=mesh)
    params = get_params(scene)
    target = torch.zeros((per, 3), device=dev)
    p1, loss1 = step(params, scene, ids, target, 1)
    p2, loss2 = step(p1, scene, ids, target, 1)
    out.update(loss1=loss1, loss2=loss2, albedo1=p1["mat_albedo_factor"],
               albedo2=p2["mat_albedo_factor"])

    out["multihost"] = render_multihost(scene, profile())
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        out["render_route"] = render(scene, profile(samples_per_wavefront=2))
    out["route_printed"] = np.array(printed.getvalue())

    out["mesh_error"] = np.array(_error(lambda: default_mesh(world + 1)))
    out["deal_error"] = np.array(_error(lambda: render_sharded(
        scene, mesh, ids[:6], W, H, 1, 1, spec, rebalance=True)))
    out["slice"] = np.array(local_pixel_slice(10))
    out["transports"] = np.array(sorted(
        ":".join(k.split(".")[1:]) for k in telemetry.counters
        if k.startswith("transport.")))
    return out


def _error(fn) -> str:
    """The message of the ValueError ``fn`` raises ("" if none)."""
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def main(argv) -> None:
    rank, world = int(argv[1]), int(argv[2])
    rdzv, scene_arg, cube_path, out_dir = argv[3:7]
    device = argv[7] if len(argv) > 7 else "cpu"
    backend = argv[8] if len(argv) > 8 else "gloo"
    torch.set_num_threads(1)
    from path_tracer_torch.parallel import multihost
    from path_tracer_torch.scene import from_numpy, load_scene
    from path_tracer_torch.scene.procedural import cornell_device_scene

    dev = multihost.initialize(device, backend=backend,
                               init_method=f"file://{rdzv}",
                               world_size=world, rank=rank)
    try:
        if scene_arg == "cornell":
            scene = cornell_device_scene(dev)
        else:
            with open(scene_arg, "rb") as f:
                carried = pickle.load(f)
            scene = from_numpy(carried["fields"], carried["statics"], dev)
        cube = load_scene(cube_path, dev)
        out = run(rank, world, scene, cube)
    finally:
        dist.destroy_process_group()
    np.savez(Path(out_dir) / f"rank{rank}.npz",
             **{k: v.cpu().numpy() if isinstance(v, torch.Tensor) else v
                for k, v in out.items()})


if __name__ == "__main__":
    main(sys.argv)
