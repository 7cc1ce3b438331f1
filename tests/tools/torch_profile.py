"""Where the time goes in one 1080p sample of the PyTorch port, on the card.

    python tests/tools/torch_profile.py [scene ...]   (default: cube spheres
                                                       reflection showcase
                                                       showcase_tex)

For each scene: one warm-up sample, then one sample (every 2^18-lane tile
of a 1920x1080 frame) under ``torch.profiler``: 4 bounces for the
reference scenes of ``tests/scenes``, 5 for ``showcase`` (the plain
100k-triangle showcase in 256-slot blocks, as the JAX bench renders it
with ``BENCH_SCENE=showcase_plain``), ``showcase_tex`` (the textured
showcase, the JAX bench's default scene), ``showcase_tex704`` (the
textured showcase at grid 704: 991,834 triangles, the flat2 walk) and
``sphere_grid70`` (4,900 spheres, the sphere block walk). Prints the wall
time (host clock around work that ends in a synchronize), the summed device
time of all kernels, the device busy share (device time / wall; kernels
run on one stream, so they do not overlap), the number of kernel launches,
and the top kernels by device time. Only device-side events are counted
(the aten ops that launch them carry the same time again). Needs a CUDA
device; imports no JAX.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def profile_scene(name: str, top: int = 14) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from path_tracer_torch.models.integrator import IntegratorSpec
    from path_tracer_torch.models.renderer import render_pixel_sums
    from path_tracer_torch.scene import load_scene

    device = torch.device("cuda", 0)
    if name in ("showcase", "showcase_tex", "showcase_tex704"):
        from path_tracer_torch.scene.showcase import showcase_device_scene

        scene = showcase_device_scene(704 if name.endswith("704") else 224,
                                      device, sl_block=256,
                                      textured=name != "showcase")
        spec = IntegratorSpec(bounces=5)
    elif name == "sphere_grid70":
        from path_tracer_torch.scene.procedural import (
            sphere_grid_device_scene,
        )

        scene = sphere_grid_device_scene(70, device)
        spec = IntegratorSpec(bounces=5)
    else:
        scene = load_scene(REPO / "tests" / "scenes" / name / "scene.isf",
                           device)
        spec = IntegratorSpec(bounces=4)
    render_pixel_sums(scene, 1920, 1080, 1, 1, spec, tile_rays=1 << 18)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render_pixel_sums(scene, 1920, 1080, 2, 1, spec, tile_rays=1 << 18)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    dev_us = sum(e.self_device_time_total for e in kernels)
    n_launch = sum(e.count for e in kernels)
    print(f"{name}: wall {wall * 1e3:.1f} ms, device {dev_us / 1e3:.1f} ms, "
          f"busy {dev_us / 1e3 / (wall * 1e3):.3f}, kernel launches "
          f"{n_launch}", flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"    {e.self_device_time_total / 1e3:9.2f} ms "
              f"{100 * e.self_device_time_total / dev_us:5.1f}% "
              f"x{e.count:<6d} {e.key[:90]}")


def main(names) -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    for name in names:
        profile_scene(name)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or ["cube", "spheres", "reflection",
                                   "showcase", "showcase_tex"]))
