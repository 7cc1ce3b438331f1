"""Multi-process setup and the multi-process render.

Port of ``path_tracer_tpu/parallel/multihost.py``. One process per device,
all in one ``torch.distributed`` process group, whether the devices sit
in one host or several: pixel tiles shard over the group's ranks, the
scene is copied to every rank, and the only traffic is the gradient sum
of a training step and the gather of a render's radiance sums.

Usage in each process (under ``torchrun``, or with an explicit rendezvous)::

    from path_tracer_torch.parallel import multihost
    device = multihost.initialize()     # torchrun's environment
    mesh = multihost.global_mesh()      # 1-D mesh over every rank
    image = multihost.render_multihost(scene, profile)
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from path_tracer_torch.parallel.mesh import (
    DP_AXIS,
    all_gather_into_tensor,
    default_mesh,
    mesh_rank,
)


def initialize(device="cuda", backend: str | None = None,
               init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None) -> torch.device:
    """Join the process group and return this rank's device.

    ``backend`` defaults to ``nccl`` for a CUDA device and ``gloo`` for
    the CPU. The rendezvous is ``torchrun``'s environment (``env://``:
    ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``) unless
    ``init_method`` (``tcp://host:port``, ``file:///path``) is given with
    ``world_size`` and ``rank``. A ``cuda`` device without an index
    becomes ``cuda:LOCAL_RANK`` and is made current; without a card,
    asking for ``cuda`` raises."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device}: no CUDA device is "
                               "available")
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    elif dev.type != "cpu":
        raise RuntimeError(f"device {device}: only cuda and cpu are "
                           "supported")
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    kwargs = {}
    if init_method is not None:
        kwargs = dict(init_method=init_method, world_size=world_size,
                      rank=rank)
    dist.init_process_group(backend, **kwargs)
    return dev


def global_mesh(axis_name: str = DP_AXIS):
    """1-D mesh over every rank of the group (all hosts)."""
    return default_mesh(None, axis_name)


def local_pixel_slice(n_pix: int) -> tuple:
    """(start, stop) of this rank's contiguous range of a flat wavefront
    of ``n_pix`` ids split over the group; the last rank takes the
    remainder."""
    n_proc = dist.get_world_size() if dist.is_initialized() else 1
    pid = dist.get_rank() if dist.is_initialized() else 0
    per = n_pix // n_proc
    start = pid * per
    stop = n_pix if pid == n_proc - 1 else start + per
    return start, stop


def render_multihost(scene, profile, mesh=None) -> np.ndarray:
    """The multi-process render: every rank of the mesh calls this with
    the same scene and profile and receives the full [H,W,3] uint8 image.

    Each tile (``tile_rays`` lanes, rounded up to a multiple of the mesh
    size) splits into one contiguous slice per rank; padding lanes render
    pixel 0 and are discarded. Samples run in batches of
    ``samples_per_launch``, added into each rank's sums sample by sample
    in sample order, and each tile's sums are gathered onto every rank.
    The image is bit-identical to a one-process ``render()``: a pixel's
    radiance does not depend on the lane or rank that renders it. With one
    process and no mesh this is the ordinary ``render()``."""
    from path_tracer_torch.models.renderer import (
        finalize,
        integrator_spec,
        render,
    )
    from path_tracer_torch.parallel.render import render_sharded

    if mesh is None and (not dist.is_initialized()
                         or dist.get_world_size() == 1):
        return render(scene, profile)
    if mesh is None:
        mesh = global_mesh()
    group, me, n_dev = mesh_rank(mesh)
    width, height = profile.resolution.width, profile.resolution.height
    n_pix = width * height
    spec = integrator_spec(profile)
    tile = min(profile.tile_rays, n_pix)
    tile = -(-tile // n_dev) * n_dev  # device-divisible lanes
    per = tile // n_dev
    n_tiles = -(-n_pix // tile)
    spl = max(1, profile.samples_per_launch)
    dev = scene.device

    rows = np.zeros((n_tiles * tile, 3), np.float32)
    for t in range(n_tiles):
        g0 = t * tile
        ids = torch.arange(g0 + me * per, g0 + (me + 1) * per,
                           dtype=torch.int32, device=dev)
        ids[ids >= n_pix] = 0
        acc = torch.zeros((per, 3), device=dev)
        done = 0
        while done < profile.samples:
            k = min(spl, profile.samples - done)
            render_sharded(scene, mesh, ids, width, height, 1 + done, k, spec,
                           acc=acc)
            done += k
        # This tile's sums, replicated onto every rank.
        rows[g0:g0 + tile] = all_gather_into_tensor(acc, group).cpu().numpy()
    return finalize(rows[:n_pix], profile.samples, profile, width, height)
