"""The 1-D device mesh of pixel-tile data parallelism, and the collectives
the sharded paths run over it.

Port of ``path_tracer_tpu/parallel/mesh.py``. PyTorch runs one process
per device, so the JAX package's single-process mesh and its multi-host
mesh both become one ``torch.distributed`` process group with one rank
per device (``parallel/multihost.py`` starts it), and a mesh is a 1-D
``DeviceMesh`` over its ranks whose dimension is named ``"dp"``. Each rank
runs on its own shard what ``shard_map``'s local function runs: plain
tensors, with the collectives below over the mesh's group.

Transport. NCCL takes CUDA tensors for every collective here, and so
does gloo (PyTorch 2.11 on an H100: ``all_reduce``, ``all_to_all_single``
and ``all_gather_into_tensor``, bool included), which copies them through
host memory itself; gloo on the CPU takes CPU tensors. So every collective
gets its tensors as they are, and each call is counted in
``utils.telemetry.counters`` as ``transport.<collective>.<backend>.<device
type>``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from path_tracer_torch.utils.telemetry import counters

DP_AXIS = "dp"


def default_mesh(n_devices: int | None = None, axis_name: str = DP_AXIS):
    """1-D mesh over the first ``n_devices`` ranks of the process group
    (all by default); collective over the whole group. Its device type is
    ``cuda`` under NCCL and ``cpu`` otherwise. Raises ``ValueError`` when
    asked for more devices than there are ranks."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("default_mesh needs a process group: call "
                           "parallel.multihost.initialize() first")
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if n_devices > world:
        raise ValueError(
            f"requested {n_devices} devices but only {world} available")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, list(range(n_devices)),
                      mesh_dim_names=(axis_name,))


def mesh_rank(mesh) -> tuple:
    """(group, this rank's index on the 1-D mesh, mesh size); raises
    where this process is not on the mesh."""
    if mesh.get_coordinate() is None:
        raise ValueError(f"rank {dist.get_rank()} is not on the mesh "
                         f"{mesh.mesh.tolist()}")
    return mesh.get_group(), mesh.get_local_rank(), mesh.size()


def _count(name: str, group, t: torch.Tensor) -> None:
    counters[f"transport.{name}.{dist.get_backend(group)}.{t.device.type}"] \
        += 1


def all_to_all_single(inp: torch.Tensor, group) -> torch.Tensor:
    """``inp`` [n * m, ...]: chunk g of m rows goes to rank g of
    ``group``; returns the chunks received, in rank order."""
    inp = inp.contiguous()
    _count("all_to_all_single", group, inp)
    out = torch.empty_like(inp)
    dist.all_to_all_single(out, inp, group=group)
    return out


def all_gather_into_tensor(inp: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``inp`` [m, ...] stacked along dim 0 in rank order:
    [n * m, ...] on every rank."""
    inp = inp.contiguous()
    _count("all_gather_into_tensor", group, inp)
    out = inp.new_empty((dist.get_world_size(group) * inp.shape[0],
                         *inp.shape[1:]))
    dist.all_gather_into_tensor(out, inp, group=group)
    return out


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``t`` over ``group``, on every rank (a new
    tensor; ``t`` is left as it is)."""
    _count("all_reduce", group, t)
    out = t.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out
