"""Sharded wavefront rendering: pixel tiles over the ranks of a mesh.

Port of ``path_tracer_tpu/parallel/render.py``. Each rank renders its
shard of the flat pixel-id wavefront against its own copy of the scene:
the RNG is counter-based per (pixel, sample) and every RNG draw keys off
the lane's travelling pixel id, so the radiance of a pixel does not
depend on the rank or the lane that renders it, and the concatenated
shards equal a one-process render bit for bit (with rebalancing too).
"""
from __future__ import annotations

import torch

from path_tracer_torch.models.integrator import IntegratorSpec, render_wavefront
from path_tracer_torch.parallel.mesh import (
    all_gather_into_tensor,
    all_to_all_single,
    mesh_rank,
)


def render_sharded(scene, mesh, pixel_ids, width: int, height: int,
                   sample_start: int, n_samples: int, spec: IntegratorSpec,
                   rebalance: bool = False,
                   acc: torch.Tensor | None = None) -> torch.Tensor:
    """Radiance **sums** [R/n, 3] over ``n_samples`` sample ids from
    ``sample_start`` of this rank's ``pixel_ids`` [R/n] (every rank of the
    mesh calls it with its own shard; the caller divides by the samples).
    ``acc``, given, is added into sample by sample, in place, and
    returned, as the one-process render driver accumulates.

    ``rebalance=True`` turns on cross-shard live-ray rebalancing: before
    every bounce each rank sorts its lanes alive-first, deals them round
    robin into one group per rank and exchanges the groups
    (``_alive_first_all_to_all``), so live lanes per rank equalize to the
    mean; the radiance is routed home by each lane's origin at the end
    and is the same bit for bit."""
    group, me, n = mesh_rank(mesh)
    r_local = pixel_ids.shape[0]
    dev = pixel_ids.device
    if acc is None:
        acc = torch.zeros((r_local, 3), device=dev)
    for k in range(n_samples):
        if not rebalance:
            acc += render_wavefront(scene, pixel_ids, width, height,
                                    sample_start + k, spec)
            continue
        lane_ids = me * r_local + torch.arange(r_local, dtype=torch.int32,
                                               device=dev)
        color, orig = render_wavefront(
            scene, pixel_ids, width, height, sample_start + k, spec,
            exchange=_alive_first_all_to_all(group, me, n),
            lane_ids=lane_ids)
        # Route each lane's radiance back to its home (rank, slot): gather
        # every rank's (color, orig) and keep the rows homed here (each
        # home slot receives exactly one lane; the rest land in a spare).
        allc = all_gather_into_tensor(color, group)
        allo = all_gather_into_tensor(orig, group).long()
        slot = torch.where(allo // r_local == me, allo % r_local, r_local)
        rad = torch.zeros((r_local + 1, 3), device=dev)
        rad[slot] = allc
        acc += rad[:r_local]
    return acc


def _alive_first_all_to_all(group, me: int, n_shards: int):
    """The per-bounce exchange hook for render_wavefront.

    Each rank sorts its lanes alive-first (stable), deals them round robin
    into ``n_shards`` interleaved groups and sends group g to rank g. The
    deal is rotated by the source rank (its sorted lane i lands in group
    (i + me) mod n), so the +-1 remainders rotate across destinations and
    every rank ends within one lane of the mean live count."""

    def exchange(state):
        alive = state[4]
        perm = torch.argsort((~alive).to(torch.uint8), stable=True)
        state = tuple(x[perm] for x in state)
        if n_shards == 1:
            return state
        r_local = alive.shape[0]
        if r_local % n_shards:
            raise ValueError(
                f"live-ray rebalancing needs the per-shard wavefront "
                f"({r_local} lanes) divisible by the mesh size ({n_shards}) "
                f"— the round-robin deal would otherwise drop lanes; pad R "
                f"to a multiple of mesh_size**2 or disable rebalance")
        dev = alive.device
        g = torch.arange(n_shards, device=dev)[:, None]
        k = torch.arange(r_local // n_shards, device=dev)[None, :]
        deal = ((g - me) % n_shards) + k * n_shards  # [n, r/n] sorted idx
        flat = deal.reshape(-1)
        # Group g (deal[g], contiguous) goes to rank g; the received groups
        # stack in source-rank order.
        return tuple(all_to_all_single(x[flat], group) for x in state)

    return exchange


def live_lane_counts(scene, mesh, pixel_ids, width: int, height: int,
                     sample_id: int, spec: IntegratorSpec) -> torch.Tensor:
    """[n_shards, bounces + 1] int32 on every rank: the live lanes of each
    rank's shard ``pixel_ids`` at the start of each bounce of one
    un-rebalanced sample (the imbalance rebalancing removes)."""
    group, _, _ = mesh_rank(mesh)
    _, live = render_wavefront(scene, pixel_ids, width, height, sample_id,
                               spec, collect_live_counts=True)
    return all_gather_into_tensor(live[None, :], group)
