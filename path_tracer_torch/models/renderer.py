"""Render driver: tiles x samples loop around the wavefront integrator.

Port of ``path_tracer_tpu/models/renderer.py``: pixels are fed in the
host-computed Morton (16x16 screen tile) order, cut into tiles
of ``tile_rays`` lanes (the last tile padded with pixel 0, discarded), and
each tile's float32 radiance sum is accumulated sample by sample in sample
order, exactly as the JAX package sums, in pass batches of
``samples_per_launch`` samples. With ``samples_per_wavefront`` (spw) > 1
every packet of ``RAY_TILE`` lanes holds ``RAY_TILE/spw`` consecutive
pixels times spw consecutive sample ids, so a kernel's warp or CTA covers
a smaller patch of the screen; the RNG streams are those of spw = 1 and
only the float summation order changes.

Accumulators stay on the device. The only host transfers are the final
[W*H,3] sum, a resumed render's starting sums, and the snapshot a pass
callback asks for (the viewer, checkpoints).

In a process group of more than one rank (``parallel/multihost.py``) the
driver takes the JAX package's multi-device route: the tile is rounded up
to a multiple of the world size, each rank renders its contiguous slice of
every tile through ``parallel.render.render_sharded``, and a snapshot
gathers the slices onto every rank (every rank must then take part in
each snapshot).
"""
from __future__ import annotations

import inspect
import time

import numpy as np
import torch
import torch.distributed as dist

from path_tracer_torch.config import Profile
from path_tracer_torch.models.integrator import IntegratorSpec, render_wavefront
from path_tracer_torch.ops import tonemap as tm
from path_tracer_torch.ops.sorting import morton_pixel_order
from path_tracer_torch.parallel.mesh import all_gather_into_tensor, default_mesh
from path_tracer_torch.parallel.render import render_sharded
from path_tracer_torch.utils.telemetry import traced

# Lanes of a kernel packet, the unit the spw packing fills: the JAX
# package's default ray tile (``pallas_bvh.RAY_TILE``).
RAY_TILE = 128


def integrator_spec(profile: Profile) -> IntegratorSpec:
    """The forward-rendering spec of a profile (never differentiable, as
    the JAX package's renderer sets it)."""
    return IntegratorSpec(bounces=profile.bounces,
                          alpha_walk_steps=profile.alpha_walk_steps,
                          shadow_walk_steps=profile.shadow_walk_steps,
                          seed=profile.seed, differentiable=False)


def accumulate_tile(acc, scene, pixel_ids, width: int, height: int,
                    sample_start: int, n_samples: int, spec: IntegratorSpec,
                    spw: int = 1) -> torch.Tensor:
    """acc [P,3] += the sums of n_samples successive samples of one tile,
    in place. With ``spw`` > 1, ``pixel_ids`` holds each of the P pixels
    spw times (``packed_lanes``) and each wavefront renders spw sample ids
    at once; the spw copies of a pixel are summed, then added to acc."""
    if spw == 1:
        for k in range(n_samples):
            acc += render_wavefront(scene, pixel_ids, width, height,
                                    sample_start + k, spec)
        return acc
    if n_samples % spw or spec.compact:
        raise ValueError(f"spw {spw} packs {n_samples} samples only when it "
                         "divides them and lanes are not compacted")
    sb = RAY_TILE // spw  # pixels per kernel packet
    lane_off = torch.arange(spw, dtype=torch.int32,
                            device=pixel_ids.device).repeat_interleave(sb)
    lane_off = lane_off.repeat(pixel_ids.shape[0] // RAY_TILE)
    for k in range(n_samples // spw):
        sid = sample_start + k * spw + lane_off  # per-lane sample ids
        rad = render_wavefront(scene, pixel_ids, width, height, sid, spec)
        # Reduce the spw sample copies of each pixel: [K, spw, sb, 3] lanes.
        acc += rad.reshape(-1, spw, sb, 3).sum(1).reshape(-1, 3)
    return acc


def packed_lanes(pixels: np.ndarray, spw: int) -> np.ndarray:
    """The lanes of a pixel list (a multiple of RAY_TILE/spw long) packed
    spw times: each RAY_TILE-lane packet holds RAY_TILE/spw consecutive
    pixels, repeated spw times."""
    if spw == 1:
        return pixels
    sb = RAY_TILE // spw
    return np.repeat(pixels.reshape(-1, 1, sb), spw, axis=1).reshape(-1)


def render_pixel_sums(scene, width: int, height: int, sample_start: int,
                      n_samples: int, spec: IntegratorSpec,
                      tile_rays: int = 1 << 16,
                      samples_per_launch: int = 1,
                      pass_callback=None,
                      init_accum: np.ndarray | None = None,
                      snapshot: bool = True,
                      samples_per_wavefront: int = 1):
    """Radiance sums [W*H, 3] (float32, linear pixel order) over n_samples
    consecutive sample ids starting at ``sample_start``, rendered on the
    scene's device.

    Samples run in pass batches of ``samples_per_launch`` (a multiple of
    spw when packing), every tile per batch. ``pass_callback``, given, is
    called as cb(samples_done, snapshot) after each batch, where
    snapshot() copies the current sums to the host; a callback returning
    False stops the render after that batch, and the result covers the
    samples done so far. ``init_accum`` [W*H,3] (linear order) starts the
    sums (a resumed render). ``snapshot=False`` returns the per-tile device
    accumulators (Morton order; this rank's slice of each tile on several
    ranks) instead of copying them to the host.
    ``samples_per_wavefront`` > 1 packs sample ids per packet where it can,
    and otherwise says so and renders with 1. While a ``torch.profiler``
    records, the call records the span ``render`` over ``render.setup``
    (the pixel order, the tiles' ids, the accumulators), ``render.pass``
    per pass batch and ``render.callback`` (``utils.telemetry``)."""
    with traced("render", scene.device):
        return _render_pixel_sums(
            scene, width, height, sample_start, n_samples, spec, tile_rays,
            samples_per_launch, pass_callback, init_accum, snapshot,
            samples_per_wavefront)


def _render_pixel_sums(scene, width, height, sample_start, n_samples, spec,
                       tile_rays, samples_per_launch, pass_callback,
                       init_accum, snapshot, samples_per_wavefront):
    """The body of ``render_pixel_sums``."""
    n_pix = width * height
    mesh = _world_mesh()
    n_dev = 1 if mesh is None else mesh.size()
    spw = max(1, samples_per_wavefront)
    if spw > 1 and (n_dev > 1 or spec.compact or n_samples % spw != 0
                    or RAY_TILE % spw != 0 or tile_rays % RAY_TILE != 0
                    or tile_rays // spw > n_pix):
        # Packing needs one device (render_sharded shards lanes, not
        # pixel/sample pairs), no lane-permuting compaction, a sample count
        # it divides, and RAY_TILE-aligned tiles no bigger than the frame.
        print(f"[renderer] samples_per_wavefront={spw} unsupported for this "
              f"config; falling back to 1", flush=True)
        spw = 1
    tile = min(tile_rays, max(1, n_pix)) if spw == 1 else tile_rays
    # Every tile shards over the ranks: round it up to a multiple of them
    # (padded lanes render pixel 0 and are discarded).
    tile = -(-tile // n_dev) * n_dev
    tpix = tile // spw  # distinct pixels per launch
    n_tiles = (n_pix + tpix - 1) // tpix
    spl = max(1, samples_per_launch)
    if spw > 1:
        spl = max(spw, (spl // spw) * spw)  # batches must divide by spw

    dev = scene.device
    with traced("render.setup", dev):
        morton = morton_pixel_order(width, height)
        all_pix = np.zeros(n_tiles * tpix, dtype=np.int32)
        all_pix[:n_pix] = morton  # padded lanes re-render pixel 0; discarded
        all_ids = packed_lanes(all_pix, spw)
        # This rank's slice of each tile, per pixels (the whole tile on one
        # device; spw is 1 on several, so lanes are pixels there).
        per = tpix // n_dev
        lo = 0 if mesh is None else mesh.get_local_rank() * per
        tile_ids = [torch.from_numpy(all_ids[t * tile + lo:][:per * spw])
                    .to(dev) for t in range(n_tiles)]
        if init_accum is not None:
            padded = np.zeros((n_tiles * tpix, 3), np.float32)
            padded[:n_pix] = np.asarray(init_accum, np.float32)[morton]
            accs = [torch.from_numpy(padded[t * tpix + lo:t * tpix + lo + per])
                    .to(dev) for t in range(n_tiles)]
        else:
            accs = [torch.zeros((per, 3), device=dev) for _ in range(n_tiles)]

    def take_snapshot() -> np.ndarray:
        if mesh is None:
            rows = torch.cat(accs)
        else:
            rows = torch.cat([all_gather_into_tensor(a, mesh.get_group())
                              for a in accs])
        rows = rows.cpu().numpy()[:n_pix]
        out = np.empty_like(rows)
        out[morton] = rows  # back to linear pixel order
        return out

    sample = sample_start
    end = sample_start + n_samples
    while sample < end:
        k = min(spl, end - sample)
        with traced("render.pass", dev):
            for ti in range(n_tiles):
                if mesh is not None:
                    render_sharded(scene, mesh, tile_ids[ti], width, height,
                                   sample, k, spec, acc=accs[ti])
                else:
                    accumulate_tile(accs[ti], scene, tile_ids[ti], width,
                                    height, sample, k, spec, spw=spw)
        sample += k
        if pass_callback is not None:
            with traced("render.callback", dev):
                go_on = pass_callback(sample - sample_start, take_snapshot)
            if go_on is False:
                break
    if not snapshot:
        return accs
    return take_snapshot()


def _world_mesh():
    """The mesh over every rank where a process group of more than one
    rank is up, else None (the one-device route)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        return default_mesh()
    return None


def render(scene, profile: Profile, progress: bool = False, viewer=None,
           checkpoint_path=None, checkpoint_every: int = 0) -> np.ndarray:
    """Render a scene → [H,W,3] uint8, accumulating radiance over sample ids
    1..=profile.samples (as the reference does).

    ``viewer`` (``viewer.ProgressiveViewer`` or anything with
    ``update(image)``) gets the tonemapped frame after every pass batch and
    can stop the render early (``stop_requested``): the image is then the
    mean over the samples done. With ``checkpoint_path`` the sums are saved
    every ``checkpoint_every`` samples (0: every pass batch) and at the
    end, and a matching checkpoint resumes the render at its next sample
    id; a checkpoint of another render raises."""
    width, height = profile.resolution.width, profile.resolution.height
    spec = integrator_spec(profile)

    init_accum = None
    samples_done = 0
    fp = None
    if checkpoint_path is not None:
        from path_tracer_torch.utils import checkpoint as ckpt

        fp = ckpt.fingerprint(width, height, profile.bounces, profile.seed,
                              scene, profile=profile)
        loaded = ckpt.load(checkpoint_path, fp)
        if loaded is not None:
            init_accum, samples_done = loaded
            samples_done = min(samples_done, profile.samples)

    t0 = time.time()
    bar = _ProgressBar(profile.samples, enabled=progress)
    bar.set(samples_done)
    last_saved = samples_done
    stopped_at = None  # an early stop asked by the viewer
    takes_progress = viewer is not None and _viewer_takes_progress(viewer)

    def on_pass(done_in_run, snapshot):
        nonlocal last_saved, stopped_at
        done = samples_done + done_in_run
        sums = None
        if viewer is not None:
            sums = snapshot()
            img = finalize(sums, done, profile, width, height)
            if takes_progress:
                rays = width * height * done_in_run * (profile.bounces + 1)
                viewer.update(img, samples_done=done,
                              samples_total=profile.samples, rays_done=rays)
            else:  # minimal viewers: update(image) only
                viewer.update(img)
        if checkpoint_path is not None and (
                checkpoint_every <= 0 or done - last_saved >= checkpoint_every
                or done >= profile.samples):
            from path_tracer_torch.utils import checkpoint as ckpt

            ckpt.save(checkpoint_path, snapshot() if sums is None else sums,
                      done, fp)
            last_saved = done
        bar.set(done)
        if viewer is not None and getattr(viewer, "stop_requested", False):
            stopped_at = done  # finalize over the samples done
            return False
        return True

    if samples_done < profile.samples:
        accum = render_pixel_sums(
            scene, width, height, samples_done + 1,
            profile.samples - samples_done, spec,
            tile_rays=profile.tile_rays,
            samples_per_launch=profile.samples_per_launch,
            samples_per_wavefront=profile.samples_per_wavefront,
            pass_callback=on_pass,
            init_accum=init_accum)
    else:
        accum = init_accum

    total = stopped_at if stopped_at is not None else profile.samples
    elapsed = time.time() - t0
    n_rays = width * height * (total - samples_done) * (profile.bounces + 1)
    verb = "Stopped" if stopped_at is not None else "Done"
    bar.finish(f"{verb}: {elapsed:.1f}s "
               f"({n_rays / max(elapsed, 1e-9) / 1e6:.1f} Mray/s)")
    return finalize(accum, total, profile, width, height)


def _viewer_takes_progress(viewer) -> bool:
    """Whether the viewer's update takes the progress keywords (checked
    once from its signature, never by catching a TypeError it raises)."""
    try:
        return "samples_done" in inspect.signature(viewer.update).parameters
    except (TypeError, ValueError):
        return False


def finalize(accum: np.ndarray, samples: int, profile: Profile, width,
             height) -> np.ndarray:
    """Radiance sums [W*H,3] → [H,W,3] uint8 (mean, tonemap, gamma)."""
    mean = torch.from_numpy(np.asarray(accum, np.float32)) / float(samples)
    u8 = tm.to_u8(tm.post_process(profile.tonemap, mean)).numpy()
    return u8.reshape(height, width, 3)


class _ProgressBar:
    """A per-sample progress line (the reference's bar)."""

    def __init__(self, total: int, enabled: bool):
        self.total = total
        self.done = 0
        self.enabled = enabled
        self.t0 = time.time()
        if enabled:
            self._draw()

    def _draw(self):
        n = int(self.done / max(1, self.total) * 40)
        print(f"\rRendering: [{'#' * n}{'-' * (40 - n)}] "
              f"{self.done}/{self.total} ({time.time() - self.t0:.0f}s)",
              end="", flush=True)

    def set(self, done: int):
        self.done = done
        if self.enabled:
            self._draw()

    def finish(self, msg: str):
        if self.enabled:
            print(f"\r{msg}{' ' * 60}", flush=True)
