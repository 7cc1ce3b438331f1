#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``path_tracer_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100: capability 9.0) and the CUDA toolkit; exits
non-zero without printing a result when there is no card or no port beside
this file. Phases, each printing one line of numbers and failing the run on
any error:

1. environment: card name and power limit, torch/CUDA versions, capability;
2. build: the kernels from ``path_tracer_torch/csrc`` with nvcc (one
   process per source, side by side), timed; the plain showcase, the
   textured showcase (its textures written and read by the port), the
   textured showcase at grid 704 (its opaque view routed to flat2, its
   transparent view to flat) and the 4,900-sphere grid built;
3. each kernel against its plain PyTorch version on the card: the 6,024
   Möller-Trumbore fixtures, seeded random rays against the ``cube`` and
   ``reflection`` tables and a random 2,500-triangle soup, the ``spheres``
   table and a random 500-sphere table (fresh and advanced t_prev, dead
   lanes, a ray count that is no multiple of the block size); the flat
   closest hit (alone and with the fused sphere pass) and the flat any-hit
   on the 100k-triangle showcase (grid 224, 256-slot blocks) and forced-BVH
   ``reflection``, with random, camera and terrain-bounce rays, against
   their plain versions and the MT kernel (3b); the alpha and
   transmittance walk kernels on the textured showcase, with camera lanes
   whose terminator comes from the opaque cast, random rays through the
   foliage, the three lights' stacked shadow lanes of the first bounce and
   dead lanes, at step caps 8 and 1 (3c); the flat2 closest hit and
   any-hit on the 991k-triangle textured showcase's opaque view (camera
   and random lanes with dead lanes, the first bounce's three shadow sets
   with 10% killed), against their plain versions and the flat kernels on
   the same tables, and flat2 against the MT kernel over all 991,834
   triangles on 2^17 random rays, the divergence gate of
   tests/tools/tpu_kernel_check.py (3d); the sphere block walk on the
   4,900-sphere grid against its plain version and the dense sphere
   kernel (3e); then each kernel's time beside its plain version's and
   its bound at the main path's shapes, and the flat kernels' on the flat2
   scene's tables; there the flat2 and sphere-walk kernels must also equal
   their timed plain versions on every one of the 2^18 lanes (3 x 2^18
   for the any-hit); then (3f) the sphere any-hit kernels on the first
   bounce's shadow sets of 2^18 camera lanes, a tenth killed: the dense
   kernel on the textured showcase (3 lights, 48 spheres), the walk on the
   4,900-sphere grid (2 point lights), each against its plain version on
   every lane and against the JAX package's elementwise in_range form
   (at most MAX_RANGE_FLIPS of the lanes), and the fused shadow kernel
   (row 15: row 10's warp any-hit, then row 14's resident walk) on the
   textured showcase's 3 x 2^18 first-bounce shadow lanes and 3 x 2^16
   incoherent lanes against its plain version and against flat_occluded +
   trans_walk launched apart, on every lane; each timed, row 15 in turns
   against the two launches; (3g, with 3f's fused checks and 6a also
   alone as ``--only 3o``) the k-nearest
   transparent hits kernel (row 3, the dense walk's producer: the table
   resident in shared memory, warp walks) on the textured showcase's
   middle 2^18 camera lanes with the opaque terminator as t_max, its
   first bounce's 3 x 2^18 stacked shadow lanes (a tenth killed) and
   random foliage rays with dead lanes, at k = 6, 1 and 8, against its
   plain version on every lane; on the duplicate-card scene, aimed, far
   and tie rays held within t_max to the ungated plain version
   (brute-force MT); then the lane slots per needed MT test, the device
   ms a launch, and the wrapper timed; (3h) the superleaf tree walk,
   closest hit and any-hit
   (rows 7 and 8), on the plain showcase and scene A's whole table:
   camera, random and first-bounce lanes and the three lights' shadow
   sets with a tenth killed (one any-hit launch), on a ragged ray count,
   against their plain versions on every lane and against the flat
   (showcase) or flat2 (scene A) kernels (the Baldwin-Weber/MT divergence
   gate); (3i, also alone with ``--only 3i``) rows 9 and 1
   against their plain versions on every field of 2^18 camera,
   first-bounce, incoherent, ragged and tie lanes, the tie rule's copy
   winning, the flat walk's packet counts and row 1's device ms per 1080p
   reflection sample; (3j, also alone with ``--only 3j``) rows 10 and 11 (the
   warp-packet flat any-hit and two-level flat2 closest hit) against
   their plain versions on every lane: row 10 on the plain showcase's
   first-bounce and incoherent shadow sets, the textured showcase's
   opaque view, a ragged count with dead warps and tie shadow rays; row 11
   on scene A's camera, first-bounce, random and ragged lanes and on tie
   rays whose copies sit in two superblocks; then scene A's packet
   counts; (3k, also alone with ``--only 3k``) rows 13 and 14 (the walks
   with the table resident in shared memory, one gated pass per lane and
   a sorted register list) against their plain versions on every field
   of every lane at caps 8, 1, 0 and 12: camera lanes with the opaque
   terminator, random foliage lanes, ragged counts with dead warps and
   the first bounce's shadow lanes on the textured showcase and scene A,
   tie rays through twelve layers of duplicated cards, and rays from 10^2
   to 10^3 group extents away on the textured showcase; then the
   walks' counts (steps, CTA passes, groups the gate admits, Baldwin-Weber
   tests executed against needed), each kernel's time with the recounted
   bound and floor, and the textured showcase's device ms per 1080p
   sample; (3l, also alone with ``--only 3l``) rows 12 and 2 (the flat2
   any-hit as two-level warp packets; the dense sphere closest hit
   writing the whole record and merging a triangle record in its launch)
   against their plain versions on every field of every lane: row 12 on
   scene A's first-bounce and incoherent shadow sets (3 x 2^18), a
   ragged count with dead warps and tie rays over two superblocks; row 2
   merged with row 11's record and alone on scene A's camera and
   first-bounce lanes, on ``spheres`` and 500 random spheres, and with
   triangle records at the sphere's t (the triangle wins) and an ulp past
   it; then row 12's work against what its results need and both rows
   timed with their bounds, scene A's device ms per 1080p sample; (3m,
   also alone with ``--only 3m``) rows 5 and 4 (the sphere block walk as
   warp packets writing the merged record; the dense sphere any-hit, one
   thread per ray over every set, the triangle result folded in as
   prior) against their plain versions on every field of every lane:
   scene B's camera and first-bounce lanes, a ragged count with dead
   warps, triangle records at the sphere's t and an ulp past it, the
   duplicate-sphere tie scene, also with each sphere's later block grown
   (the widened cut's case); the textured showcase's 3 x 2^18
   first-bounce shadow sets without and with the flat any-hit as prior,
   a random prior and 11 sets (two launches); row 5's simulated visits
   (``sph_walk_visits``) and row 4's tests, then both timed with their
   bounds; (3n, also alone with ``--only 3n``) rows 7 and 8 (the tree
   walk as warp walks, a lane testing the leaves its own gate admits; the
   any-hit's L sets in one launch) against their plain versions on every
   field of every lane: the plain showcase's and scene A's 2^18 camera
   and first-bounce lanes, random, incoherent and ragged lanes with dead
   warps, the first bounce's 3 x 2^18 shadow lanes and incoherent shadow
   sets with a tenth killed, and tie rays on the duplicate-triangle grid,
   there also against brute-force MT, and rows 9-12 (the flat and flat2
   kernels) against their ungated plain versions; the walks' counts
   (``tree_walk_visits``: leaf visits a 128-lane CTA and a 32-lane warp,
   lane-slot tests of each in-leaf layout against the tests needed), then
   the device ms a launch with the recounted bounds, beside rows 9 and 10
   (showcase) or 11 and 12 (scene A) on the same rays; (3p, only alone
   with ``--only 3p``) rows 9-12's device ms a launch at the main path's
   shapes, the script runnable from a checkout of an earlier commit to
   time that commit's kernels on the same lanes; (3q, also alone with
   ``--only 3q``) row 6 (the sphere any-hit walk as warp packets on the
   widened gate, writing prior | spheres) against its plain version on
   every lane: scene B's first-bounce and incoherent shadow sets with and
   without a prior, a ragged count with dead warps, each in-block layout
   alone, and the duplicate-sphere tie rays at t_max the ungated first
   hit, held also to the ungated walk and the dense any-hit (the
   exact-box mutation's lanes off counted), row 5 on the same rays
   against its ungated plain version; then its device ms a launch with
   the bound, ptxas's report and scene B's device ms a 1080p sample; (3r,
   also alone with ``--only 3r``) the segment prefilter kernel against its
   plain version on every lane at the main path's two call shapes (the
   alpha walk's 2,073,600 camera lanes, the 3 x 2,073,600 stacked shadow
   lanes, a seeded 28.4% live mask), each timed beside its bound and the
   plain version's time;
4. the main path at full size: ``cube``, ``spheres`` and ``reflection`` at
   1920x1080, 4 bounces, MAIN_SPP spp through ``render_pixel_sums``, and
   one frame of ``reflection`` at the reference default's size (1920x1080,
   4 bounces; CLI_FRAME_SPP spp, where the default is 64) through the CLI;
   then the plain showcase at 1920x1080, 5 bounces, SHOWCASE_SPP spp (the
   JAX bench's ``showcase_plain``), and one such CLI frame of it written to
   disk; then the textured showcase (the JAX bench's default workload) at
   1920x1080, 5 bounces, TEX_SPP spp, through ``render_pixel_sums`` and
   through the CLI; then (4d) the textured showcase at grid 704 (991,834
   triangles in 256-slot blocks: flat2 for the opaque partition) at
   1920x1080, 5 bounces, BIG_SPP spp through ``render_pixel_sums`` and one
   sample through ``render`` to a PNG; then (4e) the 4,900-sphere grid
   (the sphere block walk) written as an ISF file and rendered through the
   CLI at 1920x1080, 5 bounces, 1 spp, and at 480x270 through the walk
   and through the dense sphere kernel, same seed; then (4f) the textured
   showcase at 1920x1080, 5 bounces, FUSED_SPP spp through the fused
   shadow kernel (``PT_FUSED_SHADOW=1``) and through the two launches, in
   turns, same seed; then (4g) the textured showcase at 1920x1080, 5
   bounces, DENSE_SPP spp through the dense walk (``PT_NO_TRWALK_KERNEL=1
   PT_DENSE_TR=1``: row 3) and through the walk kernels, ABBA, and one
   1-spp frame of it through the CLI on the dense route; then (4h) the
   plain showcase at 1920x1080, 5 bounces, TREE_SPP spp under
   ``PT_BVH_KERNEL=tree`` (rows 7 and 8, one any-hit launch a bounce)
   against phase 4's flat render, the two routes in turns at
   TREE_TURN_SPP spp, one tree sample through ``torch.profiler`` and one
   1-spp textured-showcase frame through the CLI under tree.
   Every knob is restored after its phase. Launch counts are set to 0
   before each path and read after it;
4b. the showcase at 480x270, 4 spp, 5 bounces through the flat walk and
   through brute-force MT over all 100,352 triangles, same seed;
4c. the textured showcase at 480x270, 2 spp, 5 bounces through the walk
   kernels and through the cast walks alone (step cap 0), same seed;
5. the scalar-oracle gate: fourteen cases against ``tests/goldens/oracle``
   at each golden's own size (the three glb cases on scenes the port's
   glb generator and ``path-tracer-torch convert`` make), and five of
   them again with the BVH forced (the flat kernels;
   ``alpha_transparency`` then partitions and takes the walk kernels),
   with the CPU gate's statistics and tolerances;
6. the differentiable render step (training mode) on the textured
   showcase: (6a) the live variants of the alpha walk, the transmittance
   walk and the fused shadow kernel on the main path's lanes after
   tests/test_trwalk.py's training updates, each against its plain live
   version on every lane and timed beside its forward variant, and equal
   to the forward variant on untouched tables; (6b) the bench's backward
   step: d mean(img^2) / d mat_albedo_factor over the 2^18-lane 1080p
   tile, 5 bounces, 1 spp, timed (fwd+bwd rays/s, peak device memory,
   launches: the live walk kernels alone), its gradient against a central
   difference; (6c) five ``make_train_step`` steps over every parameter
   field toward a target of another seed, the albedo error falling, then
   one step through the fused route (the live fused kernel) against the
   two launches;
7. (also alone with ``--only 7``) the render driver and its options on the
   textured showcase at 1920x1080, 5 bounces (its scene file from phase
   4's ``build/`` directory): (7a) SPW_SPP spp at samples per wavefront
   1, 2 and 4, packed against unpacked within rtol 2e-5 / atol 2e-6, each
   with its seconds and launches per sample and peak device memory; (7b)
   COMPACT_SPP spp with live-ray compaction against without, bit-equal
   expected, every differing pixel logged with both values, failing
   beyond rtol 1e-5, the live lanes per bounce of the middle wavefront;
   the same on the plain showcase under ``PT_BVH_KERNEL=tree``; (7c) the
   CLI with ``--checkpoint`` at 2 spp, then at 4 spp resuming at sample
   3, its PNG equal to a straight 4-spp CLI render (phase 4's), a profile
   of another resolution against the file exiting 2, and the
   fingerprint's time; (7d) ``--debug-textures`` through the CLI (seven
   1080p PNGs) and ``compute_aovs`` at 96x54 on the card against the CPU
   port; (7e) the progressive viewer on port 0 over loopback during a
   3-spp render, one sample a pass: /status after each pass, the last
   /frame.png equal to the returned image, and a /stop after pass 1
   ending a render over one sample, equal to a 1-spp render; (7f) a
   1-spp CLI render with ``--profile-trace`` at TRACE_W x TRACE_H (one
   wavefront): the Chrome trace names the hand-written kernels that ran;
8. (also alone with ``--only 8``, then with the three glb oracle cases)
   (8a) forward renders through the wide shading rows (``sl_attr``,
   ``tex_wide``) against the per-model tables (``table_route``): the
   textured showcase at 1920x1080, 5 bounces, ROWS_TEX_SPP spp and scene
   A at ROWS_BIG_SPP, in turns, every value equal, with seconds,
   hand-written launches and peak memory of each reading, then one
   profiled sample of each in turns (device ms, all launches, the others);
   (8b) ``path-tracer-torch convert`` of the port's glb generator's files
   (no Pillow on the card), a 1080p CLI render of the converted scene, a
   file without a camera exiting 2, and the JPEG and PNG fixtures of
   ``tests/fixtures/torch_images`` (lossless, arithmetic-coded, CMYK,
   YCCK and 4:1:1 among them) decoding to Pillow's texels; the decoder's
   seconds per megapixel by JPEG kind on the card's host; the generator's
   glb with the JPEG_KINDS fixtures as its textures and the same glb with
   their ``.pillow.png`` decodes in their place, converted (every PNG
   byte-equal) and rendered at 1080p through the CLI (byte-equal, rows 9,
   10, 13 and 14 launched); ``head`` with its albedo as a lossless JPEG of
   the same texels rendered byte-equal to the PNG one; whether Pillow
   imports on the card's host: if it does, ``head`` with its textures
   re-saved as BMP, LZW TIFF and lossless WebP rendered byte-equal to the
   PNG one, else a BMP texture raising, naming the file; (8c)
   ``examples/torch_render_scene.py`` on ``cube`` and
   ``examples/torch_inverse_rendering.py``, its loss falling;
9. (also alone with ``--only 9``) the multi-device paths
   (``path_tracer_torch.parallel``) in processes this script launches
   (``--par-worker``, a ``file://`` rendezvous under ``build/``), on the
   textured showcase at 1920x1080, 5 bounces, 1 spp, 2^18-lane tiles:
   (9a) a world of one NCCL rank on cuda:0: ``render_sharded`` with
   rebalancing off and on and ``render_multihost``, each bit-equal to the
   one-process ``render_pixel_sums`` of the same sample; (9b) a world of
   two gloo ranks sharing cuda:0: the same renders, bit-equal to 9a's,
   the live lanes of each rank at each bounce before and after the
   exchange (after it within one of the mean), the hand-written launches
   of each rank (rows 9, 10, 13, 14 and 4 must run on each) and the
   transport each collective took; (9c) in the 9b world, the sharded
   ``make_train_step`` over the 2^18-lane backward tile split over the
   two ranks: the loss equal on both, the loss and ``mat_albedo_factor``
   after the step within rtol 1e-5 of the one-process step, rows 13L and
   14L launched on each rank; (9d) ``torchrun --nproc-per-node 1`` of the
   CLI on ``cube``, its PNG byte-equal to the plain CLI's. Seconds of a
   1080p sample for one process, 9a and 9b and peak device memory per
   rank are logged beside the card's name and power limit, and are not a
   scaling figure: both ranks share one card.

The last lines are a JSON object of kernel numbers, the ``nvidia-smi`` card
name and power limit, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

REPO = Path(__file__).resolve().parent
OUT = REPO / "chiprun_out" / "chip_smoke"

# Kernel-vs-plain bounds (the repo's own): the fraction of lanes whose kind
# or prim differ (flat2's divergence bound), the relative t error on
# agreeing lanes, and their u/v error (the flat kernel's test tolerance,
# tests/test_pallas_flat.py). Built -fmad=false, the kernels round as the
# plain versions do, so against those all are expected to be 0.
MAX_MISMATCH = 1e-4
MAX_REL_T = 5e-5
UV_RTOL, UV_ATOL = 1e-4, 1e-5
# The flat kernel against the MT kernel: two triangle tests that round
# apart. t within the Baldwin-Weber-vs-MT bound of
# tests/tools/tpu_kernel_check.py (rtol 5e-5, atol 1e-5: (c - o.n) cancels
# for hits near a ray start far from the origin), u/v within 0.01: BW
# takes u, v from the hit point, so a t error on a grazing ray shows in
# them (the plain versions on the CPU, phase 3b's 65,499 rays: at most
# 2.7e-4 apart on the showcase and 4.2e-3 on reflection), while a wrong
# barycentric convention is off by tenths. A lane outside either counts as
# mismatching.
DIVERGE_T_ATOL = 1e-5
DIVERGE_UV_RTOL, DIVERGE_UV_ATOL = 0.0, 1e-2
FIXTURE_TOL = 1e-5  # the reference's MT fixture tolerance
# BVH against brute force over the same scene and seed (phase 4b): share of
# pixel values within the golden tolerance, and mean energy.
MIN_PIXELS_WITHIN = 0.99
MAX_ENERGY_REL = 0.01
SHOWCASE_GRID, SHOWCASE_BLOCK = 224, 256  # bench.py's showcase_plain

# Oracle gate, as tests/test_oracle_parity.py: case -> (mean |u8| tol,
# energy rtol).
ORACLE_CASES = {
    "cube": (2.0, 0.02), "reflection": (2.0, 0.02), "spheres": (2.5, 0.04),
    "white_furnace_direct": (2.0, 0.02),
    "white_furnace_indirect": (2.5, 0.02),
    "cube_rr_b6": (2.0, 0.02), "spheres_rr_b6": (2.5, 0.04),
    "alpha_transparency": (3.1, 0.02), "head": (2.5, 0.02),
    "deep_alpha": (2.5, 0.02), "showcase_tex": (3.2, 0.02),
    "glb_converted_256": (3.0, 0.02), "glb_converted_512": (3.0, 0.02),
    "glb_multi_opacity": (3.0, 0.02),
}
# The cases whose scenes the port's glb generator and converter make
# (tests/tools/torch_gen_test_glb.py, path-tracer-torch convert).
GLB_CASES = ("glb_converted_256", "glb_converted_512", "glb_multi_opacity")
# Cases rendered again with the BVH forced: the triangle cases (the flat
# walk) and alpha_transparency, which then partitions (the walk kernels).
ORACLE_BVH_CASES = ("cube", "reflection", "white_furnace_direct",
                    "cube_rr_b6", "alpha_transparency")
# The walk kernels against their plain versions: lanes whose results
# differ at all (a texel-index flip would be one), as a share of lanes.
MAX_WALK_MISMATCH = 1e-4
# Kernel walks against forced cast walks, whole render (the gate of
# tests/test_trwalk.py:44-65): share of pixels beyond 1e-3.
MAX_WALK_PIXELS = 0.005
TEX_SPP = 4  # samples of the textured showcase's 1080p render
# The flat2 scene (scene A): the textured showcase at grid 704 (991,834
# triangles, 5,518 blocks of 256), rendered at BIG_SPP; and the sphere
# block walk's scene (scene B): the 70 x 70 sphere grid.
BIG_GRID, BIG_SPP = 704, 2
SPHERE_GRID = 70
# flat2 against the MT kernel at 991k triangles (tpu_kernel_check.py's
# gate): a lane diverges on a hit/miss flip or, both hitting, a t apart by
# more than rtol/atol 5e-5; at most this share of lanes may.
MAX_DIVERGENCE = 1e-4
# The sphere walk against the dense sphere kernel (two root forms): the
# prim flip rate and the t bound of tests/test_pallas_spheres.py.
MAX_SPHERE_FLIPS, SPHERE_RTOL = 0.01, 1e-3
WAVE = 1 << 18  # lanes of one wavefront of the main path (Profile.tile_rays)
# The sphere any-hit kernels (exact t_max) against the JAX package's
# elementwise form (the distance test): share of lanes that may part, at
# the range boundary only.
MAX_RANGE_FLIPS = 1e-4
FUSED_SPP = 1  # samples of each 1080p render of the fused-shadow A/B (4f)
# Row 3's column counts checked (3g): PT_DENSE_TR_K's default, the main
# path's, and 1.
KHIT_KS = (6, 1, 8)
CHECK_LANES = (1 << 16) - 37  # lanes of 3g's and 3h's checks: not whole CTAs
# Samples of phase 4's 1080p renders of cube, spheres and reflection, and
# of the plain showcase (flat, and under tree in 4h: the two compared).
MAIN_SPP = 2
SHOWCASE_SPP = TREE_SPP = 2
# Samples of the reference-default-sized frames (1920x1080, 4 bounces)
# rendered through the CLI in phase 4 (the reference default is 64).
CLI_FRAME_SPP = 2
DENSE_SPP = 1  # samples of each 1080p render of 4g's ABBA
SPW_SPP = TEX_SPP  # 7a's samples at spw 1 (phase 4's run), 2 and 4
COMPACT_SPP = 1  # samples of 7b's renders with and without compaction
AOV_CPU_W, AOV_CPU_H = 96, 54  # 7d's AOVs on the card against the CPU
DRIVER_W, DRIVER_H = 1920, 1080  # phase 7's frame
# 7f's traced frame: one wavefront. A 1080p sample's Chrome trace would
# hold about eight times the events (each tile repeats every op).
TRACE_W, TRACE_H = 480, 270
TREE_TURN_SPP = 1  # samples of each render of 4h's tree and flat turns
# The training phases (6b, 6c): the central difference's step on the
# albedo scale and its bound (tests/tools/tpu_kernel_check.py's chip gate),
# the target render's seed (examples/inverse_rendering.py) and the SGD
# steps taken.
FD_EPS, MAX_FD_REL = 5e-3, 0.05
TARGET_SEED = 1234
TRAIN_STEPS = 5
# 6c's learning rate over the largest entry of a first gradient: no field
# moves by more than this a step (camera rotation entries included, whose
# larger steps move the image by whole pixels).
LR_SCALE = 1e-3
# Peak rates of one H100 SXM at 700 W (NVIDIA's data sheet): float32
# outside the tensor cores, and HBM bandwidth. A kernel's bound is the
# larger of its operations over the first and its bytes over the second.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# FP32 operations (adds, multiplies, one division) per test, counted from
# the kernels' expressions: Moller-Trumbore, the centered sphere
# quadratic, one Baldwin-Weber test and one slab test of a block AABB.
OPS_MT, OPS_SPHERE, OPS_BW, OPS_SLAB = 45, 25, 32, 22


START = time.perf_counter()


def log(msg: str) -> None:
    """Prints a line; a phase's first line carries the seconds since the
    run started."""
    if msg.startswith("phase "):
        msg = f"{msg} [at {time.perf_counter() - START:.1f} s]"
    print(msg, flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def scene_path(name: str) -> Path:
    return REPO / "tests" / "scenes" / name / "scene.isf"


def cuda_ms(fn, iters: int, warm_up: bool = True) -> float:
    """Mean milliseconds per call on the card, after one warm-up call
    (none with ``warm_up`` False: for plain versions that take seconds)."""
    import torch

    if warm_up:
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def timed_once(fn):
    """(milliseconds, result) of one call on the card with no warm-up: for
    plain versions, which take seconds and whose result is compared."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def compare(label: str, got, want, t_diverges: bool = False
            ) -> tuple[float, float]:
    """(mismatch fraction, max abs err) of two HitRecords; fails the run
    when a bound is exceeded. ``t_diverges``: the flat kernel against the
    MT kernel; t takes the absolute slack DIVERGE_T_ATOL, u/v the golden
    tolerance, and a lane outside either counts as a mismatching lane (the
    two forms round apart on grazing rays far from the origin, where both
    are ill-conditioned) instead of failing the run by itself."""
    import torch

    t_atol = DIVERGE_T_ATOL if t_diverges else 0.0
    uv_rtol, uv_atol = ((DIVERGE_UV_RTOL, DIVERGE_UV_ATOL) if t_diverges
                        else (UV_RTOL, UV_ATOL))
    mism = (got.kind != want.kind) | (got.prim != want.prim) \
        | (got.backface != want.backface)
    hit_lane = torch.isfinite(want.t)
    # Each error over its bound (<= 1 passes).
    t_over = (got.t - want.t).abs() / (MAX_REL_T * want.t.abs() + t_atol)
    uv_over = torch.maximum(
        (got.u - want.u).abs() / (uv_rtol * want.u.abs() + uv_atol),
        (got.v - want.v).abs() / (uv_rtol * want.v.abs() + uv_atol))
    # 0/0 (equal t, both 0) is within the bound.
    t_over = torch.nan_to_num(t_over, nan=0.0)
    off = (~mism & hit_lane) & ((t_over > 1.0) | (uv_over > 1.0))
    n_off = int(off.sum())
    if t_diverges:
        mism = mism | off
    agree = ~mism & hit_lane
    rel = ((got.t - want.t).abs() / want.t.abs().clamp(min=1e-30))[agree]
    errs = [(got.t - want.t)[agree].abs(), (got.u - want.u)[agree].abs(),
            (got.v - want.v)[agree].abs()]
    max_abs = max([float(e.max()) if e.numel() else 0.0 for e in errs])
    frac = float(mism.float().mean())
    max_rel = float(rel.max()) if rel.numel() else 0.0
    max_t_over = float(t_over[agree].max()) if agree.any() else 0.0
    max_uv_over = float(uv_over[agree].max()) if agree.any() else 0.0
    hit = float(hit_lane.float().mean())
    log(f"  {label}: lanes={want.t.numel()} hit={hit:.3f} mismatch={frac:.2e} "
        f"(<= {MAX_MISMATCH:g}) max_rel_t={max_rel:.2e} t_err/(rtol "
        f"{MAX_REL_T:g} t + atol {t_atol:g})={max_t_over:.3f} (<= 1) "
        f"uv_err/(rtol {uv_rtol:g} uv + atol {uv_atol:g})={max_uv_over:.3f} "
        f"(<= 1) max_abs_err={max_abs:.2e}"
        + (f" (lanes of matching prim but t or u/v outside the bound: "
           f"{n_off}, counted as mismatching)" if t_diverges else ""))
    if not (frac <= MAX_MISMATCH and max_t_over <= 1.0
            and max_uv_over <= 1.0 and hit > 0.01):
        raise AssertionError(f"{label}: kernel disagrees with its plain version")
    return frac, max_abs


def random_rays(rng, r: int, lo, hi, device):
    """Rays from a box around [lo, hi] toward points inside it."""
    import torch

    span = hi - lo
    o = rng.uniform(lo - 0.5 * span, hi + 0.5 * span, (r, 3))
    d = rng.uniform(lo, hi, (r, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    as_t = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)
    return as_t(o), as_t(d)


def check_pair(label, wrapper, plain, scene, o, d, stats):
    """Kernel vs plain on fresh rays, then on the re-cast pattern (t_prev =
    the first hit's t, every 7th lane dead)."""
    import torch

    r = o.shape[0]
    tp = torch.full((r,), -1.0, device=o.device)
    first = plain(o, d, tp, scene)
    stats.append(compare(f"{label} t_prev=-1", wrapper(o, d, tp, scene), first))
    tp2 = torch.where(torch.isfinite(first.t), first.t, -1.0)
    tp2[::7] = float("inf")
    stats.append(compare(f"{label} t_prev=first hit, dead lanes",
                         wrapper(o, d, tp2, scene), plain(o, d, tp2, scene)))


def bound(ops: float, n_bytes: float) -> tuple[float, str]:
    """(bound_ms, bound_by): the least time the card could take for work
    of ``ops`` FP32 operations moving ``n_bytes`` (inputs read once,
    outputs written once)."""
    t_ops, t_bytes = ops / PEAK_FP32 * 1e3, n_bytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def compare_walk(label: str, got, want) -> tuple[float, float]:
    """(mismatch fraction, max abs err on agreeing lanes) of two walk
    results (NamedTuples of [R] tensors); fails the run when more than
    MAX_WALK_MISMATCH of the lanes differ in any field."""
    import torch

    diff = torch.zeros_like(got[0], dtype=torch.bool)
    for a, b in zip(got, want):
        same = (a == b) | (torch.isnan(a) & torch.isnan(b)) \
            if a.is_floating_point() else a == b
        diff |= ~same
    errs = [((a - b).abs()[~diff & torch.isfinite(b)])
            for a, b in zip(got, want) if a.is_floating_point()]
    max_abs = max([float(e.max()) if e.numel() else 0.0 for e in errs])
    frac = float(diff.float().mean())
    log(f"  {label}: lanes={diff.numel()} mismatch={frac:.2e} (<= "
        f"{MAX_WALK_MISMATCH:g}) max_abs_err={max_abs:.2e}")
    if frac > MAX_WALK_MISMATCH:
        raise AssertionError(f"{label}: kernel disagrees with its plain "
                             "version")
    return frac, max_abs


def foliage_rays(rng, sc, n: int, device):
    """Rays from around the transparent triangles' bounds through them."""
    v = sc.tri_v0[sc.n_tris_opaque: sc.num_real_triangles].cpu().numpy()
    return random_rays(rng, n, v.min(0), v.max(0), device)


def alpha_lanes(sc, n: int, device, rng=None):
    """Alpha-walk lanes of the main path's middle 1080p wavefront: camera
    rays, t_op from the opaque cast (spheres fused), lanes whose segment
    misses every transparent cluster dead (t_op = -1), as the integrator
    encodes them; with ``rng``, the second half random rays through the
    foliage with random t_op, and every 7th lane dead."""
    import torch

    from path_tracer_torch.ops.intersect import closest_hit
    from path_tracer_torch.ops.trwalk import hits_transparent_bounds
    from path_tracer_torch.scene.device_scene import opaque_view

    m = n if rng is None else n // 2
    o, d = camera_rays(sc, m, device)
    hit = closest_hit(o, d, torch.full((m,), -1.0, device=device),
                      opaque_view(sc))
    t_op = torch.where(hit.valid, hit.t, float("inf"))
    t_op = torch.where(hits_transparent_bounds(sc, o, d, t_op), t_op, -1.0)
    if rng is not None:
        fo, fd = foliage_rays(rng, sc, n - m, device)
        o, d = torch.cat([o, fo]).contiguous(), torch.cat([d, fd]).contiguous()
        t_op = torch.cat([t_op, as_cuda(rng.uniform(0.5, 60.0, n - m),
                                        device)])
        t_op[::7] = -1.0
    return o, d, t_op


def shadow_lanes(sc, n: int, device, rng=None, tile: int = 4):
    """The stacked [3n] shadow lanes of the first bounce of n camera lanes
    of the 1080p wavefront ``tile`` (``camera_rays``; the middle one by
    default), as the integrator builds them:
    directional light first (raw direction, pd = +inf), then the point
    lights (unit direction, pd = the distance); lanes live where the
    camera ray hit, the surface faces the light, no opaque occluder is in
    range and the segment enters a transparent cluster. With ``rng``,
    every tenth lane on average is killed besides. Returns the walk's
    arguments (o, d, pd, is_pt, surf_pos, orig_uv, orig_simple,
    walking0)."""
    import torch

    from path_tracer_torch.models.integrator import NORMAL_BIAS, _surface
    from path_tracer_torch.ops.intersect import closest_hit, occluded_multi
    from path_tracer_torch.ops.trwalk import hits_transparent_bounds
    from path_tracer_torch.scene.device_scene import opaque_view

    o, d = camera_rays(sc, n, device, tile)
    hit = closest_hit(o, d, torch.full((n,), -1.0, device=device), sc)
    surf = _surface(sc, hit, o, d)
    so = (surf.pos + surf.geom_normal * NORMAL_BIAS).contiguous()
    ds, pds = [], []
    for k in range(sc.num_dir_lights):
        ds.append((-sc.dir_dir[k]).expand(n, 3))
        pds.append(torch.full((n,), float("inf"), device=device))
    for k in range(sc.num_point_lights):
        to_surf = surf.pos - sc.point_pos[k]
        dist = torch.sqrt((to_surf * to_surf).sum(-1))
        ds.append(-(to_surf / dist[:, None]))
        pds.append(dist)
    actives = [hit.valid & ((surf.normal * x).sum(-1) > 0.0) for x in ds]
    blocked = occluded_multi(so, ds, opaque_view(sc), surf_pos=surf.pos,
                             max_dists=[None] * sc.num_dir_lights
                             + pds[sc.num_dir_lights:], actives=actives)
    n_l = len(ds)
    o3, d3, pd3 = so.repeat(n_l, 1), torch.cat(ds).contiguous(), torch.cat(pds)
    walking0 = torch.cat([a & ~b for a, b in zip(actives, blocked)])
    walking0 &= hits_transparent_bounds(sc, o3, d3, pd3 * 1.0001 + 1e-3)
    if rng is not None:
        walking0 &= as_cuda(rng.uniform(size=n_l * n) > 0.1, device, bool)
    is_pt = torch.arange(n_l * n, device=device) >= sc.num_dir_lights * n
    return (o3, d3, pd3, is_pt, surf.pos.repeat(n_l, 1),
            surf.uv.repeat(n_l, 1), surf.simple.repeat(n_l), walking0)


# Lanes of a 1080p frame, and the share of them live at a traced sample's
# bounces on the textured showcase (PERF.md, section 5).
FRAME_LANES, LIVE_SHARE = 1920 * 1080, 0.284


def prefilter_tests(sc, o, d, t_max, active, chunk: int = 1 << 20) -> int:
    """Slab tests the prefilter kernel makes: each live lane's boxes up to
    its first passing one, all P where none passes (the plain version's
    arithmetic, box by box)."""
    import torch

    boxes = sc.tr_prefilter
    n_box = boxes.shape[0]
    lanes = active.nonzero().squeeze(1)
    total = 0
    for s in range(0, lanes.numel(), chunk):
        i = lanes[s:s + chunk]
        oo, inv, tm = o[i][:, None, :], 1.0 / d[i][:, None, :], t_max[i]
        t0 = (boxes[None, :, 0:3] - oo) * inv
        t1 = (boxes[None, :, 3:6] - oo) * inv
        lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
        tn = torch.where(torch.isnan(lo), -float("inf"), lo).amax(-1)
        tf = torch.where(torch.isnan(hi), float("inf"), hi).amin(-1)
        ok = (tf >= torch.clamp(tn, min=0.0)) & (tn <= tm[:, None])
        first = torch.where(ok.any(1), ok.int().argmax(1) + 1, n_box)
        total += int(first.sum())
    return total


def phase_prefilter(device, tex) -> dict:
    """(3r) The segment prefilter kernel (``csrc/tr_prefilter.cu``) against
    its plain version at the main path's two call shapes on the textured
    showcase: the alpha walk's 2,073,600 camera lanes of a 1080p frame
    (t_max the opaque hit's t) and the shadow phase's 3 x 2,073,600
    stacked first-bounce lanes (t_max the distance to the light with the
    integrator's margin), each with a seeded LIVE_SHARE live mask. Equal
    on every lane, then timed: the kernel through its wrapper (CUDA events
    over AB_ITERS calls) and its launch's device ms, the plain version
    masked as the integrator used it, and the bound of the tests and bytes
    the live lanes need. Returns {shape: numbers}."""
    import torch

    from path_tracer_torch.ops import cuda_trwalk
    from path_tracer_torch.ops.intersect import closest_hit
    from path_tracer_torch.ops.trwalk import hits_transparent_bounds
    from path_tracer_torch.scene.device_scene import opaque_view

    log("phase 3r: the segment prefilter kernel against its plain version")
    n = FRAME_LANES
    o, d = camera_rays(tex, n, device, tile=0)
    hit = closest_hit(o, d, torch.full((n,), -1.0, device=device),
                      opaque_view(tex))
    t_op = torch.where(hit.valid, hit.t, float("inf"))
    o3, d3, pd3 = shadow_lanes(tex, n, device, tile=0)[:3]
    rng = np.random.default_rng(25)
    shapes = {"hit": (o, d, t_op), "shadow": (o3, d3, pd3 * 1.0001 + 1e-3)}
    out = {}
    for label, (oo, dd, tm) in shapes.items():
        r = oo.shape[0]
        mask = as_cuda(rng.uniform(size=r) < LIVE_SHARE, device, bool)
        kernel = lambda: cuda_trwalk.prefilter(tex, oo, dd, tm, mask)
        plain = lambda: hits_transparent_bounds(tex, oo, dd, tm) & mask
        got, want = kernel(), plain()
        off = int((got != want).sum())
        if off:
            raise AssertionError(f"prefilter {label}: {off} lanes off")
        live, passed = int(mask.sum()), int(got.sum())
        tests = prefilter_tests(tex, oo, dd, tm, mask)
        b_ms, b_by = bound(tests * OPS_SLAB, 2 * r + 28 * live
                           + nbytes(tex.tr_prefilter))
        k_ms = wrapper_ms(kernel)
        launch_ms = launch_device_ms(kernel)
        plain_ms = min(cuda_ms(plain, 3), cuda_ms(plain, 3))
        out[label] = dict(lanes=r, live=live, passed=passed, tests=tests,
                          kernel_ms=k_ms, launch_ms=launch_ms, bound_ms=b_ms,
                          bound_by=b_by, plain_ms=plain_ms)
        log(f"  prefilter {label}: {r} lanes, {live} live, {passed} pass, 0 "
            f"lanes off the plain version; {tests} slab tests "
            f"({tests / max(live, 1):.2f} a live lane); kernel {k_ms:.4f} ms "
            f"through the wrapper, {launch_ms:.4f} device ms a launch; bound "
            f"{b_ms:.4f} ms ({b_by}); plain {plain_ms:.4f} ms")
    return out


def walk_rnd(n: int, cap: int, device):
    """The alpha walk's uniforms of sample 1, bounce 0 over n lanes, at the
    sites the integrator draws them (SITE_ALPHA + k)."""
    import torch

    from path_tracer_torch.ops import rng

    pix = torch.arange(n, dtype=torch.int32, device=device)
    return torch.stack([rng.uniform(pix, 1, rng.SITE_ALPHA + k, 0)
                        for k in range(cap)]).contiguous()


def walk_gate(sc, o, d, t_hi, n_slice: int = 1 << 16):
    """Per lane of the walks: (admitted groups, real columns in them, the
    number of distinct candidates with t < t_hi), through the kernels' gate
    on their widened boxes (``trwalk.group_gate``, ``pad_groups``), from the
    plain inputs, [N] int64 each; and per 32-lane warp the real columns of
    the union of its lanes' groups, which the warp runs. Dead lanes have
    t_hi < 0."""
    import torch

    from path_tracer_torch.ops import trwalk

    n_groups = sc.tr_bw.shape[1] // 128
    real = (sc.tr_bw[0:3].abs().sum(0) > 0).view(n_groups, 128).sum(1)
    grp = trwalk.pad_groups(sc.tr_grp)[:, :n_groups]
    groups, cols, distinct, warp_cols = [], [], [], []
    for a in range(0, o.shape[0], n_slice):
        sl = slice(a, a + n_slice)
        gate = trwalk.group_gate(o[sl], d[sl], t_hi[sl], grp)
        groups.append(gate.sum(1))
        cols.append((gate * real).sum(1))
        pad = -gate.shape[0] % 32
        union = torch.cat([gate, gate.new_zeros((pad, n_groups))]).view(
            -1, 32, n_groups).any(1)
        warp_cols.append((union * real).sum(1))
        t = trwalk._eval_cols(o[sl], d[sl], t_hi[sl], sc.tr_bw)[0]
        srt = t.sort(dim=1).values
        new = torch.ones_like(srt, dtype=torch.bool)
        new[:, 1:] = srt[:, 1:] != srt[:, :-1]
        distinct.append((new & torch.isfinite(srt)).sum(1))
    return (torch.cat(groups), torch.cat(cols), torch.cat(distinct),
            torch.cat(warp_cols))


def walk_needed(sc, kind: str, lanes) -> tuple:
    """(needed, design): the Baldwin-Weber tests the walks need on
    ``lanes`` (alpha: (o, d, t_op); trans: the eight arguments of
    ``trans_walk_plain``), the real columns of the groups the gate admits
    once per live lane, with no refill at cap 8: the work whatever
    implements it, as the plain versions evaluate each column once a
    lane; and the tests the resident design makes, which tests a
    transmittance point lane's columns twice (the cut pass, then the
    product pass)."""
    import torch

    if kind == "alpha":
        o, d, t_op = lanes[:3]
        t_hi, two = torch.where(t_op < 0.0, -1.0, t_op), None
    else:
        o, d, pd, is_pt, *_, w0 = lanes
        live = w0 & (pd >= 0.0)
        t_hi, two = torch.where(live, float("inf"), -1.0), live & is_pt
    cols = walk_gate(sc, o, d, t_hi)[1]
    needed = int(cols.sum())
    return needed, needed + (int(cols[two].sum()) if two is not None else 0)


def walk_counts(label: str, sc, kind: str, lanes, rnd=None,
                cap: int = 8) -> dict:
    """A0, from the plain inputs (``walk_needed``'s lanes; ``rnd`` the
    alpha walk's uniforms): live lanes; the steps each walking lane takes at
    ``cap`` (step k is taken where the plain walk still walks after k - 1
    steps and a k-th distinct candidate exists) as a histogram; the mean
    over 128-lane CTAs with a walking lane of min(cap, the most steps + 1),
    the passes the CTA design makes; the gate's groups and real columns per
    live lane; the Baldwin-Weber tests the CTA design executes (each live
    lane sits through its CTA's passes over every real column; point lanes
    two) against those the walk needs (``walk_needed``: each admitted
    column once a live lane) and those the resident design makes (point
    lanes twice). Logged and returned."""
    import torch

    from path_tracer_torch.ops import trwalk

    tp_real = int((sc.tr_bw[0:3].abs().sum(0) > 0).sum())
    if kind == "alpha":
        o, d, t_op = lanes
        live = t_op >= 0.0
        walkers, point = live, torch.zeros_like(live)
        t_hi = torch.where(live, t_op, -1.0)
        still = [trwalk.alpha_walk_plain(sc, o, d, t_op, rnd, k).still
                 for k in range(cap)]
    else:
        o, d, pd, is_pt = lanes[:4]
        live = lanes[-1] & (pd >= 0.0)
        walkers = (live & ~is_pt if sc.tr_textured
                   else torch.zeros_like(live))
        point = live & is_pt
        t_hi = torch.where(live, float("inf"), -1.0)
        still = [trwalk.trans_walk_plain(sc, *lanes, k).still
                 for k in range(cap)]
    groups, cols, distinct, warp_cols = walk_gate(sc, o, d, t_hi)
    steps = sum((still[k - 1] & (distinct >= k)).long()
                for k in range(1, cap + 1))
    steps = torch.where(walkers, steps, 0)
    cta = torch.arange(o.shape[0], device=o.device) // 128
    n_cta = int(cta[-1]) + 1
    most = torch.zeros(n_cta, dtype=torch.long, device=o.device)
    most.scatter_reduce_(0, cta, steps, "amax")
    has = torch.zeros(n_cta, dtype=torch.long, device=o.device)
    has = has.scatter_reduce_(0, cta, walkers.long(), "amax") > 0
    passes = torch.where(has, torch.clamp(most + 1, max=cap), 0)
    lane_passes = torch.where(walkers, passes[cta],
                              torch.where(point, 2, 1))
    n_live = int(live.sum())
    executed = int(lane_passes[live].sum()) * tp_real
    needed = int(cols[live].sum())
    design = needed + int(cols[point].sum())
    # The resident design's warps run the union of their lanes' groups:
    # lane-slot tests, a warp's passes (two where its lanes are point
    # lanes) times 32 lanes times the union's real columns.
    warp = torch.arange(o.shape[0], device=o.device) // 32
    warp_passes = torch.zeros_like(warp_cols)
    warp_passes.scatter_reduce_(0, warp, torch.where(
        live, torch.where(point, 2, 1), 0), "amax")
    slots = int((warp_passes * warp_cols).sum()) * 32
    hist = torch.bincount(steps[walkers], minlength=cap + 1).tolist()
    out = dict(lanes=o.shape[0], live=n_live, walkers=int(walkers.sum()),
               point=int(point.sum()), hist=hist,
               cta_passes=float(passes[has].float().mean()) if bool(
                   has.any()) else 0.0,
               groups=float(groups[live].float().mean()),
               cols=float(cols[live].float().mean()), tp_real=tp_real,
               executed=executed, needed=needed, design=design,
               warp_slots=slots,
               warp_cols=float(warp_cols[warp_passes > 0].float().mean()))
    log(f"  A0 {label}: {out['lanes']} lanes, {n_live} live ({out['walkers']}"
        f" walking, {out['point']} point); steps at cap {cap} "
        + " ".join(f"{k}:{v}" for k, v in enumerate(hist))
        + f"; CTA passes (most steps + 1) {out['cta_passes']:.3f}; groups "
        f"per live lane {out['groups']:.3f} of {sc.tr_bw.shape[1] // 128}, "
        f"real columns {out['cols']:.1f} of {tp_real}; Baldwin-Weber tests "
        f"executed by the CTA design {executed}, needed {needed} "
        f"({needed / max(executed, 1):.4f}), made by the resident design "
        f"(point lanes twice) {design}; its warps run the union of their "
        f"lanes' groups, {out['warp_cols']:.1f} real columns per warp: "
        f"{slots} lane-slot tests ({design / max(slots, 1):.4f} of them "
        f"its lanes' own)")
    return out


def phase_walk_kernels(device, tex):
    """The walk kernels against their plain versions on the textured
    showcase (grid 224, 256-slot blocks): caps 8 and 1, dead lanes."""
    from path_tracer_torch.ops import cuda_trwalk, trwalk

    log(f"phase 3c: walk kernels (textured showcase: "
        f"{tex.num_real_triangles - tex.n_tris_opaque} transparent "
        f"triangles in {tex.tr_bw.shape[1]} columns, "
        f"{len(tex.tr_pages)} opacity page(s))")
    rng = np.random.default_rng(20261018)
    n = (1 << 16) - 37  # no multiple of the 128-lane CTA
    o, d, t_op = alpha_lanes(tex, n, device, rng)
    sh = shadow_lanes(tex, n, device, rng)
    alpha_stats, trans_stats = [], []
    for cap in (8, 1):
        rnd = as_cuda(rng.uniform(size=(cap, n)), device)
        alpha_stats.append(compare_walk(
            f"alpha walk cap {cap} (live {float((t_op >= 0).float().mean()):.3f})",
            cuda_trwalk.alpha_walk(tex, o, d, t_op, rnd, cap),
            trwalk.alpha_walk_plain(tex, o, d, t_op, rnd, cap)))
        trans_stats.append(compare_walk(
            f"transmittance walk cap {cap}, 3 x {n} lanes (live "
            f"{float(sh[-1].float().mean()):.3f})",
            cuda_trwalk.trans_walk(tex, *sh, cap),
            trwalk.trans_walk_plain(tex, *sh, cap)))
    return alpha_stats, trans_stats


def phase_walk_timing(device, tex):
    """Walk kernel and plain-version milliseconds at the main path's
    shapes: the alpha walk on the middle wavefront's 2^18 camera lanes,
    the transmittance walk on its first bounce's 3 x 2^18 shadow lanes
    (cap 8, lanes encoded as the integrator encodes them). Returns
    {name: (ms, plain_ms, bound_ms, bound_by)}."""
    from path_tracer_torch import native
    from path_tracer_torch.ops import cuda_trwalk, trwalk

    n = WAVE
    cap = trwalk.TRWALK_K
    tp_real = int((tex.tr_bw[0:3].abs().sum(0) > 0).sum())
    tables = (tex.tr_bw, tex.tr_rows, tex.tr_tex8, tex.tr_lut,
              tex.tr_page_table, tex.tr_grp)
    o, d, t_op = alpha_lanes(tex, n, device)
    rnd = walk_rnd(n, cap, device)
    run = lambda: cuda_trwalk.alpha_walk(tex, o, d, t_op, rnd, cap)
    plain = lambda: trwalk.alpha_walk_plain(tex, o, d, t_op, rnd, cap)
    ms, plain_ms, ms2 = cuda_ms(run, 20), cuda_ms(plain, 2), cuda_ms(run, 20)
    live = int((t_op >= 0).sum())
    needed = walk_needed(tex, "alpha", (o, d, t_op))[0]
    out = {"alpha_walk": (min(ms, ms2), plain_ms) + bound(
        needed * OPS_BW,
        nbytes(o, d, t_op, rnd, *tables) + n * (8 * 4 + 4))}
    log(f"  time alpha walk, {n} camera lanes ({live} live) x {tp_real} "
        f"columns: kernel {ms:.4f} ms, {ms2:.4f} ms (repeat); plain "
        f"{plain_ms:.4f} ms; bound {out['alpha_walk'][2]:.4f} ms "
        f"({out['alpha_walk'][3]}: {needed} Baldwin-Weber tests in the "
        f"admitted groups; one ungated pass per live lane "
        f"{bound(live * tp_real * OPS_BW, 0)[0]:.4f} ms)")
    sh = shadow_lanes(tex, n, device)
    o3, d3 = sh[0], sh[1]
    aux = cuda_trwalk.trans_aux(*sh[2:])
    run = lambda: native.launch_trans_walk(o3, d3, aux, tex, cap)
    plain = lambda: trwalk.trans_walk_plain(tex, *sh, cap)
    ms, plain_ms, ms2 = cuda_ms(run, 20), cuda_ms(plain, 2), cuda_ms(run, 20)
    live = int(sh[-1].sum())
    needed, design = walk_needed(tex, "trans", sh)
    out["trans_walk"] = (min(ms, ms2), plain_ms) + bound(
        needed * OPS_BW, nbytes(o3, d3, aux, *tables) + 3 * 4 * o3.shape[0])
    log(f"  time transmittance walk, {o3.shape[0]} shadow lanes ({live} "
        f"live) x {tp_real} columns: kernel {ms:.4f} ms, {ms2:.4f} ms "
        f"(repeat); plain {plain_ms:.4f} ms; bound "
        f"{out['trans_walk'][2]:.4f} ms ({out['trans_walk'][3]}: {needed} "
        f"Baldwin-Weber tests in the admitted groups, once a live lane; the "
        f"design's own {design}, point lanes twice, "
        f"{bound(design * OPS_BW, 0)[0]:.4f} ms; one ungated pass per live "
        f"lane {bound(live * tp_real * OPS_BW, 0)[0]:.4f} ms)")
    return out


def phase_kernels(device):
    import torch
    from types import SimpleNamespace

    from path_tracer_torch.ops import cuda_intersect, cuda_spheres, intersect
    from path_tracer_torch.scene import load_scene
    from path_tracer_torch.scene.device_scene import _pack_spheres

    log("phase 3: kernels against their plain versions (seeded inputs)")
    as_t = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)

    # (a) the reference's 6,024 MT fixtures, one launch per (ray, triangle).
    fx = REPO / "tests" / "fixtures" / "moller_trumbore"
    n_ok = n_all = 0
    for name in ("hit_tests", "miss_tests"):
        z = np.load(fx / f"{name}.npz")
        for i in range(z["origin"].shape[0]):
            v0 = z["v0"][i:i + 1]
            e1, e2 = z["v1"][i:i + 1] - v0, z["v2"][i:i + 1] - v0
            soa = [np.zeros((256, 3), np.float32) for _ in range(3)]
            for arr, val in zip(soa, (v0, e1, e2)):
                arr[0] = val[0]
            one = SimpleNamespace(
                tri_v0=as_t(soa[0]), tri_e1=as_t(soa[1]), tri_e2=as_t(soa[2]),
                tri_packed_t=as_t(np.concatenate(soa, axis=1).T))
            hit = cuda_intersect.closest_hit_triangles_cuda(
                as_t(z["origin"][i:i + 1]), as_t(z["dir"][i:i + 1]),
                as_t([-1.0]), one)
            t, u, v = (float(x[0]) for x in (hit.t, hit.u, hit.v))
            if name == "hit_tests":
                ok = (int(hit.prim[0]) == 0
                      and abs(t - z["dist"][i]) <= FIXTURE_TOL
                      and abs(u - z["u"][i]) <= FIXTURE_TOL
                      and abs(v - z["v"][i]) <= FIXTURE_TOL)
            else:
                ok = int(hit.kind[0]) == 0
            n_ok += ok
            n_all += 1
    log(f"  MT fixtures through the CUDA kernel: {n_ok}/{n_all} pass "
        f"(tol {FIXTURE_TOL:g})")
    if n_ok != n_all or n_all != 6024:
        raise AssertionError("MT fixtures failed through the CUDA kernel")

    rng = np.random.default_rng(20261016)
    r = (1 << 18) - 37  # no multiple of the 256-thread block
    tri_stats, sph_stats = [], []
    for name in ("cube", "reflection"):
        sc = load_scene(scene_path(name), device)
        v = sc.tri_v0[: sc.num_real_triangles].cpu().numpy()
        o, d = random_rays(rng, r, v.min(0), v.max(0), device)
        check_pair(name, cuda_intersect.closest_hit_triangles_cuda,
                   intersect.closest_hit_triangles, sc, o, d, tri_stats)
    n_soup, n_pad = 2500, 2560
    v0 = np.zeros((n_pad, 3), np.float32)
    e1 = np.zeros((n_pad, 3), np.float32)
    e2 = np.zeros((n_pad, 3), np.float32)
    v0[:n_soup] = rng.uniform(-2, 2, (n_soup, 3))
    e1[:n_soup] = rng.uniform(-0.3, 0.3, (n_soup, 3))
    e2[:n_soup] = rng.uniform(-0.3, 0.3, (n_soup, 3))
    soup = SimpleNamespace(
        tri_v0=as_t(v0), tri_e1=as_t(e1), tri_e2=as_t(e2),
        tri_packed_t=as_t(np.concatenate([v0, e1, e2], axis=1).T))
    o, d = random_rays(rng, r, np.full(3, -2.0), np.full(3, 2.0), device)
    check_pair("soup2500", cuda_intersect.closest_hit_triangles_cuda,
               intersect.closest_hit_triangles, soup, o, d, tri_stats)

    sph_scene = load_scene(scene_path("spheres"), device)
    c = sph_scene.sph_center[: sph_scene.num_real_spheres].cpu().numpy()
    o, d = random_rays(rng, r, c.min(0) - 1, c.max(0) + 1, device)
    check_pair("spheres", cuda_spheres.closest_hit_spheres_cuda,
               intersect.closest_hit_spheres, sph_scene, o, d, sph_stats)
    centers = rng.uniform(-5, 5, (500, 3)).astype(np.float32)
    radii = rng.uniform(0.05, 0.4, 500).astype(np.float32)
    ball = SimpleNamespace(sph_center=as_t(centers), sph_radius=as_t(radii),
                           sph_packed_t=as_t(_pack_spheres(centers, radii)))
    o, d = random_rays(rng, r, np.full(3, -5.0), np.full(3, 5.0), device)
    check_pair("spheres500", cuda_spheres.closest_hit_spheres_cuda,
               intersect.closest_hit_spheres, ball, o, d, sph_stats)
    return tri_stats, sph_stats


def as_cuda(x, device, dtype=np.float32):
    import torch

    return torch.from_numpy(np.ascontiguousarray(x, dtype)).to(device)


def camera_rays(sc, n: int, device, tile: int = 4):
    """The first n lanes of one 2^18-lane wavefront of the main path:
    camera rays of 1080p pixels in the renderer's Morton order, sample 1.
    Tile 4 of the frame's 8 is its middle band (terrain and spheres; tile
    0 is mostly sky)."""
    import torch

    from path_tracer_torch.ops.camera import generate_rays
    from path_tracer_torch.ops.sorting import morton_pixel_order

    start = tile * (1 << 18)
    pix = torch.from_numpy(
        morton_pixel_order(1920, 1080)[start:start + n].copy())
    o, d = generate_rays(pix.to(device), 1920, 1080, sc, 1, 0)
    return o.contiguous(), d.contiguous()


def surface_points(rng, sc, n: int):
    """n points on random real triangles, 1e-5 off them along the unit
    geometric normal (turned up, as the terrain's), as numpy arrays; on a
    scene of spheres alone, on random real spheres, 1e-5 off along a
    random normal."""
    if sc.num_real_triangles == 0:
        n_s = sc.num_real_spheres
        k = rng.integers(0, n_s, n)
        c = sc.sph_center[:n_s].cpu().numpy()[k]
        rad = sc.sph_radius[:n_s].cpu().numpy()[k]
        nrm = rng.normal(size=(n, 3))
        nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
        return c + (rad[:, None] + 1e-5) * nrm, nrm
    k = rng.integers(0, sc.num_real_triangles, n)
    v0, e1, e2 = (x[: sc.num_real_triangles].cpu().numpy()[k]
                  for x in (sc.tri_v0, sc.tri_e1, sc.tri_e2))
    u, v = rng.uniform(size=(2, n, 1))
    fold = u + v > 1.0
    u, v = np.where(fold, 1.0 - u, u), np.where(fold, 1.0 - v, v)
    nrm = np.cross(e1, e2)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    nrm *= np.where(nrm[:, 1:2] < 0.0, -1.0, 1.0)
    return v0 + u * e1 + v * e2 + 1e-5 * nrm, nrm


def bounce_rays(rng, sc, n: int, device):
    """Bounce-like rays: from surface points in cosine-distributed
    directions about the normal."""
    p, nrm = surface_points(rng, sc, n)
    r1, r2 = rng.uniform(size=(2, n, 1))
    a = np.where(np.abs(nrm[:, 0:1]) < 0.9, [[1.0, 0.0, 0.0]],
                 [[0.0, 0.0, 1.0]])
    t = np.cross(nrm, a)
    t /= np.linalg.norm(t, axis=1, keepdims=True)
    b = np.cross(nrm, t)
    phi = 2.0 * np.pi * r2
    d = (t * np.sqrt(r1) * np.cos(phi) + b * np.sqrt(r1) * np.sin(phi)
         + nrm * np.sqrt(1.0 - r1))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return as_cuda(p, device), as_cuda(d, device)


def shadow_sets(rng, sc, n: int, device):
    """Shadow casts from surface points toward every light (directional
    first, raw direction, t_max = inf; then point lights, unit direction,
    t_max = the distance): (o, [d], [t_max])."""
    p, _ = surface_points(rng, sc, n)
    ds, tms = [], []
    for dd in sc.dir_dir.cpu().numpy():
        ds.append(np.broadcast_to(-dd, p.shape))
        tms.append(np.full(n, np.inf))
    for lp in sc.point_pos.cpu().numpy():
        to = lp - p
        dist = np.linalg.norm(to, axis=1)
        ds.append(to / dist[:, None])
        tms.append(dist)
    return (as_cuda(p, device), [as_cuda(x, device) for x in ds],
            [as_cuda(x, device) for x in tms])


def phase_flat_kernels(device, showcase):
    """The flat closest hit (with and without the fused sphere pass) and
    the flat any-hit against their plain versions, the MT kernel and each
    other on the showcase and forced-BVH reflection."""
    import torch

    from path_tracer_torch.ops import cuda_bvh, cuda_intersect, cuda_spheres
    from path_tracer_torch.ops.intersect import HitRecord
    from path_tracer_torch.scene import load_scene

    log("phase 3b: flat BVH kernels (showcase grid 224 in 256-slot blocks, "
        "reflection forced onto the BVH)")
    scenes = {"showcase": showcase,
              "reflection": load_scene(scene_path("reflection"), device,
                                       use_bvh=True)}
    rng = np.random.default_rng(20261017)
    n = (1 << 16) - 37  # no multiple of the 128-ray CTA
    flat_stats, occ_err = [], 0.0
    for name, sc in scenes.items():
        v = sc.tri_v0[: sc.num_real_triangles].cpu().numpy()
        third = n // 3
        parts = [random_rays(rng, third, v.min(0), v.max(0), device),
                 camera_rays(sc, third, device),
                 bounce_rays(rng, sc, n - 2 * third, device)]
        o = torch.cat([x[0] for x in parts]).contiguous()
        d = torch.cat([x[1] for x in parts]).contiguous()
        log(f"  {name}: {sc.num_real_triangles} triangles, "
            f"{sc.sl_n_blocks} blocks of {sc.sl_block}, {n} rays "
            "(random, camera, bounce)")
        check_pair(f"{name} flat vs plain", cuda_bvh.closest_hit_triangles_flat,
                   cuda_bvh.closest_hit_triangles_flat_plain, sc, o, d,
                   flat_stats)
        tp = torch.full((n,), -1.0, device=device)
        flat = cuda_bvh.closest_hit_triangles_flat(o, d, tp, sc)
        compare(f"{name} flat vs MT kernel", flat,
                cuda_intersect.closest_hit_triangles_cuda(o, d, tp, sc),
                t_diverges=True)
        if sc.num_real_spheres:
            for tpv in (tp, torch.where(torch.isfinite(flat.t), flat.t, -1.0)):
                fused = cuda_bvh.closest_hit_triangles_flat(o, d, tpv, sc,
                                                            spheres=True)
                tri = cuda_bvh.closest_hit_triangles_flat(o, d, tpv, sc)
                sph = cuda_spheres.closest_hit_spheres_cuda(o, d, tpv, sc)
                wins = sph.t < tri.t
                merged = HitRecord(*[torch.where(wins, b, a)
                                     for a, b in zip(tri, sph)])
                same = all(torch.equal(a, b) for a, b in zip(fused, merged))
                log(f"  {name} fused spheres vs flat + sphere kernel + merge: "
                    f"{'equal' if same else 'DIFFERENT'} (sphere lanes "
                    f"{float((fused.kind == 2).float().mean()):.3f})")
                if not same:
                    raise AssertionError("fused sphere pass disagrees")

        # Any-hit: plain, the closest hit's t (x1.01 / x0.99), dead lanes,
        # and one L = 3 launch against three L = 1 launches.
        t = flat.t
        above = torch.where(torch.isfinite(t), t * 1.01, 50.0)
        below = torch.where(torch.isfinite(t), t * 0.99, 50.0)
        dead = above.clone()
        dead[::5] = -1.0
        sets = [above, below, dead]
        multi = cuda_bvh.occluded_triangles_flat_multi(o, [d] * 3, sets, sc)
        singles = [cuda_bvh.occluded_triangles_flat(o, d, x, sc) for x in sets]
        plain = cuda_bvh.occluded_triangles_flat_multi_plain(o, [d] * 3, sets,
                                                             sc)
        want_above = torch.isfinite(t) & (t <= above)
        checks = {
            "L=3 vs plain": torch.equal(multi, plain),
            "L=3 vs 3 x L=1": all(torch.equal(multi[i], singles[i])
                                  for i in range(3)),
            "t_max = 1.01 t hits": torch.equal(multi[0], want_above),
            "t_max = 0.99 t misses": not bool(
                (multi[1] & torch.isfinite(t)).any()),
            "dead lanes occluded": bool(multi[2][::5].all()),
        }
        occ_err = max(occ_err, float((multi != plain).float().max()))
        log(f"  {name} any-hit: " + ", ".join(
            f"{k} {'ok' if ok else 'FAIL'}" for k, ok in checks.items())
            + f"; occluded {float(multi[0].float().mean()):.3f}")
        if not all(checks.values()):
            raise AssertionError(f"{name}: flat any-hit check failed")
    return flat_stats, occ_err


def first_bounce(sc, n: int, device):
    """The main path's first bounce over n camera lanes: the
    camera cast, then (o, d, t_prev) of cosine-distributed bounce rays
    from the hits about the shading normal, and the shadow casts of every
    light from the same hits (o, [d], [t_max]); lanes whose camera ray
    missed are dead (t_prev = +inf, t_max = -1), as in the integrator."""
    import torch

    from path_tracer_torch.models.integrator import NORMAL_BIAS, _surface
    from path_tracer_torch.ops.intersect import closest_hit

    o, d = camera_rays(sc, n, device)
    hit = closest_hit(o, d, torch.full((n,), -1.0, device=device), sc)
    surf = _surface(sc, hit, o, d)
    alive = hit.valid
    origin = (surf.pos + surf.geom_normal * NORMAL_BIAS).contiguous()
    nrm = torch.nn.functional.normalize(surf.normal, dim=1)
    g = torch.Generator(device=device).manual_seed(3)
    r1, r2 = torch.rand((2, n, 1), generator=g, device=device)
    a = torch.where(nrm[:, 0:1].abs() < 0.9,
                    torch.tensor([1.0, 0.0, 0.0], device=device),
                    torch.tensor([0.0, 0.0, 1.0], device=device))
    t = torch.nn.functional.normalize(torch.linalg.cross(nrm, a), dim=1)
    b = torch.linalg.cross(nrm, t)
    phi = 2.0 * np.pi * r2
    bd = (t * r1.sqrt() * phi.cos() + b * r1.sqrt() * phi.sin()
          + nrm * (1.0 - r1).sqrt()).contiguous()
    tp = torch.where(alive, -1.0, float("inf"))
    ds = [(-sc.dir_dir[k]).expand(n, 3).contiguous()
          for k in range(sc.num_dir_lights)]
    tms = [torch.where(alive, float("inf"), -1.0)] * sc.num_dir_lights
    for k in range(sc.num_point_lights):
        to = sc.point_pos[k] - origin
        dist = to.norm(dim=1)
        ds.append((to / dist[:, None]).contiguous())
        tms.append(torch.where(alive, dist, -1.0))
    return (origin, bd, tp), (origin, ds, tms)


def real_per_column(real, block: int, ids):
    """Real slots of each column: ``real`` [slots] bool marks the real
    slots of the packed table, ``block`` slots a block, ``ids`` [C] the
    columns' block ids (< 0: a pad column, 0)."""
    import torch

    per_block = real.view(-1, block).sum(1)
    return torch.where(ids >= 0, per_block[ids.clamp(min=0).long()], 0)


def needed_gate(tn, tf, ids, t_prev, t_max, occluded):
    """The walk's slab gate (ops/slab.py) of these lanes on columns ``ids``,
    cut to what the result needs: a closest hit (``t_prev`` given) enters
    only columns whose entry lies before the hit's t (``t_max``, +inf on a
    miss); an any-hit lane already ``occluded`` enters none."""
    from path_tracer_torch.ops import slab

    if t_prev is None:
        return slab.occluded_gate(tn, tf, t_max, ids) & ~occluded[:, None]
    return slab.closest_gate(tn, tf, t_prev, ids) & (tn <= t_max[:, None])


def flat_work(o, d, sc, t_prev, t_max, occluded=None) -> tuple[int, int]:
    """(slab tests, triangle tests) the flat walk needs on these rays: a
    slab test of every real block per live ray, and a Baldwin-Weber test
    of every real slot of each block whose slab the ray enters before its
    result's t (closest hit: t_max = the hit's t, +inf on a miss) or
    within t_max (any-hit; an occluded ray needs one test). ``t_prev``
    None marks the any-hit; dead lanes test nothing."""
    import torch

    from path_tracer_torch.ops import slab

    ids = sc.sl_blkid[0]
    real = real_per_column(sc.sl_bw_t[0:3].abs().sum(0) > 0, sc.sl_block, ids)
    live = (t_max >= 0.0) if t_prev is None else torch.isfinite(t_prev)
    slabs = int(live.sum()) * sc.sl_n_blocks
    tests = 0 if t_prev is not None else int((occluded & live).sum())
    for a in range(0, o.shape[0], 1 << 15):
        rs = slice(a, a + (1 << 15))
        tn, tf = slab.slab(o[rs], slab.safe_inv(d[rs]), sc.sl_blkflat)
        gate = needed_gate(tn, tf, ids, None if t_prev is None else t_prev[rs],
                           t_max[rs], None if occluded is None else occluded[rs])
        tests += int((gate * real).sum())
    return slabs, tests


def packet_counts(o, d, sc, t_prev, t_hit, two_level: bool = False) -> dict:
    """The flat closest hit's packets on these lanes, counted from the plain
    inputs (no kernel carries instrumentation). A lane is admitted to a
    block when its slab gate passes (``two_level``: its superblock's gate
    too, as flat2 gates), and needs it when the entry also lies before its
    hit's t (``t_hit``, +inf on a miss), as ``flat_work`` counts. The CTA
    walk (128-lane CTAs) visits the union of its lanes' needs and runs
    every slot of a visited block on each warp with a needing lane, 32
    lanes wide; the warp walk (32-lane warps) visits the union of its
    lanes' admissions and tests each admitted lane once per slot. Returns
    the sums: live lanes, needed and admitted lane-blocks, the CTA unions
    of needs, the warp unions of needs (the CTA walk's warp visits) and of
    admissions (the warp walk's visits), CTAs and warps with a live
    lane."""
    import torch

    from path_tracer_torch.ops import slab

    ids = sc.sl_blkid[0]
    bpad = ids.shape[0]
    live = torch.isfinite(t_prev)
    out = dict(lanes=int(live.sum()), needs=0, admits=0, cta_visits=0,
               cta_warp_visits=0, warp_visits=0, live_ctas=0, live_warps=0,
               sb_warp_visits=0)
    step = 1 << 15 if not two_level else 1 << 13  # whole CTAs
    for a in range(0, o.shape[0], step):
        rs = slice(a, a + step)
        inv = slab.safe_inv(d[rs])
        tn, tf = slab.slab(o[rs], inv, sc.sl_blkflat)
        gate = slab.closest_gate(tn, tf, t_prev[rs], ids)
        if two_level:
            g_sb = slab.closest_gate(*slab.slab(o[rs], inv, sc.sl_sbflat),
                                     t_prev[rs], sc.sl_sbid[0])
            gate &= g_sb.repeat_interleave(128, dim=1)[:, :bpad]
        need = gate & (tn <= t_hit[rs][:, None])
        n = need.shape[0]
        out["needs"] += int(need.sum())
        out["admits"] += int(gate.sum())

        def unions(g, size):
            return int(g[: n - n % size].view(-1, size, g.shape[1])
                       .any(dim=1).sum())

        if two_level:
            out["sb_warp_visits"] += unions(g_sb, 32)

        out["cta_visits"] += unions(need, 128)
        out["cta_warp_visits"] += unions(need, 32)
        out["warp_visits"] += unions(gate, 32)
        for key, size in (("ctas", 128), ("warps", 32)):
            out[f"live_{key}"] += int(
                live[rs][: n - n % size].view(-1, size).any(dim=1).sum())
    return out


def log_packets(label: str, c: dict, block: int) -> dict:
    """Logs ``packet_counts``' ratios; returns them."""
    lanes, warps = max(c["lanes"], 1), max(c["live_warps"], 1)
    r = dict(needs_per_lane=c["needs"] / lanes,
             admits_per_lane=c["admits"] / lanes,
             cta_per_cta=c["cta_visits"] / max(c["live_ctas"], 1),
             cta_per_warp=c["cta_warp_visits"] / warps,
             warp_per_warp=c["warp_visits"] / warps,
             cta_efficiency=c["needs"] / max(32 * c["cta_warp_visits"], 1),
             warp_efficiency=c["needs"] / max(c["admits"], 1))
    log(f"  packets, {label}: {c['lanes']} live lanes need "
        f"{r['needs_per_lane']:.3f} blocks each (admitted to "
        f"{r['admits_per_lane']:.3f}); CTA walk: {r['cta_per_cta']:.3f} "
        f"blocks per live 128-lane CTA, {r['cta_per_warp']:.3f} warp visits "
        f"per live warp, lane-slot tests {32 * c['cta_warp_visits'] * block} "
        f"(needed / executed {r['cta_efficiency']:.3f}); warp walk: "
        f"{r['warp_per_warp']:.3f} blocks per live 32-lane warp, lane-slot "
        f"tests {c['admits'] * block} (needed / executed "
        f"{r['warp_efficiency']:.3f}); needed {c['needs'] * block}"
        + (f"; superblocks admitted per live warp "
           f"{c['sb_warp_visits'] / warps:.3f}" if c["sb_warp_visits"]
           else ""))
    return r


def phase_flat_timing(device, showcase):
    """Flat kernel and plain-version milliseconds at the main path's
    shapes: 2^18 lanes (the middle wavefront) of showcase camera rays, of
    the first bounce's rays and of its shadow casts toward the three
    lights (L = 3); then the kernels alone on incoherent rays from random
    terrain points."""
    import torch

    from path_tracer_torch.ops import cuda_bvh

    n = WAVE
    (bo, bd, btp), (so, sds, stms) = first_bounce(showcase, n, device)
    o, d = camera_rays(showcase, n, device)
    out = {}
    for label, (ro, rd, tp) in (
            ("camera", (o, d, torch.full((n,), -1.0, device=device))),
            ("first bounce", (bo, bd, btp))):
        run = lambda: cuda_bvh.closest_hit_triangles_flat(ro, rd, tp, showcase,
                                                          spheres=True)
        plain = lambda: cuda_bvh.closest_hit_triangles_flat_plain(
            ro, rd, tp, showcase, spheres=True)
        ms, plain_ms, ms2 = cuda_ms(run, 20), cuda_ms(plain, 2), cuda_ms(run, 20)
        t_out = run().t
        slabs, tests = flat_work(ro, rd, showcase, tp, t_out)
        work = bound(slabs * OPS_SLAB + tests * OPS_BW
                     + n * showcase.num_real_spheres * OPS_SPHERE,
                     nbytes(ro, rd, tp, showcase.sl_blkflat,
                            showcase.sl_blkid, showcase.sl_bw_t,
                            showcase.sph_packed_t) + n * (5 * 4 + 4))
        log(f"  time flat closest hit + spheres, {n} {label} rays x "
            f"{showcase.sl_n_blocks} blocks: kernel {ms:.4f} ms, {ms2:.4f} ms "
            f"(repeat); plain {plain_ms:.4f} ms; bound {work[0]:.4f} ms "
            f"({work[1]}: {slabs} slab tests, {tests} triangle tests)")
        out[label] = (min(ms, ms2), plain_ms) + work
    run = lambda: cuda_bvh.occluded_triangles_flat_multi(so, sds, stms,
                                                         showcase)
    plain = lambda: cuda_bvh.occluded_triangles_flat_multi_plain(so, sds, stms,
                                                                 showcase)
    ms, plain_ms, ms2 = cuda_ms(run, 20), cuda_ms(plain, 2), cuda_ms(run, 20)
    occ = run()
    slabs = tests = 0
    for k, (sd, tm) in enumerate(zip(sds, stms)):
        a, b = flat_work(so, sd, showcase, None, tm, occ[k])
        slabs, tests = slabs + a, tests + b
    work = bound(slabs * OPS_SLAB + tests * OPS_BW,
                 nbytes(so, *sds, *stms, showcase.sl_blkflat,
                        showcase.sl_blkid, showcase.sl_bw_t)
                 + n * len(sds))  # the [L,R] bool output
    log(f"  time flat any-hit, {n} first-bounce shadow rays x L={len(sds)}: "
        f"kernel {ms:.4f} ms, {ms2:.4f} ms (repeat); plain {plain_ms:.4f} ms; "
        f"bound {work[0]:.4f} ms ({work[1]}: {slabs} slab tests, {tests} "
        "triangle tests)")
    out["occluded"] = (min(ms, ms2), plain_ms) + work

    rng = np.random.default_rng(7)
    ro, rd = bounce_rays(rng, showcase, n, device)
    tp = torch.full((n,), -1.0, device=device)
    ms = cuda_ms(lambda: cuda_bvh.closest_hit_triangles_flat(
        ro, rd, tp, showcase, spheres=True), 5)
    so, sds, stms = shadow_sets(rng, showcase, n, device)
    occ_ms = cuda_ms(lambda: cuda_bvh.occluded_triangles_flat_multi(
        so, sds, stms, showcase), 5)
    log(f"  time on incoherent rays from random terrain points: closest hit "
        f"+ spheres {ms:.4f} ms, any-hit L={len(sds)} {occ_ms:.4f} ms")
    return out


def phase_flat2_kernels(device, big):
    """3d: the flat2 closest hit and any-hit against their plain versions
    and the flat kernels on the 991k-triangle showcase's opaque view (the
    tables the main path casts on), then flat2 against the MT kernel over
    the whole scene's triangles. Returns (closest-hit stats, any-hit max
    error)."""
    import torch

    from path_tracer_torch.ops import cuda_bvh, cuda_intersect
    from path_tracer_torch.scene.device_scene import opaque_view

    op = opaque_view(big)
    log(f"phase 3d: flat2 kernels (textured showcase grid {BIG_GRID}: "
        f"{big.num_real_triangles} triangles, opaque view {op.sl_n_blocks} "
        f"blocks of {big.sl_block} in {int((op.sl_sbid >= 0).sum())} "
        f"superblocks, {nbytes(big.sl_bw_t) / 1e6:.1f} MB of BW rows)")
    rng = np.random.default_rng(20261019)
    n = (1 << 16) - 37  # no multiple of the 128-ray CTA
    half = n // 2
    co, cd = camera_rays(big, half, device)
    v = big.tri_v0[: big.num_real_triangles].cpu().numpy()
    ro, rd = random_rays(rng, n - half, v.min(0), v.max(0), device)
    o, d = torch.cat([co, ro]).contiguous(), torch.cat([cd, rd]).contiguous()
    stats = []
    tp = torch.full((n,), -1.0, device=device)
    tp[::7] = float("inf")  # dead lanes
    for label in ("t_prev=-1", "t_prev=first hit"):
        want = cuda_bvh.closest_hit_triangles_flat2_plain(o, d, tp, op)
        got = cuda_bvh.closest_hit_triangles_flat2(o, d, tp, op)
        stats.append(compare(f"flat2 vs plain, {label}, every 7th lane dead",
                             got, want))
        if stats[-1][0] != 0.0:
            raise AssertionError("flat2 closest hit: mismatching lanes")
        flat = cuda_bvh.closest_hit_triangles_flat(o, d, tp, op)
        same = all(torch.equal(a, b) for a, b in zip(got, flat))
        log(f"  flat2 vs the flat kernel on the same tables: "
            f"{'equal' if same else 'DIFFERENT'}")
        if not same:
            raise AssertionError("flat2 and flat records differ")
        tp = torch.where(torch.isfinite(got.t), got.t, -1.0)
        tp[::7] = float("inf")

    _, (so, sds, stms) = first_bounce(big, n, device)
    kill = as_cuda(rng.uniform(size=(len(stms), n)) < 0.1, device, bool)
    stms = [torch.where(k, -1.0, tm) for k, tm in zip(kill, stms)]
    multi = cuda_bvh.occluded_triangles_flat2_multi(so, sds, stms, op)
    plain = cuda_bvh.occluded_triangles_flat2_multi_plain(so, sds, stms, op)
    flat = cuda_bvh.occluded_triangles_flat_multi(so, sds, stms, op)
    n_off = int((multi != plain).sum())
    log(f"  flat2 any-hit, {len(sds)} first-bounce shadow sets x {n} lanes "
        f"(10% killed): mismatching lanes vs plain {n_off}, vs the flat "
        f"kernel {int((multi != flat).sum())}; occluded "
        f"{float(multi.float().mean()):.3f}")
    if n_off or not torch.equal(multi, flat) \
            or not bool(multi[torch.stack(stms) < 0].all()):
        raise AssertionError("flat2 any-hit disagrees")

    # The divergence gate at 991k triangles (tpu_kernel_check.py:163-194):
    # the Baldwin-Weber walk against brute-force Moller-Trumbore.
    rb = 1 << 17
    ob = as_cuda(rng.uniform(v.min(0) - 5, v.max(0) + 5, (rb, 3)), device)
    tgt = as_cuda(rng.uniform(v.min(0), v.max(0), (rb, 3)), device)
    db = torch.nn.functional.normalize(tgt - ob, dim=1).contiguous()
    tpb = torch.full((rb,), -1.0, device=device)
    got = cuda_bvh.closest_hit_triangles_flat2(ob, db, tpb, big)
    ref = cuda_intersect.closest_hit_triangles_cuda(ob, db, tpb, big)
    hit_got, hit_ref = torch.isfinite(got.t), torch.isfinite(ref.t)
    t_far = hit_got & hit_ref & ~torch.isclose(got.t, ref.t, rtol=5e-5,
                                               atol=5e-5)
    rate = float(((hit_got != hit_ref) | t_far).float().mean())
    log(f"  flat2 vs MT kernel, {rb} random rays over {big.num_real_triangles}"
        f" triangles ({big.sl_n_blocks} blocks): divergence rate {rate:.2e} "
        f"(<= {MAX_DIVERGENCE:g}), hit {float(hit_ref.float().mean()):.3f}, "
        f"prim differs on {int((got.prim != ref.prim).sum())} lanes")
    if rate > MAX_DIVERGENCE:
        raise AssertionError("flat2 diverges from MT")
    return stats, float((multi != plain).float().max())


def phase_sph_walk_kernel(device, grid):
    """3e: the sphere block walk against its plain version and the dense
    sphere kernel on the 4,900-sphere grid. Returns the stats."""
    import dataclasses

    import torch

    from path_tracer_torch.ops import cuda_spheres

    log(f"phase 3e: sphere block walk ({grid.num_real_spheres} spheres in "
        f"{int((grid.sph_blkid >= 0).sum())} blocks of 128)")
    rng = np.random.default_rng(20261020)
    n = (1 << 16) - 37
    half = n // 2
    co, cd = camera_rays(grid, half, device)
    ro, rd = random_rays(rng, n - half, np.full(3, -38.0), np.full(3, 38.0),
                         device)
    o, d = torch.cat([co, ro]).contiguous(), torch.cat([cd, rd]).contiguous()
    dense = dataclasses.replace(grid, sph_use_blocks=False)
    stats = []
    tp = torch.full((n,), -1.0, device=device)
    tp[::7] = float("inf")
    for label in ("t_prev=-1", "t_prev=first hit"):
        got = cuda_spheres.closest_hit_spheres_cuda(o, d, tp, grid)
        stats.append(compare(f"sphere walk vs plain, {label}, every 7th lane "
                             "dead", got, cuda_spheres.
                             closest_hit_spheres_walk_plain(o, d, tp, grid)))
        if stats[-1][0] != 0.0:
            raise AssertionError("sphere walk: mismatching lanes")
        ref = cuda_spheres.closest_hit_spheres_cuda(o, d, tp, dense)
        flip = (got.prim != ref.prim) | (got.kind != ref.kind)
        ok = ~flip & ref.valid
        rel = float(((got.t - ref.t).abs() / ref.t.abs())[ok].max())
        log(f"  sphere walk vs dense kernel, {label}: prim flip rate "
            f"{float(flip.float().mean()):.2e} (<= {MAX_SPHERE_FLIPS}), max "
            f"rel t {rel:.2e} (<= {SPHERE_RTOL}), hit "
            f"{float(ref.valid.float().mean()):.3f}")
        if float(flip.float().mean()) > MAX_SPHERE_FLIPS or rel > SPHERE_RTOL:
            raise AssertionError("sphere walk disagrees with the dense kernel")
        tp = torch.where(torch.isfinite(got.t), got.t, -1.0)
        tp[::7] = float("inf")
    return stats


def flat2_work(o, d, sc, t_prev, t_max, occluded=None):
    """(slab tests, triangle tests, block columns entered [bpad] bool) the
    flat2 walk needs on these rays: a slab test of every real superblock
    per live ray and of the 128 columns of each superblock it enters
    before its result's t (closest hit: t_max = the hit's t; any-hit:
    within t_max), and a Baldwin-Weber test of every real slot of each
    block it enters in those. ``t_prev`` None marks the any-hit (an
    occluded ray needs one test)."""
    import torch

    from path_tracer_torch.ops import slab

    ids, sb_ids = sc.sl_blkid[0], sc.sl_sbid[0]
    real = real_per_column(sc.sl_bw_t[0:3].abs().sum(0) > 0, sc.sl_block, ids)
    bpad = sc.sl_blkflat.shape[1]
    live = (t_max >= 0.0) if t_prev is None else torch.isfinite(t_prev)
    slabs = int(live.sum()) * int((sb_ids >= 0).sum())
    tests = 0 if t_prev is not None else int((occluded & live).sum())
    needed = torch.zeros_like(ids, dtype=torch.bool)
    for a in range(0, o.shape[0], 1 << 13):
        rs = slice(a, a + (1 << 13))
        inv = slab.safe_inv(d[rs])
        g_sb, g = (needed_gate(*slab.slab(o[rs], inv, table), table_ids,
                               None if t_prev is None else t_prev[rs],
                               t_max[rs],
                               None if occluded is None else occluded[rs])
                   for table, table_ids in ((sc.sl_sbflat, sb_ids),
                                            (sc.sl_blkflat, ids)))
        g &= g_sb.repeat_interleave(128, dim=1)[:, :bpad]
        slabs += 128 * int(g_sb.sum())
        tests += int((g * real).sum())
        needed |= g.any(0)
    return slabs, tests, needed


def rows_bytes(sc, needed) -> int:
    """Bytes of the 12 used BW rows of the blocks in ``needed``, each read
    once."""
    return int(needed.sum()) * 12 * sc.sl_block * 4


def phase_flat2_timing(device, big):
    """Flat2 kernel and plain-version milliseconds at the main path's
    shapes on the 991k-triangle showcase's opaque view: 2^18 camera lanes
    of the middle wavefront, its first bounce's rays and its three shadow
    sets; beside each, the flat kernel on the same tables and rays (the
    A/B of whether flat2 is still needed on this card). The kernels'
    results must equal the timed plain versions' on every lane."""
    import torch

    from path_tracer_torch.ops import cuda_bvh
    from path_tracer_torch.scene.device_scene import opaque_view

    op = opaque_view(big)
    n = WAVE
    (bo, bd, btp), (so, sds, stms) = first_bounce(big, n, device)
    o, d = camera_rays(big, n, device)
    tables = (op.sl_sbflat, op.sl_sbid, op.sl_blkflat, op.sl_blkid)
    out = {"stats": []}
    for label, (ro, rd, tp) in (
            ("camera", (o, d, torch.full((n,), -1.0, device=device))),
            ("first bounce", (bo, bd, btp))):
        run = lambda: cuda_bvh.closest_hit_triangles_flat2(ro, rd, tp, op)
        flat = lambda: cuda_bvh.closest_hit_triangles_flat(ro, rd, tp, op)
        plain = lambda: cuda_bvh.closest_hit_triangles_flat2_plain(ro, rd, tp,
                                                                   op)
        ms, flat_ms = cuda_ms(run, 10), cuda_ms(flat, 10)
        plain_ms, want = timed_once(plain)
        ms2, flat_ms2 = cuda_ms(run, 10), cuda_ms(flat, 10)
        got = run()
        out["stats"].append(compare(f"flat2 vs plain, {n} {label} lanes",
                                    got, want))
        if out["stats"][-1][0] != 0.0:
            raise AssertionError("flat2 closest hit: mismatching lanes")
        slabs, tests, needed = flat2_work(ro, rd, op, tp, got.t)
        rows = rows_bytes(op, needed)
        work = bound(slabs * OPS_SLAB + tests * OPS_BW,
                     nbytes(ro, rd, tp, *tables) + rows + n * (4 * 4 + 4))
        log(f"  time flat2 closest hit, {n} {label} rays x {op.sl_n_blocks} "
            f"blocks: kernel {ms:.4f} ms, {ms2:.4f} ms (repeat); the flat "
            f"kernel on the same tables {flat_ms:.4f} ms, {flat_ms2:.4f} ms; "
            f"plain {plain_ms:.4f} ms; bound {work[0]:.4f} ms ({work[1]}: "
            f"{slabs} slab tests, {tests} triangle tests, {rows / 1e6:.1f} MB "
            "of BW rows)")
        out[label] = (min(ms, ms2), plain_ms) + work
        out[f"flat {label}"] = min(flat_ms, flat_ms2)
    run = lambda: cuda_bvh.occluded_triangles_flat2_multi(so, sds, stms, op)
    flat = lambda: cuda_bvh.occluded_triangles_flat_multi(so, sds, stms, op)
    plain = lambda: cuda_bvh.occluded_triangles_flat2_multi_plain(so, sds,
                                                                  stms, op)
    ms, flat_ms = cuda_ms(run, 10), cuda_ms(flat, 10)
    plain_ms, want = timed_once(plain)
    ms2, flat_ms2 = cuda_ms(run, 10), cuda_ms(flat, 10)
    occ = run()
    n_off = int((occ != want).sum())
    log(f"  flat2 any-hit vs plain, {len(sds)} first-bounce shadow sets x "
        f"{n} lanes: mismatching lanes {n_off}")
    if n_off:
        raise AssertionError("flat2 any-hit: mismatching lanes")
    out["occluded err"] = float((occ != want).float().max())
    slabs = tests = 0
    needed = torch.zeros_like(op.sl_blkid[0], dtype=torch.bool)
    for k, (sd, tm) in enumerate(zip(sds, stms)):
        a, b, c = flat2_work(so, sd, op, None, tm, occ[k])
        slabs, tests, needed = slabs + a, tests + b, needed | c
    rows = rows_bytes(op, needed)
    work = bound(slabs * OPS_SLAB + tests * OPS_BW,
                 nbytes(so, *sds, *stms, *tables) + rows
                 + n * len(sds))  # the [L,R] bool output
    log(f"  time flat2 any-hit, {n} first-bounce shadow rays x L={len(sds)}: "
        f"kernel {ms:.4f} ms, {ms2:.4f} ms (repeat); the flat kernel "
        f"{flat_ms:.4f} ms, {flat_ms2:.4f} ms; plain {plain_ms:.4f} ms; bound "
        f"{work[0]:.4f} ms ({work[1]}: {slabs} slab tests, {tests} triangle "
        f"tests)")
    out["occluded"] = (min(ms, ms2), plain_ms) + work
    out["flat occluded"] = min(flat_ms, flat_ms2)
    return out


def phase_sph_timing(device, grid):
    """Sphere walk and plain-version milliseconds on the 4,900-sphere
    grid's middle 2^18-lane camera wavefront at 1080p, beside the dense
    sphere kernel on the same rays; the walk must equal the timed plain
    version on every lane. Returns ((ms, plain ms, bound ms, bound by),
    the comparison's stats)."""
    import dataclasses

    import torch

    from path_tracer_torch import native
    from path_tracer_torch.ops import cuda_spheres, slab

    n = WAVE
    o, d = camera_rays(grid, n, device)
    tp = torch.full((n,), -1.0, device=device)
    dense = dataclasses.replace(grid, sph_use_blocks=False)
    run = lambda: cuda_spheres.closest_hit_spheres_cuda(o, d, tp, grid)
    plain = lambda: cuda_spheres.closest_hit_spheres_walk_plain(o, d, tp, grid)
    dense_run = lambda: cuda_spheres.closest_hit_spheres_cuda(o, d, tp, dense)
    # The launch alone, without the wrapper's record mapping: its few
    # small host-launched ops weigh on a sub-millisecond kernel.
    bare = lambda: native.launch_sph_walk(o, d, tp, grid.sph_blk,
                                          grid.sph_blkid, grid.sph_sorted_t,
                                          grid.sph_smap)
    ms, bare_ms, dense_ms = (cuda_ms(run, 20), cuda_ms(bare, 20),
                             cuda_ms(dense_run, 5))
    plain_ms, want = timed_once(plain)
    ms2, bare_ms2, dense_ms2 = (cuda_ms(run, 20), cuda_ms(bare, 20),
                                cuda_ms(dense_run, 5))
    got = run()
    stats = [compare(f"sphere walk vs plain, {n} camera lanes", got, want)]
    if stats[0][0] != 0.0:
        raise AssertionError("sphere walk: mismatching lanes")
    # Solves: the real spheres of every block a lane enters before its hit.
    ids = grid.sph_blkid[0]
    real = real_per_column(grid.sph_sorted_t[3] > 0.0, 128, ids)
    tn, tf = slab.slab(o, slab.safe_inv(d), grid.sph_blk)
    gate = needed_gate(tn, tf, ids, tp, got.t, None)
    n_blk = int((ids >= 0).sum())
    solves = int((gate * real).sum())
    work = bound(n * n_blk * OPS_SLAB + solves * OPS_SPHERE,
                 nbytes(o, d, tp, grid.sph_blk, grid.sph_blkid,
                        grid.sph_sorted_t, grid.sph_smap)
                 + n * (3 * 4 + 2 * 4 + 1))
    log(f"  time sphere walk, {n} camera rays x {grid.num_real_spheres} "
        f"spheres ({n_blk} blocks): kernel {ms:.4f} ms, {ms2:.4f} ms "
        f"(repeat); the launch alone {bare_ms:.4f} ms, {bare_ms2:.4f} ms; "
        f"plain {plain_ms:.4f} ms; the dense sphere kernel "
        f"{dense_ms:.4f} ms, {dense_ms2:.4f} ms; bound {work[0]:.4f} ms "
        f"({work[1]}: {solves} sphere tests, {int(gate.sum())} blocks "
        "entered)")
    return (min(ms, ms2), plain_ms) + work, stats


def phase_timing(device):
    """Kernel and plain-version milliseconds at the main path's shapes: the
    first 2^18-lane wavefront of camera rays at 1080p against reflection's
    2,048-column and spheres' 128-column tables."""
    import torch

    from path_tracer_torch.ops import cuda_intersect, cuda_spheres, intersect
    from path_tracer_torch.ops.camera import generate_rays
    from path_tracer_torch.ops.sorting import morton_pixel_order
    from path_tracer_torch.scene import load_scene

    pix = torch.from_numpy(morton_pixel_order(1920, 1080)[:WAVE].copy())
    out = {}
    for key, name, wrapper, plain in (
            ("mt", "reflection", cuda_intersect.closest_hit_triangles_cuda,
             intersect.closest_hit_triangles),
            ("sphere", "spheres", cuda_spheres.closest_hit_spheres_cuda,
             intersect.closest_hit_spheres)):
        sc = load_scene(scene_path(name), device)
        o, d = generate_rays(pix.to(device), 1920, 1080, sc, 1, 0)
        o, d = o.contiguous(), d.contiguous()
        tp = torch.full((o.shape[0],), -1.0, device=device)
        ms = cuda_ms(lambda: wrapper(o, d, tp, sc), 20)
        plain_ms = cuda_ms(lambda: plain(o, d, tp, sc), 3)
        ms2 = cuda_ms(lambda: wrapper(o, d, tp, sc), 20)
        table = sc.tri_packed_t if key == "mt" else sc.sph_packed_t
        r = o.shape[0]
        if key == "mt":
            work = bound(r * sc.num_real_triangles * OPS_MT,
                         nbytes(o, d, tp, table) + r * (4 * 4 + 4))
        else:
            work = bound(r * sc.num_real_spheres * OPS_SPHERE,
                         nbytes(o, d, tp, table) + r * (3 * 4 + 2 * 4 + 1))
        log(f"  time {key}: {r} lanes x {table.shape[1]} columns: kernel "
            f"{ms:.4f} ms, {ms2:.4f} ms (repeat); plain {plain_ms:.4f} ms; "
            f"bound {work[0]:.4f} ms ({work[1]})")
        out[key] = (min(ms, ms2), plain_ms) + work
    return out


def first_bounce_shadows(sc, n: int, device, rng=None):
    """The shadow casts of the first bounce of n camera lanes of the middle
    1080p wavefront toward every light (directional first), as the
    integrator builds them: origins 1e-5 off the hits, t_max the exact
    range limit (``shadow_t_max``) on lanes whose camera ray hit and whose
    surface faces the light, else -1; with ``rng`` a tenth of the lanes of
    every set killed besides (t_max = -1). For a partitioned scene also
    the fused kernel's walk windows pd (the prefilter of the integrator's
    fused path). Returns a dict of the fused kernel's arguments."""
    import torch

    from path_tracer_torch.models.integrator import NORMAL_BIAS, _surface
    from path_tracer_torch.ops.intersect import closest_hit, shadow_t_max
    from path_tracer_torch.ops.trwalk import hits_transparent_bounds

    o, d = camera_rays(sc, n, device)
    hit = closest_hit(o, d, torch.full((n,), -1.0, device=device), sc)
    surf = _surface(sc, hit, o, d)
    so = (surf.pos + surf.geom_normal * NORMAL_BIAS).contiguous()
    ds, mds = [], []
    for k in range(sc.num_dir_lights):
        ds.append((-sc.dir_dir[k]).expand(n, 3).contiguous())
        mds.append(None)
    for k in range(sc.num_point_lights):
        to_surf = surf.pos - sc.point_pos[k]
        dist = torch.sqrt((to_surf * to_surf).sum(-1))
        ds.append(-(to_surf / dist[:, None]))
        mds.append(dist)
    t_maxes, pds = [], []
    for dd, md in zip(ds, mds):
        act = hit.valid & ((surf.normal * dd).sum(-1) > 0.0)
        if rng is not None:
            act &= as_cuda(rng.uniform(size=n) > 0.1, device, bool)
        t_maxes.append(torch.where(act, shadow_t_max(so, dd, surf.pos, md),
                                   -1.0))
        if sc.tr_kernel_ok:
            pd = torch.full((n,), float("inf"), device=device) \
                if md is None else md
            walk = act & hits_transparent_bounds(sc, so, dd,
                                                 pd * 1.0001 + 1e-3)
            pds.append(torch.where(walk, pd, -1.0))
    return dict(s_o=so, dirs=ds, t_maxes=t_maxes, pds=pds,
                is_pt=[md is not None for md in mds], surf_pos=surf.pos,
                orig_uv=surf.uv, orig_simple=surf.simple, max_dists=mds)


def in_range_occluded(o, d, sc, surf_pos, max_dist):
    """[R] bool: the JAX package's elementwise sphere any-hit
    (``path_tracer_tpu/ops/intersect.py:304-313``): both roots of every
    real sphere, dividing by 2a, an occluder in range when its distance
    from the surface point is at most ``max_dist`` (any distance without
    one)."""
    import torch

    from path_tracer_torch.ops.intersect import _sphere_roots

    out = []
    for a in range(0, o.shape[0], 1 << 13):
        rs = slice(a, a + (1 << 13))
        oc, dc = o[rs], d[rs]
        has, t1, t2 = _sphere_roots(oc, dc, sc)
        if max_dist is None:
            ok1, ok2 = t1 >= 0.0, t2 >= 0.0
        else:
            b = oc - surf_pos[rs]
            b_dot_d = (b * dc).sum(-1)[:, None]
            b_sq = (b * b).sum(-1)[:, None]
            d_sq = (dc * dc).sum(-1)[:, None]
            lim = (max_dist[rs] * max_dist[rs])[:, None]
            rng_ok = lambda t: t * t * d_sq + 2.0 * t * b_dot_d + b_sq <= lim
            ok1, ok2 = (t1 >= 0.0) & rng_ok(t1), (t2 >= 0.0) & rng_ok(t2)
        out.append((has & (ok1 | ok2)).any(dim=1))
    return torch.cat(out)


def sphere_any_hit_work(sh, sc, occ) -> tuple[int, int]:
    """(slab tests, sphere tests) the sphere any-hit needs on these sets:
    dense, every real sphere per live lane the kernel leaves unoccluded and
    one test per occluded lane; the walk, a slab test of every real block
    per live lane and the real spheres of every block an unoccluded lane's
    gate admits, on the widened boxes and intervals the kernel's gate
    needs (``slab.padded_slab``; an occluded lane needs one test)."""
    from path_tracer_torch.ops import slab

    slabs = tests = 0
    for k, (dd, tm) in enumerate(zip(sh["dirs"], sh["t_maxes"])):
        live, hit = tm >= 0.0, occ[k]
        tests += int(hit.sum())
        open_ = live & ~hit
        if not sc.sph_use_blocks:
            tests += int(open_.sum()) * sc.num_real_spheres
            continue
        ids = sc.sph_blkid[0]
        real = real_per_column(sc.sph_sorted_t[3] > 0.0, 128, ids)
        slabs += int(live.sum()) * int((ids >= 0).sum())
        for a in range(0, dd.shape[0], 1 << 15):
            rs = slice(a, a + (1 << 15))
            tn, tf = slab.padded_slab(sh["s_o"][rs], slab.safe_inv(dd[rs]),
                                      sc.sph_blk)
            gate = slab.occluded_gate(tn, tf, tm[rs], ids) & open_[rs, None]
            tests += int((gate * real).sum())
    return slabs, tests


def phase_sphere_any_hit(device, sc, label: str):
    """3f: the sphere any-hit kernel of ``sc`` (dense up to 512 spheres,
    the walk above) on the first bounce's shadow sets of the middle 2^18
    camera lanes toward every light, a tenth killed: against its timed
    plain version (0 lanes may differ) and against the JAX package's
    elementwise in_range form (at most MAX_RANGE_FLIPS of the lanes), then
    timed. Returns (max abs err, (ms, plain ms, bound ms, bound by))."""
    import torch

    from path_tracer_torch import native
    from path_tracer_torch.ops import cuda_spheres

    rng = np.random.default_rng(20261021)
    n = WAVE
    sh = first_bounce_shadows(sc, n, device, rng)
    args = (sh["s_o"], sh["dirs"], sh["t_maxes"], sc)
    run = lambda: cuda_spheres.occluded_spheres_cuda(*args)
    plain_ms, want = timed_once(lambda: cuda_spheres.occluded_spheres_plain(
        *args))
    got = run()
    n_off = int((got != want).sum())
    flips, lanes = 0, 0
    for k, (dd, md) in enumerate(zip(sh["dirs"], sh["max_dists"])):
        ref = in_range_occluded(sh["s_o"], dd, sc, sh["surf_pos"], md) \
            & (sh["t_maxes"][k] >= 0.0)
        flips += int((ref != got[k]).sum())
        lanes += n
    # The launch alone, as the main path makes it.
    o3 = sh["s_o"].contiguous()
    ds = torch.stack(sh["dirs"]).contiguous()
    tms = torch.stack(sh["t_maxes"]).contiguous()
    if sc.sph_use_blocks:
        tables = (sc.sph_blk, sc.sph_blkid, sc.sph_sorted_t)
        bare = lambda: native.launch_sph_occ_walk(o3, ds, tms, *tables)
    else:
        tables = (sc.sph_packed_t,)
        bare = lambda: native.launch_sph_occluded(o3, ds, tms, *tables,
                                                  sc.num_real_spheres)
    ms, bare_ms = cuda_ms(run, 20), cuda_ms(bare, 20)
    ms2, bare_ms2 = cuda_ms(run, 20), cuda_ms(bare, 20)
    slabs, tests = sphere_any_hit_work(sh, sc, got)
    work = bound(slabs * OPS_SLAB + tests * OPS_SPHERE,
                 nbytes(o3, ds, tms, *tables) + ds.shape[0] * n)  # bool out
    live = float((tms >= 0.0).float().mean())
    log(f"  {label}: {ds.shape[0]} sets x {n} first-bounce shadow lanes "
        f"(live {live:.3f}), {sc.num_real_spheres} spheres "
        f"({'walk' if sc.sph_use_blocks else 'dense'}): lanes off the plain "
        f"version {n_off}; against the elementwise in_range form "
        f"{flips} of {lanes} lanes ({flips / lanes:.2e}, <= "
        f"{MAX_RANGE_FLIPS:g}); occluded {float(got.float().mean()):.3f}; "
        f"kernel {ms:.4f} ms, {ms2:.4f} ms (repeat), the launch alone "
        f"{bare_ms:.4f} ms, {bare_ms2:.4f} ms; plain {plain_ms:.4f} ms; "
        f"bound {work[0]:.4f} ms ({work[1]}: {slabs} slab tests, {tests} "
        "sphere tests)")
    if n_off or flips > MAX_RANGE_FLIPS * lanes \
            or bool(got[tms < 0.0].any()):
        raise AssertionError(f"{label}: sphere any-hit disagrees")
    return float((got != want).float().max()), (min(ms, ms2),
                                                 plain_ms) + work


def fused_bound(tex, sh, walk_tables) -> dict:
    """The fused shadow kernel's bound on ``first_bounce_shadows`` lanes
    ``sh``: the flat any-hit's on these lanes plus the transmittance
    walk's on the lanes it leaves walking; ``walk_tables`` = (rows,
    plane) the walk reads (the forward or the live ones)."""
    import torch

    from path_tracer_torch.ops import cuda_bvh
    from path_tracer_torch.scene.device_scene import opaque_view

    ov = opaque_view(tex)
    n_l, n = len(sh["dirs"]), sh["s_o"].shape[0]
    occ = cuda_bvh.occluded_triangles_flat_multi(sh["s_o"], sh["dirs"],
                                                 sh["t_maxes"], ov)
    slabs = tests = 0
    for k, (dd, tm) in enumerate(zip(sh["dirs"], sh["t_maxes"])):
        a, b = flat_work(sh["s_o"], dd, ov, None, tm, occ[k])
        slabs, tests = slabs + a, tests + b
    tp_real = int((tex.tr_bw[0:3].abs().sum(0) > 0).sum())
    walkers = int(((torch.stack(sh["pds"]) >= 0.0) & ~occ).sum())
    tables = (tex.tr_bw, *walk_tables, tex.tr_lut, tex.tr_page_table)
    b10 = bound(slabs * OPS_SLAB + tests * OPS_BW,
                nbytes(sh["s_o"], *sh["dirs"], *sh["t_maxes"], ov.sl_blkflat,
                       ov.sl_blkid, tex.sl_bw_t) + 4 * n_l * n)
    b14 = bound(walkers * tp_real * OPS_BW,
                nbytes(*sh["pds"], sh["surf_pos"], sh["orig_uv"],
                       sh["orig_simple"], *tables) + 3 * 4 * n_l * n)
    work = (b10[0] + b14[0], b10[1] if b10[0] >= b14[0] else b14[1])
    return dict(work=work, b10=b10, b14=b14, slabs=slabs, tests=tests,
                walkers=walkers, tp_real=tp_real)


def fused_incoherent(rng, sc, n: int, device) -> dict:
    """The fused kernel's arguments for n incoherent lanes: shadow casts
    from random surface points toward every light (``shadow_sets``), a
    tenth of every set killed, the walk window closed (pd = -1) on another
    tenth, random original uvs and sphere flags; keyed as
    ``first_bounce_shadows``."""
    import torch

    o, ds, tms = shadow_sets(rng, sc, n, device)
    tenth = lambda: as_cuda(rng.uniform(size=n) < 0.1, device, bool)
    pds = [torch.where(tenth(), -1.0, tm) for tm in tms]
    is_pt = [k >= sc.num_dir_lights for k in range(len(ds))]
    return dict(s_o=o, dirs=[x.contiguous() for x in ds],
                t_maxes=[torch.where(tenth(), -1.0, tm) for tm in tms],
                pds=pds, is_pt=is_pt,
                surf_pos=o, orig_uv=as_cuda(rng.uniform(-1.0, 2.0, (n, 2)),
                                            device),
                orig_simple=as_cuda(rng.uniform(size=n) < 0.2, device, bool))


def fused_args(sh: dict, cap: int) -> tuple:
    """``cuda_shadow.fused_shadow``'s arguments after the scene."""
    return (sh["s_o"], sh["dirs"], sh["t_maxes"], sh["pds"], sh["is_pt"],
            sh["surf_pos"], sh["orig_uv"], sh["orig_simple"], cap)


def fused_two_launches(sc, sh: dict, cap: int, live=None):
    """The fused kernel's result from flat_occluded + trans_walk launched
    apart, as the integrator's two-launch route calls them."""
    import torch

    from path_tracer_torch.ops import cuda_bvh, cuda_trwalk
    from path_tracer_torch.scene.device_scene import opaque_view

    n_l, n = len(sh["dirs"]), sh["s_o"].shape[0]
    occ = cuda_bvh.occluded_triangles_flat_multi(sh["s_o"], sh["dirs"],
                                                 sh["t_maxes"],
                                                 opaque_view(sc))
    is_pt3 = torch.cat([torch.full((n,), pt, device=occ.device)
                        for pt in sh["is_pt"]])
    w = cuda_trwalk.trans_walk(
        sc, sh["s_o"].repeat(n_l, 1), torch.cat(sh["dirs"]).contiguous(),
        torch.where(occ, -1.0, torch.stack(sh["pds"])).reshape(-1), is_pt3,
        sh["surf_pos"].repeat(n_l, 1), sh["orig_uv"].repeat(n_l, 1),
        sh["orig_simple"].repeat(n_l), torch.ones_like(is_pt3), cap,
        live=live)
    return (torch.where(occ, 0.0, w.trans.view(n_l, n)),
            w.t_prev.view(n_l, n), w.still.view(n_l, n))


def phase_fused_shadow_kernel(device, tex):
    """3f: the fused shadow kernel (row 15: the warp any-hit of row 10,
    then the resident walk of row 14, on a persistent CTA holding the
    transparent table in shared memory) on the textured showcase's
    first-bounce shadow lanes (3 lights x the middle 2^18 camera lanes, a
    tenth killed, step cap 8) and on 3 x 2^16 incoherent lanes, against its
    timed plain version and flat_occluded + trans_walk launched apart: 0
    lanes may differ. Then timed through its wrapper beside the two
    launches, and in turns (device ms a launch: the new, the two launches,
    and back, twice). Returns (max abs err, (ms, plain ms, bound ms, bound
    by))."""
    import torch

    from path_tracer_torch import native
    from path_tracer_torch.ops import cuda_shadow, trwalk

    rng = np.random.default_rng(20261022)
    n, cap = WAVE, trwalk.TRWALK_K
    sets = {"first-bounce": first_bounce_shadows(tex, n, device, rng),
            "incoherent": fused_incoherent(rng, tex, n // 4, device)}
    err, plain_ms = 0.0, None
    for label, sh in sets.items():
        args = (tex,) + fused_args(sh, cap)
        ms, want = timed_once(lambda: cuda_shadow.fused_shadow_plain(*args))
        plain_ms = ms if plain_ms is None else plain_ms
        got = cuda_shadow.fused_shadow(*args)
        off_plain = lanes_off(got, want)
        off_apart = lanes_off(got, fused_two_launches(tex, sh, cap))
        live = torch.stack(sh["t_maxes"]) >= 0
        log(f"  fused shadow kernel, {len(sh['dirs'])} lights x "
            f"{sh['s_o'].shape[0]} {label} shadow lanes (any-hit live "
            f"{float(live.float().mean()):.3f}): lanes off the plain version "
            f"{off_plain}, off flat_occluded + trans_walk launched apart "
            f"{off_apart}; trans_eff "
            f"0 on {float((got[0] == 0).float().mean()):.3f}, in (0, 1) on "
            f"{float(((got[0] > 0) & (got[0] < 1)).float().mean()):.4f}")
        if off_plain or off_apart:
            raise AssertionError(f"fused shadow kernel disagrees ({label})")
        err = max(err, max_err(got, want))

    sh = sets["first-bounce"]
    args = (tex,) + fused_args(sh, cap)
    run = lambda: cuda_shadow.fused_shadow(*args)
    two = lambda: fused_two_launches(tex, sh, cap)
    ms, two_ms = cuda_ms(run, 20), cuda_ms(two, 20)
    ms2, two_ms2 = cuda_ms(run, 20), cuda_ms(two, 20)
    ops = cuda_shadow.launch_operands(*args[:-1])
    new_l = lambda: native.launch_fused_shadow(*ops, tex, cap)
    turns = {"new": [], "two launches": []}
    for _ in range(2):
        for k, fn in (("new", new_l), ("two launches", two),
                      ("two launches", two), ("new", new_l)):
            turns[k].append(launch_device_ms(fn))
    fb = fused_bound(tex, sh, (tex.tr_rows, tex.tr_tex8))
    work, b10, b14 = fb["work"], fb["b10"], fb["b14"]
    log(f"  time row 15, {len(sh['dirs'])} x {n} first-bounce shadow lanes "
        f"(walking after the any-hit {fb['walkers']}): through the wrapper "
        f"{ms:.4f} ms, {ms2:.4f} ms (repeat); the two launches {two_ms:.4f}"
        f" ms, {two_ms2:.4f} ms; plain {plain_ms:.4f} ms; bound "
        f"{work[0]:.4f} ms ({work[1]}: any-hit {b10[0]:.4f} ms, "
        f"{fb['slabs']} slab tests, {fb['tests']} triangle tests; walk "
        f"{b14[0]:.4f} ms, {fb['walkers']} lanes x {fb['tp_real']} "
        "columns)")
    best = {k: min(v) for k, v in turns.items()}
    log("  A/B row 15, device ms a launch in turns: " + "; ".join(
        f"{k} " + " ".join(f"{x:.4f}" for x in v) for k, v in turns.items())
        + f"; new / two launches {best['new'] / best['two launches']:.3f}; "
        f"share of the bound {work[0] / best['new']:.3f}")
    return err, (min(ms, ms2), plain_ms) + work


def phase_fused_showcase(device, tex):
    """4f: the textured showcase at 1920x1080, 5 bounces, FUSED_SPP spp
    through the fused shadow kernel (PT_FUSED_SHADOW=1) and through the
    two launches, same seed, in turns (ABBAAB, three of each): the fused
    runs launch fused_shadow and neither two-launch kernel; at most
    MAX_WALK_PIXELS of the pixels beyond 1e-3. Returns the first fused
    run's launch counts."""
    import os

    import torch

    from path_tracer_torch.config import Profile, Resolution
    from path_tracer_torch.models.renderer import (
        integrator_spec,
        render_pixel_sums,
    )

    w, h, spp, bounces = 1920, 1080, FUSED_SPP, 5
    log(f"phase 4f: textured showcase, fused shadow kernel against the two "
        f"launches, {w}x{h}, {bounces} bounces, {spp} spp, in turns")
    profile = Profile(resolution=Resolution(w, h), bounces=bounces,
                      samples=spp)
    spec = integrator_spec(profile)
    fused, two = "fused", "two launches"
    out, secs, counts = {}, {fused: [], two: []}, {}
    for label in (fused, two, two, fused, fused, two):
        if label == fused:
            os.environ["PT_FUSED_SHADOW"] = "1"
        try:
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            sums = render_pixel_sums(tex, w, h, 1, spp, spec,
                                     tile_rays=profile.tile_rays)
            torch.cuda.synchronize()
            secs[label].append(time.perf_counter() - t0)
        finally:
            os.environ.pop("PT_FUSED_SHADOW", None)
        counts.setdefault(label, launch_counts())
        out.setdefault(label, sums / spp)
        log(f"  {label}: {secs[label][-1]:.3f} s "
            f"({secs[label][-1] / spp:.3f} s per sample), launches "
            f"{launch_counts()}")
    fc, tc = counts[fused], counts[two]
    if not fc["fused_shadow"] or fc["flat_occluded"] or fc["trans_walk"] \
            or tc["fused_shadow"] or not (tc["flat_occluded"]
                                          and tc["trans_walk"]):
        raise AssertionError(f"routes not taken as asked: {counts}")
    a, b = out[fused], out[two]
    diff = np.abs(a - b).max(axis=-1)
    frac = float((diff > 1e-3).mean())
    per = {k: [x / spp for x in v] for k, v in secs.items()}
    log(f"  seconds per sample: fused {per[fused]}, two launches "
        f"{per[two]}; pixels beyond 1e-3: {frac:.5f} (<= "
        f"{MAX_WALK_PIXELS}); max {diff.max():.3e}; mean energy "
        f"{a.mean():.6f} vs {b.mean():.6f}; finite "
        f"{bool(np.isfinite(a).all())}")
    if frac > MAX_WALK_PIXELS or not np.isfinite(a).all() or a.std() == 0:
        raise AssertionError("fused and two-launch renders disagree")
    return fc


def phase_main_path(device):
    import torch

    from path_tracer_torch import cli
    from path_tracer_torch.config import Profile, Resolution
    from path_tracer_torch.models.renderer import (
        finalize,
        integrator_spec,
        render_pixel_sums,
    )
    from path_tracer_torch.scene import load_scene
    from path_tracer_torch.utils.image_io import save_png

    spp = MAIN_SPP
    log(f"phase 4: main path at 1920x1080, 4 bounces, {spp} spp")
    OUT.mkdir(parents=True, exist_ok=True)
    profile = Profile(resolution=Resolution(1920, 1080), bounces=4,
                      samples=spp)
    spec = integrator_spec(profile)
    scenes = {name: load_scene(scene_path(name), device)
              for name in ("cube", "spheres", "reflection")}
    torch.cuda.synchronize()
    reset_launch_counts()
    per_scene = {}
    for name, sc in scenes.items():
        before = (launched("mt_closest_hit"), launched("sphere_closest_hit"))
        t0 = time.perf_counter()
        sums = render_pixel_sums(sc, 1920, 1080, 1, spp, spec,
                                 tile_rays=profile.tile_rays)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        per_scene[name] = (launched("mt_closest_hit") - before[0],
                           launched("sphere_closest_hit") - before[1])
        img = finalize(sums, spp, profile, 1920, 1080)
        save_png(img, OUT / f"{name}_1080p_{spp}spp.png")
        rays = 1920 * 1080 * spp * 5
        log(f"  {name}: {secs:.3f} s, {rays / secs / 1e6:.2f} Mray/s, "
            f"mt launches {per_scene[name][0]}, sphere launches "
            f"{per_scene[name][1]}, finite {bool(np.isfinite(sums).all())}, "
            f"image mean {img.mean():.2f} std {img.std():.2f}")
        if not (np.isfinite(sums).all() and img.std() > 0):
            raise AssertionError(f"{name}: image not finite or constant")
    launches = launch_counts()
    if per_scene["spheres"][1] == 0 or per_scene["cube"][0] == 0 \
            or per_scene["reflection"][0] == 0:
        raise AssertionError(f"a kernel was not launched: {per_scene}")

    # One frame of the reference default's size (1920x1080, 4 bounces) at
    # CLI_FRAME_SPP spp through the command line, on a scene loaded anew.
    png = OUT / "reflection_default.png"
    prof = cli_frame_profile()
    t0 = time.perf_counter()
    cli.main(["render", str(scene_path("reflection")), "-o", str(png), "-q",
              "-p", str(prof), "--device", "cuda"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    rays = 1920 * 1080 * CLI_FRAME_SPP * 5
    log(f"  reflection frame of the reference default's size via the CLI "
        f"({CLI_FRAME_SPP} spp, load included): {secs:.3f} s, "
        f"{rays / secs / 1e6:.2f} Mray/s, png {png.stat().st_size} bytes")
    return launches


def cli_frame_profile() -> Path:
    """A profile file of the reference default's resolution and bounces
    (1920x1080, 4) at CLI_FRAME_SPP samples, under the git-ignored
    build/."""
    prof = REPO / "build" / "chip_smoke_profiles" / "cli_frame.yaml"
    prof.parent.mkdir(parents=True, exist_ok=True)
    prof.write_text("resolution: {width: 1920, height: 1080}\n"
                    f"samples: {CLI_FRAME_SPP}\nbounces: 4\n")
    return prof


# The hand-written kernels by the names of their launch counters
# (``utils.telemetry.counters["launch.<kernel>"]``).
LAUNCH_KERNELS = ("mt_closest_hit", "sphere_closest_hit", "sph_walk",
                  "flat_closest_hit", "flat_occluded", "flat2_closest_hit",
                  "flat2_occluded", "alpha_walk", "trans_walk", "sph_occluded",
                  "sph_occ_walk", "fused_shadow", "alpha_walk_live",
                  "trans_walk_live", "fused_shadow_live", "k_nearest_tr_hits",
                  "tree_closest_hit", "tree_occluded")


def launched(kernel: str) -> int:
    """Launches of one hand-written kernel in this process since the last
    ``reset_launch_counts``."""
    from path_tracer_torch.utils.telemetry import counters

    return counters["launch." + kernel]


def launch_counts() -> dict:
    return {k: launched(k) for k in LAUNCH_KERNELS}


def reset_launch_counts() -> None:
    from path_tracer_torch.utils.telemetry import counters

    for k in LAUNCH_KERNELS:
        counters.pop("launch." + k, None)


def phase_showcase(device, showcase):
    """The main path of the BVH slice: the plain showcase at 1080p, 5
    bounces, SHOWCASE_SPP spp, then one frame of the reference default's
    size (CLI_FRAME_SPP spp) of it written to disk and rendered through
    the CLI. Returns the launch counts of the first run and its (seconds,
    pixel sums)."""
    import torch

    from path_tracer_torch import cli
    from path_tracer_torch.config import Profile, Resolution
    from path_tracer_torch.models.renderer import (
        finalize,
        integrator_spec,
        render_pixel_sums,
    )
    from path_tracer_torch.scene.showcase import write_showcase_scene_dir
    from path_tracer_torch.utils.image_io import save_png

    w, h, spp, bounces = 1920, 1080, SHOWCASE_SPP, 5
    log(f"phase 4 (showcase): {showcase.num_real_triangles} triangles, "
        f"{showcase.num_real_spheres} spheres, {showcase.sl_n_blocks} blocks "
        f"of {showcase.sl_block}; {w}x{h}, {bounces} bounces, {spp} spp")
    profile = Profile(resolution=Resolution(w, h), bounces=bounces,
                      samples=spp)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    sums = render_pixel_sums(showcase, w, h, 1, spp, integrator_spec(profile),
                             tile_rays=profile.tile_rays)
    torch.cuda.synchronize()
    secs = first = time.perf_counter() - t0
    counts = launch_counts()
    img = finalize(sums, spp, profile, w, h)
    save_png(img, OUT / f"showcase_1080p_{spp}spp_b5.png")
    rays = w * h * spp * (bounces + 1)
    log(f"  showcase: {secs:.3f} s, {rays / secs / 1e6:.2f} Mray/s, launches "
        f"{counts}, finite {bool(np.isfinite(sums).all())}, image mean "
        f"{img.mean():.2f} std {img.std():.2f}")
    if not (np.isfinite(sums).all() and img.std() > 0):
        raise AssertionError("showcase: image not finite or constant")
    if not (counts["flat_closest_hit"] and counts["flat_occluded"]) \
            or counts["mt_closest_hit"]:
        raise AssertionError(f"showcase did not take the flat kernels: "
                             f"{counts}")

    # Written under the git-ignored build/ (57 MB of JSON), removed after.
    scene_dir = REPO / "build" / "chip_smoke_showcase"
    path = write_showcase_scene_dir(scene_dir, grid=SHOWCASE_GRID)
    png = OUT / "showcase_default.png"
    reset_launch_counts()
    t0 = time.perf_counter()
    cli.main(["render", str(path), "-o", str(png), "-q", "-p",
              str(cli_frame_profile()), "--device", "cuda"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    cli_counts = launch_counts()
    size = path.stat().st_size
    shutil.rmtree(scene_dir)
    rays = 1920 * 1080 * CLI_FRAME_SPP * 5
    log(f"  showcase frame of the reference default's size via the CLI "
        f"(1920x1080, {CLI_FRAME_SPP} spp, 4 bounces, {size} bytes of "
        f"scene.isf loaded and "
        f"built in the timing, 512-slot blocks): {secs:.3f} s, "
        f"{rays / secs / 1e6:.2f} Mray/s, launches {cli_counts}, png "
        f"{png.stat().st_size} bytes")
    if not cli_counts["flat_closest_hit"] or cli_counts["mt_closest_hit"]:
        raise AssertionError(f"CLI frame did not take the flat kernels: "
                             f"{cli_counts}")
    return counts, (first, sums)


def phase_showcase_tex(device, tex):
    """The main path of the transparency slice: the textured showcase
    (the JAX bench's default workload) at 1920x1080, 5 bounces, TEX_SPP
    spp through ``render_pixel_sums``, then the same frame through the
    CLI. Returns the launch counts of the first and the run (seconds,
    sums, counts, peak device bytes); fails unless the flat kernels and
    both walk kernels launched."""
    import torch

    from path_tracer_torch import cli
    from path_tracer_torch.config import Profile, Resolution
    from path_tracer_torch.models.renderer import (
        finalize,
        integrator_spec,
        render_pixel_sums,
    )
    from path_tracer_torch.scene.showcase import write_showcase_scene_dir
    from path_tracer_torch.utils.image_io import save_png

    w, h, spp, bounces = 1920, 1080, TEX_SPP, 5
    log(f"phase 4 (textured showcase): {tex.num_real_triangles} triangles "
        f"({tex.n_tris_opaque} opaque), {tex.num_real_spheres} spheres, "
        f"{tex.sl_n_blocks} blocks ({tex.sl_n_blocks_opaque} opaque) of "
        f"{tex.sl_block}, walk bound {tex.num_transparent_hits + 1}; {w}x{h},"
        f" {bounces} bounces, {spp} spp")
    profile = Profile(resolution=Resolution(w, h), bounces=bounces,
                      samples=spp)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    sums = render_pixel_sums(tex, w, h, 1, spp, integrator_spec(profile),
                             tile_rays=profile.tile_rays)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = launch_counts()
    run = (secs, sums, counts, torch.cuda.max_memory_allocated())
    img = finalize(sums, spp, profile, w, h)
    save_png(img, OUT / f"showcase_tex_1080p_{spp}spp_b5.png")
    rays = w * h * spp * (bounces + 1)
    log(f"  textured showcase: {secs:.3f} s, {rays / secs / 1e6:.2f} Mray/s, "
        f"launches {counts}, finite {bool(np.isfinite(sums).all())}, image "
        f"mean {img.mean():.2f} std {img.std():.2f}")
    if not (np.isfinite(sums).all() and img.std() > 0):
        raise AssertionError("textured showcase: image not finite or constant")
    if not all(counts[k] for k in ("flat_closest_hit", "flat_occluded",
                                   "alpha_walk", "trans_walk")) \
            or counts["mt_closest_hit"]:
        raise AssertionError(f"textured showcase did not take the flat and "
                             f"walk kernels: {counts}")

    # The same frame through the command line, on the scene written to
    # disk (PNGs by the port's writer, under the git-ignored build/) and
    # loaded anew (512-slot blocks), with a profile file.
    scene_dir = REPO / "build" / "chip_smoke_showcase_tex"
    path = write_showcase_scene_dir(scene_dir, grid=SHOWCASE_GRID,
                                    textured=True)
    prof = scene_dir / "profile.yaml"
    prof.write_text(f"resolution: {{width: {w}, height: {h}}}\n"
                    f"samples: {spp}\nbounces: {bounces}\n")
    png = OUT / "showcase_tex_cli.png"
    reset_launch_counts()
    t0 = time.perf_counter()
    cli.main(["render", str(path), "-o", str(png), "-q", "-p", str(prof),
              "--device", "cuda"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    cli_counts = launch_counts()
    size = path.stat().st_size
    shutil.rmtree(scene_dir)
    log(f"  textured showcase via the CLI ({w}x{h}, {spp} spp, {bounces} "
        f"bounces, {size} bytes of scene.isf and its PNGs loaded and built "
        f"in the timing): {secs:.3f} s, {rays / secs / 1e6:.2f} Mray/s, "
        f"launches {cli_counts}, png {png.stat().st_size} bytes")
    if not (cli_counts["alpha_walk"] and cli_counts["trans_walk"]):
        raise AssertionError(f"CLI frame did not take the walk kernels: "
                             f"{cli_counts}")
    return counts, run


def phase_big_showcase(device, big):
    """4d: the 991k-triangle textured showcase at 1920x1080, 5 bounces,
    BIG_SPP spp through ``render_pixel_sums``, then one sample through
    ``render`` written as a PNG. Returns the launch counts of the first;
    fails unless the flat2 kernels, the dense sphere kernel and both walk
    kernels launched."""
    import torch

    from path_tracer_torch.config import Profile, Resolution
    from path_tracer_torch.models.renderer import (
        finalize,
        integrator_spec,
        render,
        render_pixel_sums,
    )
    from path_tracer_torch.utils.image_io import save_png

    w, h, spp, bounces = 1920, 1080, BIG_SPP, 5
    log(f"phase 4d (textured showcase grid {BIG_GRID}): "
        f"{big.num_real_triangles} triangles ({big.n_tris_opaque} opaque), "
        f"{big.num_real_spheres} spheres, {big.sl_n_blocks} blocks "
        f"({big.sl_n_blocks_opaque} opaque) of {big.sl_block}; {w}x{h}, "
        f"{bounces} bounces, {spp} spp")
    profile = Profile(resolution=Resolution(w, h), bounces=bounces,
                      samples=spp)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    sums = render_pixel_sums(big, w, h, 1, spp, integrator_spec(profile),
                             tile_rays=profile.tile_rays)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = launch_counts()
    img = finalize(sums, spp, profile, w, h)
    save_png(img, OUT / f"showcase_tex{BIG_GRID}_1080p_{spp}spp_b5.png")
    rays = w * h * spp * (bounces + 1)
    log(f"  render_pixel_sums: {secs:.3f} s ({secs / spp:.3f} s per sample), "
        f"{rays / secs / 1e6:.2f} Mray/s, launches {counts}, finite "
        f"{bool(np.isfinite(sums).all())}, image mean {img.mean():.2f} std "
        f"{img.std():.2f}")
    if not (np.isfinite(sums).all() and img.std() > 0):
        raise AssertionError("scene A: image not finite or constant")
    if not all(counts[k] for k in ("flat2_closest_hit", "flat2_occluded",
                                   "sphere_closest_hit", "alpha_walk",
                                   "trans_walk")) or counts["mt_closest_hit"]:
        raise AssertionError(f"scene A did not take the flat2, sphere and "
                             f"walk kernels: {counts}")
    png = OUT / f"showcase_tex{BIG_GRID}_render_1spp.png"
    one = Profile(resolution=Resolution(w, h), bounces=bounces, samples=1)
    reset_launch_counts()
    t0 = time.perf_counter()
    save_png(render(big, one), png)
    secs = time.perf_counter() - t0
    log(f"  render to PNG, 1 spp: {secs:.3f} s, "
        f"{w * h * (bounces + 1) / secs / 1e6:.2f} Mray/s, launches "
        f"{launch_counts()}, png {png.stat().st_size} bytes")
    return counts


def phase_sphere_grid(device, grid):
    """4e: the 4,900-sphere grid written as an ISF file by the port and
    rendered through the CLI at 1920x1080, 5 bounces, 1 spp; then at
    480x270, 2 spp through the walk and through the dense sphere kernel,
    same seed: mean energy within MAX_ENERGY_REL. Returns the CLI run's
    launch counts."""
    import dataclasses

    import torch

    from path_tracer_torch import cli
    from path_tracer_torch.models.integrator import IntegratorSpec
    from path_tracer_torch.models.renderer import render_pixel_sums
    from path_tracer_torch.scene import isf
    from path_tracer_torch.scene.procedural import sphere_grid_scene

    w, h, spp, bounces = 1920, 1080, 1, 5
    log(f"phase 4e (sphere grid): {grid.num_real_spheres} spheres, "
        f"{grid.num_point_lights} point lights; CLI {w}x{h}, {bounces} "
        f"bounces, {spp} spp")
    scene_dir = REPO / "build" / "chip_smoke_sphere_grid"
    scene_dir.mkdir(parents=True, exist_ok=True)
    path = scene_dir / "scene.isf"
    isf.save(sphere_grid_scene(SPHERE_GRID), path)
    prof = scene_dir / "profile.yaml"
    prof.write_text(f"resolution: {{width: {w}, height: {h}}}\n"
                    f"samples: {spp}\nbounces: {bounces}\n")
    png = OUT / "sphere_grid_cli.png"
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    cli.main(["render", str(path), "-o", str(png), "-q", "-p", str(prof),
              "--device", "cuda"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = launch_counts()
    size = path.stat().st_size
    shutil.rmtree(scene_dir)
    rays = w * h * spp * (bounces + 1)
    log(f"  via the CLI ({size} bytes of scene.isf loaded and built in the "
        f"timing): {secs:.3f} s, {rays / secs / 1e6:.2f} Mray/s, launches "
        f"{counts}, png {png.stat().st_size} bytes")
    log(f"  the same frame took 17.884 s on an NVIDIA H100 80GB HBM3 at "
        f"700.00 W with the sphere any-hit elementwise over all spheres "
        f"(before sph_occ.cu); this card: {smi()}")
    if not (counts["sph_walk"] and counts["sph_occ_walk"]) \
            or counts["sphere_closest_hit"] or counts["sph_occluded"]:
        raise AssertionError(f"sphere grid did not take the walks: {counts}")

    spec = IntegratorSpec(bounces=bounces)
    out = {}
    for label, sc in (("walk", grid), ("dense", dataclasses.replace(
            grid, sph_use_blocks=False))):
        reset_launch_counts()
        t0 = time.perf_counter()
        out[label] = render_pixel_sums(sc, 480, 270, 1, 2, spec,
                                       tile_rays=1 << 18) / 2
        torch.cuda.synchronize()
        log(f"  480x270, 2 spp, {label}: {time.perf_counter() - t0:.3f} s, "
            f"launches {launch_counts()}")
    got, want = out["walk"], out["dense"]
    within = float((np.abs(got - want) <= 1e-4 + 1e-3 * np.abs(want)).mean())
    energy = abs(float(got.mean()) - float(want.mean())) / float(want.mean())
    log(f"  walk vs dense: values within rtol 1e-3 / atol 1e-4 {within:.5f};"
        f" mean energy {got.mean():.6f} vs {want.mean():.6f}, rel diff "
        f"{energy:.2e} (<= {MAX_ENERGY_REL})")
    if energy > MAX_ENERGY_REL:
        raise AssertionError("sphere walk and dense renders disagree")
    return counts


def phase_walks_vs_cast(device, tex):
    """The textured showcase at 480x270, 2 spp, 5 bounces through the walk
    kernels and with their step cap set to 0 (every lane walks in the
    cast residual), same seed: at most MAX_WALK_PIXELS of the pixels
    beyond 1e-3."""
    import torch

    from path_tracer_torch.models.integrator import IntegratorSpec
    from path_tracer_torch.models.renderer import render_pixel_sums
    from path_tracer_torch.ops import trwalk

    log("phase 4c: textured showcase, walk kernels against cast walks, "
        "480x270, 2 spp, 5 bounces")
    spec = IntegratorSpec(bounces=5)
    out = {}
    cap = trwalk.TRWALK_K
    for label, k in (("kernel walks", cap), ("cast walks", 0)):
        trwalk.TRWALK_K = k
        try:
            reset_launch_counts()
            t0 = time.perf_counter()
            out[label] = render_pixel_sums(tex, 480, 270, 1, 2, spec,
                                           tile_rays=1 << 18) / 2
            torch.cuda.synchronize()
        finally:
            trwalk.TRWALK_K = cap
        log(f"  {label} (step cap {k}): {time.perf_counter() - t0:.3f} s, "
            f"launches {launch_counts()}")
    diff = np.abs(out["kernel walks"] - out["cast walks"]).max(axis=-1)
    frac = float((diff > 1e-3).mean())
    log(f"  pixels beyond 1e-3: {frac:.5f} (<= {MAX_WALK_PIXELS}); max "
        f"{diff.max():.3e}; mean energy {out['kernel walks'].mean():.6f} vs "
        f"{out['cast walks'].mean():.6f}")
    if frac > MAX_WALK_PIXELS:
        raise AssertionError("kernel walks and cast walks disagree")


def phase_bvh_vs_brute(device, showcase):
    """The showcase at 480x270, 4 spp, 5 bounces through the flat walk and
    through brute-force MT over every triangle, same seed."""
    import dataclasses

    import torch

    from path_tracer_torch.models.integrator import IntegratorSpec
    from path_tracer_torch.models.renderer import render_pixel_sums

    log("phase 4b: showcase BVH against brute force, 480x270, 4 spp, "
        "5 bounces")
    spec = IntegratorSpec(bounces=5)
    out = {}
    for label, sc in (("bvh", showcase),
                      ("brute", dataclasses.replace(showcase, use_bvh=False))):
        reset_launch_counts()
        t0 = time.perf_counter()
        out[label] = render_pixel_sums(sc, 480, 270, 1, 4, spec,
                                       tile_rays=1 << 18) / 4
        torch.cuda.synchronize()
        log(f"  {label}: {time.perf_counter() - t0:.3f} s, launches "
            f"{launch_counts()}")
    got, want = out["bvh"], out["brute"]
    within = float((np.abs(got - want)
                    <= 1e-4 + 1e-3 * np.abs(want)).mean())
    energy = abs(float(got.mean()) - float(want.mean())) / float(want.mean())
    log(f"  values within rtol 1e-3 / atol 1e-4: {within:.5f} (>= "
        f"{MIN_PIXELS_WITHIN}); mean energy {got.mean():.6f} vs "
        f"{want.mean():.6f}, rel diff {energy:.2e} (<= {MAX_ENERGY_REL})")
    if not (within >= MIN_PIXELS_WITHIN and energy <= MAX_ENERGY_REL):
        raise AssertionError("showcase: BVH and brute renders disagree")


_CONVERTED: set = set()  # the glb scenes oracle_scene converted this run


def oracle_scene(spec: str) -> Path:
    """An oracle case's scene file: a path in the repo, ``@showcase_tex_g64``
    (the textured showcase at grid 64, written by the port's own showcase
    writer), or ``@glb_converted`` / ``@glb_multi_opacity`` (the port's
    glb generator's file through ``path-tracer-torch convert``), made
    under the git-ignored build/; a glb scene is converted anew once in
    each run, never taken from an earlier run's build/."""
    if not spec.startswith("@"):
        return REPO / spec
    if spec in ("@glb_converted", "@glb_multi_opacity"):
        out = REPO / "build" / f"chip_smoke_{spec[1:]}"
        if spec not in _CONVERTED:
            shutil.rmtree(out, ignore_errors=True)
            convert_glb(out, multi_opacity=spec == "@glb_multi_opacity")
            _CONVERTED.add(spec)
        return out / "scene.isf"
    if spec != "@showcase_tex_g64":
        raise ValueError(f"unknown generated scene {spec}")
    from path_tracer_torch.scene.showcase import write_showcase_scene_dir

    return write_showcase_scene_dir(REPO / "build" / "chip_smoke_tex_g64",
                                    grid=64, textured=True)


def tool(name: str):
    """The module tests/tools/<name>.py, loaded by its file path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, REPO / "tests" / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def convert_glb(out: Path, multi_opacity: bool, textures=None) -> dict:
    """Write the port's test glb (tests/tools/torch_gen_test_glb.py, PNGs by
    the port's writer; ``textures``, image bytes, in place of its own) and
    convert it through ``path-tracer-torch convert`` into ``out``:
    {triangles, seconds of the conversion, files}."""
    from path_tracer_torch import cli

    gen = tool("torch_gen_test_glb")
    out.mkdir(parents=True, exist_ok=True)
    glb = out / "scene.glb"
    n_tris = gen.write_glb(glb, multi_opacity=multi_opacity,
                           textures=textures)
    t0 = time.perf_counter()
    cli.main(["convert", str(glb), str(out)])
    secs = time.perf_counter() - t0
    return dict(triangles=n_tris, seconds=secs,
                files=sorted(p.name for p in out.iterdir()))


def phase_oracle(device, cases=None):
    import importlib.util

    import torch

    # By file path: an installed package named ``tests`` would shadow the
    # repo's (namespace) tests directory.
    spec = importlib.util.spec_from_file_location(
        "reference_oracle", REPO / "tests" / "oracle" / "reference_oracle.py")
    oracle_mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = oracle_mod  # dataclasses look the module up
    spec.loader.exec_module(oracle_mod)
    post_process = oracle_mod.post_process

    from path_tracer_torch.models.integrator import IntegratorSpec
    from path_tracer_torch.models.renderer import render_pixel_sums
    from path_tracer_torch.scene import load_scene

    log("phase 5: oracle gate (tests/goldens/oracle) on the card"
        + (f": {', '.join(cases)}" if cases else ""))
    failed = []
    runs = ([(c, False) for c in cases] if cases else
            [(c, False) for c in ORACLE_CASES]
            + [(c, True) for c in ORACLE_BVH_CASES])
    for case, bvh in runs:
        tol, energy_rtol = ORACLE_CASES[case]
        z = np.load(REPO / "tests" / "goldens" / "oracle" / f"{case}.npz")
        oracle = z["radiance"].astype(np.float64)
        w, h, spp, b = (int(z[k]) for k in ("width", "height", "spp", "bounces"))
        sc = load_scene(oracle_scene(str(z["scene"])), device,
                        use_bvh=True if bvh else None)
        label = f"{case} [bvh]" if bvh else case
        t0 = time.perf_counter()
        wave = render_pixel_sums(sc, w, h, 1, spp, IntegratorSpec(bounces=b))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        wave = (wave / spp).reshape(h, w, 3).astype(np.float64)
        finite = np.isfinite(oracle).all(-1) & np.isfinite(wave).all(-1)
        om, wm = oracle[finite].mean(), wave[finite].mean()
        diff = np.abs(post_process("FILMIC", oracle).astype(np.int64)
                      - post_process("FILMIC", np.maximum(wave, 0.0))
                      .astype(np.int64))[finite]
        p99 = float(np.percentile(diff, 99))
        ok = (finite.mean() > 0.99
              and abs(om - wm) <= max(energy_rtol * om, 5e-4)
              and diff.mean() <= tol and p99 <= 40)
        log(f"  {label}: {'OK' if ok else 'FAIL'} {w}x{h} {spp} spp b{b} "
            f"finite {finite.mean():.4f} energy {wm:.5f} vs {om:.5f} "
            f"(rtol {energy_rtol}) mean|u8| {diff.mean():.3f} (<= {tol}) "
            f"p99 {p99:.0f} (<= 40) {secs:.2f} s")
        if not ok:
            failed.append(label)
    if failed:
        raise AssertionError(f"oracle gate failed: {failed}")


def training_updates(sc):
    """The scene after tests/test_trwalk.py's training updates: opacity
    factors x 0.6, the first opacity page moved by +0.17, then -0.09,
    clipped to [0.05, 0.95]."""
    import dataclasses

    off, w, h, _ = sc.tr_pages[0]
    td = sc.tex_data.clone()
    for step in (0.17, -0.09):
        td[off:off + w * h] = (td[off:off + w * h] + step).clamp(0.05, 0.95)
    return dataclasses.replace(sc, tex_data=td,
                               mat_opacity_factor=sc.mat_opacity_factor * 0.6)


def lanes_off(got, want) -> int:
    """Lanes on which two walk results (tuples of [R] or [L,R] tensors)
    differ in any field."""
    import torch

    diff = torch.zeros_like(got[0], dtype=torch.bool)
    for a, b in zip(got, want):
        same = ((a == b) | (torch.isnan(a) & torch.isnan(b))
                if a.is_floating_point() else a == b)
        diff |= ~same
    return int(diff.sum())


def max_err(got, want) -> float:
    return max(float((a.float() - b.float()).abs().nan_to_num(0.0).max())
               for a, b in zip(got, want))


def phase_live_kernels(device, tex):
    """6a: the live variants (training mode) of the alpha walk, the
    transmittance walk and the fused shadow kernel on the textured
    showcase's lanes of the main path's middle wavefront (the 2^18 alpha
    lanes of 3c's timing, the 3 x 2^18 first-bounce shadow lanes of 3c and
    3f), on the tables after tests/test_trwalk.py's training updates:
    each against its plain live version (0 lanes may differ) and timed
    beside its forward variant on the same lanes; on the untouched tables
    each equals its forward variant on every lane. Returns {name: (max
    abs err, (ms, plain ms, bound ms, bound by))}."""
    from path_tracer_torch import native
    from path_tracer_torch.ops import cuda_shadow, cuda_trwalk, trwalk

    n, cap = WAVE, trwalk.TRWALK_K
    upd = training_updates(tex)
    live, live_same = trwalk.live_tables(upd), trwalk.live_tables(tex)
    tp_real = int((tex.tr_bw[0:3].abs().sum(0) > 0).sum())
    log(f"phase 6a: live walk kernels, textured showcase after the training "
        f"updates (opacity factors x 0.6, page 0 +0.17 -0.09), f32 plane "
        f"{tuple(live.plane.shape)} ({nbytes(live.plane)} bytes, the u8 "
        f"plane {nbytes(tex.tr_tex8)})")
    out = {}

    def report(name, got, want, same_live, same_fwd, moved, run, fwd,
               plain_ms, b, note):
        off, off_same = lanes_off(got, want), lanes_off(same_live, same_fwd)
        ms, fwd_ms = cuda_ms(run, 20), cuda_ms(fwd, 20)
        ms2, fwd_ms2 = cuda_ms(run, 20), cuda_ms(fwd, 20)
        log(f"  {name}, {note}: lanes off the plain live version {off}; "
            f"untouched tables, lanes off the forward kernel {off_same}; "
            f"lanes the updates moved against the forward kernel {moved}; "
            f"live kernel {ms:.4f} ms, {ms2:.4f} ms (repeat); forward "
            f"kernel {fwd_ms:.4f} ms, {fwd_ms2:.4f} ms; plain live "
            f"{plain_ms:.4f} ms; bound {b[0]:.4f} ms ({b[1]})")
        if off or off_same or not moved:
            raise AssertionError(f"{name}: live kernel disagrees")
        out[name] = (max_err(got, want), (min(ms, ms2), plain_ms) + b)

    o, d, t_op = alpha_lanes(tex, n, device)
    rnd = walk_rnd(n, cap, device)
    alpha = lambda sc, lv=None: cuda_trwalk.alpha_walk(sc, o, d, t_op, rnd,
                                                       cap, live=lv)
    plain_ms, want = timed_once(
        lambda: trwalk.alpha_walk_plain(upd, o, d, t_op, rnd, cap, live))
    got = alpha(upd, live)
    n_live = int((t_op >= 0).sum())
    report("alpha_walk_live", got, want, alpha(tex, live_same), alpha(tex),
           lanes_off(got, alpha(upd)), lambda: alpha(upd, live),
           lambda: alpha(upd), plain_ms,
           bound(walk_needed(tex, "alpha", (o, d, t_op))[0] * OPS_BW,
                 nbytes(o, d, t_op, rnd, tex.tr_bw, *live, tex.tr_lut,
                        tex.tr_page_table, tex.tr_grp) + n * (8 * 4 + 4)),
           f"{n} camera lanes ({n_live} live) x {tp_real} columns")

    sh = shadow_lanes(tex, n, device)
    o3, d3, w0 = sh[0], sh[1], sh[-1]
    aux = cuda_trwalk.trans_aux(*sh[2:])
    plain_ms, want = timed_once(
        lambda: trwalk.trans_walk_plain(upd, *sh, cap, live))
    got = cuda_trwalk.trans_walk(upd, *sh, cap, live=live)
    walkers = int(w0.sum())
    report("trans_walk_live", got, want,
           cuda_trwalk.trans_walk(tex, *sh, cap, live=live_same),
           cuda_trwalk.trans_walk(tex, *sh, cap),
           lanes_off(got, cuda_trwalk.trans_walk(upd, *sh, cap)),
           lambda: native.launch_trans_walk(o3, d3, aux, upd, cap, live),
           lambda: native.launch_trans_walk(o3, d3, aux, upd, cap),
           plain_ms,
           bound(walk_needed(tex, "trans", sh)[0] * OPS_BW,
                 nbytes(o3, d3, aux, tex.tr_bw, *live, tex.tr_lut,
                        tex.tr_page_table, tex.tr_grp)
                 + 3 * 4 * o3.shape[0]),
           f"{o3.shape[0]} shadow lanes ({walkers} live) x {tp_real} "
           "columns")

    rng = np.random.default_rng(20261022)
    fs = first_bounce_shadows(tex, n, device, rng)
    args = (fs["s_o"], fs["dirs"], fs["t_maxes"], fs["pds"], fs["is_pt"],
            fs["surf_pos"], fs["orig_uv"], fs["orig_simple"], cap)
    fused = lambda sc, lv=None: cuda_shadow.fused_shadow(sc, *args, live=lv)
    plain_ms, want = timed_once(
        lambda: cuda_shadow.fused_shadow_plain(upd, *args, live=live))
    got = fused(upd, live)
    fb = fused_bound(upd, fs, live)
    report("fused_shadow_live", got, want, fused(tex, live_same), fused(tex),
           lanes_off(got, fused(upd)), lambda: fused(upd, live),
           lambda: fused(upd), plain_ms, fb["work"],
           f"{len(fs['dirs'])} lights x {n} first-bounce shadow lanes (a "
           f"tenth killed; walking after the any-hit {fb['walkers']}; bound "
           f"any-hit {fb['b10'][0]:.4f} ms + walk {fb['b14'][0]:.4f} ms)")
    return out


def backward_tile(device):
    """The bench's backward tile: 1080p pixel ids of Morton tile 4
    (lanes 4r to 5r, r = 2^18), as bench.py's _backward_rays_per_s."""
    import torch

    from path_tracer_torch.ops.sorting import morton_pixel_order

    return torch.from_numpy(morton_pixel_order(1920, 1080)[
        4 * WAVE:5 * WAVE].copy()).to(device)


def phase_backward(device, tex):
    """6b: the bench's backward step (bench.py:344-380) on the port: the
    textured showcase, the 2^18-lane 1080p tile, 5 bounces, 1 spp,
    differentiable; loss mean(img^2), its gradient with respect to
    mat_albedo_factor. One warm-up, then a timed step ending in
    torch.cuda.synchronize(): fwd+bwd rays/s = r (bounces + 1) / dt, peak
    device memory, and the launch counts of the timed step (the live walk
    kernels run, the forward ones do not). Fails unless the gradient is
    finite and non-zero and within MAX_FD_REL of a central difference of
    a scalar factor f on the albedo table (d loss / d f at f = 1 is
    sum(grad * albedo); tests/tools/tpu_kernel_check.py:249-283). Returns
    the timed step's launch counts."""
    import dataclasses

    import torch

    from path_tracer_torch.models.integrator import (
        IntegratorSpec,
        render_wavefront,
    )

    w, h, bounces = 1920, 1080, 5
    ids = backward_tile(device)
    spec = IntegratorSpec(bounces=bounces, differentiable=True)
    albedo = tex.mat_albedo_factor

    def step():
        leaf = albedo.detach().clone().requires_grad_(True)
        s = dataclasses.replace(tex, mat_albedo_factor=leaf)
        loss = (render_wavefront(s, ids, w, h, 1, spec) ** 2).mean()
        return loss.detach(), torch.autograd.grad(loss, [leaf])[0]

    log(f"phase 6b: backward step, textured showcase, {ids.numel()} lanes of "
        f"the 1080p Morton tile 4, {bounces} bounces, 1 spp, d mean(img^2) / "
        "d mat_albedo_factor")
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    loss, grad = step()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated(device)

    def loss_at(f):
        with torch.no_grad():
            s = dataclasses.replace(tex, mat_albedo_factor=albedo * f)
            return float((render_wavefront(s, ids, w, h, 1, spec) ** 2)
                         .mean())

    fd = (loss_at(1.0 + FD_EPS) - loss_at(1.0 - FD_EPS)) / (2 * FD_EPS)
    g_f = float((grad * albedo).sum())
    rel = abs(g_f - fd) / max(abs(fd), 1e-30)
    rays = ids.numel() * (bounces + 1)
    log(f"  {smi()}: warm-up {warm:.3f} s; timed step {dt:.3f} s, fwd+bwd "
        f"{rays / dt:.1f} rays/s ({rays / dt / 1e6:.3f} Mray/s); peak device "
        f"memory {peak} bytes ({peak / 2**30:.3f} GiB); loss {float(loss):.6e};"
        f" launches {counts}; d loss / d f = sum(grad * albedo) {g_f:.6e}, "
        f"central difference (eps {FD_EPS}) {fd:.6e}, relative {rel:.4f} "
        f"(<= {MAX_FD_REL})")
    if not (torch.isfinite(grad).all() and grad.abs().max() > 0):
        raise AssertionError("backward step: gradient not finite or zero")
    if not (rel <= MAX_FD_REL and abs(fd) > 1e-12):
        raise AssertionError("backward step: gradient off the difference")
    if not (counts["alpha_walk_live"] and counts["trans_walk_live"]) \
            or counts["alpha_walk"] or counts["trans_walk"]:
        raise AssertionError(f"backward step did not take the live walk "
                             f"kernels alone: {counts}")
    return counts


def phase_train_steps(device, tex):
    """6c: make_train_step on the backward tile, TRAIN_STEPS SGD steps over
    every field of PARAM_FIELDS, the albedo table started at albedo * 0.4 +
    0.2 (clipped), against a forward render (differentiable=False) of the
    true scene at the RNG seed TARGET_SEED (examples/inverse_rendering.py's
    set-up). The learning rate is LR_SCALE over the largest entry of a
    first gradient, so no field moves by more than LR_SCALE a step; every
    step renders sample 1. Fails unless every loss, gradient and parameter is
    finite and the mean albedo error over the models the tile shows falls
    from the first step to the last. Then one step under PT_FUSED_SHADOW=1
    (its launch counts returned): the live fused kernel runs, and the loss
    equals the two-launch route's to 1e-5 relative."""
    import os

    import torch

    from path_tracer_torch.models.integrator import (
        IntegratorSpec,
        render_wavefront,
    )
    from path_tracer_torch.parallel import get_params, make_train_step
    from path_tracer_torch.parallel.train import value_and_grad

    w, h, bounces = 1920, 1080, 5
    ids = backward_tile(device)
    spec = IntegratorSpec(bounces=bounces, differentiable=True)
    with torch.no_grad():
        target = render_wavefront(tex, ids, w, h, 1, IntegratorSpec(
            bounces=bounces, seed=TARGET_SEED))
    true = tex.mat_albedo_factor
    params = get_params(tex)
    params["mat_albedo_factor"] = (true * 0.4 + 0.2).clamp(0.0, 1.0)
    loss0, g0 = value_and_grad(params, tex, ids, target, 1, w, h, spec)
    bad = [k for k, g in g0.items() if not torch.isfinite(g).all()]
    gmax = max(float(g.abs().max()) for g in g0.values())
    lr = LR_SCALE / gmax
    seen = g0["mat_albedo_factor"].abs().sum(1) > 0
    err = lambda p: float((p["mat_albedo_factor"] - true)[seen].abs().mean())
    log(f"phase 6c: {TRAIN_STEPS} make_train_step steps over "
        f"{len(params)} parameter fields, lr {lr:.4e} ({LR_SCALE} / largest "
        f"first gradient entry {gmax:.4e}), {int(seen.sum())} of "
        f"{seen.numel()} "
        f"albedo rows seen; first loss {float(loss0):.6e}; non-finite "
        f"gradients {bad}")
    step = make_train_step(w, h, spec, lr=lr)
    p, losses, errs = params, [], [err(params)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        p, loss = step(p, tex, ids, target, 1)
        losses.append(float(loss))
        errs.append(err(p))
        bad += [k for k, v in p.items() if not torch.isfinite(v).all()]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device)
    log(f"  {TRAIN_STEPS} steps in {secs:.3f} s, peak device memory {peak} "
        f"bytes ({peak / 2**30:.3f} GiB); losses {losses}; mean albedo "
        f"error {errs}; non-finite {bad}")
    # errs[0] is the start's error, errs[1] the first step's.
    if bad or not np.isfinite(losses).all() or not errs[-1] < errs[1]:
        raise AssertionError("train steps: non-finite, or the albedo error "
                             "did not fall")
    reset_launch_counts()
    os.environ["PT_FUSED_SHADOW"] = "1"
    try:
        _, loss_f = step(p, tex, ids, target, 1)
        torch.cuda.synchronize()
    finally:
        os.environ.pop("PT_FUSED_SHADOW", None)
    counts = launch_counts()
    _, loss_t = step(p, tex, ids, target, 1)
    rel = abs(float(loss_f) - float(loss_t)) / abs(float(loss_t))
    log(f"  one step through the fused shadow route: loss {float(loss_f):.8e} "
        f"against {float(loss_t):.8e} through the two launches (relative "
        f"{rel:.2e} <= 1e-5); launches {counts}")
    if rel > 1e-5 or not counts["fused_shadow_live"] \
            or counts["fused_shadow"] or counts["trans_walk_live"]:
        raise AssertionError("fused training step disagrees or did not take "
                             "the live fused kernel")
    return counts


def khit_work(o, d, t_max, tris, gbox, sbox) -> tuple[int, int]:
    """(slab tests, MT tests) row 3 needs on these lanes (t_max encoded,
    <= 0 dead): a slab test of every group box per live lane and of the
    four sub-group boxes of each group it reaches, and an MT test of every
    real column its gate admits (``cuda_khit``'s plain gate: the group and
    the sub-group)."""
    from path_tracer_torch.ops import cuda_khit
    from path_tracer_torch.scene.device_scene import KHIT_GRP, KHIT_SUB

    real = (tris[3:9].abs().sum(0) > 0)
    slabs = int((t_max > 0.0).sum()) * gbox.shape[1]
    tests = 0
    for a in range(0, o.shape[0], 1 << 14):
        rs = slice(a, a + (1 << 14))
        reach = cuda_khit._group_reach(o[rs], d[rs], t_max[rs], gbox)
        slabs += int(reach.sum()) * (KHIT_GRP // KHIT_SUB)
        sub = cuda_khit._group_reach(o[rs], d[rs], t_max[rs], sbox)
        cols = (reach.repeat_interleave(KHIT_GRP, dim=1)
                & sub.repeat_interleave(KHIT_SUB, dim=1))
        tests += int((cols & real).sum())
    return slabs, tests


def khit_slots(o, d, t_max, tris, gbox, sbox) -> dict:
    """Row 3's lane slots (MT tests a lane executes or sits out) against
    the MT tests it needs (``khit_work``: the columns of the sub-groups a
    lane reaches): every sub-group some lane of a warp reaches costs 32
    lanes x 32 columns."""
    import torch

    from path_tracer_torch.ops import cuda_khit
    from path_tracer_torch.scene.device_scene import KHIT_GRP, KHIT_SUB

    g, subs = gbox.shape[1], KHIT_GRP // KHIT_SUB
    warp = 0
    for a in range(0, o.shape[0], 1 << 14):  # whole warps: 2^14 lanes
        rs = slice(a, a + (1 << 14))
        reach = cuda_khit._group_reach(o[rs], d[rs], t_max[rs], gbox)
        sub = cuda_khit._group_reach(o[rs], d[rs], t_max[rs], sbox)
        sub = sub.view(-1, g, subs) & reach[:, :, None]
        pad = -sub.shape[0] % 32
        sub = torch.cat([sub, sub.new_zeros((pad, g, subs))])
        warp += int(sub.view(-1, 32, g, subs).any(1).sum()) * 32 * KHIT_SUB
    _, tests = khit_work(o, d, t_max, tris, gbox, sbox)
    return dict(warp=warp, tests=tests, warp_per=warp / max(tests, 1))


def aimed_rays(sc, n: int, seed: int):
    """n rays from random origins around the transparent triangles toward
    points on the valid group boxes (corners, edge points, face points) and
    on the cards (vertices and edge points), numpy: the grazing set of
    tests/test_torch_walk_gate.py."""
    g = np.random.default_rng(seed)
    grp = sc.tr_grp.cpu().numpy()
    boxes = grp[:6, grp[6] > 0].T
    lo, hi = boxes[:, :3], boxes[:, 3:]
    k, rows = n // 4, np.arange(n)
    b = g.integers(0, len(boxes), n)
    corner = np.where(g.integers(0, 2, (n, 3)).astype(bool), lo[b], hi[b])
    free = g.uniform(lo[b], hi[b])
    edge = corner.copy()
    axis = g.integers(0, 3, n)
    edge[rows, axis] = free[rows, axis]
    face = free.copy()
    keep = g.integers(0, 3, n)
    face[rows, keep] = corner[rows, keep]
    lo_n, hi_n = sc.n_tris_opaque, sc.num_real_triangles
    v0, e1, e2 = (x[lo_n:hi_n].cpu().numpy()
                  for x in (sc.tri_v0, sc.tri_e1, sc.tri_e2))
    tri = g.integers(0, len(v0), n)
    w = g.uniform(size=(n, 1))
    vert = v0[tri] + np.where(g.integers(0, 3, (n, 1)) == 1, e1[tri],
                              np.where(g.integers(0, 2, (n, 1)) == 1,
                                       e2[tri], 0.0))
    on_edge = v0[tri] + w * e1[tri]
    tgt = np.concatenate([corner[:k], edge[k:2 * k], face[2 * k:3 * k],
                          np.where(g.integers(0, 2, (n - 3 * k, 1)) == 1,
                                   vert[3 * k:], on_edge[3 * k:])])
    o = tgt + g.uniform(-1.0, 1.0, (n, 3)) * (v0.max(0) - v0.min(0))
    d = tgt - o
    return o, d / np.linalg.norm(d, axis=1, keepdims=True)


def khit_ungated_off(o, d, sc, k: int) -> list:
    """Lanes where row 3's kernel differs, within t_max, from the ungated
    plain version (every group box at +-1e30: brute-force MT), at t_max
    +inf, the ungated first hit and an ulp below and above it; the kernel
    must also equal the plain version on every lane of each."""
    import torch

    from path_tracer_torch.ops import cuda_khit

    n = o.shape[0]
    inf = torch.full((n,), float("inf"), device=o.device)
    everywhere = sc.khit_gbox.clone()
    everywhere[0:3], everywhere[3:6] = -1e30, 1e30
    want_t, want_c = cuda_khit.k_nearest_tr_hits_plain(
        o, d, inf, sc.khit_tris, everywhere, k)
    first = want_t[0]
    act = torch.ones((n,), dtype=torch.bool, device=o.device)
    off = []
    for tm in (inf, first, torch.nextafter(first, -inf),
               torch.nextafter(first, inf)):
        got_t, got_c = cuda_khit.k_nearest_tr_hits(o, d, act, sc, k,
                                                   t_max=tm)
        p_t, p_c = cuda_khit.k_nearest_tr_hits_plain(
            o, d, tm, sc.khit_tris, sc.khit_gbox, k, sc.khit_sbox)
        if not (torch.equal(got_t, p_t) and torch.equal(got_c, p_c)):
            raise AssertionError("row 3 disagrees with its plain version")
        w_in, g_in = want_t <= tm, got_t <= tm
        bad = (w_in != g_in) | (w_in & ((got_t != want_t)
                                        | (got_c != want_c)))
        off.append(int(bad.any(0).sum()))
    return off


def phase_khit(device, tex):
    """3g: row 3 (k_nearest_tr_hits: the table resident in shared memory,
    warp walks, each lane testing the 32-column sub-groups it reaches)
    against its plain version on every lane of the textured showcase: the
    middle wavefront's 2^18 camera lanes with the opaque terminator as
    t_max (dead where the segment misses every transparent cluster), its
    first bounce's 3 x 2^18 stacked shadow lanes (t_max the distance to
    the light with the prefilter's margin, a tenth killed), and random
    rays through the foliage with random t_max (every 7th lane dead, a
    ragged count), at k = 6, 1 and 8; on the duplicate-card scene, rays
    aimed at group boxes' corners, edges and faces and the cards' vertices
    and edges, rays from 10^2 to 10^3 group extents away and tie rays
    through the layered copies, held within t_max to the ungated plain
    version (brute-force MT) at four t_max. Then the lane slots per needed
    MT test, the device ms a launch on camera and shadow lanes, and the
    wrapper's time beside the plain version and the bound. Returns
    (max abs err, {"camera": (ms, plain ms, bound ms, bound by),
    "shadow": ...})."""
    import torch

    from path_tracer_torch import native
    from path_tracer_torch.ops import cuda_khit
    from path_tracer_torch.scene.device_scene import KHIT_GRP
    from path_tracer_torch.scene.procedural import (
        duplicate_card_device_scene,
        tie_rays,
    )

    tris, gbox, sbox = tex.khit_tris, tex.khit_gbox, tex.khit_sbox
    log(f"phase 3g: k-nearest transparent hits (row 3), textured showcase: "
        f"{tex.tri_v0.shape[0] - tex.n_tris_opaque} transparent columns in "
        f"{gbox.shape[1]} groups of {KHIT_GRP}")
    rng = np.random.default_rng(20261024)
    o, d, t_op = alpha_lanes(tex, WAVE, device)
    sh = shadow_lanes(tex, WAVE, device, rng)
    m = CHECK_LANES
    fo, fd = foliage_rays(rng, tex, m, device)
    f_act = as_cuda(np.arange(m) % 7 != 0, device, bool)
    sets = {
        "camera": (o, d, t_op >= 0.0, t_op),
        "shadow": (sh[0], sh[1], sh[7], sh[2] * 1.0001 + 1e-3),
        "foliage": (fo, fd, f_act, as_cuda(rng.uniform(0.5, 60.0, m),
                                           device)),
    }
    err = 0.0
    for label, (ro, rd, act, tm) in sets.items():
        enc = torch.where(act, tm, -1.0)
        for k in KHIT_KS:
            ts, pos = cuda_khit.k_nearest_tr_hits(ro, rd, act, tex, k,
                                                  t_max=tm)
            want_ts, want_pos = cuda_khit.k_nearest_tr_hits_plain(
                ro, rd, enc, tris, gbox, k, sbox)
            off = int(((ts != want_ts) | (pos != want_pos)).any(0).sum())
            fin = torch.isfinite(want_ts)
            if fin.any():
                err = max(err, float((ts - want_ts)[fin].abs().max()))
            log(f"  {label}, {ro.shape[0]} lanes (live "
                f"{float((enc > 0).float().mean()):.3f}), k = {k}: lanes off "
                f"the plain version {off}; hits per live lane "
                f"{float(fin.sum()) / max(1, int((enc > 0).sum())):.3f}")
            if off:
                raise AssertionError("row 3 disagrees with its plain "
                                     "version")

    cards = duplicate_card_device_scene(device)
    n_c = 1 << 14
    card_sets = {
        "aimed": aimed_rays(cards, n_c, 23),
        "far": far_rays(cards, n_c, 26)[:2],
        "tie": tie_rays(n_c, seed=5),
    }
    for label, (co, cd) in card_sets.items():
        co, cd = as_cuda(co, device), as_cuda(cd, device)
        for k in (6, 1):
            off = khit_ungated_off(co, cd, cards, k)
            log(f"  duplicate cards ({cards.khit_tris.shape[1]} columns), "
                f"{label} rays, {n_c} lanes, k = {k}: lanes off the ungated "
                f"plain version within t_max (inf, the first hit, an ulp "
                f"below, above) {off}; off the plain version 0")
            if any(off):
                raise AssertionError(f"row 3, {label} rays: a hit within "
                                     "t_max lost")

    out = {}
    k = KHIT_KS[0]
    for label in ("camera", "shadow"):
        ro, rd, act, tm = sets[label]
        enc = torch.where(act, tm, -1.0)
        slots = khit_slots(ro, rd, enc, tris, gbox, sbox)
        log(f"  row 3 {label} lanes: MT tests needed {slots['tests']}; lane "
            f"slots {slots['warp']}, {slots['warp_per']:.3f} a needed test")
        run = lambda: cuda_khit.k_nearest_tr_hits(ro, rd, act, tex, k,
                                                  t_max=tm)
        plain = lambda: cuda_khit.k_nearest_tr_hits_plain(ro, rd, enc, tris,
                                                          gbox, k, sbox)
        ms, plain_ms, ms2 = cuda_ms(run, 20), cuda_ms(plain, 2), cuda_ms(
            run, 20)
        new_ms = [launch_device_ms(lambda: native.launch_khit(
            ro, rd, enc, tris, gbox, sbox, k)) for _ in range(2)]
        slabs, tests = khit_work(ro, rd, enc, tris, gbox, sbox)
        work = bound(slabs * OPS_SLAB + tests * OPS_MT,
                     nbytes(ro, rd, enc, tris, gbox, sbox)
                     + ro.shape[0] * k * 8)
        new = min(new_ms)
        log(f"  time row 3, {ro.shape[0]} {label} lanes, k = {k}: through "
            f"the wrapper {ms:.4f} ms, {ms2:.4f} ms (repeat); device ms a "
            "launch " + " ".join(f"{x:.4f}" for x in new_ms) + f"; plain "
            f"{plain_ms:.4f} ms; bound {work[0]:.4f} ms ({work[1]}: {slabs} "
            f"slab tests, {tests} MT tests), floor {2 * work[0]:.4f} ms; "
            f"share of the bound {work[0] / new:.3f}")
        if work[0] > new:
            raise AssertionError(f"row 3 {label}: faster than its bound")
        out[label] = (min(ms, ms2), plain_ms) + work
    return err, out


def tree_divergence(got, ref) -> tuple[float, float]:
    """(divergence, flips): the share of lanes where two closest-hit
    records diverge, a hit/miss flip or both hitting with t apart by more
    than rtol/atol 5e-5 (the flat2-against-MT gate of
    tests/tools/tpu_kernel_check.py), and the share that flip hit/miss or
    prim."""
    import torch

    hg, hr = torch.isfinite(got.t), torch.isfinite(ref.t)
    far = hg & hr & ~torch.isclose(got.t, ref.t, rtol=5e-5, atol=5e-5)
    flip = (hg != hr) | (hg & (got.prim != ref.prim))
    return (float(((hg != hr) | far).float().mean()),
            float(flip.float().mean()))


def records_off(got, want):
    """[R] bool: the lanes where two HitRecords differ in any field (NaN
    equal to NaN)."""
    import torch

    off = torch.zeros_like(want.t, dtype=torch.bool)
    for a, b in zip(got, want):
        off |= (a != b) & ~(torch.isnan(a) & torch.isnan(b)) \
            if a.is_floating_point() else a != b
    return off


def tree_walk_visits(o, d, g, sc, any_hit: bool = False,
                     widths=(128, 32)) -> dict:
    """Rows 7 and 8's work on these lanes, from the plain walk
    (``cuda_bvh.tree_walk_steps`` or, with ``any_hit``,
    ``occluded_tree_steps``) in packets of each width: 128, the replaced
    CTA design's packet, and 32, the kernel's warp. Per width: the leaf
    visits (a leaf some lane's gate admits), the live packets, the slab
    tests of the nodes the lanes' gates admit, the MT tests the lanes need
    (the real, nonzero-edge, slots of the leaves their own gates admit:
    the same at every width), the distinct leaves some lane needs and the
    layouts the groups pick. At width 128 also the lane-slot tests the CTA
    design executes (128 x block a visit: every lane, every slot); at
    width 32 the histogram of needing rays a visit (``hist`` [33]) and the
    lane-slot tests of each in-leaf layout: lane per ray (32 x block a
    visit), the leaf over the warp (k x block for k needing rays, plus its
    reduction, counted as 32 lane slots a ray for each 128-slot chunk) and
    the kernel's mix (lane per ray from native.TREE_WALK_LANE_WISE rays).
    ``result`` is the last width's result, the plain version's."""
    import torch

    from path_tracer_torch import native
    from path_tracer_torch.ops import cuda_bvh

    block = sc.sl_block
    real = (sc.sl_tris_t[3:9].abs().sum(0) > 0).view(-1, block).sum(1)
    steps_fn = (cuda_bvh.occluded_tree_steps if any_hit
                else cuda_bvh.tree_walk_steps)
    live = g >= 0.0 if any_hit else g < float("inf")
    pad = -o.shape[0] % cuda_bvh.GROUP
    layouts = cuda_bvh.packet_layouts(torch.nn.functional.pad(
        d, (0, 0, 0, pad), value=1.0).view(-1, cuda_bvh.GROUP, 3))
    red = 32 * block // 128  # a spread ray's reductions, in lane slots
    out = {"lane_wise": native.TREE_WALK_LANE_WISE}
    zero = lambda: torch.zeros((), dtype=torch.long, device=o.device)
    for width in widths:
        steps = steps_fn(o, d, g, sc, width=width)
        visits, slabs, tests, spread, mix = (zero() for _ in range(5))
        hist = torch.zeros(33, dtype=torch.long, device=o.device)
        seen = torch.zeros(real.numel() + 1, dtype=torch.bool,
                           device=o.device)
        while True:
            try:
                lane, visit, leaf = next(steps)
            except StopIteration as done:
                result = done.value
                break
            # No boolean indexing: it would sync the card at every step.
            k = torch.where(visit, lane.sum(1), 0)
            visits += visit.sum()
            slabs += lane.sum()
            tests += (k * real[(leaf - 1).clamp(min=0)]).sum()
            seen[torch.where(visit, leaf, 0)] = True
            if width == 32:
                hist += torch.bincount(k, minlength=33)
                spread += (k * (block + red)).sum()
                mix += torch.where(k >= native.TREE_WALK_LANE_WISE,
                                   32 * block, k * (block + red)).sum()
        packets = live.new_zeros(live.numel() + pad)
        packets[:live.numel()] = live
        w = dict(visits=int(visits), slabs=int(slabs), tests=int(tests),
                 leaves=int(seen[1:].sum()),
                 live=int(packets.view(-1, width).any(1).sum()),
                 layouts=int(layouts.unique().numel()))
        if width == 128:
            w["cta_slots"] = 128 * block * w["visits"]
        else:
            hist[0] = 0
            w.update(hist=hist.tolist(), lane_slots=32 * block * w["visits"],
                     spread_slots=int(spread), mix_slots=int(mix))
        out[width] = w
    out["result"] = result
    return out


def log_tree_visits(label: str, v: dict) -> None:
    """Logs ``tree_walk_visits``' counts."""
    w32 = v[32]
    need = max(w32["tests"], 1)
    line = (f"  rows 7-8 visits, {label}: MT tests needed {w32['tests']}, "
            f"slab tests {w32['slabs']}, leaves {w32['leaves']}, layouts "
            f"{w32['layouts']}; warps: {w32['visits']} leaf visits over "
            f"{w32['live']} live warps "
            f"({w32['visits'] / max(w32['live'], 1):.2f} a warp), needing "
            "rays a visit " + " ".join(f"{k}:{c}" for k, c in
                                       enumerate(w32["hist"]) if c)
            + f"; lane slots a needed test: lane per ray "
            f"{w32['lane_slots'] / need:.3f}, the leaf over the warp "
            f"{w32['spread_slots'] / need:.3f}, the mix (lane per ray from "
            f"{v['lane_wise']}) {w32['mix_slots'] / need:.3f}")
    if 128 in v:
        w128 = v[128]
        line += (f"; 128-lane CTAs: {w128['visits']} leaf visits over "
                 f"{w128['live']} live CTAs "
                 f"({w128['visits'] / max(w128['live'], 1):.2f} a CTA), "
                 f"lane slots a needed test {w128['cta_slots'] / need:.3f}")
        if w128["tests"] != w32["tests"]:
            raise AssertionError(f"{label}: the lanes' needed tests depend "
                                 "on the packet")
    log(line)


def tree_bound(v: dict, sc, o, d, g, out_bytes: int) -> tuple:
    """The bound of one launch from ``tree_walk_visits``' width-32 counts
    (summed over the sets of an any-hit launch): the operations of the
    slab and MT tests the lanes need; the bytes of the rays, the outputs,
    the node tables of the layouts the groups pick and the rows of the
    leaves some lane needs (on scene A they come from HBM)."""
    ws = v if isinstance(v, list) else [v]
    ops = sum(w[32]["slabs"] * OPS_SLAB + w[32]["tests"] * OPS_MT for w in ws)
    layouts = max(w[32]["layouts"] for w in ws)
    leaves = max(w[32]["leaves"] for w in ws)
    node_bytes = nbytes(sc.sl_nodes6, sc.sl_meta6) * layouts // 6
    return bound(ops, nbytes(o, d, g) + out_bytes + node_bytes
                 + leaves * sc.sl_block * 9 * 4)


def phase_tree_kernels(device, showcase, big):
    """3h: rows 7 and 8 (the superleaf tree walk) against their plain
    versions on every lane, on the plain showcase (100,352 terrain
    triangles, 516 blocks) and scene A's whole table (991,834 triangles,
    5,518 blocks): camera lanes (every 7th dead), random lanes,
    first-bounce lanes (dead where the camera ray missed) and the first
    bounce's shadow sets toward the three lights with a tenth killed (one
    launch), on a ragged ray count; beside the flat (showcase) or flat2
    (scene A) kernels on the same rays, the Baldwin-Weber/MT divergence at
    most MAX_DIVERGENCE of the lanes on camera and random rays (the gate's
    own rays); on first-bounce lanes the hit/miss and prim flips at most
    that, their t reported (a bounce ray that grazes its own surface hits
    a neighbour at t ~ 1e-3, where the Baldwin-Weber plane constant
    cancels: ROADMAP Queue 3). Returns (closest max abs err, any-hit max
    abs err)."""
    import torch

    from path_tracer_torch.ops import cuda_bvh

    log("phase 3h: superleaf tree walk (rows 7 and 8)")
    rng = np.random.default_rng(20261025)
    n = CHECK_LANES
    c_err = o_err = 0.0
    for name, sc, other, other_occ in (
            ("showcase", showcase, cuda_bvh.closest_hit_triangles_flat,
             cuda_bvh.occluded_triangles_flat_multi),
            (f"scene A (grid {BIG_GRID})", big,
             cuda_bvh.closest_hit_triangles_flat2,
             cuda_bvh.occluded_triangles_flat2_multi)):
        log(f"  {name}: {sc.num_real_triangles} triangles, "
            f"{sc.sl_n_blocks} blocks of {sc.sl_block}, {sc.sl_n_nodes} "
            f"forest nodes, {nbytes(sc.sl_tris_t) / 1e6:.1f} MB of MT rows")
        o, d = camera_rays(sc, n, device)
        tp = torch.full((n,), -1.0, device=device)
        tp[::7] = float("inf")
        v = sc.tri_v0[: sc.num_real_triangles].cpu().numpy()
        ro_, rd_ = random_rays(rng, n, v.min(0), v.max(0), device)
        (bo, bd, btp), (so, sds, stms) = first_bounce(sc, n, device)
        for label, (ro, rd, rtp) in (
                ("camera", (o, d, tp)),
                ("random", (ro_, rd_, torch.full((n,), -1.0,
                                                 device=device))),
                ("first bounce", (bo, bd, btp))):
            got = cuda_bvh.closest_hit_triangles_tree(ro, rd, rtp, sc)
            want = cuda_bvh.closest_hit_triangles_tree_plain(ro, rd, rtp, sc)
            off = records_off(got, want)
            fin = torch.isfinite(want.t)
            c_err = max(c_err, float((got.t - want.t)[fin].abs().max())
                        if fin.any() else 0.0)
            div, flips = tree_divergence(got, other(ro, rd, rtp, sc))
            gated = flips if label == "first bounce" else div
            log(f"  {name} {label}, {n} lanes (hit "
                f"{float(fin.float().mean()):.3f}): lanes off the plain "
                f"version {int(off.sum())}; against the "
                f"{other.__name__.split('_')[-1]} kernel divergence "
                f"{div:.2e}, hit/miss or prim flips {flips:.2e} (gated "
                f"{'flips' if label == 'first bounce' else 'divergence'} "
                f"<= {MAX_DIVERGENCE:g})")
            if off.any() or gated > MAX_DIVERGENCE:
                raise AssertionError(f"{name}: tree closest hit disagrees")
        kill = as_cuda(rng.uniform(size=(len(stms), n)) < 0.1, device, bool)
        stms = [torch.where(k, -1.0, tm) for k, tm in zip(kill, stms)]
        flat = other_occ(so, sds, stms, sc)
        before = launched("tree_occluded")
        got = cuda_bvh.occluded_triangles_tree_multi(so, sds, stms, sc)
        launches = launched("tree_occluded") - before
        want = cuda_bvh.occluded_triangles_tree_multi_plain(so, sds, stms,
                                                            sc)
        o_err = max(o_err, float((got != want).float().max()))
        for i, tm in enumerate(stms):
            off = int((got[i] != want[i]).sum())
            flips = float((got[i] != flat[i]).float().mean())
            log(f"  {name} shadow set {i} ({n} lanes, occluded "
                f"{float(got[i].float().mean()):.3f}): lanes off the plain "
                f"version {off}; flips against the other kernel "
                f"{flips:.2e} (<= {MAX_DIVERGENCE:g}); dead lanes occluded "
                f"{bool(got[i][tm < 0].all())}")
            if off or flips > MAX_DIVERGENCE or not bool(got[i][tm < 0].all()):
                raise AssertionError(f"{name}: tree any-hit disagrees")
        if launches != 1:
            raise AssertionError(f"{name}: {len(stms)} shadow sets took "
                                 f"{launches} any-hit launches, not 1")
    return c_err, o_err


AB_ITERS = 10  # launches per CUDA-event reading of a kernel's time


def held(label: str, new, want: dict) -> float:
    """Fails the run unless the record ``new`` equals every record of
    ``want`` ({name: record}) on every field of every lane, NaN equal to
    NaN; returns its max abs error against the first."""
    offs = {k: lanes_off(new, w) for k, w in want.items()}
    log(f"  {label}: {new.t.numel()} lanes, hit "
        f"{float(new.valid.float().mean()):.3f}; lanes off "
        + ", ".join(f"{k} {v}" for k, v in offs.items()))
    if any(offs.values()):
        raise AssertionError(f"{label}: the redesigned kernel disagrees")
    return max_err(new, next(iter(want.values())))


def dead_warps(g, fill: float = float("inf")):
    """The gate values g (t_prev, or t_max with ``fill`` -1) with whole
    warps dead (every fifth) and partly dead ones (every third lane of the
    warps two after them)."""
    import torch

    lane = torch.arange(g.shape[0], device=g.device)
    warp = lane // 32
    dead = (warp % 5 == 2) | ((warp % 5 == 4) & (lane % 3 == 0))
    return torch.where(dead, fill, g)


def device_events(prof) -> list:
    """(name, device ms) of each activity ``torch.profiler`` recorded on the
    card (kernels, copies, sets), read from its raw kineto events:
    ``key_averages()`` takes about 15 s to summarize the 60k events of a
    textured-showcase sample, these well under one."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.duration_ns() / 1e6)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda and e.duration_ns() > 0]


def kernel_device_ms(scene, spec) -> dict:
    """{kernel: (device ms, launches)} summed by ``torch.profiler`` (CUDA
    activity alone) over one 1080p sample (every 2^18-lane tile) after one
    warm-up sample, for each kernel, the port's and ATen's, by the
    identifier ending in "_kernel" in the profiler's name; and "all", every
    kernel's on the card."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    from path_tracer_torch.models.renderer import render_pixel_sums

    render_pixel_sums(scene, 1920, 1080, 1, 1, spec, tile_rays=WAVE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        render_pixel_sums(scene, 1920, 1080, 2, 1, spec, tile_rays=WAVE)
        torch.cuda.synchronize()
    events = device_events(prof)
    out = {"all": (sum(ms for _, ms in events), len(events))}
    for name, ms in events:
        m = re.search(r"::(\w+_kernel)\b", name)
        if m:
            total, n = out.get(m.group(1), (0.0, 0))
            out[m.group(1)] = (total + ms, n + 1)
    log(f"  (profiled sample and its summary: {time.perf_counter() - t0:.1f} "
        "s)")
    return out


def wrapper_ms(fn) -> float:
    """Milliseconds a call of a kernel's wrapper ``fn`` (its checks, its
    launch and its ATen ops) as the kernels line reports the rows: the
    lesser of two ``cuda_ms`` readings of AB_ITERS calls."""
    return min(cuda_ms(fn, AB_ITERS), cuda_ms(fn, AB_ITERS))


def launch_device_ms(fn, iters: int = 10) -> float:
    """Device milliseconds per call of ``fn`` (a launch alone) after one
    warm-up: CUDA events around each call, each pair behind a 2M-cycle
    sleep kernel that keeps the card busy while the host makes the call's
    checks and allocations, so the events time the kernel alone where
    events around a run of sub-0.1 ms calls time the host."""
    import torch

    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def phase_redesigned(device, showcase) -> dict:
    """3i: the flat closest hit (row 9: warp packets) and brute-force MT
    (row 1: the table resident in shared memory, four rays a thread)
    against their plain versions, every field of every lane, and the tie
    rule; the packet counts; row 1's device time over one 1080p
    reflection sample. Returns the numbers."""
    import torch

    from path_tracer_torch.models.integrator import IntegratorSpec
    from path_tracer_torch.ops import cuda_bvh, cuda_intersect
    from path_tracer_torch.ops import intersect
    from path_tracer_torch.ops.camera import generate_rays
    from path_tracer_torch.ops.sorting import morton_pixel_order
    from path_tracer_torch.scene import build_scene, load_scene
    from path_tracer_torch.scene.procedural import (
        duplicate_grid_scene,
        tie_rays,
        tie_winners,
    )

    log("phase 3i: rows 9 and 1 (warp-packet flat walk; resident-table MT) "
        "against their plain versions")
    t0 = time.perf_counter()
    n = WAVE
    out = {"row9_err": 0.0, "row1_err": 0.0}
    flat_new = cuda_bvh.closest_hit_triangles_flat
    flat_plain = cuda_bvh.closest_hit_triangles_flat_plain
    minus1 = torch.full((n,), -1.0, device=device)
    (bo, bd, btp), _ = first_bounce(showcase, n, device)
    co, cd = camera_rays(showcase, n, device)
    io, id_ = bounce_rays(np.random.default_rng(7), showcase, n, device)
    ties = build_scene(duplicate_grid_scene(), ".", device, use_bvh=True,
                       sl_block=128)
    ties_mt = build_scene(duplicate_grid_scene(), ".", device,
                          use_bvh=False)
    to, td = (as_cuda(x, device) for x in tie_rays(n))
    tie_tp = minus1.clone()
    tie_tp[::9] = float("inf")
    rr = n - 37  # no multiple of 32, 128 or 256
    lanes = {"camera": (co, cd, minus1), "first bounce": (bo, bd, btp),
             "incoherent": (io, id_, minus1)}
    for label, (o, d, tp) in lanes.items():
        new = flat_new(o, d, tp, showcase, spheres=True)
        out["row9_err"] = max(out["row9_err"], held(
            f"row 9, showcase {label}, spheres", new,
            {"plain": flat_plain(o, d, tp, showcase, spheres=True)}))
    o, d = bo[:rr].contiguous(), bd[:rr].contiguous()
    tp = dead_warps(btp[:rr])
    out["row9_err"] = max(out["row9_err"], held(
        "row 9, showcase first bounce, ragged R, dead warps",
        flat_new(o, d, tp, showcase), {"plain": flat_plain(o, d, tp,
                                                           showcase)}))
    # Tie rays: where a hit lies an ulp before its block's entry (rays
    # through a vertex or an edge of the box) a cut of whole blocks at a
    # lane's best t would let the visit order decide between equal-t
    # copies; the warp walk has no such cut and must equal the plain
    # version.
    out["row9_err"] = max(out["row9_err"], held(
        "row 9, duplicate-triangle grid, tie rays",
        flat_new(to, td, tie_tp, ties),
        {"plain": flat_plain(to, td, tie_tp, ties)}))

    mt_new = cuda_intersect.closest_hit_triangles_cuda
    mt_plain = intersect.closest_hit_triangles
    refl = load_scene(scene_path("reflection"), device)
    pix = torch.from_numpy(morton_pixel_order(1920, 1080)[:n].copy())
    ro, rd = (x.contiguous() for x in generate_rays(pix.to(device), 1920,
                                                    1080, refl, 1, 0))
    rng = np.random.default_rng(20261016)
    soups = {}
    for n_soup in (2500, 10000):  # resident, and streamed past 4,096
        n_pad = -(-n_soup // 256) * 256
        tri = np.zeros((3, n_pad, 3), np.float32)
        tri[0, :n_soup] = rng.uniform(-2, 2, (n_soup, 3))
        tri[1:, :n_soup] = rng.uniform(-0.3, 0.3, (2, n_soup, 3))
        soups[n_soup] = SimpleNamespace(
            tri_v0=as_cuda(tri[0], device), tri_e1=as_cuda(tri[1], device),
            tri_e2=as_cuda(tri[2], device), num_real_triangles=n_soup,
            tri_packed_t=as_cuda(np.concatenate(list(tri), axis=1).T,
                                 device))
    so, sd = random_rays(rng, rr, np.full(3, -2.0), np.full(3, 2.0), device)
    s_tp = dead_warps(torch.full((rr,), -1.0, device=device))
    cases = [("reflection camera lanes", refl, (ro, rd, minus1)),
             ("soup of 2,500, ragged R, dead warps", soups[2500],
              (so, sd, s_tp)),
             ("soup of 10,000 (streamed), 2^16 - 37 lanes", soups[10000],
              (so[: (1 << 16) - 37].contiguous(),
               sd[: (1 << 16) - 37].contiguous(),
               s_tp[: (1 << 16) - 37].contiguous())),
             ("duplicate-triangle grid, tie rays", ties_mt,
              (to, td, tie_tp))]
    for label, sc, args in cases:
        out["row1_err"] = max(out["row1_err"], held(
            f"row 1, {label} (N = {sc.tri_packed_t.shape[1]})",
            mt_new(*args, sc), {"plain": mt_plain(*args, sc)}))
    # Every tie ray's hit lies on a duplicated triangle: the copy of lowest
    # index (MT) or lowest packed slot (the flat walk) must win.
    for label, sc, hits, rule in (
            ("MT", ties_mt, mt_new(to, td, tie_tp, ties_mt), 0),
            ("flat walk", ties, flat_new(to, td, tie_tp, ties), 1)):
        tie_rule_held(label, sc, hits, rule, n // 2)

    # Packets of the warp walk, from the plain inputs.
    for label, (o, d, tp) in lanes.items():
        t_hit = flat_new(o, d, tp, showcase).t
        log_packets(label, packet_counts(o, d, showcase, tp, t_hit),
                    showcase.sl_block)

    # Device time per main-path sample, from the profiler (the textured
    # showcase's, row 9 among its kernels, is phase 3k's).
    prof = kernel_device_ms(refl, IntegratorSpec(bounces=4))
    out["profile reflection"] = prof
    log_profile("reflection", prof)
    if prof.get("mt_closest_hit_kernel", (0, 0))[1] == 0:
        raise AssertionError("reflection: mt_closest_hit_kernel never ran")
    log(f"  phase 3i took {time.perf_counter() - t0:.1f} s")
    return out


def tie_rule_held(label: str, sc, hits, rule: int, min_hits: int) -> None:
    """Fails the run unless the tie rule's copy (``tie_winners(sc)[rule]``:
    0 lowest index, 1 lowest packed slot) won on every hitting lane of
    ``hits``, and at least ``min_hits`` lanes hit."""
    import torch

    from path_tracer_torch.scene.procedural import tie_winners

    want = torch.from_numpy(tie_winners(sc)[rule]).to(hits.prim.device)
    prim = hits.prim[hits.valid].long()
    n_won = int((want[prim] == prim).sum())
    log(f"  tie rays through the {label}: {prim.numel()} hits, the tie "
        f"rule's copy won on {n_won}")
    if n_won != prim.numel() or prim.numel() < min_hits:
        raise AssertionError(f"{label} tie rule: another copy won")


def log_profile(label: str, prof: dict) -> None:
    """Logs ``kernel_device_ms``' kernels, largest first."""
    log(f"  profiler, one 1080p sample of the {label}: "
        + ", ".join(f"{k} {v[0]:.3f} ms in {v[1]} launches"
                    for k, v in sorted(prof.items(), key=lambda x: -x[1][0])
                    if k != "all")
        + f"; all kernels {prof['all'][0]:.3f} ms device time over "
        f"{prof['all'][1]} launches")


def occ_held(label: str, o, ds, tms, sc) -> None:
    """Fails the run unless row 10 equals its plain version on every lane
    of the sets."""
    import torch

    from path_tracer_torch.ops import cuda_bvh

    new = cuda_bvh.occluded_triangles_flat_multi(o, ds, tms, sc)
    off = int((new != cuda_bvh.occluded_triangles_flat_multi_plain(
        o, ds, tms, sc)).sum())
    dead = torch.stack(tms) < 0.0
    log(f"  row 10, {label}: {len(ds)} x {o.shape[0]} lanes, occluded "
        f"{float(new[~dead].float().mean()):.3f} of the live; lanes off the "
        f"plain version {off}")
    if off or not bool(new[dead].all()):
        raise AssertionError(f"row 10, {label}: the warp any-hit disagrees")


def phase_rows_10_11(device, showcase, tex, big) -> None:
    """3j: the flat any-hit (row 10) and the flat2 closest hit (row 11) as
    warp packets against their plain versions, every lane; flat2 on tie
    rays whose copies sit in two superblocks; scene A's packet counts."""
    import torch

    from path_tracer_torch.ops import cuda_bvh
    from path_tracer_torch.scene import build_scene
    from path_tracer_torch.scene.device_scene import opaque_view
    from path_tracer_torch.scene.procedural import (
        duplicate_grid_scene,
        tie_rays,
    )

    log("phase 3j: rows 10 and 11 (warp-packet flat any-hit; two-level "
        "warp-packet flat2 closest hit) against their plain versions")
    phase_t0 = time.perf_counter()
    n = WAVE
    rng = np.random.default_rng(20261021)

    # Row 10 on every lane of each set.
    _, (so, sds, stms) = first_bounce(showcase, n, device)
    occ_held("plain showcase first-bounce shadow sets", so, sds, stms,
             showcase)
    io, ids, itms = shadow_sets(rng, showcase, n, device)
    occ_held("plain showcase incoherent shadow sets", io, ids, itms,
             showcase)
    _, (to3, tds, ttms) = first_bounce(tex, n, device)
    occ_held("textured showcase's opaque view, first-bounce shadow sets",
             to3, tds, ttms, opaque_view(tex))
    rr = n - 37
    occ_held("ragged R, dead warps", so[:rr].contiguous(),
             [x[:rr].contiguous() for x in sds],
             [dead_warps(x[:rr], -1.0) for x in stms], showcase)
    ties = build_scene(duplicate_grid_scene(), ".", device, use_bvh=True,
                       sl_block=128)
    to, td = (as_cuda(x, device) for x in tie_rays(n))
    tie_tp = torch.full((n,), -1.0, device=device)
    tie_tp[::9] = float("inf")
    t_hit = cuda_bvh.closest_hit_triangles_flat_plain(to, td, tie_tp, ties).t
    hit, dead = torch.isfinite(t_hit), torch.isinf(tie_tp)
    tie_tms = [torch.where(dead, -1.0, torch.where(hit, t_hit * k, 5.0))
               for k in (1.5, 0.5)]
    occ_held("tie rays (edges, vertices, stacked copies), t_max 1.5 t and "
             "0.5 t, dead lanes", to, [td, td], tie_tms, ties)

    # Row 11 on every field of every lane of scene A's opaque view.
    op = opaque_view(big)
    m = 1 << 16
    flat2_new = cuda_bvh.closest_hit_triangles_flat2
    flat2_plain = cuda_bvh.closest_hit_triangles_flat2_plain
    (bo, bd, btp), _ = first_bounce(big, n, device)
    co, cd = camera_rays(big, n, device)
    v = big.tri_v0[: big.num_real_triangles].cpu().numpy()
    ro, rd = random_rays(rng, m, v.min(0), v.max(0), device)
    minus1 = torch.full((n,), -1.0, device=device)
    cases = {"camera": (co[:m], cd[:m], minus1[:m]),
             "first bounce": (bo[:m], bd[:m], btp[:m]),
             "random": (ro, rd, minus1[:m]),
             "first bounce, ragged R, dead warps": (
                 bo[m:2 * m - 37].contiguous(), bd[m:2 * m - 37].contiguous(),
                 dead_warps(btp[m:2 * m - 37]))}
    for label, (o, d, tp) in cases.items():
        o, d, tp = o.contiguous(), d.contiguous(), tp.contiguous()
        held(f"row 11, scene A {label}", flat2_new(o, d, tp, op),
             {"plain": flat2_plain(o, d, tp, op)})
    # Tie rays where the stacked copies sit in two superblocks: a cut at a
    # lane's best t would let the visit order decide here.
    ties2 = build_scene(duplicate_grid_scene(8, 8400), ".", device,
                        use_bvh=True, sl_block=128)
    log(f"  two-superblock tie scene: {ties2.num_real_triangles} triangles "
        f"in {ties2.sl_n_blocks} blocks of 128, "
        f"{int((ties2.sl_sbid >= 0).sum())} superblocks")
    to2, td2 = (as_cuda(x, device) for x in tie_rays(n))
    new = flat2_new(to2, td2, tie_tp, ties2)
    held("row 11, tie rays across two superblocks", new,
         {"plain": flat2_plain(to2, td2, tie_tp, ties2)})
    tie_rule_held("flat2 walk (two superblocks)", ties2, new, 1, n // 2)

    # Scene A's packets: the blocks the two gates admit against the blocks
    # a lane needs.
    for label, (o, d, tp) in (("scene A camera", (co, cd, minus1)),
                              ("scene A first bounce", (bo, bd, btp))):
        t_hit = flat2_new(o, d, tp, op).t
        log_packets(label, packet_counts(o, d, op, tp, t_hit,
                                         two_level=True), op.sl_block)
    log(f"  phase 3j took {time.perf_counter() - phase_t0:.1f} s")


def walk_held(label: str, new, want: dict) -> float:
    """Fails the run unless the walk result ``new`` equals every result of
    ``want`` ({name: result}) on every field of every lane, NaN equal to
    NaN; returns its max abs error against the first."""
    offs = {k: lanes_off(new, w) for k, w in want.items()}
    log(f"  {label}: {new[0].numel()} lanes; lanes off "
        + ", ".join(f"{k} {v}" for k, v in offs.items()))
    if any(offs.values()):
        raise AssertionError(f"{label}: the redesigned walk disagrees")
    return max_err(new, next(iter(want.values())))


def ray_walk_lanes(sc, o, d, g, device, scale=1.0):
    """Alpha and transmittance lanes of the rays (o, d) [n, 3] on the card:
    t_op past every candidate, at the lane's first candidate, random
    (``scale`` x U(0.5, 8)) or dead, and uniforms above every card's
    opacity on half the lanes; each ray also as a directional lane and two
    point lanes at random distances (``scale`` x U(0.5, 9)), with sphere
    originals and idle lanes mixed in. ``g`` draws the randoms."""
    import torch

    from path_tracer_torch.ops import trwalk

    n = o.shape[0]
    first = trwalk._eval_cols(o, d, torch.full((n,), float("inf"),
                                               device=device),
                              sc.tr_bw)[0].amin(dim=1)
    t_op = as_cuda(g.uniform(0.5, 8.0, n) * scale, device)
    t_op[::3] = float("inf")
    t_op[1::3] = torch.where(torch.isfinite(first), first, 2.0)[1::3]
    t_op[::7] = -1.0
    rnd = as_cuda(g.uniform(size=(12, n)), device)
    rnd[:, ::2] = 0.95
    o3, d3 = o.repeat(3, 1), d.repeat(3, 1)
    pd = as_cuda(np.concatenate([np.full(n, np.inf), g.uniform(
        0.5, 9.0, 2 * n) * np.tile(scale, 2 if np.ndim(scale) else 1)]),
        device)
    sh = (o3, d3, pd, torch.arange(3 * n, device=device) >= n, o3,
          as_cuda(g.uniform(-1.0, 2.0, (3 * n, 2)), device),
          as_cuda(g.uniform(size=3 * n) < 0.2, device, bool),
          as_cuda(g.uniform(size=3 * n) > 0.1, device, bool))
    return (o, d, t_op), rnd, sh


def tie_card_lanes(cards, n: int, device):
    """``ray_walk_lanes`` of n tie rays from above through every layer of
    the duplicate-card scene."""
    from path_tracer_torch.scene.procedural import tie_rays

    o, d = (as_cuda(x, device) for x in tie_rays(n, seed=5))
    return ray_walk_lanes(cards, o, d, np.random.default_rng(20261024),
                          device)


def far_rays(sc, n: int, seed: int):
    """n rays toward points on the transparent cards (vertices, edge points,
    interior points) from origins 10^2 to 10^3 group extents away (the
    largest side of the smallest valid group box that holds the point):
    half from random directions, half grazing their card (cosine 10^-3 to
    10^-1), where a candidate's t rounds most. Returns (o, d, distance),
    numpy."""
    g = np.random.default_rng(seed)
    lo_n, hi_n = sc.n_tris_opaque, sc.num_real_triangles
    v0, e1, e2 = (x[lo_n:hi_n].cpu().numpy().astype(np.float64)
                  for x in (sc.tri_v0, sc.tri_e1, sc.tri_e2))
    tri = g.integers(0, len(v0), n)
    v0, e1, e2 = v0[tri], e1[tri], e2[tri]
    a, b = g.uniform(size=(2, n, 1))
    kind = g.integers(0, 3, (n, 1))
    a = np.where(kind == 0, np.round(a), a)  # vertices
    b = np.where(kind == 0, 0.0, np.where(kind == 1, 1.0 - a, b * (1 - a)))
    tgt = v0 + a * e1 + b * e2
    unit = lambda x: x / np.linalg.norm(x, axis=1, keepdims=True)
    nrm, t1 = unit(np.cross(e1, e2)), unit(e1)
    phi = g.uniform(0.0, 2.0 * np.pi, (n, 1))
    cos = 10.0 ** g.uniform(-3.0, -1.0, (n, 1)) * g.choice([-1.0, 1.0],
                                                            (n, 1))
    graze = (np.sqrt(1.0 - cos * cos)
             * (np.cos(phi) * t1 + np.sin(phi) * np.cross(nrm, t1))
             + cos * nrm)
    d = np.where(np.arange(n)[:, None] % 2 == 0, graze,
                 unit(g.normal(size=(n, 3))))
    grp = sc.tr_grp.cpu().numpy()
    boxes = grp[:6, grp[6] > 0].T
    ext = (boxes[:, 3:] - boxes[:, :3]).max(1)
    # A point on a card lies in its group's box up to the rounding of the
    # float32 edges it is built from.
    gap = np.linalg.norm(np.maximum(np.maximum(
        boxes[None, :, :3] - tgt[:, None, :],
        tgt[:, None, :] - boxes[None, :, 3:]), 0.0), axis=2)
    holds = gap <= 1e-4 * ext.max()
    dist = (np.where(holds, ext[None, :], np.inf).min(1)
            * 10.0 ** g.uniform(2.0, 3.0, n))
    return tgt - d * dist[:, None], d, dist


def phase_rows_13_14(device, tex, big) -> dict:
    """3k: the alpha walk (row 13) and the transmittance walk (row 14) with
    the table resident in shared memory, each lane one gated pass and a
    sorted list, against their plain versions on every field of every
    lane: camera lanes with the opaque terminator, camera and random
    foliage lanes with a seventh dead, a ragged count with dead warps, the
    first bounce's 3 x 2^18 shadow lanes (all, and a tenth killed, and
    ragged with dead warps) on the textured showcase and scene A, tie rays
    through the layered duplicate-card scene, and textured-showcase rays
    from far origins (``far_rays``), each at caps 8, 1, 0 and 12; A0's
    counts; each kernel's time with the recounted bound and the
    -fmad=false floor; row 14 by kind of lane; the textured showcase's
    device time over one 1080p sample (scene A's is 3l's). Returns the
    numbers."""
    import torch

    from path_tracer_torch import native
    from path_tracer_torch.models.integrator import IntegratorSpec
    from path_tracer_torch.ops import cuda_trwalk, trwalk
    from path_tracer_torch.scene.procedural import (
        duplicate_card_device_scene,
    )

    log("phase 3k: rows 13 and 14 (the table resident in shared memory, "
        "one gated pass per lane, the steps from a sorted register list) "
        "against their plain versions")
    phase_t0 = time.perf_counter()
    n, rr = WAVE, WAVE - 37
    rng = np.random.default_rng(20261023)
    out = {"row13_err": 0.0, "row14_err": 0.0}
    caps = (8, 1, 0, 12)

    def alpha_held(label, sc, lanes, rnd):
        for cap in caps:
            args = lanes + (rnd, cap)
            out["row13_err"] = max(out["row13_err"], walk_held(
                f"row 13, {label}, cap {cap}",
                cuda_trwalk.alpha_walk(sc, *args),
                {"plain": trwalk.alpha_walk_plain(sc, *args)}))

    def trans_held(label, sc, lanes):
        for cap in caps:
            args = lanes + (cap,)
            out["row14_err"] = max(out["row14_err"], walk_held(
                f"row 14, {label}, cap {cap}",
                cuda_trwalk.trans_walk(sc, *args),
                {"plain": trwalk.trans_walk_plain(sc, *args)}))

    sets = {}
    for name, sc in (("textured showcase", tex), ("scene A", big)):
        cam = alpha_lanes(sc, n, device)
        sh = shadow_lanes(sc, n, device)
        sets[name] = (sc, cam, sh)
        rnd = walk_rnd(n, 12, device)
        alpha_held(f"{name} camera lanes", sc, cam, rnd)
        alpha_held(f"{name} camera and random foliage lanes, a seventh "
                   "dead", sc, alpha_lanes(sc, n, device, rng), rnd)
        alpha_held(f"{name} ragged R, dead warps", sc,
                   (cam[0][:rr].contiguous(), cam[1][:rr].contiguous(),
                    dead_warps(cam[2][:rr], -1.0)), rnd[:, :rr])
        trans_held(f"{name} first-bounce shadow lanes", sc, sh)
        trans_held(f"{name} first-bounce shadow lanes, a tenth killed", sc,
                   shadow_lanes(sc, n, device, rng))
        m = 3 * n - 37
        alive = dead_warps(torch.ones(m, device=device), 0.0) > 0.0
        trans_held(f"{name} ragged R, dead warps", sc,
                   tuple(x[:m].contiguous() for x in sh[:-1])
                   + (sh[-1][:m] & alive,))
    cards = duplicate_card_device_scene(device)
    log(f"  duplicate-card scene: {cards.num_real_triangles} triangles, "
        f"transparent table {cards.tr_bw.shape[1]} columns (the showcases' "
        f"sets held in {time.perf_counter() - phase_t0:.1f} s)")
    cam, rnd, sh = tie_card_lanes(cards, n, device)
    alpha_held("tie rays through 12 layers of duplicated cards", cards, cam,
               rnd)
    trans_held("tie rays through 12 layers of duplicated cards", cards, sh)
    o, d, dist = far_rays(tex, n, 20261025)
    cam, rnd, sh = ray_walk_lanes(
        tex, as_cuda(o, device), as_cuda(d, device),
        np.random.default_rng(20261026), device, dist)
    far = ("textured showcase rays from 10^2 to 10^3 group extents away "
           f"(origins up to {float(np.abs(o).max()):.0f}; half grazing their "
           "card)")
    alpha_held(far, tex, cam, rnd)
    trans_held(far, tex, sh)

    # A0 and each kernel's time, with the recounted bound and the floor.
    log(f"  parity held in {time.perf_counter() - phase_t0:.1f} s")
    cap = trwalk.TRWALK_K
    out["a0"], out["time"] = {}, {}
    for name, (sc, cam, sh) in sets.items():
        rnd = walk_rnd(n, cap, device)
        tp_real = int((sc.tr_bw[0:3].abs().sum(0) > 0).sum())
        tables = (sc.tr_bw, sc.tr_rows, sc.tr_tex8, sc.tr_lut,
                  sc.tr_page_table, sc.tr_grp)
        a0 = walk_counts(f"{name} alpha, camera lanes", sc, "alpha", cam,
                         rnd, cap)
        out["a0"][f"row 13 {name}"] = a0
        b = bound(a0["needed"] * OPS_BW,
                  nbytes(*cam, rnd, *tables) + n * (8 * 4 + 4))
        ms = min(cuda_ms(lambda: cuda_trwalk.alpha_walk(sc, *cam, rnd, cap),
                         AB_ITERS) for _ in range(2))
        out["time"][f"row 13 {name}"] = (
            ms, b, bound(a0["live"] * tp_real * OPS_BW, 0),
            bound(a0["design"] * OPS_BW, 0))
        a0 = walk_counts(f"{name} transmittance, first-bounce shadow lanes",
                         sc, "trans", sh, None, cap)
        out["a0"][f"row 14 {name}"] = a0
        aux = cuda_trwalk.trans_aux(*sh[2:])
        b = bound(a0["needed"] * OPS_BW,
                  nbytes(sh[0], sh[1], aux, *tables) + 3 * 4 * 3 * n)
        ms = min(cuda_ms(lambda: native.launch_trans_walk(sh[0], sh[1], aux,
                                                          sc, cap),
                         AB_ITERS) for _ in range(2))
        out["time"][f"row 14 {name}"] = (
            ms, b, bound(a0["live"] * tp_real * OPS_BW, 0),
            bound(a0["design"] * OPS_BW, 0))
        # Where row 14's time goes: each kind of lane alone, the others
        # dead (a point lane makes two passes, a directional lane one and
        # its steps).
        for part, keep in (("directional lanes", ~sh[3]),
                           ("point lanes", sh[3])):
            aux_k = cuda_trwalk.trans_aux(*sh[2:-1], sh[-1] & keep)
            ms = cuda_ms(lambda: native.launch_trans_walk(
                sh[0], sh[1], aux_k, sc, cap), AB_ITERS)
            out[f"row 14 {name} {part}"] = ms
            log(f"  row 14, {name}: the {part} alone "
                f"({int((sh[-1] & keep).sum())} live) {ms:.4f} ms")
    for label, (ms, b, ungated, des_b) in out["time"].items():
        log(f"  time {label}: {ms:.4f} ms; bound {b[0]:.4f} ms ({b[1]}; "
            f"the resident design's own tests {des_b[0]:.4f}; one ungated "
            f"pass per live lane {ungated[0]:.4f}), -fmad=false floor "
            f"{2 * b[0]:.4f} ms; share of the bound {b[0] / ms:.3f}")
        if b[0] > ms:
            raise AssertionError(f"{label}: faster than its bound")

    # Device time per main-path sample of the textured showcase, from the
    # profiler.
    prof = kernel_device_ms(tex, IntegratorSpec(bounces=5))
    out["profile textured showcase"] = prof
    log_profile("textured showcase", prof)
    for k in ("alpha_walk_kernel", "trans_walk_kernel"):
        if prof.get(k, (0.0, 0))[1] == 0:
            raise AssertionError(f"textured showcase: {k} never ran")
    log(f"  phase 3k took {time.perf_counter() - phase_t0:.1f} s")
    return out


def any2_work(o, ds, tms, sc, occ) -> dict:
    """Row 12's work on these sets (the any-hit's [L,R] result ``occ``):
    what the result needs (``flat2_work``: a slab test of every real
    superblock per live ray and of the 128 columns of each superblock an
    unoccluded ray enters, every real slot of each block it enters, one
    test for an occluded ray) and what the warp design executes. The design
    walks a ray's superblocks and blocks in column order, as the plain
    version does: each live warp slab-tests every real superblock for its
    32 rays, each ray still open when its superblock is reached tests the
    superblock's 128 columns, and each ray still open when a block is
    reached is served 128 slots (a chunk) at a time up to the chunk of its
    first hit. Returns the counts, the design's tests on real slots and its
    lane slots (128 a served ray and chunk), and the needed blocks."""
    import torch

    from path_tracer_torch.ops import cuda_bvh, slab

    ids, sb_ids = sc.sl_blkid[0], sc.sl_sbid[0]
    block = sc.sl_block
    n_groups = min(sb_ids.shape[0], ids.shape[0] // 128)
    n_sb = int((sb_ids[:n_groups] >= 0).sum())
    real = sc.sl_bw_t[0:3].abs().sum(0) > 0
    out = dict(slabs=0, tests=0, d_slabs=0, d_tests=0, d_slots=0,
               live_warps=0)
    needed = torch.zeros_like(ids, dtype=torch.bool)
    r = o.shape[0]
    for k, (d, tm) in enumerate(zip(ds, tms)):
        a, b, c = flat2_work(o, d, sc, None, tm, occ[k])
        out["slabs"] += a
        out["tests"] += b
        needed |= c
        live = tm >= 0.0
        warps = int(live[: r - r % 32].view(-1, 32).any(1).sum()) + int(
            bool(live[r - r % 32:].any()))
        out["live_warps"] += warps
        out["d_slabs"] += 32 * n_sb * warps
        for rs in (slice(x, x + (1 << 16)) for x in range(0, r, 1 << 16)):
            oc, dc, tmc = o[rs], d[rs], tm[rs]
            inv = slab.safe_inv(dc)
            done = tmc < 0.0
            sb_gate = slab.occluded_gate(*slab.slab(oc, inv, sc.sl_sbflat),
                                         tmc, sb_ids)
            for g in slab.live_columns(sb_gate[:, :n_groups]):
                lanes = torch.nonzero(sb_gate[:, g] & ~done)[:, 0]
                if lanes.numel() == 0:
                    continue
                out["d_slabs"] += 128 * lanes.numel()
                w = 128 * g
                gate = slab.occluded_gate(
                    *slab.slab(oc[lanes], inv[lanes],
                               sc.sl_blkflat[:, w:w + 128]),
                    tmc[lanes], ids[w:w + 128])
                for col in slab.live_columns(gate):
                    ln = lanes[torch.nonzero(gate[:, col])[:, 0]]
                    ln = ln[~done[ln]]
                    if ln.numel() == 0:
                        continue
                    start, rows = cuda_bvh._block_rows(sc, w + col)
                    t, _, _, _, ok = cuda_bvh._bw_test(oc[ln], dc[ln], rows)
                    hit = ok & (t <= tmc[ln][:, None])
                    any_hit = hit.any(dim=1)
                    first = torch.where(any_hit, hit.int().argmax(dim=1),
                                        block - 1)
                    chunks = first // 128 + 1
                    per_chunk = real[start:start + block].view(-1, 128).sum(1)
                    out["d_slots"] += 128 * int(chunks.sum())
                    out["d_tests"] += int(per_chunk.cumsum(0)[chunks - 1].sum())
                    done[ln] |= any_hit
    out["needed"] = needed
    return out


def log_any2_work(label: str, w: dict) -> None:
    """Logs ``any2_work``'s counts and ratios."""
    log(f"  row 12 work, {label}: slab tests needed {w['slabs']}, the "
        f"design's {w['d_slabs']} ({w['d_slabs'] / max(w['slabs'], 1):.3f}x; "
        f"{w['live_warps']} live warps); Baldwin-Weber tests needed "
        f"{w['tests']}, the design's on real slots {w['d_tests']} "
        f"({w['d_tests'] / max(w['tests'], 1):.3f}x), its lane slots "
        f"{w['d_slots']} ({w['d_slots'] / max(w['tests'], 1):.3f} a needed "
        f"test, {w['d_slots'] / max(w['d_tests'], 1):.3f} a test it makes); "
        f"{int(w['needed'].sum())} blocks needed")


def rows_12_2_parity(device, big) -> dict:
    """3l's parity: row 12 (the two-level warp any-hit) against its plain
    version on every lane of scene A's first-bounce and incoherent shadow
    sets (3 x 2^18), a ragged count with dead warps, and tie rays over two
    superblocks at t_max 1.5 t and 0.5 t with dead lanes; row 2 (the dense
    sphere kernel writing the merged record) merged and alone against its
    plain version, on every field of every lane: scene A's camera and
    first-bounce lanes (merged with row 11's record), ``spheres`` (a
    ragged count, dead warps) and 500 random spheres (merged with a random
    triangle record), and triangle records at the sphere's t (the triangle
    must win) and an ulp past it. Returns the sets and errors."""
    import torch

    from path_tracer_torch.ops import cuda_bvh, cuda_spheres, intersect
    from path_tracer_torch.scene import build_scene, load_scene
    from path_tracer_torch.scene.device_scene import (
        _pack_spheres,
        opaque_view,
    )
    from path_tracer_torch.scene.procedural import (
        duplicate_grid_scene,
        tie_rays,
    )

    log("phase 3l: rows 12 and 2 redesigned (the flat2 any-hit as two-level "
        "warp packets; the dense sphere closest hit writing the merged "
        "record) against their plain versions")
    t0 = time.perf_counter()
    n, rr = WAVE, WAVE - 37
    rng = np.random.default_rng(20261027)
    op = opaque_view(big)
    out = {"row12_err": 0.0, "row2_err": 0.0, "op": op}

    def occ2_held(label, o, ds, tms, sc):
        new = cuda_bvh.occluded_triangles_flat2_multi(o, ds, tms, sc)
        want = {"plain": cuda_bvh.occluded_triangles_flat2_multi_plain(
                    o, ds, tms, sc)}
        offs = {k: int((new != w).sum()) for k, w in want.items()}
        dead = torch.stack(tms) < 0.0
        log(f"  row 12, {label}: {len(ds)} x {o.shape[0]} lanes, occluded "
            f"{float(new[~dead].float().mean()):.3f} of the live; lanes off "
            + ", ".join(f"{k} {v}" for k, v in offs.items()))
        if any(offs.values()) or not bool(new[dead].all()):
            raise AssertionError(f"row 12, {label}: the warp any-hit "
                                 "disagrees")
        return new

    (bo, bd, btp), (so, sds, stms) = first_bounce(big, n, device)
    log(f"  scene A's first bounce cast in {time.perf_counter() - t0:.1f} s")
    out["first-bounce"] = (so, sds, stms, occ2_held(
        "scene A first-bounce shadow sets", so, sds, stms, op))
    io, ids_, itms = shadow_sets(rng, op, n, device)
    out["incoherent"] = (io, ids_, itms, occ2_held(
        "scene A incoherent shadow sets", io, ids_, itms, op))
    occ2_held("scene A first-bounce shadow sets, ragged R, dead warps",
              so[:rr].contiguous(), [x[:rr].contiguous() for x in sds],
              [dead_warps(x[:rr], -1.0) for x in stms], op)
    ties2 = build_scene(duplicate_grid_scene(8, 8400), ".", device,
                        use_bvh=True, sl_block=128)
    to, td = (as_cuda(x, device) for x in tie_rays(n))
    tie_tp = torch.full((n,), -1.0, device=device)
    tie_tp[::9] = float("inf")
    t_hit = cuda_bvh.closest_hit_triangles_flat2_plain(to, td, tie_tp,
                                                       ties2).t
    hit, dead = torch.isfinite(t_hit), torch.isinf(tie_tp)
    tie_tms = [torch.where(dead, -1.0, torch.where(hit, t_hit * k, 5.0))
               for k in (1.5, 0.5)]
    tie_occ = occ2_held("tie rays across two superblocks, t_max 1.5 t and "
                        "0.5 t, dead lanes", to, [td, td], tie_tms, ties2)
    if not (bool(tie_occ[0][hit & ~dead].all())
            and not bool(tie_occ[1][hit & ~dead].any())):
        raise AssertionError("row 12, tie rays: a hit within t_max missed "
                             "or one beyond it counted")

    log(f"  row 12 held in {time.perf_counter() - t0:.1f} s")
    sph_new = cuda_spheres.closest_hit_spheres_cuda
    sph_plain = cuda_spheres.closest_hit_spheres_merged_plain

    def sph_held(label, o, d, tp, sc, tri=None, extra=None):
        want = {"plain": sph_plain(o, d, tp, sc, tri), **(extra or {})}
        new = sph_new(o, d, tp, sc, tri=tri)
        out["row2_err"] = max(out["row2_err"],
                              held(f"row 2, {label}", new, want))
        return new

    minus1 = torch.full((n,), -1.0, device=device)
    co, cd = camera_rays(big, n, device)
    out["scene A"] = {}
    for label, (o, d, tp) in (("camera", (co, cd, minus1)),
                              ("first bounce", (bo, bd, btp))):
        tri = cuda_bvh.closest_hit_triangles_flat2(o, d, tp, op)
        out["scene A"][label] = (o, d, tp, tri)
        got = sph_held(f"scene A {label} lanes, merged with row 11's record",
                       o, d, tp, op, tri)
        kinds = {int(k) for k in got.kind.unique()}
        if not {1, 2} <= kinds:
            raise AssertionError(f"scene A {label}: kinds {kinds}")
        sph_held(f"scene A {label} lanes, alone", o, d, tp, op)
    # Triangle records at the sphere's t (the triangle wins every lane) and
    # an ulp past it (the sphere wins every hitting lane).
    o, d, tp, _ = out["scene A"]["first bounce"]
    sph = sph_plain(o, d, tp, op)
    g = torch.Generator(device=device).manual_seed(5)

    def fake(t):
        """A triangle record of hits at t, with random u, v, backface."""
        m = t.shape[0]
        return intersect.HitRecord(
            t=t.contiguous(),
            kind=torch.where(torch.isfinite(t), 1, 0).to(torch.int32),
            prim=torch.arange(m, dtype=torch.int32, device=device),
            u=torch.rand(m, generator=g, device=device),
            v=torch.rand(m, generator=g, device=device),
            backface=torch.rand(m, generator=g, device=device) < 0.5)

    tie = fake(sph.t)
    sph_held("scene A first bounce, a triangle record at the sphere's t",
             o, d, tp, op, tie, {"the triangle record": tie})
    past = fake(torch.nextafter(sph.t, torch.tensor(float("inf"),
                                                    device=device)))
    got = sph_held("scene A first bounce, a triangle record an ulp past "
                   "the sphere's t", o, d, tp, op, past)
    if not bool((got.kind[sph.valid] == 2).all()):
        raise AssertionError("row 2: a sphere lost to a farther triangle")

    sph_sc = load_scene(scene_path("spheres"), device)
    po, pd = camera_rays(sph_sc, n, device)
    out["spheres"] = (sph_sc, po, pd, minus1)
    sph_held("spheres camera lanes", po, pd, minus1, sph_sc)
    sph_held("spheres camera lanes, ragged R, dead warps",
             po[:rr].contiguous(), pd[:rr].contiguous(),
             dead_warps(minus1[:rr]), sph_sc)
    centers = rng.uniform(-5, 5, (500, 3)).astype(np.float32)
    radii = rng.uniform(0.05, 0.4, 500).astype(np.float32)
    ball = SimpleNamespace(sph_center=as_cuda(centers, device),
                           sph_radius=as_cuda(radii, device),
                           sph_packed_t=as_cuda(_pack_spheres(centers, radii),
                                                device),
                           num_real_spheres=500)
    ro, rd = random_rays(rng, rr, np.full(3, -5.0), np.full(3, 5.0), device)
    rtp = dead_warps(torch.full((rr,), -1.0, device=device))
    sph_held("500 spheres, ragged R, dead warps", ro, rd, rtp, ball)
    t_rand = as_cuda(np.where(rng.uniform(size=rr) < 0.3, np.inf,
                              rng.uniform(0.0, 12.0, rr)), device)
    sph_held("500 spheres, merged with a random triangle record", ro, rd,
             rtp, ball, fake(t_rand))
    return out


def rows_12_2_work(par: dict, design: bool = True) -> dict:
    """3l's counts on scene A's first-bounce and incoherent shadow sets:
    what row 12's results need (``flat2_work``: slab tests, BW tests and
    the needed blocks, the bound's work) and, with ``design``, what the
    design executes (``any2_work``, logged)."""
    out = {}
    for label in ("first-bounce", "incoherent"):
        o, ds, tms, occ = par[label]
        if design:
            out[label] = any2_work(o, ds, tms, par["op"], occ)
            log_any2_work(f"scene A {label} shadow sets", out[label])
            continue
        w = dict(slabs=0, tests=0, needed=0)
        for k, (d, tm) in enumerate(zip(ds, tms)):
            a, b, c = flat2_work(o, d, par["op"], None, tm, occ[k])
            w = dict(slabs=w["slabs"] + a, tests=w["tests"] + b,
                     needed=c | w["needed"])
        out[label] = w
    return out


def phase_rows_12_2(device, big, design_counts: bool = True) -> dict:
    """3l: rows 12 and 2 against their plain versions
    (``rows_12_2_parity``), row 12's counts (``rows_12_2_work``; the
    design's own only with ``design_counts``, as ``--only 3l`` runs it),
    then their times with their bounds: row 12 on scene A's 3 x 2^18
    first-bounce and incoherent shadow lanes; row 2 through its wrapper,
    the launch alone and its plain version, on scene A's 2^18 camera and
    first-bounce lanes merged with row 11's record and on the ``spheres``
    scene's camera lanes. Returns the numbers."""
    import torch

    from path_tracer_torch import native
    from path_tracer_torch.ops import cuda_spheres

    phase_t0 = time.perf_counter()
    par = rows_12_2_parity(device, big)
    log(f"  parity held in {time.perf_counter() - phase_t0:.1f} s")
    work = rows_12_2_work(par, design_counts)
    log(f"  counts done at {time.perf_counter() - phase_t0:.1f} s")
    op = par["op"]
    out = {"row12_err": par["row12_err"], "row2_err": par["row2_err"],
           "work": {k: {f: v for f, v in w.items() if f != "needed"}
                    for k, w in work.items()}, "times": {}}
    n = WAVE
    sb_tables = (op.sl_sbflat, op.sl_sbid, op.sl_blkflat, op.sl_blkid)
    for label in ("first-bounce", "incoherent"):
        o, ds, tms, _ = par[label]
        dss, tmss = torch.stack(ds).contiguous(), torch.stack(tms).contiguous()
        args = (o, dss, tmss, *sb_tables, op.sl_bw_t, op.sl_block)
        ms = [cuda_ms(lambda: native.launch_flat2_occluded(*args), AB_ITERS)
              for _ in range(2)]
        w = work[label]
        b = bound(w["slabs"] * OPS_SLAB + w["tests"] * OPS_BW,
                  nbytes(o, dss, tmss, *sb_tables)
                  + rows_bytes(op, w["needed"]) + n * len(ds))
        out["times"][f"row 12 {label}"] = (ms, b)

    sph_new = cuda_spheres.closest_hit_spheres_cuda
    rec_bytes = 3 * 4 + 2 * 4 + 1  # t, u, v, kind, prim, backface
    cases = [(f"row 2 scene A {label} lanes, merged", op, o, d, tp, tri)
             for label, (o, d, tp, tri) in par["scene A"].items()]
    sph_sc, po, pd, ptp = par["spheres"]
    cases.append(("row 2 spheres camera lanes", sph_sc, po, pd, ptp, None))
    for label, sc, o, d, tp, tri in cases:
        table = sc.sph_packed_t
        ms = [cuda_ms(lambda: sph_new(o, d, tp, sc, tri=tri), AB_ITERS)
              for _ in range(2)]
        launch = min(cuda_ms(lambda: native.launch_sphere_closest_hit(
            o, d, tp, table, tri), AB_ITERS) for _ in range(2))
        plain_ms, _ = timed_once(
            lambda: cuda_spheres.closest_hit_spheres_merged_plain(
                o, d, tp, sc, tri))
        b = bound(n * sc.num_real_spheres * OPS_SPHERE,
                  nbytes(o, d, tp, table, *(tri or ())) + n * rec_bytes)
        out["times"][label] = (ms, b, launch, plain_ms)
    for label, (ms, b, *rest) in out["times"].items():
        extra = ""
        if rest:
            extra = (f"; the launch alone {rest[0]:.4f} ms; plain "
                     f"{rest[1]:.4f} ms")
        log(f"  time {label}: {min(ms):.4f} ms (readings "
            + " ".join(f"{x:.4f}" for x in ms) + f"); bound {b[0]:.4f} ms "
            f"({b[1]}), -fmad=false floor {2 * b[0]:.4f} ms; share of the "
            f"bound {b[0] / min(ms):.3f}{extra}")
        if b[0] > min(ms):
            raise AssertionError(f"{label}: faster than its bound")
    log(f"  phase 3l took {time.perf_counter() - phase_t0:.1f} s")
    return out


# Row 4's operations per sphere test, split as the kernel computes them:
# oc and cc = |oc|^2 - r^2, once per (ray, sphere); b, disc and the roots,
# once per set still open.
OPS_SPHERE_SHARED, OPS_SPHERE_SET = 10, OPS_SPHERE - 10


def sph_block_best(o, d, tp, sc, chunk: int = 1 << 13):
    """[R, C] each lane's nearest valid root in each block column of the
    sphere walk (its naive quadratic; +inf for none and on pad columns)."""
    import torch

    from path_tracer_torch.ops.cuda_spheres import _sqrt_rn

    ids = sc.sph_blkid[0]
    sph = sc.sph_sorted_t
    nblk = sph.shape[1] // 128
    col = ids.clamp(min=0).long()
    out = []
    for a in range(0, o.shape[0], chunk):
        oc, dc, tpc = o[a:a + chunk], d[a:a + chunk], tp[a:a + chunk, None]
        aa = dc[:, 0] * dc[:, 0] + dc[:, 1] * dc[:, 1] + dc[:, 2] * dc[:, 2]
        inv2a = (1.0 / (2.0 * aa))[:, None]
        ocx = oc[:, 0:1] - sph[None, 0]
        ocy = oc[:, 1:2] - sph[None, 1]
        ocz = oc[:, 2:3] - sph[None, 2]
        b = 2.0 * (ocx * dc[:, 0:1] + ocy * dc[:, 1:2] + ocz * dc[:, 2:3])
        cc = ocx * ocx + ocy * ocy + ocz * ocz - (sph[3] * sph[3])[None, :]
        disc = b * b - (4.0 * aa)[:, None] * cc
        has = disc >= 0.0
        sq = _sqrt_rn(torch.where(has, disc, 0.0))
        t1 = (-b - sq) * inv2a
        t2 = (-b + sq) * inv2a
        v1 = has & (t1 >= 0.0) & (t1 > tpc)
        v2 = has & (t2 >= 0.0) & (t2 > tpc)
        t = torch.where(v1, t1, torch.where(v2, t2, float("inf")))
        best = t.view(-1, nblk, 128).min(dim=2).values[:, col]
        out.append(torch.where(ids[None, :] >= 0, best, float("inf")))
    return torch.cat(out)


def sph_walk_visits(o, d, tp, sc) -> dict:
    """Row 5's visits on these lanes (R a multiple of 32), simulated warp by
    warp as csrc/sph_walk.cu makes them: each warp lists the block columns
    some live ray's gate admits, keyed by their nearest slab entry, visits
    them nearest key first (lowest column on equal keys) while the key is
    no farther than some live ray's best t (widened), and serves each to
    the rays of its mask whose slab entry is no farther than their own
    best t (widened); a block's solves stop at its last real sphere
    (n_real). Returns the number of warp visits that serve some ray, the
    histogram of rays served a visit (``hist`` [33]), the slab tests of
    the gate and of the visits, the solves the kernel makes, and the lane
    slots each in-block layout occupies: lane per ray (32 x n_real a
    visit), the block over the warp (32 x its 32-slot groups up to n_real,
    a served ray) and both as the kernel chooses (lane per ray from
    native.SPH_WALK_LANE_WISE rays), with the kernel's widened cut
    (native.SPH_WALK_CUT_WIDEN)."""
    import torch

    from path_tracer_torch import native
    from path_tracer_torch.ops import slab

    widen, lane_wise_from = (native.SPH_WALK_CUT_WIDEN,
                             native.SPH_WALK_LANE_WISE)

    ids = sc.sph_blkid[0]
    sph = sc.sph_sorted_t
    pad = ((sph[0] == 1e30) & (sph[1] == 1e30) & (sph[2] == 1e30)
           & (sph[3] == 0.0)).view(-1, 128)
    slot = torch.arange(1, 129, device=o.device)
    n_real = torch.where(pad, 0, slot).max(dim=1).values[
        ids.clamp(min=0).long()]
    tn, tf = slab.slab(o, slab.safe_inv(d), sc.sph_blk)
    gate = slab.closest_gate(tn, tf, tp, ids)
    best = sph_block_best(o, d, tp, sc)
    r, c = gate.shape
    w = r // 32
    g, tnw, bw = (x.view(w, 32, c) for x in (gate, tn, best))
    live = (tp < float("inf")).view(w, 32)
    key = torch.where(g, tnw.clamp(min=0.0), float("inf")).min(dim=1).values
    visited = ~g.any(dim=1)
    bt = torch.full((w, 32), float("inf"), device=o.device)
    hist = torch.zeros(33, dtype=torch.long, device=o.device)
    live_warps = int(live.any(dim=1).sum())
    out = dict(visit_slabs=0, design_solves=0, lane_slots_a=0,
               lane_slots_b=0, lane_slots_both=0)
    for _ in range(c):
        col = torch.where(visited, float("inf"), key).argmin(dim=1)
        open_ = ~visited.gather(1, col[:, None])[:, 0]
        reach = torch.where(live, bt * widen,
                            float("-inf")).max(dim=1).values
        go = open_ & (key.gather(1, col[:, None])[:, 0] <= reach)
        if not bool(go.any()):
            break
        visited[go, col[go]] = True
        at = col[:, None, None].expand(w, 32, 1)
        gc, tnc, bc = (x.gather(2, at)[..., 0] for x in (g, tnw, bw))
        masked = go[:, None] & gc
        out["visit_slabs"] += int(masked.sum())
        need = masked & (tnc <= bt * widen)
        k = need.sum(dim=1)
        served = go & (k > 0)
        hist += torch.bincount(k[served], minlength=33)
        nr = n_real[col][served]
        ks = k[served]
        a = 32 * nr
        b = ks * 32 * ((nr + 31) // 32)
        lane_wise = ks >= lane_wise_from
        out["lane_slots_a"] += int(a.sum())
        out["lane_slots_b"] += int(b.sum())
        out["lane_slots_both"] += int(torch.where(lane_wise, a, b).sum())
        out["design_solves"] += int(torch.where(lane_wise, ks * nr,
                                                b).sum())
        bt = torch.where(need, torch.minimum(bt, bc), bt)
    ks = torch.arange(33, device=o.device)
    return dict(out, visits=int(hist[1:].sum()), hist=hist.tolist(),
                served=int((hist * ks).sum()),
                gate_slabs=32 * live_warps * int((ids >= 0).sum()))


def sph_walk_needed(o, d, tp, sc, t_hit) -> tuple[int, int]:
    """(slab tests, sphere solves) the walk's result needs: a slab test of
    every real block per live ray, and the real spheres of every block a
    ray's gate admits whose entry lies before its hit (``needed_gate``)."""
    from path_tracer_torch.ops import slab

    ids = sc.sph_blkid[0]
    real = real_per_column(sc.sph_sorted_t[3] > 0.0, 128, ids)
    tn, tf = slab.slab(o, slab.safe_inv(d), sc.sph_blk)
    gate = needed_gate(tn, tf, ids, tp, t_hit, None)
    live = int((tp < float("inf")).sum())
    return live * int((ids >= 0).sum()), int((gate * real).sum())


def log_sph_walk_visits(label: str, v: dict, solves: int) -> None:
    from path_tracer_torch import native

    log(f"  row 5 visits, {label}: {v['visits']} warp visits serving "
        f"{v['served']} rays (rays served a visit: "
        + " ".join(f"{k}:{n}" for k, n in enumerate(v["hist"]) if n)
        + f"); needed solves {solves}; lane slots, lane per ray "
        f"{v['lane_slots_a']} ({v['lane_slots_a'] / max(solves, 1):.3f} a "
        f"needed solve), block over the warp {v['lane_slots_b']} "
        f"({v['lane_slots_b'] / max(solves, 1):.3f}), both from "
        f"{native.SPH_WALK_LANE_WISE} rays {v['lane_slots_both']} "
        f"({v['lane_slots_both'] / max(solves, 1):.3f}); the design's "
        f"solves {v['design_solves']} "
        f"({v['design_solves'] / max(solves, 1):.3f}); slab tests: gate "
        f"{v['gate_slabs']}, visits {v['visit_slabs']}")


def sph_occ_dense_work(o, ds, tms, sc, prior=None) -> dict:
    """Row 4's tests on these sets: what the result needs (the bound's
    count, as ``sphere_any_hit_work``: every real sphere for a live lane
    the spheres leave unoccluded, one test for an occluded one; with
    ``prior``, none for a set whose prior is set) and the design's
    operations: a lane runs the spheres in order until every set is
    closed, paying OPS_SPHERE_SHARED a sphere for the shared oc and cc and
    OPS_SPHERE_SET for each set still open. Returns the counts."""
    import torch

    from path_tracer_torch.ops.cuda_spheres import _sqrt_rn

    n_s = sc.num_real_spheres
    sph = sc.sph_packed_t[:, :n_s]
    r = o.shape[0]
    iters = torch.zeros(r, dtype=torch.long, device=o.device)
    tests = set_tests = 0
    for k, (d, tm) in enumerate(zip(ds, tms)):
        closed = tm < 0.0 if prior is None else (tm < 0.0) | prior[k]
        firsts = []
        for a in range(0, r, 1 << 15):
            oc, dc, tmc = o[a:a + (1 << 15)], d[a:a + (1 << 15)], \
                tm[a:a + (1 << 15), None]
            aa = (dc[:, 0] * dc[:, 0] + dc[:, 1] * dc[:, 1]
                  + dc[:, 2] * dc[:, 2])
            inv2a = (1.0 / (2.0 * aa))[:, None]
            ocx = oc[:, 0:1] - sph[None, 0]
            ocy = oc[:, 1:2] - sph[None, 1]
            ocz = oc[:, 2:3] - sph[None, 2]
            b = 2.0 * (ocx * dc[:, 0:1] + ocy * dc[:, 1:2] + ocz * dc[:, 2:3])
            cc = ocx * ocx + ocy * ocy + ocz * ocz - (sph[3] * sph[3])[None]
            disc = b * b - (4.0 * aa)[:, None] * cc
            has = disc >= 0.0
            sq = _sqrt_rn(torch.where(has, disc, 0.0))
            t1, t2 = (-b - sq) * inv2a, (-b + sq) * inv2a
            hit = has & (((t1 >= 0.0) & (t1 <= tmc))
                         | ((t2 >= 0.0) & (t2 <= tmc)))
            firsts.append(torch.where(hit.any(dim=1),
                                      hit.int().argmax(dim=1) + 1, n_s))
        run = torch.where(closed, 0, torch.cat(firsts))  # spheres tested
        occ = run < n_s
        tests += int((occ & ~closed).sum()) \
            + int((~occ & ~closed).sum()) * n_s
        set_tests += int(run.sum())
        iters = torch.maximum(iters, run)
    design = int(iters.sum()) * OPS_SPHERE_SHARED + set_tests * OPS_SPHERE_SET
    return dict(tests=tests, set_tests=set_tests, lane_iters=int(iters.sum()),
                design_ops=design, needed_ops=tests * OPS_SPHERE)


def rows_5_4_parity(device, tex, grid) -> dict:
    """3m's parity: row 5 (the warp-packet sphere walk writing the merged
    record) against its plain version on every field of every lane: scene
    B's middle-wavefront camera lanes and first-bounce lanes, a ragged
    count with dead warps, triangle records at the sphere's t (the
    triangle must win) and an ulp past it, and the duplicate-sphere tie
    scene (the lowest slot), also with each sphere's later block grown;
    row 4 (one thread per ray over every set, the triangle result folded
    in) against its plain version on every lane of the textured
    showcase's first-bounce shadow sets (3 x 2^18, a tenth killed),
    without and with the flat any-hit's result as ``prior``, a ragged
    count with dead warps, a random prior, and 11 sets (two launches).
    Returns the sets and errors."""
    import torch

    from path_tracer_torch import native
    from path_tracer_torch.ops import cuda_bvh, cuda_spheres
    from path_tracer_torch.ops import intersect
    from path_tracer_torch.scene.device_scene import opaque_view
    from path_tracer_torch.scene.procedural import (
        duplicate_sphere_device_scene,
        sphere_tie_rays,
    )

    log("phase 3m: rows 5 and 4 (the sphere block walk as warp packets "
        "writing the merged record; the dense sphere any-hit as one thread "
        "per ray over every set, the triangle result folded in) against "
        "their plain versions")
    t0 = time.perf_counter()
    n, rr = WAVE, WAVE - 37
    out = {"row5_err": 0.0, "row4_err": 0.0}
    walk_new = cuda_spheres.closest_hit_spheres_cuda
    walk_plain = cuda_spheres.closest_hit_spheres_walk_merged_plain

    def walk_held(label, o, d, tp, sc, tri=None, extra=None):
        want = {"plain": walk_plain(o, d, tp, sc, tri), **(extra or {})}
        new = walk_new(o, d, tp, sc, tri=tri)
        out["row5_err"] = max(out["row5_err"],
                              held(f"row 5, {label}", new, want))
        return new

    minus1 = torch.full((n,), -1.0, device=device)
    co, cd = camera_rays(grid, n, device)
    cam = walk_held("scene B camera lanes", co, cd, minus1, grid)
    (bo, bd, btp), _ = first_bounce(grid, n, device)
    bounce = walk_held("scene B first-bounce lanes", bo, bd, btp, grid)
    out["scene B"] = {"camera": (co, cd, minus1, cam),
                      "first bounce": (bo, bd, btp, bounce)}
    walk_held("scene B first-bounce lanes, ragged R, dead warps",
              bo[:rr].contiguous(), bd[:rr].contiguous(),
              dead_warps(btp[:rr]), grid)
    g = torch.Generator(device=device).manual_seed(11)

    def fake(t):
        """A triangle record of hits at t, with random u, v, backface."""
        m = t.shape[0]
        return intersect.HitRecord(
            t=t.contiguous(),
            kind=torch.where(torch.isfinite(t), 1, 0).to(torch.int32),
            prim=torch.arange(m, dtype=torch.int32, device=device),
            u=torch.rand(m, generator=g, device=device),
            v=torch.rand(m, generator=g, device=device),
            backface=torch.rand(m, generator=g, device=device) < 0.5)

    for label, (o, d, tp, rec) in out["scene B"].items():
        tie = fake(rec.t)
        walk_held(f"scene B {label}, a triangle record at the sphere's t",
                  o, d, tp, grid, tie, {"the triangle record": tie})
        past = fake(torch.nextafter(rec.t, torch.tensor(float("inf"),
                                                        device=device)))
        got = walk_held(f"scene B {label}, a triangle record an ulp past the "
                        "sphere's t", o, d, tp, grid, past)
        if not bool((got.kind[rec.valid] == 2).all()):
            raise AssertionError("row 5: a sphere lost to a farther "
                                 "triangle")
    ties = duplicate_sphere_device_scene(device)
    to, td = (as_cuda(x, device) for x in sphere_tie_rays(n, 12))
    ttp = minus1.clone()
    ttp[::13] = float("inf")
    got = walk_held("duplicate-sphere tie rays", to, td, ttp, ties)
    first = walk_held("duplicate-sphere tie rays, from the first hit", to, td,
                      torch.where(got.valid, got.t, ttp), ties)
    # Each sphere's later block grown by 0.5: the walk meets the
    # higher-slot copy first, and reaches the lower-slot one only through
    # its widened cut.
    new = walk_held("duplicate-sphere tie rays, later blocks grown", to, td,
                    ttp, duplicate_sphere_device_scene(device, 0.5))
    firsts = ties.sph_smap.view(-1, 128)[0::2, 0]
    if not all(bool(torch.isin(x.prim[x.valid], firsts).all())
               for x in (got, first, new)):
        raise AssertionError("row 5, tie rays: a copy other than the "
                             "lowest slot won")
    log(f"  row 5 held in {time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(20261101)
    sh = first_bounce_shadows(tex, n, device, rng)
    op = opaque_view(tex)
    so = sh["s_o"]
    dss = torch.stack(sh["dirs"]).contiguous()
    tmss = torch.stack(sh["t_maxes"]).contiguous()
    tri = cuda_bvh.occluded_triangles_flat_multi(so, dss, tmss, op)
    out["tex"] = (sh, dss, tmss, tri)
    occ_new = cuda_spheres.occluded_spheres_cuda
    occ_plain = cuda_spheres.occluded_spheres_plain

    def occ_held(label, o, ds, tms, prior=None):
        new = occ_new(o, ds, tms, tex, prior=prior)
        off = int((new != occ_plain(o, ds, tms, tex, prior)).sum())
        dead = tms < 0.0
        log(f"  row 4, {label}: {tms.shape[0]} x {tms.shape[1]} lanes, "
            f"occluded {float(new[~dead].float().mean()):.3f} of the live; "
            f"lanes off the plain version {off}")
        if off:
            raise AssertionError(f"row 4, {label}: the dense any-hit "
                                 "disagrees")
        if prior is None and bool(new[dead].any()):
            raise AssertionError(f"row 4, {label}: a dead lane occluded")
        if prior is not None and not bool(new[prior].all()):
            raise AssertionError(f"row 4, {label}: a prior set dropped")
        return new

    occ_held("textured first-bounce shadow sets", so, dss, tmss)
    occ_held("textured first-bounce shadow sets, the flat any-hit as prior",
             so, dss, tmss, tri)
    occ_held("ragged R, dead warps, the flat any-hit as prior",
             so[:rr].contiguous(), dss[:, :rr].contiguous(),
             torch.stack([dead_warps(x[:rr], -1.0) for x in tmss]),
             tri[:, :rr].contiguous())
    rand = torch.rand(tmss.shape, generator=g, device=device) < 0.1
    occ_held("a random tenth as prior", so, dss, tmss, rand)
    # More sets than the kernel holds per lane: a launch per chunk.
    n_sets = native.SPH_OCC_MAX_SETS + 3
    pick = torch.arange(n_sets, device=device) % dss.shape[0]
    before = launched("sph_occluded")
    occ_held(f"{n_sets} sets (the first-bounce sets repeated), a random "
             "prior", so, dss[pick].contiguous(), tmss[pick].contiguous(),
             rand[pick].contiguous())
    if launched("sph_occluded") != before + 2:
        raise AssertionError(f"row 4: {n_sets} sets took "
                             f"{launched('sph_occluded') - before} "
                             "launches, not 2")
    log(f"  row 4 held in {time.perf_counter() - t0:.1f} s")
    return out


def phase_rows_5_4(device, tex, grid) -> dict:
    """3m: rows 5 and 4 against their plain versions (``rows_5_4_parity``);
    row 5's simulated visits and the lane slots of each in-block layout on
    scene B's camera and first-bounce lanes, row 4's tests with and
    without prior; then each kernel timed (CUDA events, two readings)
    beside its plain version, with its bound: row 5 through its wrapper on
    scene B's 2^18 camera and first-bounce lanes, row 4 through
    occluded_multi's sphere half (the flat any-hit's result as prior) on
    the textured showcase's 3 x 2^18 first-bounce shadow lanes. Returns
    the numbers."""
    from path_tracer_torch.ops import cuda_spheres

    phase_t0 = time.perf_counter()
    par = rows_5_4_parity(device, tex, grid)
    n = WAVE
    out = {"row5_err": par["row5_err"], "row4_err": par["row4_err"],
           "visits": {}, "times": {}}
    rec_bytes = 3 * 4 + 2 * 4 + 1
    walk_tables = (grid.sph_blk, grid.sph_blkid, grid.sph_sorted_t)
    for label, (o, d, tp, rec) in par["scene B"].items():
        v = sph_walk_visits(o, d, tp, grid)
        slabs, solves = sph_walk_needed(o, d, tp, grid, rec.t)
        log_sph_walk_visits(f"scene B {label} lanes", v, solves)
        out["visits"][label] = dict(v, needed_solves=solves,
                                    needed_slabs=slabs)
        b = bound(slabs * OPS_SLAB + solves * OPS_SPHERE,
                  nbytes(o, d, tp, *walk_tables, grid.sph_smap)
                  + n * rec_bytes)
        run = lambda: cuda_spheres.closest_hit_spheres_cuda(o, d, tp, grid)
        ms = [cuda_ms(run, 10), cuda_ms(run, 10)]
        plain_ms, _ = timed_once(
            lambda: cuda_spheres.closest_hit_spheres_walk_merged_plain(
                o, d, tp, grid))
        out["times"][f"row 5 scene B {label} lanes"] = (ms, b, plain_ms)

    sh, dss, tmss, tri = par["tex"]
    so = sh["s_o"]
    for label, prior in (("no prior", None), ("prior", tri)):
        w = sph_occ_dense_work(so, sh["dirs"], sh["t_maxes"], tex, prior)
        out["visits"][f"row 4 {label}"] = w
        log(f"  row 4 tests, textured first-bounce shadow sets, {label}: "
            f"needed {w['tests']} ({w['needed_ops']:.4e} operations), the "
            f"design's {w['set_tests']} set tests over {w['lane_iters']} "
            f"lane-sphere steps ({w['design_ops']:.4e} operations, "
            f"{w['design_ops'] / max(w['needed_ops'], 1):.3f}x)")
    b = bound(out["visits"]["row 4 prior"]["needed_ops"],
              nbytes(so, dss, tmss, tex.sph_packed_t, tri)
              + dss.shape[0] * n)
    run = lambda: cuda_spheres.occluded_spheres_cuda(so, dss, tmss, tex,
                                                     prior=tri)
    ms = [cuda_ms(run, 10), cuda_ms(run, 10)]
    plain_ms, _ = timed_once(lambda: cuda_spheres.occluded_spheres_plain(
        so, dss, tmss, tex, tri))
    out["times"]["row 4 through occluded_multi's sphere half"] = (ms, b,
                                                                 plain_ms)
    for label, (ms, b, plain_ms) in out["times"].items():
        log(f"  time {label}: " + " ".join(f"{x:.4f}" for x in ms)
            + f" ms; bound {b[0]:.4f} ms ({b[1]}), share "
            f"{b[0] / min(ms):.3f}; plain {plain_ms:.4f} ms")
        if b[0] > min(ms):
            raise AssertionError(f"{label}: faster than its bound")
    log(f"  phase 3m took {time.perf_counter() - phase_t0:.1f} s")
    return out


def exact_box_walk(o, d, t_max, sc):
    """The plain any-hit walk on the exact boxes and intervals (``slab``'s
    pads at 0): the mutation the widened gate repairs. [R] bool."""
    from path_tracer_torch.ops import cuda_spheres, slab

    names = ("BOX_PAD_EXT", "BOX_PAD_MAG", "BOX_PAD_T")
    saved = [getattr(slab, k) for k in names]
    try:
        for k in names:
            setattr(slab, k, 0.0)
        return cuda_spheres._occluded_walk_plain(o, d, t_max, sc)
    finally:
        for k, v in zip(names, saved):
            setattr(slab, k, v)


def phase_row_6(device, grid) -> dict:
    """3q: row 6 (the sphere any-hit walk as warp packets writing prior |
    spheres) against its plain version on every lane: scene B's
    first-bounce shadow sets of the middle 2^18 camera lanes toward both
    lights and its incoherent later-bounce sets (random sphere-surface
    points toward both lights), a tenth of each killed, without and with a
    random tenth as prior (scene B has no triangles, so no triangle
    any-hit to fold), a ragged count with dead warps, each in-block layout
    alone; the witness: the duplicate-sphere scene's tie rays (seeds 0-3,
    2^16 each) at t_max the first-hit t of the closest-hit walk run
    ungated, held to the ungated any-hit walk and the dense any-hit, with
    the exact-box mutation's lanes off counted (the witness still bites);
    row 5 on the same rays against its ungated plain version from t_prev =
    -1 and from the hit. Then, on both scene B sets, device ms a launch
    (each layout alone too), the wrapper's time, the plain version, the
    bound from the tests the widened gate needs and ptxas's report; and
    scene B's device ms and launches a 1080p sample from the profiler.
    Returns the numbers."""
    import dataclasses

    import torch

    from path_tracer_torch import native
    from path_tracer_torch.models.integrator import IntegratorSpec
    from path_tracer_torch.ops import cuda_spheres
    from path_tracer_torch.scene.procedural import (
        duplicate_sphere_device_scene,
        sphere_tie_rays,
    )

    log("phase 3q: row 6 (the sphere any-hit walk as warp packets writing "
        "prior | spheres) against its plain version")
    t0 = time.perf_counter()
    n, rr = WAVE, WAVE - 37
    rng = np.random.default_rng(20261116)
    tenth = lambda m: as_cuda(rng.uniform(size=m) < 0.1, device, bool)
    fb = first_bounce_shadows(grid, n, device, rng)
    io, ids, itms = shadow_sets(rng, grid, n, device)
    sets = {
        "first-bounce": (fb["s_o"].contiguous(), torch.stack(fb["dirs"]),
                         torch.stack(fb["t_maxes"])),
        "incoherent": (io, torch.stack(ids).contiguous(), torch.stack(
            [torch.where(tenth(n), -1.0, tm) for tm in itms])),
    }

    def tables(sc):
        return sc.sph_blk, sc.sph_blkid, sc.sph_sorted_t

    def held6(label, o, ds, tms, sc, prior=None, extra=None):
        before = launched("sph_occ_walk")
        new = cuda_spheres.occluded_spheres_cuda(o, ds, tms, sc, prior=prior)
        if launched("sph_occ_walk") != before + 1 \
                or new.dtype != torch.bool:
            raise AssertionError(f"row 6, {label}: not one bool launch")
        want = {"the plain version": cuda_spheres.occluded_spheres_plain(
                    o, ds, tms, sc, prior), **(extra or {})}
        offs = {k: int((new != w).sum()) for k, w in want.items()}
        dead = tms < 0.0
        log(f"  row 6, {label}: {tms.shape[0]} x {tms.shape[1]} lanes (live "
            f"{float((~dead).float().mean()):.3f}), occluded "
            f"{float(new[~dead].float().mean()):.4f} of the live; lanes off "
            + ", ".join(f"{k} {v}" for k, v in offs.items()))
        if any(offs.values()):
            raise AssertionError(f"row 6, {label}: the walk disagrees")
        if prior is None and bool(new[dead].any()):
            raise AssertionError(f"row 6, {label}: a dead lane occluded")
        if prior is not None and not bool(new[prior].all()):
            raise AssertionError(f"row 6, {label}: a prior set dropped")
        return new

    for label, (o, ds, tms) in sets.items():
        new = held6(f"scene B {label} shadow sets", o, ds, tms, grid)
        prior = torch.stack([tenth(n) for _ in range(tms.shape[0])])
        folded = held6(f"scene B {label} shadow sets, a random tenth as "
                       "prior", o, ds, tms, grid, prior)
        for lw in (1, 33):
            one = native.launch_sph_occ_walk(o, ds, tms, *tables(grid),
                                             prior, lane_wise=lw)
            if not torch.equal(one, folded):
                raise AssertionError(f"row 6, {label}: lane_wise {lw} "
                                     "differs from the mix")
        held6(f"scene B {label} shadow sets, ragged R, dead warps, a random "
              "prior", o[:rr].contiguous(), ds[:, :rr].contiguous(),
              torch.stack([dead_warps(x[:rr], -1.0) for x in tms]), grid,
              prior[:, :rr].contiguous())
        if not bool(new.any()):
            raise AssertionError(f"row 6, {label}: nothing occluded")

    ties = duplicate_sphere_device_scene(device)
    blk = ties.sph_blk.clone()
    blk[0:3], blk[3:6] = -1e30, 1e30
    ungated = dataclasses.replace(ties, sph_blk=blk)
    m = 1 << 16
    out = {"witness exact-box lanes off": [], "times": {}}
    for seed in range(4):
        to, td = (as_cuda(x, device) for x in sphere_tie_rays(m, seed))
        t = cuda_spheres._sph_walk_plain(
            to, td, torch.full((m,), -1.0, device=device), ungated)[0]
        judges = {
            "the ungated walk": cuda_spheres._occluded_walk_plain(
                to, td, t, ungated)[None],
            "the dense any-hit": cuda_spheres._occluded_dense_plain(
                to, td, t, ties)[None]}
        got = held6(f"duplicate-sphere tie rays, seed {seed}, t_max the "
                    "ungated first hit", to, td[None], t[None], ties,
                    extra=judges)
        exact = int((exact_box_walk(to, td, t, ties) != got[0]).sum())
        out["witness exact-box lanes off"].append(exact)
        log(f"  row 6, tie rays seed {seed}: the plain walk on the exact "
            f"boxes is off on {exact} lanes (the witness bites)")
        if not exact:
            raise AssertionError("row 6 witness: the exact-box mutation "
                                 "shows no lane off")
        tp = torch.full((m,), -1.0, device=device)
        for start in ("t_prev = -1", "from the hit"):
            rec = cuda_spheres.closest_hit_spheres_cuda(to, td, tp, ties)
            held(f"row 5, tie rays seed {seed}, {start}", rec, {
                "the ungated plain walk":
                    cuda_spheres.closest_hit_spheres_walk_plain(to, td, tp,
                                                                ungated),
                "its plain version":
                    cuda_spheres.closest_hit_spheres_walk_plain(to, td, tp,
                                                                ties)})
            tp = torch.where(rec.valid, rec.t, -1.0)
    log(f"  row 6 held in {time.perf_counter() - t0:.1f} s")

    for name, report in ptxas_report(native.kernels().build_log):
        if "sph_occ_walk" in name:
            log(f"  ptxas {name}: {report}")
    for label, (o, ds, tms) in sets.items():
        new_ms = [launch_device_ms(lambda: native.launch_sph_occ_walk(
            o, ds, tms, *tables(grid))) for _ in range(2)]
        lanes = {lw: launch_device_ms(lambda: native.launch_sph_occ_walk(
            o, ds, tms, *tables(grid), lane_wise=lw)) for lw in (1, 33)}
        wrap = lambda: cuda_spheres.occluded_spheres_cuda(o, ds, tms, grid)
        w_new = [cuda_ms(wrap, AB_ITERS) for _ in range(2)]
        plain_ms, want = timed_once(
            lambda: cuda_spheres.occluded_spheres_plain(o, ds, tms, grid))
        sh = {"s_o": o, "dirs": list(ds), "t_maxes": list(tms)}
        slabs, tests = sphere_any_hit_work(sh, grid, want)
        work = bound(slabs * OPS_SLAB + tests * OPS_SPHERE,
                     nbytes(o, ds, tms, *tables(grid)) + tms.numel())
        new = min(new_ms)
        log(f"  time row 6, scene B {label} shadow sets, {tms.numel()} "
            "lanes, device ms a launch "
            + " ".join(f"{x:.4f}" for x in new_ms) + "; each layout alone: "
            f"lane per ray {lanes[1]:.4f}, the block over the warp "
            f"{lanes[33]:.4f}; through the wrapper "
            + " ".join(f"{x:.4f}" for x in w_new)
            + f"; plain {plain_ms:.4f} ms; bound {work[0]:.4f} ms "
            f"({work[1]}: {slabs} slab tests, {tests} sphere tests), floor "
            f"{2 * work[0]:.4f} ms; share of the bound {work[0] / new:.3f}")
        if work[0] > new:
            raise AssertionError(f"row 6 {label}: faster than its bound")
        out["times"][label] = dict(new=new_ms, lanes=lanes, wrap=w_new,
                                   plain_ms=plain_ms, bound=work)

    # One 1080p sample of scene B.
    prof = kernel_device_ms(grid, IntegratorSpec(bounces=5))
    log_profile("scene B", prof)
    new_k = prof.get("sph_occ_walk_kernel", (0.0, 0))
    log(f"  scene B a 1080p sample: row 6 {new_k[0]:.3f} ms in {new_k[1]} "
        f"launches; all kernels {prof['all'][0]:.3f} ms in "
        f"{prof['all'][1]} launches")
    if not new_k[1]:
        raise AssertionError("scene B's sample did not take row 6")
    out["profile"] = prof
    log(f"  phase 3q took {time.perf_counter() - t0:.1f} s")
    return out


def phase_flat_turns(device, showcase, big) -> None:
    """3p: rows 9-12's device ms a launch (``launch_device_ms``, three
    readings each) at the main path's shapes: rows 9 and 11 on the middle
    wavefront's 2^18 camera and first-bounce lanes, rows 10 and 12 on the
    first bounce's 3 x 2^18 shadow lanes in one launch, on the plain
    showcase (9, 10) and scene A (11, 12). It calls only launchers whose
    operands have not changed since the flat kernels' gates were widened,
    so this script, copied into a checkout of an earlier commit and run
    there, times that commit's kernels on the same lanes: run from both,
    in turns, it gives the widening's cost on one card."""
    import torch

    from path_tracer_torch import native

    n = WAVE
    log("phase 3p: rows 9-12, device ms a launch")
    for name, sc, rows in (("plain showcase", showcase, ("9", "10")),
                           ("scene A", big, ("11", "12"))):
        flat = (sc.sl_blkflat, sc.sl_blkid, sc.sl_bw_t, sc.sl_block)
        two = (sc.sl_sbflat, sc.sl_sbid) if sc is big else ()
        closest = (native.launch_flat2_closest_hit if two
                   else native.launch_flat_closest_hit)
        any_hit = (native.launch_flat2_occluded if two
                   else native.launch_flat_occluded)
        co, cd = camera_rays(sc, n, device)
        (bo, bd, btp), _ = first_bounce(sc, n, device)
        sh = first_bounce_shadows(sc, n, device)
        dss = torch.stack(sh["dirs"]).contiguous()
        tmss = torch.stack(sh["t_maxes"]).contiguous()
        minus1 = torch.full((n,), -1.0, device=device)
        cases = (
            (f"row {rows[0]} {name} camera lanes",
             lambda: closest(co, cd, minus1, *two, *flat)),
            (f"row {rows[0]} {name} first-bounce lanes",
             lambda: closest(bo, bd, btp, *two, *flat)),
            (f"row {rows[1]} {name} first-bounce shadow sets",
             lambda: any_hit(sh["s_o"], dss, tmss, *two, *flat)),
        )
        for label, fn in cases:
            ms = [launch_device_ms(fn) for _ in range(3)]
            log(f"  time {label}: " + " ".join(f"{x:.4f}" for x in ms)
                + f" (best {min(ms):.4f})")


def ungated_scene(sc):
    """The scene with every real block and superblock box at +-1e30: the
    flat and flat2 walks' ungated form (every block tested by every live
    lane), their judge on tie rays."""
    import dataclasses

    def opened(boxes, ids):
        boxes = boxes.clone()
        real = ids[0] >= 0
        boxes[0:3, real] = -1e30
        boxes[3:6, real] = 1e30
        return boxes

    return dataclasses.replace(
        sc, sl_blkflat=opened(sc.sl_blkflat, sc.sl_blkid),
        sl_sbflat=opened(sc.sl_sbflat, sc.sl_sbid))


def phase_rows_7_8(device, showcase, big) -> dict:
    """3n: rows 7 and 8 (the superleaf tree walk as warp walks, each lane
    testing the leaves its own gate admits; the any-hit over all L sets in
    one launch) against their plain versions on every field of every lane,
    on the plain showcase and scene A's whole
    table, the middle wavefront's 2^18 camera lanes, first-bounce lanes,
    random and incoherent (cosine from random surface points) lanes, a
    ragged count with dead warps, and the first bounce's 3 x 2^18 shadow
    lanes (a tenth killed), the incoherent lanes' shadow sets and a ragged
    count with dead warps; tie rays on ``duplicate_grid_scene`` (pairs of
    copies in one leaf, a stack of 300 over several), t_max 1.5 t and
    0.5 t, held also against brute-force MT, and rows 9-12 (the flat and
    flat2 kernels) on the same tie rays against their ungated plain
    versions (every block and superblock box at +-1e30: brute-force
    Baldwin-Weber). Then the work (``tree_walk_visits``) on the
    showcase's and scene A's camera, first-bounce and first shadow set,
    and the device ms a launch (``launch_device_ms``, twice) with the
    bound recounted from the plain version's needed tests, beside rows 9
    and 10 (showcase) or 11 and 12 (scene A) on the same rays. Returns the
    errors and times."""
    import torch

    from path_tracer_torch import native
    from path_tracer_torch.ops import cuda_bvh, cuda_intersect
    from path_tracer_torch.scene import build_scene
    from path_tracer_torch.scene.procedural import (
        duplicate_grid_scene,
        tie_rays,
        tie_winners,
    )

    log("phase 3n: rows 7 and 8 (warp walks, a lane testing the leaves its "
        "own gate admits; the any-hit's L sets in one launch) against their "
        "plain versions; rows 7-12 on tie rays against brute force")
    phase_t0 = time.perf_counter()
    n, m = WAVE, WAVE // 4  # 2^16 random, incoherent and ragged lanes
    rr = m - 37
    out = {"row7_err": 0.0, "row8_err": 0.0, "times": {}}
    rng = np.random.default_rng(20261107)

    def closest_held(label, o, d, tp, sc, plain=None):
        o, d, tp = o.contiguous(), d.contiguous(), tp.contiguous()
        if plain is None:
            plain = cuda_bvh.closest_hit_triangles_tree_plain(o, d, tp, sc)
        new = cuda_bvh.closest_hit_triangles_tree(o, d, tp, sc)
        out["row7_err"] = max(out["row7_err"],
                              held(f"row 7, {label}", new, {"plain": plain}))
        return new

    def any_held(label, o, ds, tms, sc, plain=None):
        o = o.contiguous()
        if plain is None:
            plain = cuda_bvh.occluded_triangles_tree_multi_plain(o, ds, tms,
                                                                 sc)
        before = launched("tree_occluded")
        new = cuda_bvh.occluded_triangles_tree_multi(o, ds, tms, sc)
        launches = launched("tree_occluded") - before
        off = int((new != plain).sum())
        dead = torch.stack(list(tms)) < 0.0
        log(f"  row 8, {label}: {len(ds)} x {o.shape[0]} lanes in "
            f"{launches} launch, occluded "
            f"{float(new[~dead].float().mean()):.3f} of the live; lanes off "
            f"the plain version {off}")
        if off or launches != 1 or not bool(new[dead].all()):
            raise AssertionError(f"row 8, {label}: the tree any-hit "
                                 "disagrees")
        out["row8_err"] = max(out["row8_err"],
                              float((new != plain).float().max()))
        return new

    for name, sc in (("plain showcase", showcase), ("scene A", big)):
        t0 = time.perf_counter()
        minus1 = torch.full((n,), -1.0, device=device)
        co, cd = camera_rays(sc, n, device)
        (bo, bd, btp), _ = first_bounce(sc, n, device)
        sh = first_bounce_shadows(sc, n, device, rng)
        so, sds, stms = sh["s_o"], sh["dirs"], sh["t_maxes"]
        v = sc.tri_v0[: sc.num_real_triangles].cpu().numpy()
        ro, rd = random_rays(rng, m, v.min(0), v.max(0), device)
        io, id_ = bounce_rays(rng, sc, m, device)
        iso, isds, istms = shadow_sets(rng, sc, m, device)
        kill = as_cuda(rng.uniform(size=(len(istms), m)) < 0.1, device, bool)
        istms = [torch.where(k, -1.0, tm) for k, tm in zip(kill, istms)]
        cases = {"camera": (co, cd, minus1),
                 "first-bounce": (bo, bd, btp)}
        visits = {}
        for label, (o, d, tp) in cases.items():
            visits[label] = tree_walk_visits(o, d, tp, sc)
            log_tree_visits(f"{name} {label} lanes", visits[label])
            closest_held(f"{name} {label} lanes", o, d, tp, sc,
                         cuda_bvh.tree_record(*visits[label]["result"], sc))
        closest_held(f"{name} random lanes", ro, rd, minus1[:m], sc)
        closest_held(f"{name} incoherent lanes", io, id_, minus1[:m], sc)
        closest_held(f"{name} first-bounce lanes, ragged R, dead warps",
                     bo[:rr], bd[:rr], dead_warps(btp[:rr]), sc)
        sv = [tree_walk_visits(so, sd, tm, sc, any_hit=True,
                               widths=(128, 32) if k == 0 else (32,))
              for k, (sd, tm) in enumerate(zip(sds, stms))]
        log_tree_visits(f"{name} first-bounce shadow set 0", sv[0])
        any_held(f"{name} first-bounce shadow sets, a tenth killed", so, sds,
                 stms, sc, torch.stack([x["result"] for x in sv]))
        any_held(f"{name} incoherent shadow sets, a tenth killed", iso, isds,
                 istms, sc)
        any_held(f"{name} ragged R, dead warps", so[:rr],
                 [x[:rr].contiguous() for x in sds],
                 [dead_warps(x[:rr], -1.0) for x in stms], sc)
        log(f"  {name} held in {time.perf_counter() - t0:.1f} s")

        # Both designs in turns, the launch alone, beside the flat family.
        tables = (sc.sl_nodes6, sc.sl_meta6, sc.sl_tris_t, sc.sl_n_nodes,
                  sc.sl_block)
        flat = (sc.sl_blkflat, sc.sl_blkid, sc.sl_bw_t, sc.sl_block)
        rows = ("9", "10") if sc is showcase else ("11", "12")
        sbs = (sc.sl_sbflat, sc.sl_sbid)
        for label, (o, d, tp) in cases.items():
            b = tree_bound(visits[label], sc, o, d, tp, n * (4 * 4 + 4))
            new_ms = [launch_device_ms(
                lambda: native.launch_tree_closest_hit(o, d, tp, *tables))
                for _ in range(2)]
            other = launch_device_ms(
                (lambda: native.launch_flat_closest_hit(o, d, tp, *flat))
                if sc is showcase else
                (lambda: native.launch_flat2_closest_hit(o, d, tp, *sbs,
                                                         *flat)))
            plain_ms, _ = timed_once(
                lambda: cuda_bvh.closest_hit_triangles_tree_plain(o, d, tp,
                                                                  sc))
            out["times"][f"row 7 {name} {label} lanes"] = (
                new_ms, b, plain_ms, (rows[0], other),
                wrapper_ms(lambda: cuda_bvh.closest_hit_triangles_tree(
                    o, d, tp, sc)))
        dss, tmss = torch.stack(sds).contiguous(), torch.stack(stms)
        b = tree_bound(sv, sc, so, dss, tmss, dss.shape[0] * n)
        new_ms = [launch_device_ms(
            lambda: native.launch_tree_occluded(so, dss, tmss, *tables))
            for _ in range(2)]
        other = launch_device_ms(
            (lambda: native.launch_flat_occluded(so, dss, tmss, *flat))
            if sc is showcase else
            (lambda: native.launch_flat2_occluded(so, dss, tmss, *sbs,
                                                  *flat)))
        plain_ms, _ = timed_once(
            lambda: cuda_bvh.occluded_triangles_tree_multi_plain(so, sds,
                                                                 stms, sc))
        out["times"][f"row 8 {name} first-bounce shadow sets"] = (
            new_ms, b, plain_ms, (rows[1], other),
            wrapper_ms(lambda: cuda_bvh.occluded_triangles_tree_multi(
                so, sds, stms, sc)))

    # Tie rays: pairs of copies in one leaf, a stack of 300 over several;
    # held also against brute-force MT (row 1's kernel, the same MT
    # arithmetic) in hit/miss and t, the prim free among copies at one t.
    ties = build_scene(duplicate_grid_scene(), ".", device, use_bvh=True,
                       sl_block=128)
    to, td = (as_cuda(x, device) for x in tie_rays(rr))
    tie_tp = torch.full((rr,), -1.0, device=device)
    tie_tp[::9] = float("inf")

    ungated = ungated_scene(ties)
    off = lambda x, w: int(((x.valid != w.valid)
                            | (w.valid & (x.t != w.t))).sum())

    def brute_held(label, tp, new):
        brute = cuda_intersect.closest_hit_triangles_cuda(to, td, tp, ties)
        log(f"    {label}, against brute-force MT (hit/miss or t): lanes "
            f"off {off(new, brute)}")
        if off(new, brute):
            raise AssertionError(f"row 7, {label}: a hit of the brute "
                                 "force lost")
        for walk in ("flat", "flat2"):  # rows 9 and 11
            got = getattr(cuda_bvh, f"closest_hit_triangles_{walk}")(
                to, td, tp, ties)
            want = getattr(cuda_bvh, f"closest_hit_triangles_{walk}_plain")(
                to, td, tp, ungated)
            log(f"    {label}, the {walk} kernel against its ungated plain "
                f"version (hit/miss or t): lanes off {off(got, want)} (prim "
                f"{int((got.prim != want.prim).sum())})")
            if off(got, want):
                raise AssertionError(f"{walk}, {label}: a hit of the "
                                     "ungated walk lost")
        return brute

    hits = closest_held("tie rays (centroids, the stack, edges, vertices), "
                        "ragged R", to, td, tie_tp, ties)
    brute = brute_held("tie rays", tie_tp, hits)
    winner = torch.from_numpy(tie_winners(ties)[1]).to(device)
    prim = hits.prim[hits.valid].long()
    log(f"    tie rays: {prim.numel()} hits, the lowest slot's copy won on "
        f"{int((winner[prim] == prim).sum())} (the tree's rule: the first "
        "leaf visited)")
    for label, tp in (("from the first hit", hits.t),
                      ("from an ulp before the brute force's hit",
                       torch.nextafter(brute.t, torch.tensor(-1.0,
                                                             device=device)))):
        tp = torch.where(hits.valid, tp, tie_tp)
        brute_held(f"tie rays, {label}", tp,
                   closest_held(f"tie rays, {label}", to, td, tp, ties))
    dead = torch.isinf(tie_tp)
    tms = [torch.where(dead, -1.0, torch.where(hits.valid, hits.t * k, 5.0))
           for k in (1.5, 0.5, 1.0)]
    occ = any_held("tie rays, t_max 1.5 t, 0.5 t and t, dead lanes", to,
                   [td] * len(tms), tms, ties)
    want = torch.stack([(brute.valid & (brute.t <= tm)) | (tm < 0)
                        for tm in tms])
    log(f"    tie rays' any-hits against brute-force MT: lanes off "
        f"{int((occ != want).sum())}")
    if (occ != want).any():
        raise AssertionError("row 8, tie rays: a hit of the brute force "
                             "lost")
    for walk in ("flat", "flat2"):  # rows 10 and 12
        got = getattr(cuda_bvh, f"occluded_triangles_{walk}_multi")(
            to, [td] * len(tms), tms, ties)
        want = getattr(cuda_bvh, f"occluded_triangles_{walk}_multi_plain")(
            to, [td] * len(tms), tms, ungated)
        log(f"    tie rays' any-hits, the {walk} kernel against its ungated "
            f"plain version: lanes off {int((got != want).sum())}")
        if (got != want).any():
            raise AssertionError(f"{walk} any-hit, tie rays: a hit of the "
                                 "ungated walk lost")

    for label, (new_ms, b, plain_ms, (row, other), wrap) in \
            out["times"].items():
        new = min(new_ms)
        log(f"  time {label}, device ms a launch: "
            + " ".join(f"{x:.4f}" for x in new_ms) + f"; bound {b[0]:.4f} "
            f"ms ({b[1]}), -fmad=false floor {2 * b[0]:.4f} ms; share of "
            f"the bound {b[0] / new:.3f}; row {row} on the same rays "
            f"{other:.4f}; plain (the tree walk) {plain_ms:.4f} ms; through "
            f"its wrapper (cuda_ms, as the kernels line) {wrap:.4f} ms")
        if b[0] > new:
            raise AssertionError(f"{label}: faster than its bound")
    log(f"  phase 3n took {time.perf_counter() - phase_t0:.1f} s")
    return out


def with_env(env: dict):
    """Set environment knobs; returns a function that restores them."""
    import os

    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)

    def restore():
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    return restore


DENSE_ENV = {"PT_NO_TRWALK_KERNEL": "1", "PT_DENSE_TR": "1"}


def timed_render(sc, w, h, spp, bounces, env=None, spw: int = 1,
                 compact: bool = False):
    """(seconds, pixel sums, launch counts) of one render_pixel_sums call
    (counts set to 0 just before it), with ``env`` knobs set for it, spw
    samples per wavefront and live-ray compaction as asked."""
    import dataclasses

    import torch

    from path_tracer_torch.config import Profile, Resolution
    from path_tracer_torch.models.renderer import (
        integrator_spec,
        render_pixel_sums,
    )

    profile = Profile(resolution=Resolution(w, h), bounces=bounces,
                      samples=spp)
    restore = with_env(env or {})
    try:
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        sums = render_pixel_sums(
            sc, w, h, 1, spp,
            dataclasses.replace(integrator_spec(profile), compact=compact),
            tile_rays=profile.tile_rays, samples_per_wavefront=spw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = launch_counts()
    finally:
        restore()
    return secs, sums, counts


def cli_frame(path: Path, png: Path, env: dict, w: int = 1920,
              h: int = 1080, bounces: int = 5):
    """(seconds, launch counts) of one 1-spp frame through the CLI with
    ``env`` knobs set for it."""
    import torch

    from path_tracer_torch import cli

    prof = path.parent / "profile_1spp.yaml"
    prof.write_text(f"resolution: {{width: {w}, height: {h}}}\n"
                    f"samples: 1\nbounces: {bounces}\n")
    restore = with_env(env)
    try:
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        cli.main(["render", str(path), "-o", str(png), "-q", "-p", str(prof),
                  "--device", "cuda"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = launch_counts()
    finally:
        restore()
    return secs, counts


def phase_dense_route(device, tex, tex_path: Path):
    """4g: the textured showcase at 1920x1080, 5 bounces, DENSE_SPP spp
    through the dense walk (PT_NO_TRWALK_KERNEL=1 PT_DENSE_TR=1: row 3,
    no walk kernel) and through the walk kernels, same seed, in turns
    (ABBA): at most MAX_WALK_PIXELS of the pixels beyond 1e-3; seconds
    per sample and row 3's launches per sample; then one 1-spp frame of
    the scene file through the CLI on the dense route. Returns the first
    dense run's launch counts."""
    from path_tracer_torch.models.renderer import finalize
    from path_tracer_torch.config import Profile, Resolution
    from path_tracer_torch.utils.image_io import save_png

    w, h, spp, bounces = 1920, 1080, DENSE_SPP, 5
    log(f"phase 4g: textured showcase, the dense walk (row 3) against the "
        f"walk kernels, {w}x{h}, {bounces} bounces, {spp} spp, ABBA")
    runs = {"dense": [], "kernels": []}
    first = {}
    for label in ("kernels", "dense", "dense", "kernels"):
        secs, sums, counts = timed_render(
            tex, w, h, spp, bounces, DENSE_ENV if label == "dense" else None)
        runs[label].append(secs / spp)
        first.setdefault(label, (sums, counts))
        log(f"  {label}: {secs:.3f} s ({secs / spp:.3f} s per sample), "
            f"launches {counts}")
    dense, dense_counts = first["dense"]
    kern, kern_counts = first["kernels"]
    if not dense_counts["k_nearest_tr_hits"] or dense_counts["alpha_walk"] \
            or dense_counts["trans_walk"]:
        raise AssertionError(f"the dense route did not take row 3 alone: "
                             f"{dense_counts}")
    diff = np.abs(dense / spp - kern / spp).max(axis=-1)
    frac = float((diff > 1e-3).mean())
    img = finalize(dense, spp, Profile(resolution=Resolution(w, h),
                                       bounces=bounces, samples=spp), w, h)
    save_png(img, OUT / f"showcase_tex_dense_1080p_{spp}spp_b5.png")
    log(f"  dense against the walk kernels: pixels beyond 1e-3 {frac:.5f} "
        f"(<= {MAX_WALK_PIXELS}), max {diff.max():.3e}; seconds per sample "
        f"dense {runs['dense']}, walk kernels {runs['kernels']}; row 3 "
        f"launches per sample {dense_counts['k_nearest_tr_hits'] / spp:.1f}; "
        f"kernel launches per sample, dense "
        f"{sum(dense_counts.values()) / spp:.1f}, walk kernels "
        f"{sum(kern_counts.values()) / spp:.1f}; finite "
        f"{bool(np.isfinite(dense).all())}")
    if not np.isfinite(dense).all() or frac > MAX_WALK_PIXELS:
        raise AssertionError("the dense route and the walk kernels disagree")
    png = OUT / "showcase_tex_dense_cli_1spp.png"
    secs, counts = cli_frame(tex_path, png, DENSE_ENV)
    log(f"  dense route via the CLI (1 spp, scene load included): "
        f"{secs:.3f} s, launches {counts}, png {png.stat().st_size} bytes")
    if not counts["k_nearest_tr_hits"] or counts["alpha_walk"]:
        raise AssertionError(f"CLI frame did not take row 3: {counts}")
    return dense_counts


def phase_tree_route(device, showcase, flat, tex_path: Path):
    """4h: the plain showcase at 1920x1080, 5 bounces, TREE_SPP spp under
    PT_BVH_KERNEL=tree (rows 7 and 8; the any-hit one launch a bounce for
    the three lights, so as many as row 7's) against the flat route's
    render of the same frame (``flat``: (seconds, sums) of phase 4's
    showcase run): at least MIN_PIXELS_WITHIN of the values within rtol
    1e-3 / atol 1e-4 and mean energy within MAX_ENERGY_REL; then the two
    routes in turns (flat, tree, tree, flat) at TREE_TURN_SPP spp, seconds
    per sample; one 1080p sample under tree through ``torch.profiler``
    (rows 7 and 8's device ms a sample); and one 1-spp frame of the
    textured showcase's scene file through the CLI under tree (the
    partition stands down: row 7 serves the whole-scene walks). Returns
    the tree run's launch counts and the profile."""
    from path_tracer_torch.config import Profile, Resolution
    from path_tracer_torch.models.integrator import IntegratorSpec
    from path_tracer_torch.models.renderer import finalize
    from path_tracer_torch.utils.image_io import save_png

    w, h, spp, bounces = 1920, 1080, TREE_SPP, 5
    log(f"phase 4h: the plain showcase through the tree walk "
        f"(PT_BVH_KERNEL=tree), {w}x{h}, {bounces} bounces, {spp} spp")
    tree_env = {"PT_BVH_KERNEL": "tree"}
    secs, got, counts = timed_render(showcase, w, h, spp, bounces, tree_env)
    flat_secs, want = flat
    img = finalize(got, spp, Profile(resolution=Resolution(w, h),
                                     bounces=bounces, samples=spp), w, h)
    save_png(img, OUT / f"showcase_tree_1080p_{spp}spp_b5.png")
    got, want = got / spp, want / spp
    within = float((np.abs(got - want) <= 1e-4 + 1e-3 * np.abs(want)).mean())
    energy = abs(float(got.mean()) - float(want.mean())) / float(want.mean())
    log(f"  tree: {secs:.3f} s ({secs / spp:.3f} s per sample; the flat "
        f"route {flat_secs:.3f} s, {flat_secs / spp:.3f} s per sample), "
        f"launches {counts}; values within rtol 1e-3 / atol 1e-4 of the "
        f"flat route {within:.5f} (>= {MIN_PIXELS_WITHIN}); mean energy "
        f"{got.mean():.6f} vs {want.mean():.6f}, rel diff {energy:.2e} (<= "
        f"{MAX_ENERGY_REL})")
    if not (counts["tree_closest_hit"] and counts["tree_occluded"]) or \
            counts["flat_closest_hit"] or counts["flat_occluded"] or \
            counts["flat2_closest_hit"] or counts["flat2_occluded"]:
        raise AssertionError(f"the tree route did not take rows 7 and 8 "
                             f"alone: {counts}")
    if counts["tree_occluded"] != counts["tree_closest_hit"]:
        raise AssertionError("the tree any-hit took more than one launch a "
                             f"bounce: {counts}")
    if not (np.isfinite(got).all() and within >= MIN_PIXELS_WITHIN
            and energy <= MAX_ENERGY_REL):
        raise AssertionError("tree and flat renders disagree")
    turns = {"flat": [], "tree": []}
    for route in ("flat", "tree", "tree", "flat"):
        t, _, _ = timed_render(showcase, w, h, TREE_TURN_SPP, bounces,
                               tree_env if route == "tree" else None)
        turns[route].append(t / TREE_TURN_SPP)
    log(f"  in turns (flat, tree, tree, flat), {TREE_TURN_SPP} spp each: "
        f"seconds per sample, flat "
        + " ".join(f"{x:.4f}" for x in turns["flat"]) + ", tree "
        + " ".join(f"{x:.4f}" for x in turns["tree"]))
    restore = with_env(tree_env)
    try:
        prof = kernel_device_ms(showcase, IntegratorSpec(bounces=bounces))
    finally:
        restore()
    log_profile("plain showcase under PT_BVH_KERNEL=tree", prof)
    for k in ("tree_closest_kernel", "tree_occluded_kernel"):
        if prof.get(k, (0.0, 0))[1] == 0:
            raise AssertionError(f"the profiled tree sample ran no {k}")
    png = OUT / "showcase_tex_tree_cli_1spp.png"
    cli_secs, cli_counts = cli_frame(tex_path, png, tree_env)
    log(f"  textured showcase under tree via the CLI (1 spp, scene load "
        f"included): {cli_secs:.3f} s, launches {cli_counts}, png "
        f"{png.stat().st_size} bytes")
    if not cli_counts["tree_closest_hit"] or cli_counts["alpha_walk"] \
            or cli_counts["flat_closest_hit"]:
        raise AssertionError(f"CLI frame did not take the tree walk: "
                             f"{cli_counts}")
    return counts, prof


# The kernel identifier each launch count counts (the live variants run
# the forward variants' kernels).
KERNEL_OF_COUNT = {
    "mt_closest_hit": "mt_closest_hit_kernel",
    "sphere_closest_hit": "sphere_closest_hit_kernel",
    "sph_walk": "sph_walk_kernel",
    "flat_closest_hit": "flat_closest_hit_kernel",
    "flat_occluded": "flat_occluded_kernel",
    "flat2_closest_hit": "flat2_closest_hit_kernel",
    "flat2_occluded": "flat2_occluded_kernel",
    "alpha_walk": "alpha_walk_kernel",
    "trans_walk": "trans_walk_kernel",
    "sph_occluded": "sph_occ_dense_kernel",
    "sph_occ_walk": "sph_occ_walk_kernel",
    "fused_shadow": "fused_shadow_kernel",
    "alpha_walk_live": "alpha_walk_kernel",
    "trans_walk_live": "trans_walk_kernel",
    "fused_shadow_live": "fused_shadow_kernel",
    "k_nearest_tr_hits": "khit_kernel",
    "tree_closest_hit": "tree_closest_kernel",
    "tree_occluded": "tree_occluded_kernel"}


def per_sample(counts: dict, spp: int) -> float:
    """The hand-written kernels' launches a sample."""
    return sum(counts.values()) / spp


def driver_render(label: str, sc, spp: int, env=None, spw: int = 1,
                  compact: bool = False):
    """(seconds, sums, counts, peak device bytes) of a render_pixel_sums
    run of phase 7's frame, 5 bounces, logged."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    secs, sums, counts = timed_render(sc, DRIVER_W, DRIVER_H, spp, 5, env,
                                      spw=spw, compact=compact)
    peak = torch.cuda.max_memory_allocated()
    log(f"  {label}: {secs:.3f} s ({secs / spp:.4f} s per sample), "
        f"{per_sample(counts, spp):.1f} kernel launches per sample, peak "
        f"device memory {peak / 2**30:.3f} GiB; launches "
        + str({k: v for k, v in counts.items() if v}))
    if not np.isfinite(sums).all():
        raise AssertionError(f"{label}: sums not finite")
    return secs, sums, counts, peak


def parted_pixels(label: str, got, want, path: Path) -> int:
    """Logs every pixel whose sums differ (both values; past the first 20
    into ``path``) and returns how many values lie beyond rtol 1e-5."""
    diff = np.nonzero((got != want).any(axis=1))[0]
    lines = [f"pixel {i} (x {i % DRIVER_W}, y {i // DRIVER_W}): "
             f"{got[i].tolist()} against {want[i].tolist()}" for i in diff]
    path.write_text("".join(ln + "\n" for ln in lines))
    for ln in lines[:20]:
        log(f"    {label}, {ln}")
    beyond = int((~np.isclose(got, want, rtol=1e-5, atol=0.0)).sum())
    log(f"  {label}: {diff.size} pixels differ (all in {path.name}), "
        f"{beyond} values beyond rtol 1e-5")
    return beyond


def live_counts(sc, compact: bool, env=None) -> list:
    """The live lanes before each of 6 bounces of sample 1 on the middle
    2^18-lane wavefront of the frame's Morton order."""
    import torch

    from path_tracer_torch.models.integrator import (
        IntegratorSpec,
        render_wavefront,
    )
    from path_tracer_torch.ops.sorting import morton_pixel_order

    pix = morton_pixel_order(DRIVER_W, DRIVER_H)[3 * WAVE:4 * WAVE].copy()
    restore = with_env(env or {})
    try:
        _, live = render_wavefront(
            sc, torch.from_numpy(pix).to(sc.device), DRIVER_W, DRIVER_H, 1,
            IntegratorSpec(bounces=5, compact=compact),
            collect_live_counts=True)
    finally:
        restore()
    return live.tolist()


def phase_spw_compact(tex, showcase, tex_run=None) -> dict:
    """7a and 7b (see the module docstring). ``tex_run``: phase 4's
    SPW_SPP-spp run of the textured showcase, (seconds, sums, counts, peak
    device bytes), taken as the spw 1 run. Returns the numbers."""
    log(f"phase 7a: samples per wavefront on the textured showcase, "
        f"{DRIVER_W}x{DRIVER_H}, 5 bounces, {SPW_SPP} spp")
    out = {"spw": {}}
    if tex_run is not None:
        secs, base, counts, peak = tex_run
        log(f"  spw 1: phase 4's run, {secs:.3f} s ({secs / SPW_SPP:.4f} s "
            f"per sample), {per_sample(counts, SPW_SPP):.1f} kernel launches "
            f"per sample, peak device memory {peak / 2**30:.3f} GiB")
        out["spw"][1] = (secs / SPW_SPP, per_sample(counts, SPW_SPP), peak)
    else:
        secs, base, counts, peak = driver_render("spw 1", tex, SPW_SPP)
        out["spw"][1] = (secs / SPW_SPP, per_sample(counts, SPW_SPP), peak)
    for spw in (2, 4):
        secs, sums, counts, peak = driver_render(f"spw {spw}", tex, SPW_SPP,
                                                 spw=spw)
        near = np.isclose(sums, base, rtol=2e-5, atol=2e-6)
        rel = np.abs(sums - base) / np.maximum(np.abs(base), 1e-30)
        log(f"  spw {spw} against spw 1: values beyond rtol 2e-5 / atol 2e-6 "
            f"{int((~near).sum())} of {near.size}; max abs "
            f"{np.abs(sums - base).max():.3e}, max rel {rel.max():.3e}")
        if not near.all() or not counts["alpha_walk"]:
            raise AssertionError(f"spw {spw}: packed and unpacked differ")
        out["spw"][spw] = (secs / SPW_SPP, per_sample(counts, SPW_SPP), peak)

    for name, sc, env in (("textured showcase", tex, None),
                          ("plain showcase under PT_BVH_KERNEL=tree",
                           showcase, {"PT_BVH_KERNEL": "tree"})):
        log(f"phase 7b: live-ray compaction on the {name}, {DRIVER_W}x"
            f"{DRIVER_H}, 5 bounces, {COMPACT_SPP} spp")
        runs = {c: driver_render("compacted" if c else "not compacted", sc,
                                 COMPACT_SPP, env, compact=c)
                for c in (False, True)}
        lives = {c: live_counts(sc, c, env) for c in (False, True)}
        log(f"  live lanes before each bounce, the middle wavefront: "
            f"{lives[False]} (compacted {lives[True]})")
        if lives[False] != lives[True]:
            raise AssertionError(f"{name}: live counts differ")
        tag = "tree" if env else "flat"
        beyond = parted_pixels(f"{name}, compacted against not", runs[True][1],
                               runs[False][1], OUT / f"compact_{tag}.txt")
        key = "tree_closest_hit" if env else "alpha_walk"
        if beyond or not runs[True][2][key]:
            raise AssertionError(f"{name}: compaction changed the image")
        out[tag] = {c: (r[0] / COMPACT_SPP, per_sample(r[2], COMPACT_SPP),
                        r[3]) for c, r in runs.items()}
        out[tag]["live"] = lives[False]
    return out


def cli_main(*argv) -> int:
    """The CLI's exit code for argv (0 when it returns)."""
    from path_tracer_torch import cli

    try:
        cli.main(list(argv))
    except SystemExit as e:
        return int(e.code)
    return 0


def profile_file(path: Path, spp: int, w: int = 0, h: int = 0) -> Path:
    """A profile of phase 7's frame (or w x h), 5 bounces, spp samples."""
    path.write_text(f"resolution: {{width: {w or DRIVER_W}, height: "
                    f"{h or DRIVER_H}}}\nsamples: {spp}\nbounces: 5\n")
    return path


def phase_checkpoint_aov(device, tex, tex_path: Path, straight=None) -> dict:
    """7c and 7d (see the module docstring). ``straight``: phase 4's
    4-spp CLI PNG of the same frame, else rendered here. Returns the
    numbers."""
    import dataclasses
    import os

    import torch

    from path_tracer_torch.config import Resolution
    from path_tracer_torch.models.debug_aov import AOV_NAMES, compute_aovs
    from path_tracer_torch.utils import checkpoint
    from path_tracer_torch.utils.image_io import read_png

    log(f"phase 7c: the CLI with --checkpoint on the textured showcase, "
        f"{DRIVER_W}x{DRIVER_H}, 5 bounces: 2 spp, then 4 spp resumed at "
        "sample 3")
    work = REPO / "build" / "chip_smoke_driver"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    scene = str(tex_path)
    ckpt = work / "render.ckpt"
    p2, p4 = (profile_file(work / f"p{n}.yaml", n) for n in (2, 4))
    out = {}
    if straight is None:
        straight = work / "straight.png"
        t0 = time.perf_counter()
        if cli_main("render", scene, "-o", str(straight), "-q", "-p",
                    str(p4), "--device", "cuda"):
            raise AssertionError("the straight CLI render failed")
        log(f"  straight 4-spp CLI render: {time.perf_counter() - t0:.3f} s")
    runs = []
    for label, prof, png in (("2 spp", p2, work / "half.png"),
                             ("4 spp, resumed", p4, work / "resumed.png")):
        reset_launch_counts()
        t0 = time.perf_counter()
        rc = cli_main("render", scene, "-o", str(png), "-q", "-p", str(prof),
                      "--checkpoint", str(ckpt), "--checkpoint-every", "2",
                      "--device", "cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        with np.load(ckpt) as z:
            done = int(z["samples_done"])
        counts = launch_counts()
        runs.append(counts["flat_closest_hit"])
        log(f"  {label}: exit {rc}, {secs:.3f} s (load included), the "
            f"checkpoint holds {done} samples, flat closest-hit launches "
            f"{counts['flat_closest_hit']}")
        if rc or done != (2 if png.name == "half.png" else 4):
            raise AssertionError(f"checkpointed CLI render, {label}")
    same = np.array_equal(read_png(work / "resumed.png"), read_png(straight))
    log(f"  resumed PNG equal to the straight 4-spp CLI render: {same}; the "
        f"resumed run's launches {runs[1]} (the 2-spp run's {runs[0]})")
    if not same or runs[1] != runs[0]:
        raise AssertionError("the resumed render is not the straight one")
    p_other = profile_file(work / "other.yaml", 4, DRIVER_W // 2,
                           DRIVER_H // 2)
    rc = cli_main("render", scene, "-o", str(work / "x.png"), "-q", "-p",
                  str(p_other), "--checkpoint", str(ckpt), "--device",
                  "cuda")
    log(f"  a profile of half the resolution against the checkpoint: exit "
        f"{rc}")
    if rc != 2 or (work / "x.png").exists():
        raise AssertionError("a mismatched checkpoint did not exit 2")
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        checkpoint.fingerprint(DRIVER_W, DRIVER_H, 5, 0, tex)
        times.append(time.perf_counter() - t0)
    hashed = sum(getattr(tex, f.name).numel()
                 * getattr(tex, f.name).element_size()
                 for f in dataclasses.fields(tex)
                 if isinstance(getattr(tex, f.name), torch.Tensor)
                 and not f.name.startswith(checkpoint._DERIVED_PREFIXES)
                 and f.name not in checkpoint._DERIVED)
    log(f"  fingerprint of the textured showcase: "
        + ", ".join(f"{t:.3f}" for t in times)
        + f" s ({hashed / 2**20:.1f} MiB of input tensors hashed)")
    out["fingerprint_s"] = times

    log(f"phase 7d: --debug-textures through the CLI ({DRIVER_W}x"
        f"{DRIVER_H}), and "
        f"compute_aovs at {AOV_CPU_W}x{AOV_CPU_H} on the card against the "
        "CPU port")
    aov_dir = OUT / "aov"
    aov_dir.mkdir(parents=True, exist_ok=True)
    cwd = os.getcwd()
    t0 = time.perf_counter()
    try:
        os.chdir(aov_dir)
        rc = cli_main("render", scene, "-o", str(work / "y.png"), "-q", "-p",
                      str(p2), "--debug-textures", "--device", "cuda")
    finally:
        os.chdir(cwd)
    shapes = {k: read_png(aov_dir / f"{k}.png").shape for k in AOV_NAMES}
    want_shape = (DRIVER_H, DRIVER_W, 3)
    log(f"  exit {rc} in {time.perf_counter() - t0:.3f} s (load included): "
        + ", ".join(f"{k} {v}" for k, v in shapes.items()))
    if rc or any(v != want_shape for v in shapes.values()) \
            or (work / "y.png").exists():
        raise AssertionError("--debug-textures did not write seven PNGs")
    cpu = dataclasses.replace(tex, **{
        f.name: getattr(tex, f.name).cpu() for f in dataclasses.fields(tex)
        if isinstance(getattr(tex, f.name), torch.Tensor)})
    res = Resolution(AOV_CPU_W, AOV_CPU_H)
    card, host = compute_aovs(tex, res), compute_aovs(cpu, res)
    within = {k: float(np.isclose(card[k], host[k], rtol=1e-3,
                                  atol=1e-4).mean()) for k in AOV_NAMES}
    log("  values within rtol 1e-3 / atol 1e-4 of the CPU port (>= "
        f"{MIN_PIXELS_WITHIN}): "
        + ", ".join(f"{k} {v:.5f}" for k, v in within.items()))
    if min(within.values()) < MIN_PIXELS_WITHIN \
            or not all(np.isfinite(v).all() for v in card.values()):
        raise AssertionError("AOVs on the card and the CPU disagree")
    shutil.rmtree(work)
    return out


def phase_viewer_trace(device, tex, tex_path: Path) -> dict:
    """7e and 7f (see the module docstring). Returns the numbers."""
    import json as json_
    import re
    import threading
    import urllib.request

    import torch

    from path_tracer_torch.cli import TRACE_FILE
    from path_tracer_torch.config import Profile, Resolution
    from path_tracer_torch.models.renderer import render
    from path_tracer_torch.utils.image_io import read_png
    from path_tracer_torch.viewer import ProgressiveViewer

    log(f"phase 7e: the progressive viewer over loopback during a 3-spp "
        f"render of the textured showcase, {DRIVER_W}x{DRIVER_H}, 5 bounces, "
        "one sample a pass")
    get = lambda url: urllib.request.urlopen(url, timeout=30).read()
    prof = lambda n: Profile(resolution=Resolution(DRIVER_W, DRIVER_H),
                             bounces=5, samples=n, samples_per_launch=1)
    out = {}

    def watched(viewer, stop_after=None):
        """The viewer's update, reading /status after each pass (and
        sending /stop from another thread after pass stop_after)."""
        update, seen, spent = viewer.update, [], []

        def wrapped(image, samples_done=0, samples_total=0, rays_done=0):
            t0 = time.perf_counter()
            update(image, samples_done, samples_total, rays_done)
            seen.append(json_.loads(get(viewer.url + "status"))[
                "samples_done"])
            if samples_done == stop_after:
                t = threading.Thread(target=get, args=(viewer.url + "stop",))
                t.start()
                t.join()
            spent.append(time.perf_counter() - t0)

        viewer.update = wrapped
        return seen, spent

    viewer = ProgressiveViewer(port=0)
    try:
        seen, spent = watched(viewer)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = render(tex, prof(3), viewer=viewer)
        secs = time.perf_counter() - t0
        same = np.array_equal(read_png(get(viewer.url + "frame.png")), img)
    finally:
        viewer.close()
    log(f"  /status after each pass: {seen}; the last /frame.png equal to "
        f"the returned image: {same}; {secs:.3f} s, of it "
        + ", ".join(f"{x:.3f}" for x in spent)
        + " s in the viewer's update (PNG encoding and /status)")
    if seen != [1, 2, 3] or not same:
        raise AssertionError("the viewer's frames or status are wrong")
    viewer = ProgressiveViewer(port=0)
    try:
        seen, _ = watched(viewer, stop_after=1)
        img = render(tex, prof(3), viewer=viewer)
        stopped = viewer.stop_requested
    finally:
        viewer.close()
    t0 = time.perf_counter()
    one = render(tex, prof(1))
    secs1 = time.perf_counter() - t0
    same = np.array_equal(img, one)
    log(f"  /stop after pass 1: passes {seen}, stop requested {stopped}, "
        f"the image equal to a 1-spp render: {same} (that render "
        f"{secs1:.3f} s without a viewer)")
    if seen != [1] or not (stopped and same):
        raise AssertionError("the viewer's stop was not honoured")
    out["viewer_s"] = (secs, spent, secs1)

    log(f"phase 7f: a 1-spp CLI render of the textured showcase at {TRACE_W}x"
        f"{TRACE_H} (one wavefront), 5 bounces, with --profile-trace")
    work = REPO / "build" / "chip_smoke_trace"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    p1 = profile_file(work / "p1.yaml", 1, TRACE_W, TRACE_H)
    reset_launch_counts()
    t0 = time.perf_counter()
    rc = cli_main("render", str(tex_path), "-o", str(work / "t.png"), "-q",
                  "-p", str(p1), "--profile-trace", str(work / "trace"),
                  "--device", "cuda")
    secs = time.perf_counter() - t0
    counts = launch_counts()
    trace = work / "trace" / TRACE_FILE
    size = trace.stat().st_size if trace.exists() else 0
    events = json_.loads(trace.read_text())["traceEvents"] if size else []
    named = {}
    for e in events:
        if e.get("cat") == "kernel":
            m = re.search(r"(\w+_kernel)\b", e.get("name", ""))
            if m:
                named[m.group(1)] = named.get(m.group(1), 0) + 1
    ran = {KERNEL_OF_COUNT[k]: n for k, n in counts.items() if n}
    log(f"  exit {rc} in {secs:.3f} s (load and trace export included), "
        f"trace {size} bytes, {len(events)} events; hand-written kernels "
        f"launched {ran}, in the trace "
        + str({k: named.get(k, 0) for k in ran}))
    if rc or not ran or not all(named.get(k) for k in ran):
        raise AssertionError("the trace does not name the kernels that ran")
    out["trace"] = (secs, size, len(events))
    shutil.rmtree(work)
    return out


def kernel_name(mangled: str) -> str:
    """The kernel's identifier in an Itanium-mangled name (the last
    length-prefixed identifier ending in "kernel"), with its raw template
    arguments, e.g. mt_closest_hit_kernel<Lb1E>."""
    i, name = 0, mangled
    while i < len(mangled):
        j = i
        while j < len(mangled) and mangled[j].isdigit():
            j += 1
        if j == i:
            i += 1
            continue
        k = j + int(mangled[i:j])
        if mangled[j:k].endswith("kernel"):
            name = mangled[j:k]
            if mangled[k:k + 1] == "I":
                name += "<" + mangled[k + 1:mangled.index("E", k) + 1] + ">"
        i = k
    return name


def ptxas_report(build_log: str) -> list:
    """[(kernel, "registers, smem | spills")] from nvcc's -Xptxas -v output:
    each entry function's name (the identifier before its parameters) with
    the lines ptxas prints after it."""
    import re

    out = []
    for ln in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            out.append([kernel_name(m.group(1)), []])
        elif out and ("registers" in ln or "spill" in ln):
            out[-1][1].append(ln.split(":", 1)[-1].strip())
    return [(n, " | ".join(r)) for n, r in out]


# Phase 8: the wide shading rows, convert without Pillow, the examples.
FRAME_W, FRAME_H = 1920, 1080  # the frame of phases 8a and 8b
ROWS_TEX_SPP, ROWS_BIG_SPP = 1, 1  # 8a's samples a render: textured, scene A
EXAMPLE_STEPS = 10  # steps of torch_inverse_rendering.py in 8c
FIXTURES = REPO / "tests" / "fixtures" / "torch_images"


def hand_launches() -> int:
    """The hand-written kernels' launches since the counts were reset."""
    return sum(launch_counts().values())


def profiled_sample(sc, spec, sample: int) -> tuple:
    """(device ms, launches on the card, hand-written launches) of one
    FRAME_W x FRAME_H sample under ``torch.profiler`` (CUDA activity
    alone)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from path_tracer_torch.models.renderer import render_pixel_sums

    torch.cuda.synchronize()
    reset_launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        render_pixel_sums(sc, FRAME_W, FRAME_H, sample, 1, spec,
                          tile_rays=WAVE)
        torch.cuda.synchronize()
    events = device_events(prof)
    return sum(ms for _, ms in events), len(events), hand_launches()


@contextlib.contextmanager
def table_route():
    """Forward renders inside read the per-model tables, the route the
    differentiable path takes: ``integrator._uses_rows`` answers False."""
    from path_tracer_torch.models import integrator

    uses_rows = integrator._uses_rows
    integrator._uses_rows = lambda scene, spec: False
    try:
        yield
    finally:
        integrator._uses_rows = uses_rows


def rows_against_tables(label: str, sc, spp: int) -> dict:
    """One scene's 8a: FRAME_W x FRAME_H, 5 bounces, ``spp`` samples
    through each route in turns (rows, tables, tables, rows), every value of the sums
    equal across routes and readings; seconds and hand-written launches a
    sample and peak device memory per reading; then one profiled sample
    of each route in the same turns: device ms, all launches and the
    others (ATen kernels and copies) a sample."""
    import torch

    from path_tracer_torch.models.integrator import IntegratorSpec, _uses_rows
    from path_tracer_torch.models.renderer import render_pixel_sums

    # The wide rows (a forward render's route) and the per-model tables.
    spec = IntegratorSpec(bounces=5)
    routes = {"rows": contextlib.nullcontext, "tables": table_route}
    if not _uses_rows(sc, spec):
        raise AssertionError(f"{label}: a forward render takes no rows")
    log(f"  {label}: sl_attr {sc.sl_attr.numel() * 4} bytes "
        f"{tuple(sc.sl_attr.shape)}, tex_wide {sc.tex_wide.numel() * 4} bytes "
        f"{tuple(sc.tex_wide.shape)}, wide_covered {sc.wide_covered}")
    order = ("rows", "tables", "tables", "rows")
    out = {k: dict(secs=[], hand=[], peak=[], dev=[], all=[], other=[])
           for k in routes}
    first = None
    for route in order:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        with routes[route]():
            sums = render_pixel_sums(sc, FRAME_W, FRAME_H, 1, spp, spec,
                                     tile_rays=WAVE)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        r = out[route]
        r["secs"].append(secs / spp)
        r["hand"].append(hand_launches() / spp)
        r["peak"].append(torch.cuda.max_memory_allocated())
        if first is None:
            first = sums
        off = int((sums != first).sum())
        log(f"    {route}: {secs / spp:.4f} s a sample, "
            f"{r['hand'][-1]:.1f} hand-written launches a sample, peak "
            f"{r['peak'][-1] / 2**30:.3f} GiB, values off the first "
            f"reading {off} of {sums.size}")
        if off or not np.isfinite(sums).all():
            raise AssertionError(f"{label}: {route} differs from the first "
                                 f"reading on {off} values")
    for route in order:
        with routes[route]():
            ms, n_all, hand = profiled_sample(sc, spec, spp + 1)
        r = out[route]
        r["dev"].append(ms)
        r["all"].append(n_all)
        r["other"].append(n_all - hand)
        log(f"    {route} (profiled sample {spp + 1}): {ms:.3f} device ms, "
            f"{n_all} launches, {hand} hand-written, {n_all - hand} others "
            "(ATen kernels, copies)")
    rows, tab = out["rows"], out["tables"]
    log(f"  {label}: rows / tables: s a sample {rows['secs']} / "
        f"{tab['secs']}; hand-written launches {rows['hand']} / "
        f"{tab['hand']}; other launches {rows['other']} / {tab['other']}; "
        f"device ms {rows['dev']} / {tab['dev']}; peak GiB "
        f"{[p / 2**30 for p in rows['peak']]} / "
        f"{[p / 2**30 for p in tab['peak']]}; all launches a sample "
        f"{np.mean(rows['all']) / np.mean(tab['all']):.4f}x")
    return out


def phase_wide_rows(tex, big) -> dict:
    """8a: the wide rows against the tables on the textured showcase and
    scene A."""
    log("phase 8a: wide shading rows (sl_attr, tex_wide) against the "
        "per-model tables")
    return {"textured showcase": rows_against_tables(
                "textured showcase", tex, ROWS_TEX_SPP),
            "scene A": rows_against_tables("scene A", big, ROWS_BIG_SPP)}


def phase_convert(device, oracle: bool) -> None:
    """8b: the glTF converter where Pillow is not installed: the port's
    glb generator, ``path-tracer-torch convert``, a FRAME_W x FRAME_H
    CLI render of the converted scene through the flat and walk kernels; the no-camera
    file exits 2; the fixtures' JPEGs and PNGs decode to the texels
    Pillow gave; with ``oracle`` the three glb oracle cases."""
    import importlib.util

    import torch

    from path_tracer_torch import cli
    from path_tracer_torch.utils.image_io import decode_image_rgba, read_png

    log(f"phase 8b: convert (PIL importable: "
        f"{importlib.util.find_spec('PIL') is not None})")
    OUT.mkdir(parents=True, exist_ok=True)
    scenes = {}
    for tag, multi in (("glb_converted", False), ("glb_multi_opacity", True)):
        out = REPO / "build" / f"chip_smoke_{tag}"
        shutil.rmtree(out, ignore_errors=True)
        info = convert_glb(out, multi)
        doc = json.loads((out / "scene.isf").read_text())
        textures = sorted({ch["texture"] for m in doc["models"]
                           for ch in m["material"].values()
                           if isinstance(ch, dict) and ch.get("texture")})
        log(f"  {tag}: {info['triangles']} triangles converted in "
            f"{info['seconds']:.3f} s: {len(doc['models'])} models, "
            f"textures {textures}, files {info['files']}")
        if len(doc["models"]) != (4 if multi else 2) or not all(
                (out / t).exists() for t in textures):
            raise AssertionError(f"{tag}: the converted scene is incomplete")
        scenes[tag] = out / "scene.isf"
    prof = REPO / "build" / "chip_smoke_profiles" / "glb.yaml"
    prof.parent.mkdir(parents=True, exist_ok=True)
    prof.write_text(f"resolution: {{width: {FRAME_W}, height: {FRAME_H}}}"
                    "\nsamples: 1\nbounces: 4\n")
    png = OUT / "glb_converted_cli.png"
    reset_launch_counts()
    t0 = time.perf_counter()
    cli.main(["render", str(scenes["glb_converted"]), "-o", str(png), "-q",
              "-p", str(prof), "--device", "cuda"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = launch_counts()
    img = read_png(png)
    log(f"  converted glb through the CLI ({FRAME_W}x{FRAME_H}, 1 spp, 4 "
        f"bounces, load included): {secs:.3f} s, launches "
        f"{ {k: v for k, v in counts.items() if v} }, image mean "
        f"{img.mean():.2f} std {img.std():.2f}")
    if not (img.std() > 0 and all(counts[k] for k in (
            "flat_closest_hit", "flat_occluded", "alpha_walk",
            "trans_walk"))):
        raise AssertionError(f"converted glb render: {counts}")
    nocam = REPO / "build" / "chip_smoke_nocam.gltf"
    nocam.write_text(json.dumps({"asset": {"version": "2.0"}, "scene": 0,
                                 "scenes": [{"nodes": []}], "nodes": []}))
    proc = subprocess.run(
        [sys.executable, "-m", "path_tracer_torch.cli", "convert",
         str(nocam), str(REPO / "build" / "chip_smoke_nocam_out")],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    log(f"  no-camera file: exit {proc.returncode}, stderr "
        f"{proc.stderr.strip()!r}")
    if proc.returncode != 2 or "No camera" not in proc.stderr:
        raise AssertionError("convert of a file without a camera must exit 2")
    n_images = 0
    for src in sorted(FIXTURES.iterdir()):
        if src.name.endswith(".pillow.png"):
            continue
        want = read_png(src.with_name(src.name + ".pillow.png"))
        got = decode_image_rgba(src.read_bytes(), src.name)
        off = (int(np.abs(got.astype(np.int64) - want).max())
               if got.shape == want.shape else None)
        log(f"  {src.name}: {got.shape[1]}x{got.shape[0]}, largest texel "
            f"difference from Pillow's decode {off}")
        if off != 0:
            raise AssertionError(f"{src.name}: decode differs from Pillow's")
        n_images += 1
    if n_images < 2:
        raise AssertionError("no image fixtures found")
    phase_jpeg_kinds()
    phase_pillow_formats()
    if oracle:
        phase_oracle(device, GLB_CASES)


# The fixtures of the JPEG kinds beyond baseline and progressive Huffman.
JPEG_KINDS = ("arith_420_restart.jpg", "arith_prog_422.jpg", "cmyk_q75.jpg",
              "ll_gray_p7.jpg", "ll_rgb_p4_restart.jpg", "rgb_411_q75.jpg",
              "ycck_q75.jpg")


def rendered_equal(label: str, scenes: dict, want_rows=()) -> None:
    """Render each of ``scenes`` ({tag: scene file}) at FRAME_W x FRAME_H,
    1 spp, 4 bounces through the CLI, log seconds and hand-written
    launches, and require the PNGs byte-equal and ``want_rows`` launched
    in each."""
    from path_tracer_torch.utils.image_io import read_png

    pngs = {}
    for tag, path in scenes.items():
        png = OUT / f"{tag}_cli.png"
        secs, counts = cli_frame(path, png, {}, FRAME_W, FRAME_H, 4)
        img = read_png(png)
        log(f"  {tag} through the CLI ({FRAME_W}x{FRAME_H}, 1 spp, 4 "
            f"bounces, load included): {secs:.3f} s, hand-written launches "
            f"{ {k: v for k, v in counts.items() if v} }, image mean "
            f"{img.mean():.2f} std {img.std():.2f}")
        if not (img.std() > 0 and all(counts[k] for k in want_rows)):
            raise AssertionError(f"{tag}: render {counts}")
        pngs[tag] = png.read_bytes()
    same = len(set(pngs.values())) == 1
    log(f"  {label}: renders byte-equal {same}")
    if not same:
        raise AssertionError(f"{label}: the renders differ")


def phase_jpeg_kinds() -> None:
    """8b's JPEG kinds: the port's decoder's seconds per megapixel by kind
    on this host (tests/tools/torch_jpeg_timing.py); the glb generator's
    file with the JPEG_KINDS fixtures as its textures, converted and
    rendered at FRAME_W x FRAME_H through the CLI, against the same glb
    with Pillow's decodes (``.pillow.png``) in their place: converted PNGs
    and renders byte-equal, rows 9, 10, 13 and 14 launched; tests/scenes/
    head with its albedo as a lossless JPEG of the same texels, rendered
    against the PNG one, byte-equal."""
    timing = tool("torch_jpeg_timing")
    t0 = time.perf_counter()
    head = timing.head_lossless()
    log(f"  the head's 1024x1024 albedo written as a lossless JPEG "
        f"({len(head[0])} bytes) in {time.perf_counter() - t0:.2f} s")
    for r in timing.time_decoders(repeats=3, head=head):
        log(f"  decode {r['kind']}, {r['file']} ({r['pixels']} px): "
            f"{r['seconds']:.6f} s, {r['s_per_mp']:.3f} s per megapixel "
            "(the card's host)")
    kinds = [FIXTURES / n for n in JPEG_KINDS]
    outs = {}
    for tag, files in (("glb_jpeg_kinds", kinds), ("glb_jpeg_kinds_pillow", [
            p.with_name(p.name + ".pillow.png") for p in kinds])):
        out = REPO / "build" / f"chip_smoke_{tag}"
        shutil.rmtree(out, ignore_errors=True)
        info = convert_glb(out, False, [p.read_bytes() for p in files])
        log(f"  {tag}: {info['triangles']} triangles converted in "
            f"{info['seconds']:.3f} s, files {info['files']}")
        outs[tag] = out
    a, b = outs["glb_jpeg_kinds"], outs["glb_jpeg_kinds_pillow"]
    names = sorted(p.name for p in a.iterdir() if p.suffix in (".png",
                                                               ".isf"))
    equal = (names == sorted(p.name for p in b.iterdir()
                             if p.suffix in (".png", ".isf"))
             and all((a / n).read_bytes() == (b / n).read_bytes()
                     for n in names))
    n_albedo = sum(n.startswith("albedo_tex_") for n in names)
    log(f"  converted files {names}: byte-equal to the Pillow-decoded "
        f"glb's {equal}")
    if not equal or n_albedo != len(kinds):
        raise AssertionError("the glb of JPEG kinds converts differently")
    rendered_equal("the glb of JPEG kinds against its Pillow-decoded twin",
                   {t: o / "scene.isf" for t, o in outs.items()},
                   ("flat_closest_hit", "flat_occluded", "alpha_walk",
                    "trans_walk"))
    scenes = {}
    for tag in ("head_png", "head_lossless_jpeg"):
        out = REPO / "build" / f"chip_smoke_{tag}"
        shutil.rmtree(out, ignore_errors=True)
        shutil.copytree(scene_path("head").parent, out)
        scenes[tag] = out / "scene.isf"
    ll = scenes["head_lossless_jpeg"].parent
    (ll / "albedo_tex_0.jpg").write_bytes(head[0])
    (ll / "albedo_tex_0.png").unlink()
    isf = ll / "scene.isf"
    text = isf.read_text()
    if text.count('"albedo_tex_0.png"') < 1:
        raise AssertionError("the head scene names no albedo_tex_0.png")
    isf.write_text(text.replace('"albedo_tex_0.png"', '"albedo_tex_0.jpg"'))
    rendered_equal("head, lossless JPEG albedo against the PNG", scenes)


# The writers 8b re-saves head's textures with where Pillow imports
# (tests/tools/torch_image_formats.py).
PILLOW_WRITERS = ("bmp", "tiff_lzw", "webp_lossless")


def phase_pillow_formats() -> None:
    """8b's textures in formats other than PNG and JPEG, which the port
    reads through Pillow as the JAX package's loaders do: whether Pillow
    imports on this host (asked of a child process); if it does,
    tests/scenes/head with its textures re-saved by PILLOW_WRITERS
    (tests/tools/torch_image_formats.py, a child process) rendered at
    FRAME_W x FRAME_H through the CLI, byte-equal to the PNG scene; if it
    does not, ``load_texture_rgb`` of a BMP raising ``ValueError`` that
    names the file and the need for Pillow."""
    import struct

    from path_tracer_torch.utils.image_io import load_texture_rgb

    probe = subprocess.run(
        [sys.executable, "-c", "import PIL; print(PIL.__version__)"],
        capture_output=True, text=True, timeout=120)
    pillow = probe.returncode == 0
    log(f"  Pillow imports on the card's host: {pillow}"
        + (f" (Pillow {probe.stdout.strip()})" if pillow else ""))
    out = REPO / "build" / "chip_smoke_head_formats"
    shutil.rmtree(out, ignore_errors=True)
    try:
        if pillow:
            t0 = time.perf_counter()
            subprocess.run(
                [sys.executable, str(REPO / "tests" / "tools"
                                     / "torch_image_formats.py"),
                 str(scene_path("head").parent), str(out), *PILLOW_WRITERS],
                check=True, capture_output=True, text=True, timeout=600)
            log(f"  head's textures re-saved by {PILLOW_WRITERS} in "
                f"{time.perf_counter() - t0:.2f} s")
            shutil.copytree(scene_path("head").parent, out / "png")
            rendered_equal(
                "head, textures as BMP, LZW TIFF and lossless WebP against "
                "the PNG", {f"head_{w}": out / w / "scene.isf"
                            for w in ("png",) + PILLOW_WRITERS})
            return
        # A 1 x 1 24-bit BMP: the file header, the info header, one row.
        bmp = out / "tex.bmp"
        out.mkdir(parents=True)
        bmp.write_bytes(b"BM" + struct.pack("<IHHI", 58, 0, 0, 54)
                        + struct.pack("<IiiHHIIiiII", 40, 1, 1, 1, 24, 0, 4,
                                      2835, 2835, 0, 0) + b"\x00\x00\xff\x00")
        try:
            load_texture_rgb(bmp)
            msg = None
        except ValueError as e:
            msg = str(e)
        log(f"  a BMP texture without Pillow: {msg!r}")
        if msg is None or str(bmp) not in msg or "need Pillow" not in msg:
            raise AssertionError("a BMP without Pillow must raise naming "
                                 "the file")
    finally:
        shutil.rmtree(out, ignore_errors=True)


def run_example(name: str, argv: list) -> tuple:
    """(seconds, standard output) of examples/<name>.py's ``main(argv)``,
    run in this process (its kernels already built)."""
    import contextlib
    import importlib.util
    import io

    spec = importlib.util.spec_from_file_location(
        name, REPO / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        module.main(argv)
    return time.perf_counter() - t0, out.getvalue()


def phase_examples() -> None:
    """8c: examples/torch_render_scene.py on ``cube`` at its default size
    writes a PNG; examples/torch_inverse_rendering.py takes EXAMPLE_STEPS
    steps and its loss falls (each run through its ``main``)."""
    import re

    from path_tracer_torch.utils.image_io import read_png

    log("phase 8c: the examples on the card")
    png = OUT / "example_cube.png"
    secs, _ = run_example("torch_render_scene",
                          [str(scene_path("cube")), str(png)])
    img = read_png(png)
    log(f"  torch_render_scene.py: {secs:.2f} s, {img.shape[1]}x"
        f"{img.shape[0]} PNG, mean {img.mean():.2f}")
    if img.shape != (360, 640, 3) or not img.std() > 0:
        raise AssertionError("torch_render_scene.py wrote no image")
    secs, out = run_example("torch_inverse_rendering", [str(EXAMPLE_STEPS)])
    losses = [float(x) for x in re.findall(r"loss ([0-9.]+)", out)]
    errs = [float(x) for x in re.findall(r"max albedo err ([0-9.]+)", out)]
    log(f"  torch_inverse_rendering.py: {EXAMPLE_STEPS} steps in {secs:.2f} "
        f"s: losses {losses}, max albedo errors {errs}")
    if len(losses) < 2 or not losses[-1] < losses[0]:
        raise AssertionError("torch_inverse_rendering.py: the loss did not "
                             "fall")


# Phase 9: the multi-device paths on one card. The rows the textured
# showcase's forward render launches (9, 10, 13, 14, 4) and the training
# step's (13L, 14L), each of which every rank must launch.
PAR_ROWS = ("flat_closest_hit", "flat_occluded", "alpha_walk", "trans_walk",
            "sph_occluded")
PAR_TRAIN_ROWS = ("alpha_walk_live", "trans_walk_live")
PAR_LR = 1e-2  # 9c's step (make_train_step's default)
PAR_TIMEOUT = 300  # seconds a launched world of phase 9 may take
PAR_DIR = REPO / "build" / "chip_smoke_parallel"  # the worlds' files


def par_spec(differentiable: bool = False):
    from path_tracer_torch.models.integrator import IntegratorSpec

    return IntegratorSpec(bounces=5, differentiable=differentiable)


def par_profile():
    """Phase 9's frame: 1920x1080, 5 bounces, 1 spp, 2^18-lane tiles."""
    from path_tracer_torch.config import Profile, Resolution

    return Profile(resolution=Resolution(DRIVER_W, DRIVER_H), bounces=5,
                   samples=1, tile_rays=WAVE)


def par_sums(sc, mesh, rebalance: bool) -> np.ndarray:
    """The 1080p radiance sums of sample 1 (linear order) through
    render_sharded: the one-process driver's Morton tiles of 2^18 lanes,
    each rank its contiguous slice of every tile, every tile's sums
    gathered onto every rank."""
    import torch

    from path_tracer_torch.ops.sorting import morton_pixel_order
    from path_tracer_torch.parallel.mesh import (
        all_gather_into_tensor,
        mesh_rank,
    )
    from path_tracer_torch.parallel.render import render_sharded

    group, me, n = mesh_rank(mesh)
    n_pix = DRIVER_W * DRIVER_H
    morton = morton_pixel_order(DRIVER_W, DRIVER_H)
    n_tiles = -(-n_pix // WAVE)
    pix = np.zeros(n_tiles * WAVE, np.int32)
    pix[:n_pix] = morton
    per = WAVE // n
    rows = []
    for t in range(n_tiles):
        ids = torch.from_numpy(pix[t * WAVE + me * per:][:per]).to(sc.device)
        acc = render_sharded(sc, mesh, ids, DRIVER_W, DRIVER_H, 1, 1,
                             par_spec(), rebalance=rebalance)
        rows.append(all_gather_into_tensor(acc, group))
    rows = torch.cat(rows).cpu().numpy()[:n_pix]
    out = np.empty_like(rows)
    out[morton] = rows
    return out


def par_exchange_live(sc, mesh) -> tuple:
    """(before, after): this rank's live lanes at each bounce's exchange
    of one rebalanced sample of the middle tile's slice."""
    import torch

    from path_tracer_torch.models.integrator import render_wavefront
    from path_tracer_torch.parallel.mesh import mesh_rank
    from path_tracer_torch.parallel.render import _alive_first_all_to_all

    group, me, n = mesh_rank(mesh)
    per = WAVE // n
    ids = backward_tile(sc.device)[me * per:(me + 1) * per]
    inner = _alive_first_all_to_all(group, me, n)
    before, after = [], []

    def counted(state):
        before.append(int(state[4].sum()))
        out = inner(state)
        after.append(int(out[4].sum()))
        return out

    render_wavefront(sc, ids, DRIVER_W, DRIVER_H, 1, par_spec(),
                     exchange=counted, lane_ids=me * per + torch.arange(
                         per, dtype=torch.int32, device=sc.device))
    return before, after


def par_timed(fn):
    """(seconds, result, launch counts) of fn(), counts set to 0 before."""
    import torch

    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out, launch_counts()


def par_world(kind: str, rank: int, world: int, device) -> dict:
    """What one rank of 9a or 9b computes (the module docstring)."""
    import torch

    from path_tracer_torch.models.integrator import render_wavefront
    from path_tracer_torch.parallel import mesh as pmesh
    from path_tracer_torch.parallel.multihost import render_multihost
    from path_tracer_torch.parallel.train import get_params, make_train_step
    from path_tracer_torch.scene.showcase import showcase_device_scene
    from path_tracer_torch.utils import telemetry

    t0 = time.perf_counter()
    tex = showcase_device_scene(SHOWCASE_GRID, device,
                                sl_block=SHOWCASE_BLOCK, textured=True)
    out = {"build_s": time.perf_counter() - t0}
    mesh = pmesh.default_mesh()
    per = WAVE // world
    tile = backward_tile(device)[rank * per:(rank + 1) * per]
    # Warm-up: the process's first launches and allocations, on this
    # rank's slice of one tile.
    render_wavefront(tex, tile, DRIVER_W, DRIVER_H, 1, par_spec())
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    # Rebalancing off and on in turns (off, on, on, off); each repeat
    # must give the same sums.
    sums = {}
    for reb in (False, True, True, False):
        key = "on" if reb else "off"
        secs, got, counts = par_timed(lambda: par_sums(tex, mesh, reb))
        out.setdefault(f"{key}_s", []).append(secs)
        if key in sums:
            if not np.array_equal(got, sums[key]):
                raise AssertionError(f"{kind} rank {rank}: rebalance {key} "
                                     "differs from its repeat")
            continue
        sums[key] = got
        out[f"{key}_counts"] = json.dumps(counts)
        if rank == 0:
            np.save(PAR_DIR / f"{kind}_{key}.npy", got)
    out["peak"] = torch.cuda.max_memory_allocated(device)
    out["peak_over"] = out["peak"] - base
    out["live_before"], out["live_after"] = par_exchange_live(tex, mesh)
    if kind == "9a":
        secs, img, _ = par_timed(lambda: render_multihost(
            tex, par_profile(), mesh=mesh))
        out["multihost_s"] = secs
        out["multihost"] = img
    else:
        step = make_train_step(DRIVER_W, DRIVER_H, par_spec(True),
                               n_samples=1, lr=PAR_LR, mesh=mesh)
        params = get_params(tex)
        secs, (new, loss), counts = par_timed(lambda: step(
            params, tex, tile, torch.zeros((per, 3), device=device), 1))
        out.update(step_s=secs, loss=loss.cpu().numpy(),
                   albedo=new["mat_albedo_factor"].cpu().numpy(),
                   step_counts=json.dumps(counts),
                   reduced_bytes=4 * (1 + sum(p.numel()
                                              for p in params.values())))
    out["transports"] = json.dumps({
        ":".join(k.split(".")[1:]): v for k, v in telemetry.counters.items()
        if k.startswith("transport.")})
    return out


def par_worker(argv: list) -> int:
    """``chip_smoke.py --par-worker KIND RANK WORLD``: one rank of 9a (NCCL,
    a world of one) or 9b (gloo, two ranks sharing cuda:0), joined through
    a ``file://`` rendezvous in PAR_DIR; writes PAR_DIR/KIND_rankRANK.npz
    and leaves the group on exit."""
    import torch.distributed as dist

    kind, rank, world = argv[0], int(argv[1]), int(argv[2])
    sys.path.insert(0, str(REPO))
    from path_tracer_torch import native
    from path_tracer_torch.parallel import multihost

    native.kernels()  # built by the launching run: loaded from its cache
    device = multihost.initialize(
        "cuda:0", backend="nccl" if kind == "9a" else "gloo",
        init_method=f"file://{PAR_DIR / (kind + '.rdzv')}",
        world_size=world, rank=rank)
    try:
        out = par_world(kind, rank, world, device)
    finally:
        dist.destroy_process_group()
    np.savez(PAR_DIR / f"{kind}_rank{rank}.npz", **out)
    return 0


def par_launch(kind: str, world: int) -> list:
    """Runs the world of ``kind`` (one process a rank, each logging into
    PAR_DIR) to its end; its ranks' results. Fails, stopping the other
    ranks, as soon as a rank exits non-zero, or at PAR_TIMEOUT."""
    logs = [PAR_DIR / f"{kind}_rank{r}.log" for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, str(REPO / "chip_smoke.py"), "--par-worker",
                 kind, str(r), str(world)], cwd=REPO, stdout=f,
                stderr=subprocess.STDOUT))
    deadline = time.perf_counter() + PAR_TIMEOUT
    try:
        while any(p.poll() is None for p in procs):
            failed = [r for r, p in enumerate(procs) if p.poll()]
            if failed or time.perf_counter() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            raise AssertionError(f"{kind} rank {r} exited {p.returncode}:\n"
                                 f"{logs[r].read_text()[-4000:]}")
    return [dict(np.load(PAR_DIR / f"{kind}_rank{r}.npz"))
            for r in range(world)]


def par_check_rows(label: str, counts: dict, rows) -> None:
    missing = [k for k in rows if not counts[k]]
    if missing:
        raise AssertionError(f"{label}: rows {missing} not launched: "
                             f"{counts}")


def phase_parallel(device, tex) -> None:
    """9: the multi-device paths on one card (the module docstring)."""
    import torch

    from path_tracer_torch.models.integrator import render_wavefront
    from path_tracer_torch.models.renderer import finalize, render_pixel_sums
    from path_tracer_torch.parallel.train import (
        get_params,
        make_train_step,
        value_and_grad,
    )

    card = smi()
    note = f"{card}; not a scaling figure: both ranks share one card"
    log(f"phase 9: multi-device paths on one card, textured showcase, "
        f"{DRIVER_W}x{DRIVER_H}, 5 bounces, 1 spp, {WAVE}-lane tiles")
    shutil.rmtree(PAR_DIR, ignore_errors=True)
    PAR_DIR.mkdir(parents=True)
    try:
        ids = backward_tile(device)
        render_wavefront(tex, ids, DRIVER_W, DRIVER_H, 1, par_spec())
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        one_s = []
        for _ in range(2):
            secs, ref, _ = par_timed(lambda: render_pixel_sums(
                tex, DRIVER_W, DRIVER_H, 1, 1, par_spec(), tile_rays=WAVE))
            one_s.append(secs)
        peak = torch.cuda.max_memory_allocated(device) - base
        log(f"  one process: {one_s[0]:.3f}, {one_s[1]:.3f} s a 1080p "
            f"sample, peak device memory {peak} bytes over what the process "
            f"held before ({note})")
        ref_img = finalize(ref, 1, par_profile(), DRIVER_W, DRIVER_H)
        # 9c's references: the one-process step over the whole tile, and
        # over its two halves with their losses and gradients summed (the
        # association of a two-rank all_reduce).
        p0 = get_params(tex)
        zeros = torch.zeros((WAVE, 3), device=device)
        new, loss = make_train_step(DRIVER_W, DRIVER_H, par_spec(True),
                                    n_samples=1, lr=PAR_LR)(
            p0, tex, ids, zeros, 1)
        full_loss = float(loss)
        full_albedo = new["mat_albedo_factor"].cpu().numpy()
        half = WAVE // 2
        parts = [value_and_grad(p0, tex, ids[h:h + half], zeros[:half], 1,
                                DRIVER_W, DRIVER_H, par_spec(True))
                 for h in (0, half)]
        half_loss = float(parts[0][0] + parts[1][0])
        g = parts[0][1]["mat_albedo_factor"] + parts[1][1][
            "mat_albedo_factor"]
        with torch.no_grad():
            half_albedo = (p0["mat_albedo_factor"] - PAR_LR * g).cpu().numpy()
        albedo0 = p0["mat_albedo_factor"].cpu().numpy()

        results = {}
        for kind, world in (("9a", 1), ("9b", 2)):
            t0 = time.perf_counter()
            ranks = par_launch(kind, world)
            results[kind] = ranks
            what = ("one NCCL rank on cuda:0" if kind == "9a"
                    else "two gloo ranks sharing cuda:0")
            log(f"  {kind} ({what}): the world ran in "
                f"{time.perf_counter() - t0:.1f} s")
            for key in ("off", "on"):
                got = np.load(PAR_DIR / f"{kind}_{key}.npy")
                n_off = int((got != ref).any(axis=1).sum())
                log(f"    rebalance {key}: pixels off the one-process sums "
                    f"{n_off} of {ref.shape[0]}")
                if n_off:
                    raise AssertionError(f"{kind} rebalance {key}: not "
                                         "bit-equal to one process")
            for r, z in enumerate(ranks):
                counts = {k: json.loads(str(z[f"{k}_counts"]))
                          for k in ("off", "on")}
                log(f"    rank {r}: s a 1080p sample in turns, rebalance off "
                    f"{z['off_s'][0]:.3f}, on {z['on_s'][0]:.3f}, on "
                    f"{z['on_s'][1]:.3f}, off {z['off_s'][1]:.3f}; peak "
                    f"device memory {int(z['peak_over'])} bytes over the "
                    f"scene and warm-up ({int(z['peak'])} in all); scene "
                    f"built in {float(z['build_s']):.2f} s ({note})")
                log(f"    rank {r} launches (rebalance off): "
                    f"{ {k: counts['off'][k] for k in PAR_ROWS} }; "
                    f"transports {str(z['transports'])}")
                par_check_rows(f"{kind} rank {r}", counts["off"], PAR_ROWS)
                par_check_rows(f"{kind} rank {r} rebalanced", counts["on"],
                               PAR_ROWS)
            before = np.array([z["live_before"] for z in ranks])
            after = np.array([z["live_after"] for z in ranks])
            log(f"    live lanes per rank and bounce, middle tile, before "
                f"the exchange {before.tolist()}, after {after.tolist()}")
            if (before.sum(0) != after.sum(0)).any() or (np.abs(
                    after - after.mean(0)) > 1).any():
                raise AssertionError(f"{kind}: the exchange lost lanes or "
                                     "left a rank beyond +-1 of the mean")
        z = results["9a"][0]
        if not np.array_equal(z["multihost"], ref_img):
            raise AssertionError("9a: render_multihost's image is not the "
                                 "one-process image")
        log(f"  9a render_multihost: image equal to the one-process image, "
            f"{float(z['multihost_s']):.3f} s ({note})")
        for key in ("off", "on"):
            if not np.array_equal(np.load(PAR_DIR / f"9a_{key}.npy"),
                                  np.load(PAR_DIR / f"9b_{key}.npy")):
                raise AssertionError(f"9b rebalance {key}: not 9a's sums")
        b = results["9b"]
        losses = [float(z["loss"]) for z in b]
        upd = b[0]["albedo"].astype(np.float64) - albedo0
        full_upd = full_albedo.astype(np.float64) - albedo0
        rel = abs(losses[0] - full_loss) / abs(full_loss)
        upd_rel = float(np.max(np.abs(upd - full_upd))
                        / np.max(np.abs(full_upd)))
        same = (losses[0] == losses[1] == half_loss and all(
            np.array_equal(z["albedo"], half_albedo) for z in b))
        step_counts = [json.loads(str(z["step_counts"])) for z in b]
        step_rows = [{k: c[k] for k in PAR_TRAIN_ROWS} for c in step_counts]
        log(f"  9c: sharded train step over the {WAVE}-lane backward tile "
            f"split over 2 ranks (lr {PAR_LR}, {int(b[0]['reduced_bytes'])} "
            f"bytes all_reduced): losses {losses}; the one-process step over "
            f"the two halves summed {half_loss}, loss and mat_albedo_factor "
            f"equal {same}; over the whole tile {full_loss}, relative "
            f"{rel:.3e}, the update's largest difference over its largest "
            f"entry {upd_rel:.3e} (float32 sums of a gradient over 2^17 and "
            f"2^18 lanes); seconds {[float(z['step_s']) for z in b]}; "
            f"launches {step_rows} ({note})")
        if not same or rel > 1e-5:
            raise AssertionError("9c: the sharded step disagrees")
        for r, c in enumerate(step_counts):
            par_check_rows(f"9c rank {r}", c, PAR_TRAIN_ROWS)

        # 9d: torchrun with one process of the CLI against the plain CLI.
        prof = profile_file(PAR_DIR / "p.yaml", 2, 480, 270)
        plain, ranked = PAR_DIR / "plain.png", PAR_DIR / "torchrun.png"
        argv = ["render", str(scene_path("cube")), "-p", str(prof), "-q",
                "--device", "cuda", "-o"]
        if cli_main(*argv, str(plain)):
            raise AssertionError("9d: the plain CLI failed")
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "1", "-m", "path_tracer_torch.cli", *argv,
             str(ranked)], cwd=REPO, capture_output=True, text=True,
            timeout=PAR_TIMEOUT, env=dict(os.environ, PYTHONPATH=str(REPO)))
        same = ranked.exists() and ranked.read_bytes() == plain.read_bytes()
        log(f"  9d: torchrun --nproc-per-node 1 of the CLI (cube, 480x270, 2 "
            f"spp): exit {run.returncode} in {time.perf_counter() - t0:.1f} "
            f"s, PNG byte-equal to the plain CLI's {same}")
        if run.returncode or not same:
            raise AssertionError(f"9d failed:\n{run.stdout[-2000:]}\n"
                                 f"{run.stderr[-2000:]}")
    finally:
        shutil.rmtree(PAR_DIR, ignore_errors=True)


def main() -> int:
    import torch

    start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--par-worker"]:
        return par_worker(sys.argv[2:])
    sys.path.insert(0, str(REPO))
    from path_tracer_torch import native

    only = sys.argv[2] if sys.argv[1:2] == ["--only"] else None
    alone = ("3i", "3j", "3k", "3l", "3m", "3n", "3o", "3p", "3q", "3r",
             "7", "8", "9")
    if sys.argv[1:] and (len(sys.argv) != 3 or only not in alone):
        print("usage: chip_smoke.py [--only " + "|".join(alone) + "]",
              file=sys.stderr)
        return 2
    card = smi()
    device = torch.device("cuda", 0)
    cap = torch.cuda.get_device_capability(0)
    log(f"phase 1: {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | capability {cap} | "
        f"{torch.cuda.device_count()} device(s)")
    if cap != (9, 0):
        raise AssertionError(f"need an sm_90 card, got capability {cap}")

    k = native.kernels()
    log(f"phase 2: built {native.CSRC.name}/*.cu in {k.build_seconds:.2f} s")
    for name, report in ptxas_report(k.build_log):
        log(f"  {name}: {report}")

    from path_tracer_torch.scene import build_scene
    from path_tracer_torch.scene.showcase import (
        showcase_device_scene,
        showcase_scene,
    )

    t0 = time.perf_counter()
    showcase = build_scene(showcase_scene(SHOWCASE_GRID), ".", device,
                           sl_block=SHOWCASE_BLOCK)
    log(f"  showcase (grid {SHOWCASE_GRID}, {SHOWCASE_BLOCK}-slot blocks) "
        f"built in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    tex = showcase_device_scene(SHOWCASE_GRID, device,
                                sl_block=SHOWCASE_BLOCK, textured=True)
    log(f"  textured showcase built (textures written and read) in "
        f"{time.perf_counter() - t0:.2f} s; tr_kernel_ok {tex.tr_kernel_ok}")
    if not tex.tr_kernel_ok:
        raise AssertionError("textured showcase: no walk-kernel tables")
    if only == "3r":  # phase 3r alone: the segment prefilter
        print(json.dumps({"prefilter": phase_prefilter(device, tex),
                          "card": card}))
        log(f"chip_smoke: phase 3r passed in "
            f"{time.perf_counter() - start:.1f} s")
        return 0
    if only == "9":  # phase 9 alone
        phase_parallel(device, tex)
        log(f"chip_smoke: phase 9 passed in "
            f"{time.perf_counter() - start:.1f} s")
        print(card)
        return 0
    if only == "3o":  # phase 3o alone: rows 15, 3 and 15L
        log("phase 3o: rows 15 and 3 (3f's and 3g's checks and turns), then "
            "15L (6a)")
        phase_fused_shadow_kernel(device, tex)
        phase_khit(device, tex)
        phase_live_kernels(device, tex)
        log(f"chip_smoke: phase 3o passed in "
            f"{time.perf_counter() - start:.1f} s")
        print(card)
        return 0
    if only == "7":  # phase 7 alone, on the textured showcase's scene file
        from path_tracer_torch.scene.showcase import write_showcase_scene_dir

        OUT.mkdir(parents=True, exist_ok=True)
        routes_dir = REPO / "build" / "chip_smoke_showcase_tex_routes"
        tex_path = write_showcase_scene_dir(routes_dir, grid=SHOWCASE_GRID,
                                            textured=True)
        try:
            phase_spw_compact(tex, showcase)
            phase_checkpoint_aov(device, tex, tex_path)
            phase_viewer_trace(device, tex, tex_path)
        finally:
            shutil.rmtree(routes_dir, ignore_errors=True)
        log(f"chip_smoke: phase 7 passed in "
            f"{time.perf_counter() - start:.1f} s")
        print(card)
        return 0
    if only == "3i":  # phase 3i alone
        phase_redesigned(device, showcase)
        log(f"chip_smoke: phase 3i passed in "
            f"{time.perf_counter() - start:.1f} s")
        print(card)
        return 0
    from path_tracer_torch.ops.intersect import _walk_variant
    from path_tracer_torch.scene.device_scene import (
        opaque_view,
        transparent_view,
    )
    from path_tracer_torch.scene.procedural import sphere_grid_device_scene

    t0 = time.perf_counter()
    grid = sphere_grid_device_scene(SPHERE_GRID, device)
    log(f"  scene B ({grid.num_real_spheres} spheres) built in "
        f"{time.perf_counter() - t0:.2f} s")
    if not grid.sph_use_blocks:
        raise AssertionError("the sphere grid does not take the walk")
    if only in ("3m", "3q"):  # phase 3m or 3q alone
        if only == "3m":
            phase_rows_5_4(device, tex, grid)
        else:
            phase_row_6(device, grid)
        log(f"chip_smoke: phase {only} passed in "
            f"{time.perf_counter() - start:.1f} s")
        print(card)
        return 0
    t0 = time.perf_counter()
    big = showcase_device_scene(BIG_GRID, device, sl_block=SHOWCASE_BLOCK,
                                textured=True)
    walks = [_walk_variant(v(big)) for v in (opaque_view, transparent_view)]
    log(f"  textured showcase grid {BIG_GRID} built in "
        f"{time.perf_counter() - t0:.2f} s: {big.num_real_triangles} "
        f"triangles, {big.sl_n_blocks} blocks, walks (opaque, transparent) "
        f"{walks}, tr_kernel_ok {big.tr_kernel_ok}")
    if walks != ["flat2", "flat"] or not big.tr_kernel_ok:
        raise AssertionError("scene A does not route as the JAX package's")
    if only == "8":  # phase 8 alone, with the glb oracle cases
        phase_wide_rows(tex, big)
        phase_convert(device, oracle=True)
        phase_examples()
        log(f"chip_smoke: phase 8 passed in "
            f"{time.perf_counter() - start:.1f} s")
        print(card)
        return 0
    if only in ("3j", "3k", "3l", "3n", "3p"):  # one of these alone
        if only == "3p":
            phase_flat_turns(device, showcase, big)
        elif only == "3j":
            phase_rows_10_11(device, showcase, tex, big)
        elif only == "3k":
            phase_rows_13_14(device, tex, big)
        elif only == "3l":
            phase_rows_12_2(device, big)
        else:
            phase_rows_7_8(device, showcase, big)
        log(f"chip_smoke: phase {only} passed in "
            f"{time.perf_counter() - start:.1f} s")
        print(card)
        return 0
    tri_stats, sph_stats = phase_kernels(device)
    flat_stats, occ_err = phase_flat_kernels(device, showcase)
    alpha_stats, trans_stats = phase_walk_kernels(device, tex)
    flat2_stats, occ2_err = phase_flat2_kernels(device, big)
    walk_stats = phase_sph_walk_kernel(device, grid)
    times = phase_timing(device)
    flat_times = phase_flat_timing(device, showcase)
    walk_times = phase_walk_timing(device, tex)
    flat2_times = phase_flat2_timing(device, big)
    _, sph_timing_stats = phase_sph_timing(device, grid)
    log("phase 3f: sphere any-hit kernels and the fused shadow kernel at "
        "the main path's shapes")
    occ_err, _ = phase_sphere_any_hit(device, tex, "dense sphere any-hit")
    occ_walk_err, _ = phase_sphere_any_hit(device, grid,
                                           "sphere any-hit walk")
    fused_err, fused_time = phase_fused_shadow_kernel(device, tex)
    khit_err, khit_times = phase_khit(device, tex)
    tree_err, tree_occ_err = phase_tree_kernels(device, showcase, big)
    phase_redesigned(device, showcase)
    phase_rows_10_11(device, showcase, tex, big)
    phase_rows_13_14(device, tex, big)
    phase_prefilter(device, tex)
    rows_12_2 = phase_rows_12_2(device, big, design_counts=False)
    rows_5_4 = phase_rows_5_4(device, tex, grid)
    row_6 = phase_row_6(device, grid)
    rows_7_8 = phase_rows_7_8(device, showcase, big)
    launches = phase_main_path(device)
    flat_launches, flat_render = phase_showcase(device, showcase)
    walk_launches, tex_run = phase_showcase_tex(device, tex)
    big_launches = phase_big_showcase(device, big)
    grid_launches = phase_sphere_grid(device, grid)
    fused_launches = phase_fused_showcase(device, tex)
    # The textured showcase's scene file for the CLI frames of 4g, 4h and
    # 7, written under the git-ignored build/ and removed after them.
    from path_tracer_torch.scene.showcase import write_showcase_scene_dir

    routes_dir = REPO / "build" / "chip_smoke_showcase_tex_routes"
    tex_path = write_showcase_scene_dir(routes_dir, grid=SHOWCASE_GRID,
                                        textured=True)
    try:
        dense_launches = phase_dense_route(device, tex, tex_path)
        tree_launches, _ = phase_tree_route(device, showcase, flat_render,
                                            tex_path)
        phase_spw_compact(tex, showcase, tex_run)
        phase_checkpoint_aov(device, tex, tex_path,
                             straight=OUT / "showcase_tex_cli.png")
        phase_viewer_trace(device, tex, tex_path)
    finally:
        shutil.rmtree(routes_dir, ignore_errors=True)
    phase_bvh_vs_brute(device, showcase)
    phase_walks_vs_cast(device, tex)
    phase_oracle(device)
    live_stats = phase_live_kernels(device, tex)
    bwd_launches = phase_backward(device, tex)
    fused_train_launches = phase_train_steps(device, tex)
    phase_wide_rows(tex, big)
    phase_convert(device, oracle=False)  # phase 5 ran the glb cases
    phase_examples()
    phase_parallel(device, tex)

    def entry(name, source, replaces, launches, err, t):
        return {"name": name, "route": "cuda",
                "source": f"path_tracer_torch/csrc/{source}",
                "replaces": f"path_tracer_tpu/ops/{replaces}",
                "launches": launches, "max_abs_err": err, "ms": t[0],
                "plain_ms": t[1], "bound_ms": t[2], "bound_by": t[3],
                "library_ms": None}

    # Row 2 at the main path's shape on scene A: the 2^18 camera lanes of
    # the middle wavefront, merged with row 11's record in the launch.
    ms, b, _, plain_ms = rows_12_2["times"][
        "row 2 scene A camera lanes, merged"]
    row2_time = (min(ms), plain_ms) + b
    # Rows 5 and 4 at the main path's shapes: row 5 through its wrapper on
    # scene B's 2^18 camera lanes of the middle wavefront; row 4 through
    # occluded_multi's sphere half (the flat any-hit's result as prior) on
    # the textured showcase's 3 x 2^18 first-bounce shadow lanes.
    ms, b, plain_ms = rows_5_4["times"]["row 5 scene B camera lanes"]
    row5_time = (min(ms), plain_ms) + b
    ms, b, plain_ms = rows_5_4["times"][
        "row 4 through occluded_multi's sphere half"]
    row4_time = (min(ms), plain_ms) + b
    # Row 6 through its wrapper on scene B's first-bounce shadow sets of
    # the middle wavefront's 2^18 camera lanes toward both lights (3q).
    t6 = row_6["times"]["first-bounce"]
    row6_time = (min(t6["wrap"]), t6["plain_ms"]) + t6["bound"]
    # Rows 7 and 8 at the tree route's shapes on the plain showcase,
    # through their wrappers (cuda_ms, as the other rows): the 2^18 camera
    # lanes of the middle wavefront, and the first bounce's 3 x 2^18 shadow
    # lanes in one launch (the device ms a launch alone are 3n's turns).
    tree_times = {}
    for key, label in (("camera", "row 7 plain showcase camera lanes"),
                       ("occluded", "row 8 plain showcase first-bounce "
                                    "shadow sets")):
        _, b, plain_ms, _, wrap = rows_7_8["times"][label]
        tree_times[key] = (wrap, plain_ms) + b
    kernels = [
        entry("mt_closest_hit", "mt_closest_hit.cu", "pallas_intersect.py:39",
              launches["mt_closest_hit"], max(s[1] for s in tri_stats),
              times["mt"]),
        entry("sphere_closest_hit", "sphere_closest_hit.cu",
              "pallas_spheres.py:34", launches["sphere_closest_hit"],
              max([s[1] for s in sph_stats] + [rows_12_2["row2_err"]]),
              row2_time),
        entry("flat_closest_hit", "flat_closest_hit.cu", "pallas_bvh.py:549",
              flat_launches["flat_closest_hit"],
              max(s[1] for s in flat_stats), flat_times["camera"]),
        entry("flat_occluded", "flat_occluded.cu", "pallas_bvh.py:1058",
              flat_launches["flat_occluded"], occ_err,
              flat_times["occluded"]),
        entry("alpha_walk", "alpha_walk.cu", "pallas_trwalk.py:305",
              walk_launches["alpha_walk"], max(s[1] for s in alpha_stats),
              walk_times["alpha_walk"]),
        entry("trans_walk", "trans_walk.cu", "pallas_trwalk.py:600",
              walk_launches["trans_walk"], max(s[1] for s in trans_stats),
              walk_times["trans_walk"]),
        entry("flat2_closest_hit", "flat2_closest_hit.cu",
              "pallas_bvh.py:1217", big_launches["flat2_closest_hit"],
              max(s[1] for s in flat2_stats + flat2_times["stats"]),
              flat2_times["camera"]),
        entry("flat2_occluded", "flat2_occluded.cu", "pallas_bvh.py:1464",
              big_launches["flat2_occluded"],
              max(occ2_err, flat2_times["occluded err"],
                  rows_12_2["row12_err"]),
              flat2_times["occluded"]),
        entry("sph_walk", "sph_walk.cu", "pallas_spheres.py:385",
              grid_launches["sph_walk"],
              max([s[1] for s in walk_stats + sph_timing_stats]
                  + [rows_5_4["row5_err"]]), row5_time),
        entry("sph_occluded", "sph_occ.cu", "pallas_spheres.py:197",
              walk_launches["sph_occluded"], max(occ_err,
                                                 rows_5_4["row4_err"]),
              row4_time),
        entry("sph_occ_walk", "sph_occ.cu", "pallas_spheres.py:484",
              grid_launches["sph_occ_walk"], occ_walk_err, row6_time),
        entry("fused_shadow", "fused_shadow.cu", "pallas_shadow.py:49",
              fused_launches["fused_shadow"], fused_err, fused_time),
        entry("alpha_walk_live", "alpha_walk.cu", "pallas_trwalk.py:746",
              bwd_launches["alpha_walk_live"], *live_stats["alpha_walk_live"]),
        entry("trans_walk_live", "trans_walk.cu", "pallas_trwalk.py:778",
              bwd_launches["trans_walk_live"], *live_stats["trans_walk_live"]),
        entry("fused_shadow_live", "fused_shadow.cu", "pallas_shadow.py:141",
              fused_train_launches["fused_shadow_live"],
              *live_stats["fused_shadow_live"]),
        entry("k_nearest_tr_hits", "khit.cu", "pallas_intersect.py:162",
              dense_launches["k_nearest_tr_hits"], khit_err,
              khit_times["camera"]),
        entry("tree_closest_hit", "tree_walk.cu", "pallas_bvh.py:82",
              tree_launches["tree_closest_hit"],
              max(tree_err, rows_7_8["row7_err"]), tree_times["camera"]),
        entry("tree_occluded", "tree_walk.cu", "pallas_bvh.py:363",
              tree_launches["tree_occluded"],
              max(tree_occ_err, rows_7_8["row8_err"]),
              tree_times["occluded"]),
    ]
    log(f"chip_smoke: all phases passed in {time.perf_counter() - start:.1f} "
        "s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
