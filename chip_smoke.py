#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``path_tracer_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100: capability 9.0) and the CUDA toolkit; exits
non-zero without printing a result when there is no card or no port beside
this file. Phases, each printing one line of numbers and failing the run on
any error:

1. environment: card name and power limit, torch/CUDA versions, capability;
2. build: the kernels from ``path_tracer_torch/csrc`` with nvcc, timed;
3. each kernel against its plain PyTorch version on the card: the 6,024
   Möller-Trumbore fixtures, seeded random rays against the ``cube`` and
   ``reflection`` tables and a random 2,500-triangle soup, the ``spheres``
   table and a random 500-sphere table (fresh and advanced t_prev, dead
   lanes, a ray count that is no multiple of the block size); the flat
   closest hit (alone and with the fused sphere pass) and the flat any-hit
   on the 100k-triangle showcase (grid 224, 256-slot blocks) and forced-BVH
   ``reflection``, with random, camera and terrain-bounce rays, against
   their plain versions and the MT kernel; then each kernel's time beside
   its plain version's at the main path's shapes;
4. the main path at full size: ``cube``, ``spheres`` and ``reflection`` at
   1920x1080, 4 bounces, 16 spp through ``render_pixel_sums``, and one
   reference-default frame of ``reflection`` (1920x1080, 64 spp, 4
   bounces) through the CLI; then the plain showcase at 1920x1080, 5
   bounces, 16 spp (the JAX bench's scene), and one reference-default frame
   of it written to disk and rendered through the CLI. Launch counts are
   set to 0 before each path and read after it;
4b. the showcase at 480x270, 4 spp, 5 bounces through the flat walk and
   through brute-force MT over all 100,352 triangles, same seed;
5. the scalar-oracle gate: seven cases against ``tests/goldens/oracle`` at
   each golden's own size, and four of them again with the BVH forced
   (the flat kernels), with the CPU gate's statistics and tolerances.

The last lines are a JSON object of kernel numbers, the ``nvidia-smi`` card
name and power limit, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

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
}
# The triangle cases, rendered again with the BVH forced (the flat walk).
ORACLE_BVH_CASES = ("cube", "reflection", "white_furnace_direct",
                    "cube_rr_b6")


def log(msg: str) -> None:
    print(msg, flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def scene_path(name: str) -> Path:
    return REPO / "tests" / "scenes" / name / "scene.isf"


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call on the card, after one warm-up call."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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
    geometric normal (turned up, as the terrain's), as numpy arrays."""
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


def phase_flat_timing(device, showcase):
    """Flat kernel and plain-version milliseconds at the main path's
    shapes: 2^18 lanes (the middle wavefront) of showcase camera rays, of
    the first bounce's rays and of its shadow casts toward the three
    lights (L = 3); then the kernels alone on incoherent rays from random
    terrain points."""
    import torch

    from path_tracer_torch.ops import cuda_bvh

    n = 1 << 18
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
        log(f"  time flat closest hit + spheres, {n} {label} rays x "
            f"{showcase.sl_n_blocks} blocks: kernel {ms:.4f} ms, {ms2:.4f} ms "
            f"(repeat); plain {plain_ms:.4f} ms")
        out[label] = (min(ms, ms2), plain_ms)
    run = lambda: cuda_bvh.occluded_triangles_flat_multi(so, sds, stms,
                                                         showcase)
    plain = lambda: cuda_bvh.occluded_triangles_flat_multi_plain(so, sds, stms,
                                                                 showcase)
    ms, plain_ms, ms2 = cuda_ms(run, 20), cuda_ms(plain, 2), cuda_ms(run, 20)
    log(f"  time flat any-hit, {n} first-bounce shadow rays x L={len(sds)}: "
        f"kernel {ms:.4f} ms, {ms2:.4f} ms (repeat); plain {plain_ms:.4f} ms")
    out["occluded"] = (min(ms, ms2), plain_ms)

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


def phase_timing(device):
    """Kernel and plain-version milliseconds at the main path's shapes: the
    first 2^18-lane wavefront of camera rays at 1080p against reflection's
    2,048-column and spheres' 128-column tables."""
    import torch

    from path_tracer_torch.ops import cuda_intersect, cuda_spheres, intersect
    from path_tracer_torch.ops.camera import generate_rays
    from path_tracer_torch.ops.sorting import morton_pixel_order
    from path_tracer_torch.scene import load_scene

    pix = torch.from_numpy(morton_pixel_order(1920, 1080)[: 1 << 18].copy())
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
        table = (sc.tri_packed_t if key == "mt" else sc.sph_packed_t).shape
        log(f"  time {key}: {o.shape[0]} lanes x {table[1]} columns: kernel "
            f"{ms:.4f} ms, {ms2:.4f} ms (repeat); plain {plain_ms:.4f} ms")
        out[key] = (min(ms, ms2), plain_ms)
    return out


def phase_main_path(device):
    import torch

    from path_tracer_torch import cli
    from path_tracer_torch.config import Profile, Resolution
    from path_tracer_torch.models.renderer import (
        finalize,
        integrator_spec,
        render_pixel_sums,
    )
    from path_tracer_torch.ops import cuda_intersect, cuda_spheres
    from path_tracer_torch.scene import load_scene
    from path_tracer_torch.utils.image_io import save_png

    log("phase 4: main path at 1920x1080, 4 bounces, 16 spp")
    OUT.mkdir(parents=True, exist_ok=True)
    profile = Profile(resolution=Resolution(1920, 1080), bounces=4, samples=16)
    spec = integrator_spec(profile)
    scenes = {name: load_scene(scene_path(name), device)
              for name in ("cube", "spheres", "reflection")}
    torch.cuda.synchronize()
    reset_launch_counts()
    per_scene = {}
    for name, sc in scenes.items():
        before = (cuda_intersect.launches, cuda_spheres.launches)
        t0 = time.perf_counter()
        sums = render_pixel_sums(sc, 1920, 1080, 1, 16, spec,
                                 tile_rays=profile.tile_rays)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        per_scene[name] = (cuda_intersect.launches - before[0],
                           cuda_spheres.launches - before[1])
        img = finalize(sums, 16, profile, 1920, 1080)
        save_png(img, OUT / f"{name}_1080p_16spp.png")
        rays = 1920 * 1080 * 16 * 5
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

    # One reference-default frame (Profile(): 1920x1080, 64 spp, 4 bounces)
    # through the command line, on a scene loaded anew by the CLI.
    png = OUT / "reflection_default.png"
    t0 = time.perf_counter()
    cli.main(["render", str(scene_path("reflection")), "-o", str(png), "-q",
              "--device", "cuda"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    rays = 1920 * 1080 * 64 * 5
    log(f"  reflection reference-default frame via the CLI (64 spp, load "
        f"included): {secs:.3f} s, {rays / secs / 1e6:.2f} Mray/s, "
        f"png {png.stat().st_size} bytes")
    return launches


def launch_counts() -> dict:
    from path_tracer_torch.ops import cuda_bvh, cuda_intersect, cuda_spheres

    return {"mt_closest_hit": cuda_intersect.launches,
            "sphere_closest_hit": cuda_spheres.launches,
            "flat_closest_hit": cuda_bvh.closest_hit_launches,
            "flat_occluded": cuda_bvh.occluded_launches}


def reset_launch_counts() -> None:
    from path_tracer_torch.ops import cuda_bvh, cuda_intersect, cuda_spheres

    cuda_intersect.launches = cuda_spheres.launches = 0
    cuda_bvh.closest_hit_launches = cuda_bvh.occluded_launches = 0


def phase_showcase(device, showcase):
    """The main path of the BVH slice: the plain showcase at 1080p, 5
    bounces, 16 spp, then one reference-default frame of it written to
    disk and rendered through the CLI. Returns the launch counts of the
    16-spp run."""
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

    w, h, spp, bounces = 1920, 1080, 16, 5
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
    secs = time.perf_counter() - t0
    counts = launch_counts()
    img = finalize(sums, spp, profile, w, h)
    save_png(img, OUT / "showcase_1080p_16spp_b5.png")
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
    cli.main(["render", str(path), "-o", str(png), "-q", "--device", "cuda"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    cli_counts = launch_counts()
    size = path.stat().st_size
    shutil.rmtree(scene_dir)
    rays = 1920 * 1080 * 64 * 5
    log(f"  showcase reference-default frame via the CLI (1920x1080, 64 spp, "
        f"4 bounces, {size} bytes of scene.isf loaded and "
        f"built in the timing, 512-slot blocks): {secs:.3f} s, "
        f"{rays / secs / 1e6:.2f} Mray/s, launches {cli_counts}, png "
        f"{png.stat().st_size} bytes")
    if not cli_counts["flat_closest_hit"] or cli_counts["mt_closest_hit"]:
        raise AssertionError(f"CLI frame did not take the flat kernels: "
                             f"{cli_counts}")
    return counts


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


def phase_oracle(device):
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

    log("phase 5: oracle gate (tests/goldens/oracle) on the card")
    failed = []
    runs = [(c, False) for c in ORACLE_CASES] + [(c, True)
                                                 for c in ORACLE_BVH_CASES]
    for case, bvh in runs:
        tol, energy_rtol = ORACLE_CASES[case]
        z = np.load(REPO / "tests" / "goldens" / "oracle" / f"{case}.npz")
        oracle = z["radiance"].astype(np.float64)
        w, h, spp, b = (int(z[k]) for k in ("width", "height", "spp", "bounces"))
        sc = load_scene(REPO / str(z["scene"]), device, use_bvh=bvh)
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from path_tracer_torch import native

    card = smi()
    device = torch.device("cuda", 0)
    cap = torch.cuda.get_device_capability(0)
    log(f"phase 1: {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | capability {cap} | "
        f"{torch.cuda.device_count()} device(s)")
    if cap != (9, 0):
        raise AssertionError(f"need an sm_90 card, got capability {cap}")

    k = native.kernels()
    regs = [ln.strip() for ln in k.build_log.splitlines()
            if "registers" in ln or "spill" in ln]
    log(f"phase 2: built {native.CSRC.name}/*.cu in {k.build_seconds:.2f} s "
        f"({' | '.join(regs)})")

    from path_tracer_torch.scene import build_scene
    from path_tracer_torch.scene.showcase import showcase_scene

    t0 = time.perf_counter()
    showcase = build_scene(showcase_scene(SHOWCASE_GRID), ".", device,
                           sl_block=SHOWCASE_BLOCK)
    log(f"  showcase (grid {SHOWCASE_GRID}, {SHOWCASE_BLOCK}-slot blocks) "
        f"built in {time.perf_counter() - t0:.2f} s")

    tri_stats, sph_stats = phase_kernels(device)
    flat_stats, occ_err = phase_flat_kernels(device, showcase)
    times = phase_timing(device)
    flat_times = phase_flat_timing(device, showcase)
    launches = phase_main_path(device)
    flat_launches = phase_showcase(device, showcase)
    phase_bvh_vs_brute(device, showcase)
    phase_oracle(device)

    kernels = [
        {"name": "mt_closest_hit", "route": "cuda",
         "source": "path_tracer_torch/csrc/mt_closest_hit.cu",
         "replaces": "path_tracer_tpu/ops/pallas_intersect.py:39",
         "launches": launches["mt_closest_hit"],
         "max_abs_err": max(s[1] for s in tri_stats),
         "ms": times["mt"][0], "plain_ms": times["mt"][1]},
        {"name": "sphere_closest_hit", "route": "cuda",
         "source": "path_tracer_torch/csrc/sphere_closest_hit.cu",
         "replaces": "path_tracer_tpu/ops/pallas_spheres.py:34",
         "launches": launches["sphere_closest_hit"],
         "max_abs_err": max(s[1] for s in sph_stats),
         "ms": times["sphere"][0], "plain_ms": times["sphere"][1]},
        {"name": "flat_closest_hit", "route": "cuda",
         "source": "path_tracer_torch/csrc/flat_closest_hit.cu",
         "replaces": "path_tracer_tpu/ops/pallas_bvh.py:549",
         "launches": flat_launches["flat_closest_hit"],
         "max_abs_err": max(s[1] for s in flat_stats),
         "ms": flat_times["camera"][0], "plain_ms": flat_times["camera"][1]},
        {"name": "flat_occluded", "route": "cuda",
         "source": "path_tracer_torch/csrc/flat_occluded.cu",
         "replaces": "path_tracer_tpu/ops/pallas_bvh.py:1058",
         "launches": flat_launches["flat_occluded"],
         "max_abs_err": occ_err,
         "ms": flat_times["occluded"][0],
         "plain_ms": flat_times["occluded"][1]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
