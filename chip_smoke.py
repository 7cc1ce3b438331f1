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
   lanes, a ray count that is no multiple of the block size), then each
   kernel's time beside its plain version's at the main path's shapes;
4. the main path at full size: ``cube``, ``spheres`` and ``reflection`` at
   1920x1080, 4 bounces, 16 spp through ``render_pixel_sums``, with each
   kernel's launch count over that run, and one reference-default frame of
   ``reflection`` (1920x1080, 64 spp, 4 bounces) through the CLI;
5. the scalar-oracle gate: seven cases against ``tests/goldens/oracle`` at
   each golden's own size, with the CPU gate's statistics and tolerances.

The last lines are a JSON object of kernel numbers, the ``nvidia-smi`` card
name and power limit, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
OUT = REPO / "chiprun_out" / "chip_smoke"

# Kernel-vs-plain bounds (the repo's own): the fraction of lanes whose kind
# or prim differ (flat2's divergence bound) and the relative t error on
# agreeing lanes (the Baldwin-Weber-vs-MT bound). Built -fmad=false, the
# kernels round as the plain versions do, so both are expected to be 0.
MAX_MISMATCH = 1e-4
MAX_REL_T = 5e-5
FIXTURE_TOL = 1e-5  # the reference's MT fixture tolerance

# Oracle gate, as tests/test_oracle_parity.py: case -> (mean |u8| tol,
# energy rtol).
ORACLE_CASES = {
    "cube": (2.0, 0.02), "reflection": (2.0, 0.02), "spheres": (2.5, 0.04),
    "white_furnace_direct": (2.0, 0.02),
    "white_furnace_indirect": (2.5, 0.02),
    "cube_rr_b6": (2.0, 0.02), "spheres_rr_b6": (2.5, 0.04),
}


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


def compare(label: str, got, want) -> tuple[float, float]:
    """(mismatch fraction, max abs err) of two HitRecords; fails the run
    when a bound is exceeded."""
    import torch

    mism = (got.kind != want.kind) | (got.prim != want.prim) \
        | (got.backface != want.backface)
    agree = ~mism & torch.isfinite(want.t)
    rel = ((got.t - want.t).abs() / want.t.abs().clamp(min=1e-30))[agree]
    errs = [(got.t - want.t)[agree].abs(), (got.u - want.u)[agree].abs(),
            (got.v - want.v)[agree].abs()]
    max_abs = max([float(e.max()) if e.numel() else 0.0 for e in errs])
    frac = float(mism.float().mean())
    max_rel = float(rel.max()) if rel.numel() else 0.0
    hit = float(torch.isfinite(want.t).float().mean())
    log(f"  {label}: lanes={want.t.numel()} hit={hit:.3f} mismatch={frac:.2e} "
        f"(<= {MAX_MISMATCH:g}) max_rel_t={max_rel:.2e} (<= {MAX_REL_T:g}) "
        f"max_abs_err={max_abs:.2e}")
    if not (frac <= MAX_MISMATCH and max_rel <= MAX_REL_T and hit > 0.01):
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
    cuda_intersect.launches = 0
    cuda_spheres.launches = 0
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
    launches = (cuda_intersect.launches, cuda_spheres.launches)
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
    for case, (tol, energy_rtol) in ORACLE_CASES.items():
        z = np.load(REPO / "tests" / "goldens" / "oracle" / f"{case}.npz")
        oracle = z["radiance"].astype(np.float64)
        w, h, spp, b = (int(z[k]) for k in ("width", "height", "spp", "bounces"))
        sc = load_scene(REPO / str(z["scene"]), device)
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
        log(f"  {case}: {'OK' if ok else 'FAIL'} {w}x{h} {spp} spp b{b} "
            f"finite {finite.mean():.4f} energy {wm:.5f} vs {om:.5f} "
            f"(rtol {energy_rtol}) mean|u8| {diff.mean():.3f} (<= {tol}) "
            f"p99 {p99:.0f} (<= 40) {secs:.2f} s")
        if not ok:
            failed.append(case)
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

    tri_stats, sph_stats = phase_kernels(device)
    times = phase_timing(device)
    launches = phase_main_path(device)
    phase_oracle(device)

    kernels = [
        {"name": "mt_closest_hit", "route": "cuda",
         "source": "path_tracer_torch/csrc/mt_closest_hit.cu",
         "replaces": "path_tracer_tpu/ops/pallas_intersect.py:39",
         "launches": launches[0],
         "max_abs_err": max(s[1] for s in tri_stats),
         "ms": times["mt"][0], "plain_ms": times["mt"][1]},
        {"name": "sphere_closest_hit", "route": "cuda",
         "source": "path_tracer_torch/csrc/sphere_closest_hit.cu",
         "replaces": "path_tracer_tpu/ops/pallas_spheres.py:34",
         "launches": launches[1],
         "max_abs_err": max(s[1] for s in sph_stats),
         "ms": times["sphere"][0], "plain_ms": times["sphere"][1]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
