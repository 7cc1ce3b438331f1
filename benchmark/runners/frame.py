"""The ``frame`` runner: progressive rendering, one closed-loop flow.

The window makes one call of ``models.renderer.render_pixel_sums`` for
more samples than it can finish; each pass is the mix's
``samples_per_pass`` samples of the whole frame (one wavefront when the
profile's ``tile_rays`` covers it), sample ids from the seed on, and the
pass callback, after a synchronize, takes each pass's time and stops the
render once ``--seconds`` have passed. The sums stay on the device until
the window has closed. The rate (the mix's ``rate_metric``) counts
W*H*(bounces+1) rays a sample completed, over the window's seconds.
"""
from __future__ import annotations

import time

from benchmark import check, scenes

# The render profile's keys this runner runs; any other key is refused, so
# that a configuration cannot state a setting that the window never uses.
PROFILE_KEYS = {"resolution", "bounces", "tile_rays", "alpha_walk_steps",
                "shadow_walk_steps", "seed"}


class Runner:
    """The ``frame`` runner (``runners/__init__.py`` sets out the
    interface)."""

    def __init__(self, cell: str, cfg: dict, mix: dict, seed: int, device,
                 spans, build_dir):
        self.cell, self.cfg, self.mix, self.seed = cell, cfg, mix, seed
        self.device, self.spans, self.build_dir = device, spans, build_dir
        prof = cfg["profile"]
        unknown = set(prof) - PROFILE_KEYS
        if unknown:
            raise ValueError(f"profile keys the frame runner does not run: "
                             f"{sorted(unknown)}")
        self.width = prof["resolution"]["width"]
        self.height = prof["resolution"]["height"]
        self.bounces = prof["bounces"]
        self.rng_seed = prof.get("seed", 0)
        self.tile_rays = prof["tile_rays"]
        self.per_pass = mix["samples_per_pass"]
        # The window's first sample id; the warm-up renders the id before.
        self.start = int(seed)
        self.raw = self.scene = self.spec = None
        self.ref = {}  # the reference's scene by dtype, once made
        self.samples, self.pass_times, self.snapshot = 0, [], None

    # -- set-up ---------------------------------------------------------------

    def setup(self):
        from path_tracer_torch import native
        from path_tracer_torch.models.integrator import IntegratorSpec
        from path_tracer_torch.scene.device_scene import build_scene

        with self.spans("scene_generate"):
            tex_dir = self.build_dir / "textures" / self.cfg["name"]
            self.raw = scenes.generate(self.cfg["scene"], tex_dir)
            scenes.write_textures(self.raw, tex_dir)
        if self.device.type == "cuda":
            import torch

            with self.spans("cuda_init"):
                torch.zeros(1, device=self.device)
                torch.cuda.synchronize()
            with self.spans("kernel_load"):
                native.kernels()
        with self.spans("scene_build"):
            self.scene = build_scene(scenes.port_scene(self.raw), tex_dir,
                                     self.device,
                                     sl_block=self.cfg["sl_block"])
        prof = self.cfg["profile"]
        self.spec = IntegratorSpec(
            bounces=self.bounces, alpha_walk_steps=prof.get("alpha_walk_steps"),
            shadow_walk_steps=prof.get("shadow_walk_steps"), seed=self.rng_seed)
        with self.spans("warm_up"):
            self._render(self.start - 1, self.per_pass)
            self._sync()

    def _sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _render(self, sample_start, n_samples, callback=None):
        from path_tracer_torch.models.renderer import render_pixel_sums

        return render_pixel_sums(
            self.scene, self.width, self.height, sample_start, n_samples,
            self.spec, tile_rays=self.tile_rays,
            samples_per_launch=self.per_pass, pass_callback=callback,
            snapshot=False)

    # -- the window -------------------------------------------------------

    def window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        last = [t0]

        def on_pass(done, snapshot):
            self._sync()
            now = time.perf_counter()
            self.pass_times.append(now - last[0])
            last[0] = now
            self.samples, self.snapshot = done, snapshot
            return now - t0 < seconds

        self._render(self.start, 1 << 30, on_pass)
        window_s = last[0] - t0
        return {"window_s": window_s, "attempted": len(self.pass_times),
                "unit_times": self.pass_times,
                "metrics": {self.mix["rate_metric"]:
                            self.rays(self.samples) / window_s / 1e6}}

    def rays(self, samples: int) -> int:
        """Rays a count of samples casts: W*H*(bounces+1) each."""
        return self.width * self.height * samples * (self.bounces + 1)

    # -- the traced pass --------------------------------------------------

    def trace(self, profiled) -> dict:
        """The mix's traced passes, after the window: their timeline, the
        least seconds by kernel family, the samples traced and the
        window's pass times."""
        from benchmark.counts.capture import Capture

        n = self.mix["profiled_passes"] * self.per_pass
        with Capture() as cap:
            tl = profiled(lambda: self._render(self.start + (1 << 20), n))
        return {"timeline": tl, "least": cap.least_seconds(),
                "traced_samples": n, "pass_times": self.pass_times}

    # -- the check --------------------------------------------------------

    def _free_program(self):
        import gc

        import torch

        self.scene = self.snapshot = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _ref_sums(self, pixels, start, n, dtype=None):
        """The plain reference's sums of ``n`` samples from ``start`` at
        ``pixels``, in float32 or ``dtype``."""
        import torch

        from benchmark.reference import tracer

        dtype = torch.float32 if dtype is None else dtype
        if dtype not in self.ref:
            self.ref[dtype] = tracer.RefScene(self.raw, self.device, dtype)
        return tracer.pixel_sums(self.ref[dtype], pixels, start, n, self.width,
                                 self.height, self.bounces,
                                 self.rng_seed).cpu().numpy()

    def _pixels(self, seed):
        return check.check_pixels(seed, self.width * self.height,
                                  self.cfg["check_pixels"])

    def check(self, dtype=None) -> dict:
        """The compared numbers of the window's sums (``check.py``). The
        program's scene is freed first. ``dtype`` (a torch dtype) runs the
        reference in it and compares it in the program's place: the
        control."""
        n = self.samples
        pixels = self._pixels(self.seed)
        got = self.snapshot()[pixels]
        self._free_program()
        want = self._ref_sums(pixels, self.start, n)
        if dtype is not None:
            got = self._ref_sums(pixels, self.start, n, dtype)
        return check.numbers(got, want, n)

    def reading(self, seed: int, samples: int) -> dict:
        """The compared numbers of ``samples`` samples rendered from the
        seed's first sample id through the window's own call, with the
        program's render and the reference's seconds."""
        t0 = time.perf_counter()
        got = {}
        self._render(seed, samples, lambda done, snap: got.update(snap=snap))
        self._sync()
        t1 = time.perf_counter()
        pixels = self._pixels(seed)
        nums = check.numbers(got["snap"]()[pixels],
                             self._ref_sums(pixels, seed, samples), samples)
        return dict(render_s=t1 - t0, reference_s=time.perf_counter() - t1,
                    **nums)

    def control_reading(self, seed: int, samples: int) -> dict:
        """The control's numbers: the reference in bfloat16 in the
        program's place, at the pixels and sample ids of a reading."""
        import torch

        t0 = time.perf_counter()
        pixels = self._pixels(seed)
        nums = check.numbers(
            self._ref_sums(pixels, seed, samples, torch.bfloat16),
            self._ref_sums(pixels, seed, samples), samples)
        return dict(seconds=time.perf_counter() - t0, **nums)
