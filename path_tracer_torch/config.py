"""Render profile and resolution config.

Port of ``path_tracer_tpu/config.py``: the same fields, defaults and
validation (reference defaults 1920x1080, bounces=4, samples=64,
COOK_TORRANCE, FILMIC). PyYAML is imported only inside ``Profile.load``,
so building a ``Profile`` in code needs nothing beyond the stdlib.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Union

BRDF_TYPES = ("COOK_TORRANCE",)
TONEMAP_TYPES = ("REINHARD", "FILMIC", "ACES")


@dataclasses.dataclass(frozen=True)
class Resolution:
    width: int = 1920
    height: int = 1080

    @property
    def num_pixels(self) -> int:
        return self.width * self.height


@dataclasses.dataclass(frozen=True)
class Profile:
    resolution: Resolution = Resolution()
    bounces: int = 4
    samples: int = 64
    brdf: str = "COOK_TORRANCE"
    tonemap: str = "FILMIC"
    # Step bounds of the alpha and shadow-transmittance walks (None =
    # auto: the scene's num_transparent_hits + 1, the reference's
    # unbounded walk; all-opaque scenes collapse both to one cast).
    alpha_walk_steps: int | None = None
    shadow_walk_steps: int | None = None
    # Rays per wavefront (pixel tile size, flattened).
    tile_rays: int = 1 << 18
    # Samples per launch batch; values are batch-invariant.
    samples_per_launch: int = 1
    # Sample copies packed per kernel packet (only 1 is supported here).
    samples_per_wavefront: int = 1
    seed: int = 0

    def __post_init__(self):
        if self.brdf not in BRDF_TYPES:
            raise ValueError(f"unknown brdf {self.brdf!r}, expected one of {BRDF_TYPES}")
        if self.tonemap not in TONEMAP_TYPES:
            raise ValueError(
                f"unknown tonemap {self.tonemap!r}, expected one of {TONEMAP_TYPES}"
            )

    @staticmethod
    def load(path: Union[str, Path]) -> "Profile":
        """Load a YAML render profile (the reference's schema)::

            resolution: {width: 800, height: 600}
            bounces: 4
            samples: 16
            brdf: COOK_TORRANCE
            tonemap: FILMIC
        """
        import yaml

        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        return Profile.from_dict(raw)

    @staticmethod
    def from_dict(raw: dict) -> "Profile":
        kwargs = {}
        if "resolution" in raw:
            res = raw["resolution"]
            kwargs["resolution"] = Resolution(int(res["width"]), int(res["height"]))
        for key in (
            "bounces",
            "samples",
            "alpha_walk_steps",
            "shadow_walk_steps",
            "tile_rays",
            "samples_per_launch",
            "samples_per_wavefront",
            "seed",
        ):
            if key in raw:
                # Only the walk depths are nullable (null = auto-size).
                nullable = key in ("alpha_walk_steps", "shadow_walk_steps")
                if raw[key] is None and not nullable:
                    raise ValueError(f"profile key '{key}' must be an "
                                     f"integer, got null")
                kwargs[key] = None if raw[key] is None else int(raw[key])
        for key in ("brdf", "tonemap"):
            if key in raw:
                kwargs[key] = str(raw[key])
        return Profile(**kwargs)
