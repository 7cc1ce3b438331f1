"""Tonemap operators + gamma/quantize post-processing.

Port of ``path_tracer_tpu/ops/tonemap.py``: Reinhard c/(c+1); Hejl-Burgess-
Dawson Filmic with 0.004 toe offset; Narkowicz ACES clamped; then gamma
1/2.2 after every tonemap (Filmic is double-gamma'd, a reference quirk) and
a truncating, saturating u8 cast.
"""
from __future__ import annotations

import torch


def reinhard(c):
    return c / (c + 1.0)


def filmic(c):
    c = torch.clamp(c - 0.004, min=0.0)
    num = c * (6.2 * c + 0.5)
    denom = c * (6.2 * c + 1.7) + 0.06
    return num / denom


def aces(c):
    num = c * (2.51 * c + 0.03)
    denom = c * (2.43 * c + 0.59) + 0.14
    return torch.clamp(num / denom, 0.0, 1.0)


_TONEMAPS = {"REINHARD": reinhard, "FILMIC": filmic, "ACES": aces}


def tonemap(kind: str, color):
    return _TONEMAPS[kind](color)


def post_process(kind: str, color):
    """HDR color [..,3] → float in [0,255] after tonemap + gamma."""
    c = tonemap(kind, color)
    c = torch.pow(torch.clamp(c, min=0.0), 1.0 / 2.2)
    return torch.clamp(c * 255.0, 0.0, 255.0)


def to_u8(post: torch.Tensor) -> torch.Tensor:
    return torch.floor(post).to(torch.uint8)
