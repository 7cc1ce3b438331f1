"""The counter-based RNG's arithmetic, frozen here for the reference.

A uniform in [0, 1) per lane hashes (pixel id, sample id, site, seed) with
a uint32 mixer; the renderer under test draws the same uniforms at the
same sites, so the reference follows its paths sample for sample. uint32
arithmetic is carried in int64 holding values in [0, 2^32); each product
is split into 16-bit halves so that none passes 2^48.
"""
from __future__ import annotations

import torch

SITE_CAM_X = 0
SITE_CAM_Y = 1
SITE_ALPHA = 2  # + walk step k
_M32 = 0xFFFFFFFF


def site_layout(alpha_steps: int) -> tuple[int, int, int, int]:
    """(ggx_r1, ggx_r2, rr, stride) of a bounce whose alpha walk draws up
    to ``alpha_steps`` uniforms: 40, 41, 42 and 64 for walks of at most
    38 steps, else sites past the walk's, the stride a multiple of 64."""
    if alpha_steps <= 40 - SITE_ALPHA:
        return 40, 41, 42, 64
    g1 = SITE_ALPHA + alpha_steps
    return g1, g1 + 1, g1 + 2, ((g1 + 3) + 63) // 64 * 64


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo, hi = c & 0xFFFF, (c >> 16) & 0xFFFF
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _mix32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    x = (_mul32(a, 0xCC9E2D51) + (b ^ 0x9E3779B9)) & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    x = (x + _mul32(b, 0x27D4EB2F)) & _M32
    x = x ^ (x >> 15)
    x = _mul32(x, 0x2545F491)
    x = x ^ (x >> 13)
    return x


def uniform(pix: torch.Tensor, sample: torch.Tensor, site: int,
            seed: int) -> torch.Tensor:
    """U[0,1) float32 per lane; ``pix`` and ``sample`` int64 tensors (any
    values, taken modulo 2^32)."""
    site_key = (site * 0x01000193 + ((seed * 0x61C88647) & _M32)) & _M32
    key = (_mul32(sample & _M32, 0x9E3779B1) + site_key) & _M32
    bits = _mix32(pix & _M32, key)
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))
