"""Stateless counter-based RNG, bit-identical to ``path_tracer_tpu/ops/rng.py``.

Each draw hashes (pixel_id, sample_id, site, seed) with the same uint32
mixer as the JAX package, so every lane gets the same stream on any device,
tile or shard, and the port's renders follow the JAX package's sample for
sample. torch's uint32 arithmetic is partial, so the mixer runs in int64
holding values in [0, 2^32): every product is taken modulo 2^32 by
splitting the 32-bit constant into 16-bit halves (no product exceeds
2^48, so int64 never overflows), and every sum is masked.

``site`` is a static per-draw-site constant (see ``site_layout``).
"""
from __future__ import annotations

import torch

SITE_CAM_X = 0
SITE_CAM_Y = 1
SITE_STRIDE = 64
SITE_ALPHA = 2  # + walk step k
SITE_GGX_R1 = 40
SITE_GGX_R2 = 41
SITE_RR = 42

_M32 = 0xFFFFFFFF


def site_layout(alpha_steps: int) -> tuple[int, int, int, int]:
    """(ggx_r1, ggx_r2, rr, stride) for a bounce whose alpha walk draws up
    to ``alpha_steps`` accept uniforms. Shallow walks keep the historical
    constants (GGX at 40/41, RR at 42, stride 64); deeper walks widen the
    layout so walk sites never collide with the bounce's GGX/RR draws."""
    if alpha_steps <= SITE_GGX_R1 - SITE_ALPHA:
        return SITE_GGX_R1, SITE_GGX_R2, SITE_RR, SITE_STRIDE
    g1 = SITE_ALPHA + alpha_steps
    stride = ((g1 + 3) + 63) // 64 * 64
    return g1, g1 + 1, g1 + 2, stride


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32) and a Python int c."""
    lo, hi = c & 0xFFFF, (c >> 16) & 0xFFFF
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _mix32(a: torch.Tensor, b: int) -> torch.Tensor:
    """One-way mix of a uint32 stream (int64 tensor) with a uint32 key."""
    x = (_mul32(a, 0xCC9E2D51) + (b ^ 0x9E3779B9)) & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    # Second round keyed by b to break (a, b) linearity.
    x = (x + ((b * 0x27D4EB2F) & _M32)) & _M32
    x = x ^ (x >> 15)
    x = _mul32(x, 0x2545F491)
    x = x ^ (x >> 13)
    return x


def uniform(pixel_id: torch.Tensor, sample_id: int, site: int,
            seed: int) -> torch.Tensor:
    """U[0,1) float32 per lane. pixel_id: [R] integer tensor (>= 0);
    sample_id, site, seed: Python ints (any seed, masked to 32 bits)."""
    site_key = (site * 0x01000193 + ((seed * 0x61C88647) & _M32)) & _M32
    key = (sample_id * 0x9E3779B1 + site_key) & _M32
    bits = _mix32(pixel_id.to(torch.int64) & _M32, key)
    # 24-bit mantissa → [0, 1); exact in float32.
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))
