"""Row 3's serving rule (``csrc/khit.cu``), emulated in plain torch on the
CPU, against the producer's plain version (``cuda_khit``).

The kernel walks a warp of 32 lanes over the 128-column groups some lane's
gate admits, in ascending order; in each, over the 32-column sub-groups
some needing lane's gate admits, in ascending order; and there each lane
whose own gate admits the sub-group tests its 32 columns in ascending
order, inserting each hit into its own sorted list of K (``klist.cuh``:
an equal t already held is dropped, a t past the K-th too). The emulation
does the same, warp by warp, group by group and sub-group by sub-group,
on the plain version's gates and Moller-Trumbore columns, and must give
the plain version's (t, column) lists on every lane and row, exactly, at
K = 1, 6 and 8, on tie rays through the layered duplicate-card scene
(copies at equal t, where only the lowest column may win), from above and
from 10^2 to 10^3 units back, with dead lanes and finite t_max.
"""
import numpy as np
import pytest
import torch

R = 512
GROUP, SUB, LANES = 128, 32, 32


@pytest.fixture(scope="module")
def cards():
    from path_tracer_torch.scene.procedural import (
        duplicate_card_device_scene,
    )

    return duplicate_card_device_scene("cpu")


def _insert(kt, kc, t, col, mask):
    """klist.cuh's list_insert on every lane of ``mask``: a t already held
    is dropped, a t past the K-th too, else it goes in sorted place."""
    k = kt.shape[1]
    ok = mask & ~(kt == t[:, None]).any(1) & (t < kt[:, -1])
    at = (kt < t[:, None]).sum(1, keepdim=True)
    slot = torch.arange(k)[None, :]
    prev_t = torch.cat([kt[:, :1], kt[:, :-1]], 1)
    prev_c = torch.cat([kc[:, :1], kc[:, :-1]], 1)
    new_t = torch.where(slot < at, kt, torch.where(slot == at, t[:, None],
                                                   prev_t))
    new_c = torch.where(slot < at, kc, torch.where(slot == at, col[:, None],
                                                   prev_c))
    return (torch.where(ok[:, None], new_t, kt),
            torch.where(ok[:, None], new_c, kc))


def _served(o, d, t_max, tris, gbox, sbox, k: int):
    """The kernel's serving rule, emulated: (ts [k, R], pos [k, R], the
    (warp, sub-group) visits)."""
    from path_tracer_torch.ops import cuda_khit

    r = o.shape[0]
    reach = cuda_khit._group_reach(o, d, t_max, gbox)  # [R, G]
    sub = cuda_khit._group_reach(o, d, t_max, sbox)  # [R, 4G]
    t_col = cuda_khit._mt_columns(o, d, tris)  # [R, T], +inf: no hit
    kt = torch.full((r, k), float("inf"))
    kc = torch.zeros((r, k), dtype=torch.int64)
    warp = torch.arange(r) // LANES
    n_warps = int(warp[-1]) + 1
    visits = 0
    per_warp = lambda m: torch.zeros(n_warps, dtype=torch.int64).index_add_(
        0, warp, m.long())
    for g in range(reach.shape[1]):
        warp_in = per_warp(reach[:, g])[warp] > 0  # the warp visits g
        for q in range(GROUP // SUB):
            lanes = reach[:, g] & sub[:, g * GROUP // SUB + q]
            visited = warp_in & (per_warp(lanes)[warp] > 0)
            visits += int((per_warp(lanes) > 0).sum())
            c0 = g * GROUP + q * SUB
            for j in range(SUB):  # ascending columns, each a lane's own
                t = t_col[:, c0 + j]
                kt, kc = _insert(kt, kc, t, torch.full((r,), c0 + j),
                                 visited & lanes & (t < float("inf")))
    return kt.T.contiguous(), kc.T.to(torch.int32).contiguous(), visits


def _tie_lanes(sc, origin: str):
    """Tie rays through every layer of duplicated cards, from above or from
    10^2 to 10^3 units back along the same rays; every 7th lane dead, a
    fifth of the lanes with a t_max short of the lower layers."""
    from path_tracer_torch.scene.procedural import tie_rays

    o, d = tie_rays(R, seed=9)
    g = np.random.default_rng(9)
    back = (10.0 ** g.uniform(2.0, 3.0, (R, 1)) if origin == "far"
            else np.zeros((R, 1)))
    o = (o - d * back).astype(np.float32)
    t_max = np.where(g.uniform(size=R) < 0.2,
                     g.uniform(1.0, 4.0, R) + back[:, 0], np.inf)
    t_max[::7] = -1.0
    return (torch.from_numpy(o), torch.from_numpy(d),
            torch.from_numpy(t_max.astype(np.float32)))


@pytest.mark.parametrize("origin", ["above", "far"])
@pytest.mark.parametrize("k", [1, 6, 8])
def test_khit_serving_equals_plain(cards, k, origin):
    from path_tracer_torch.ops.cuda_khit import k_nearest_tr_hits_plain

    o, d, t_max = _tie_lanes(cards, origin)
    tris, gbox, sbox = cards.khit_tris, cards.khit_gbox, cards.khit_sbox
    want_t, want_c = k_nearest_tr_hits_plain(o, d, t_max, tris, gbox, k,
                                             sbox)
    got_t, got_c, visits = _served(o, d, t_max, tris, gbox, sbox, k)
    assert torch.equal(got_t, want_t) and torch.equal(got_c, want_c)
    # Copies at equal t: the lists hold distinct t, each the lowest column.
    assert torch.isfinite(want_t[0]).float().mean() > 0.5
    assert visits > 0
