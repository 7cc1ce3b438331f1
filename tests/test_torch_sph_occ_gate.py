"""The sphere walks' gates on rays aimed where a sphere touches a face of
its block's box, and the sphere any-hit walk's fold of the triangle result,
on the CPU.

The witness: ``duplicate_sphere_device_scene`` (600 spheres in 8 blocks,
the block walks) with ``sphere_tie_rays`` (centres, silhouettes, the
points where a sphere touches a face of its box's AABB, points of that
face nearby), t_max the first-hit t of the closest-hit walk run ungated
(every ``sph_blk`` box at +-1e30). There the any-hit walk
(``cuda_spheres.occluded_spheres_plain``, what ``csrc/sph_occ.cu``'s walk
is held to on the card) must find the occluder of every hitting lane: 0
lanes off the same walk run ungated and off the dense any-hit
(``_occluded_dense_plain``, which has no gate). On the exact boxes
(``slab``'s pads at 0) a lane's own rounded slab test puts the block's
entry past the root of a ray through a touching point and the walk loses
the occluder there: that mutation must show lanes off, so the witness
keeps its teeth. The closest-hit walk (row 5) gates on exact boxes with no
upper bound but its cut, widened by 2^-8, and is held to its ungated run on
the same rays, from t_prev = -1 and from its hit.

The fold: on CPU tensors ``occluded_spheres_cuda(..., prior=p)`` is
``p | occluded_spheres_plain(...)``, dead lanes (t_max < 0) included,
where a dead lane is never occluded by a sphere.
"""
import dataclasses

import numpy as np
import pytest
import torch

N = 8192  # lanes a seed; sphere_tie_rays' touching quarter is [N/2, 3N/4)
SEEDS = (0, 1)
PADS = ("BOX_PAD_EXT", "BOX_PAD_MAG", "BOX_PAD_T")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ties():
    """(the duplicate-sphere scene, the same with every block box at
    +-1e30: the walks ungated)."""
    from path_tracer_torch.scene.procedural import (
        duplicate_sphere_device_scene,
    )

    sc = duplicate_sphere_device_scene("cpu")
    assert sc.sph_use_blocks and sc.num_real_spheres == 600
    blk = sc.sph_blk.clone()
    blk[0:3], blk[3:6] = -1e30, 1e30
    return sc, dataclasses.replace(sc, sph_blk=blk)


@pytest.fixture(scope="module")
def witness(ties):
    """seed -> (o, d, t of the ungated closest-hit walk from t_prev = -1)."""
    from path_tracer_torch.ops.cuda_spheres import _sph_walk_plain
    from path_tracer_torch.scene.procedural import sphere_tie_rays

    out = {}
    for seed in SEEDS:
        o, d = (torch.from_numpy(x) for x in sphere_tie_rays(N, seed))
        t = _sph_walk_plain(o, d, torch.full((N,), -1.0), ties[1])[0]
        assert torch.isfinite(t).float().mean() > 0.95
        out[seed] = (o, d, t)
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_any_hit_walk_keeps_occluders_at_box_faces(ties, witness, seed):
    from path_tracer_torch.ops import cuda_spheres

    sc, ungated = ties
    o, d, t = witness[seed]
    got = cuda_spheres.occluded_spheres_plain(o, [d], [t], sc)[0]
    assert torch.equal(got, cuda_spheres._occluded_walk_plain(o, d, t,
                                                              ungated))
    assert torch.equal(got, cuda_spheres._occluded_dense_plain(o, d, t, sc))
    assert torch.equal(got, torch.isfinite(t))  # t_max is the first root
    # The wrapper on CPU tensors is the plain version.
    assert torch.equal(cuda_spheres.occluded_spheres_cuda(o, [d], [t], sc)[0],
                       got)


@pytest.mark.parametrize("seed", SEEDS)
def test_exact_boxes_drop_occluders_at_box_faces(ties, witness, seed,
                                                 monkeypatch):
    """Why the any-hit walk widens its gate: on the exact boxes and
    intervals it loses hundreds of occluders, nearly all of them on rays
    aimed at the touching points."""
    from path_tracer_torch.ops import cuda_spheres, slab

    sc, _ = ties
    o, d, t = witness[seed]
    for name in PADS:
        monkeypatch.setattr(slab, name, 0.0)
    exact = cuda_spheres._occluded_walk_plain(o, d, t, sc)
    off = torch.nonzero(exact != torch.isfinite(t))[:, 0]
    touching = ((off >= N // 2) & (off < 3 * N // 4)).sum()
    assert off.numel() > 100 and touching >= 0.95 * off.numel(), (
        off.numel(), int(touching))


@pytest.mark.parametrize("start", ["fresh", "from_hit"])
@pytest.mark.parametrize("seed", SEEDS)
def test_sphere_walk_keeps_hits_at_box_faces(ties, witness, seed, start):
    """Row 5 on its exact boxes equals its ungated run on every field of
    every lane, from t_prev = -1 and from the first hit (the far roots)."""
    from path_tracer_torch.ops.cuda_spheres import (
        closest_hit_spheres_walk_plain,
    )

    sc, ungated = ties
    o, d, t = witness[seed]
    tp = torch.full((N,), -1.0)
    if start == "from_hit":
        tp = torch.where(torch.isfinite(t), t, -1.0)
    got = closest_hit_spheres_walk_plain(o, d, tp, sc)
    want = closest_hit_spheres_walk_plain(o, d, tp, ungated)
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert got.valid.float().mean() > 0.95
    if start == "from_hit":
        assert got.backface[got.valid].all()


def test_any_hit_walk_folds_prior(ties, witness):
    """Three sets on the walk (the witness rays at t_max the first root,
    and on every other lane half of it, and reversed), every 7th lane of
    each dead: with a random prior the result is prior | spheres on every
    lane, a dead lane its prior; without one, a dead lane is not
    occluded."""
    from path_tracer_torch.ops.cuda_spheres import (
        occluded_spheres_cuda,
        occluded_spheres_plain,
    )

    sc, _ = ties
    o, d, t = witness[SEEDS[0]]
    ds = torch.stack([d, d, -d])
    half = torch.where(torch.arange(N) % 2 == 0, 0.5 * t, t)
    tms = torch.stack([t, half, torch.full((N,), float("inf"))])
    tms[:, ::7] = -1.0
    g = np.random.default_rng(5)
    prior = torch.from_numpy(g.uniform(size=(3, N)) < 0.1)
    alone = occluded_spheres_cuda(o, ds, tms, sc)
    assert torch.equal(alone, occluded_spheres_plain(o, ds, tms, sc))
    got = occluded_spheres_cuda(o, ds, tms, sc, prior=prior)
    assert torch.equal(got, prior | alone)
    assert torch.equal(got, occluded_spheres_plain(o, ds, tms, sc, prior))
    dead = tms < 0.0
    assert not alone[dead].any() and torch.equal(got[dead], prior[dead])
    assert prior[dead].any() and alone[0].float().mean() > 0.8
    assert 0.05 < alone[1].float().mean() < 0.95


def _fake_walk_operands(n, sets):
    from torch._subclasses.fake_tensor import FakeTensorMode

    mode = FakeTensorMode()
    with mode:
        cuda = dict(device="cuda")
        ops = dict(
            o=torch.empty((n, 3), **cuda),
            ds=torch.empty((sets, n, 3), **cuda),
            tms=torch.empty((sets, n), **cuda),
            blk=torch.empty((8, 128), **cuda),
            blkid=torch.empty((1, 128), dtype=torch.int32, **cuda),
            sorted=torch.empty((4, 256), **cuda),
            prior=torch.empty((sets, n), dtype=torch.bool, **cuda))
    return mode, ops


@pytest.mark.parametrize("fault", ["prior f32", "prior shape",
                                   "prior device", "lane_wise 0",
                                   "lane_wise 34"])
def test_sph_occ_walk_launch_checks_prior(fault, monkeypatch):
    """The walk's launcher takes the triangle any-hit's [L,R] bool as
    prior and a layout threshold in 1..33, and raises on any other before
    it builds or launches."""
    from path_tracer_torch import native

    def _no_build():
        raise AssertionError("built before its checks")

    monkeypatch.setattr(native, "kernels", _no_build)
    n, sets = 64, 3
    mode, x = _fake_walk_operands(n, sets)
    prior, lane_wise = x["prior"], native.SPH_OCC_WALK_LANE_WISE
    with mode:
        if fault == "prior f32":
            prior = torch.empty((sets, n), device="cuda")  # the f32 of old
        elif fault == "prior shape":
            prior = torch.empty((sets - 1, n), dtype=torch.bool,
                                device="cuda")
    if fault == "prior device":
        prior = torch.zeros((sets, n), dtype=torch.bool)
    if fault.startswith("lane_wise"):
        lane_wise = int(fault.split()[1])
    with mode, pytest.raises(ValueError):
        native.launch_sph_occ_walk(x["o"], x["ds"], x["tms"], x["blk"],
                                   x["blkid"], x["sorted"], prior,
                                   lane_wise=lane_wise)
