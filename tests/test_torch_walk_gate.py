"""The resident transparent walks' group gate and sorted list, on the CPU.

The walk kernels (``csrc/alpha_walk.cu``, ``csrc/trans_walk.cu``) admit a
lane to a 128-column group of the transparent table only where its segment
[0, t_hi] enters the group's box, then make one pass over the admitted
columns that collects the lane's K = min(steps_cap, 8) nearest distinct
candidates, and step through that list, refilling it by another pass when
it runs out while the lane walks on. These tests hold the pieces to the
contract:

- the gate in plain torch (``trwalk.group_gate``, the kernels' expression)
  equals JAX's ``pallas_trwalk._slab_groups`` lane by lane, on unwidened
  boxes and intervals, on showcase48's ``tr_grp`` with zero direction
  components and dead lanes mixed in;
- the kernels' gate (``trwalk.resident_gate``: the boxes widened as they
  are staged, each lane's slab interval widened) drops no candidate of
  the ungated ``_eval_cols``: on showcase48's foliage rays, on rays aimed
  at its and the duplicate-card scene's group boxes' faces, edges and
  corners and their cards' vertices and edge points, on tie rays, and on
  rays from origins 10^2 to 10^3 group extents away (half of them grazing
  their card), with t_hi infinite, at a candidate's t and one ulp either
  side; on the exact boxes and intervals the gate does drop some (the
  rounded slab test misses rays that graze a card's vertex or edge lying
  on a box face), which is why the kernels widen them;
- a plain form of the list walk (the gate, the K smallest distinct t with
  the lowest column each, consumed step by step, refilled) equals
  ``alpha_walk_plain`` and ``trans_walk_plain`` on every field of every
  lane at caps 0, 1, 8 and 12, on tie rays through the layered
  duplicate-card scene (copies at equal t; 12 layers, so cap 12 refills)
  and on showcase48's foliage rays;
- row 3's producer (``cuda_khit.k_nearest_tr_hits_plain``, whose gate
  widens the 128-column group boxes, the 32-column sub-group boxes and
  each lane's interval the same way)
  keeps, within t_max, every entry of the ungated producer (every group
  box at +-1e30: brute-force MT) on the aimed, far, tie and foliage sets of
  the duplicate-card scene and showcase48, at t_max infinite, at the
  ungated first hit and one ulp either side; on the exact boxes and
  intervals it drops entries on the cards' aimed and far sets.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

R = 1024
KMAX = 8  # the kernels' list length


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def showcase48():
    from path_tracer_torch.scene.showcase import showcase_device_scene

    return showcase_device_scene(48, "cpu", sl_block=256, textured=True)


@pytest.fixture(scope="module")
def cards():
    """Twelve layers of duplicated transparent cards and a stack of 300
    copies over an opaque floor (3,374 triangles, 27 groups)."""
    from path_tracer_torch.scene.procedural import (
        duplicate_card_device_scene,
    )

    return duplicate_card_device_scene("cpu")


def _foliage_rays(sc, seed, r):
    """Rays from around the transparent triangles' bounds through them."""
    v = sc.tri_v0[sc.n_tris_opaque:sc.num_real_triangles].numpy()
    g = np.random.default_rng(seed)
    o = g.uniform(v.min(0) - 2, v.max(0) + 2, (r, 3))
    d = g.uniform(v.min(0), v.max(0), (r, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32), g


def _aimed_rays(sc, seed, r):
    """Rays from random origins around the transparent triangles toward
    points on the valid group boxes (corners, edge points, face points)
    and on the cards (vertices and edge points)."""
    g = np.random.default_rng(seed)
    grp = sc.tr_grp.numpy()
    boxes = grp[:6, grp[6] > 0].T  # [G, 6]
    lo, hi = boxes[:, :3], boxes[:, 3:]
    k = r // 4
    b = g.integers(0, len(boxes), r)
    corner = np.where(g.integers(0, 2, (r, 3)).astype(bool), lo[b], hi[b])
    # Edge points: two coordinates at a corner, one free; face points: one.
    free = g.uniform(lo[b], hi[b])
    edge, face = corner.copy(), corner.copy()
    axis = g.integers(0, 3, r)
    edge[np.arange(r), axis] = free[np.arange(r), axis]
    face_keep = g.integers(0, 3, r)
    face = free.copy()
    face[np.arange(r), face_keep] = corner[np.arange(r), face_keep]
    v0 = sc.tri_v0[sc.n_tris_opaque:sc.num_real_triangles].numpy()
    e1 = sc.tri_e1[sc.n_tris_opaque:sc.num_real_triangles].numpy()
    e2 = sc.tri_e2[sc.n_tris_opaque:sc.num_real_triangles].numpy()
    tri = g.integers(0, len(v0), r)
    w = g.uniform(size=(r, 1))
    vert = v0[tri] + np.where(g.integers(0, 3, (r, 1)) == 1, e1[tri],
                              np.where(g.integers(0, 2, (r, 1)) == 1,
                                       e2[tri], 0.0))
    on_edge = v0[tri] + w * e1[tri]
    tgt = np.concatenate([corner[:k], edge[k:2 * k], face[2 * k:3 * k],
                          np.where(g.integers(0, 2, (r - 3 * k, 1)) == 1,
                                   vert[3 * k:], on_edge[3 * k:])])
    span = v0.max(0) - v0.min(0)
    o = tgt + g.uniform(-1.0, 1.0, (r, 3)) * span
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _far_rays(sc, seed, r):
    """Rays toward points on the cards (vertices, edge points, interior
    points) from origins 10^2 to 10^3 group extents away (the largest side
    of the smallest valid group box that holds the point): a far camera
    over a small group. Half come from random directions, half graze
    their card (cosine 10^-3 to 10^-1), where a candidate's t rounds
    most."""
    g = np.random.default_rng(seed)
    lo_n = sc.n_tris_opaque
    v0, e1, e2 = (x[lo_n:sc.num_real_triangles].numpy().astype(np.float64)
                  for x in (sc.tri_v0, sc.tri_e1, sc.tri_e2))
    tri = g.integers(0, len(v0), r)
    v0, e1, e2 = v0[tri], e1[tri], e2[tri]
    a, b = g.uniform(size=(2, r, 1))
    kind = g.integers(0, 3, (r, 1))
    a = np.where(kind == 0, np.round(a), a)  # vertices
    b = np.where(kind == 0, 0.0, np.where(kind == 1, 1.0 - a, b * (1 - a)))
    tgt = v0 + a * e1 + b * e2
    unit = lambda x: x / np.linalg.norm(x, axis=1, keepdims=True)
    n, t1 = unit(np.cross(e1, e2)), unit(e1)
    phi = g.uniform(0.0, 2.0 * np.pi, (r, 1))
    cos = 10.0 ** g.uniform(-3.0, -1.0, (r, 1)) * g.choice([-1.0, 1.0],
                                                            (r, 1))
    graze = (np.sqrt(1.0 - cos * cos)
             * (np.cos(phi) * t1 + np.sin(phi) * np.cross(n, t1)) + cos * n)
    d = np.where(np.arange(r)[:, None] % 2 == 0, graze,
                 unit(g.normal(size=(r, 3))))
    grp = sc.tr_grp.numpy()
    boxes = grp[:6, grp[6] > 0].T
    ext = (boxes[:, 3:] - boxes[:, :3]).max(1)
    # A point on a card lies in its group's box up to the rounding of the
    # float32 edges it is built from.
    gap = np.linalg.norm(np.maximum(np.maximum(
        boxes[None, :, :3] - tgt[:, None, :],
        tgt[:, None, :] - boxes[None, :, 3:]), 0.0), axis=2)
    scale = np.where(gap <= 1e-4 * ext.max(), ext[None, :], np.inf).min(1)
    assert np.isfinite(scale).all()
    o = tgt - d * (scale * 10.0 ** g.uniform(2.0, 3.0, r))[:, None]
    return o.astype(np.float32), d.astype(np.float32)


def _columns_gate(sc, o, d, t_hi, widened: bool):
    """[N, T] bool: the gate of each column's group, the kernels' one
    (``resident_gate``) or on the exact boxes and intervals."""
    from path_tracer_torch.ops.trwalk import group_gate, resident_gate

    gate = (resident_gate(o, d, t_hi, sc.tr_grp) if widened
            else group_gate(o, d, t_hi, sc.tr_grp))
    return gate[:, torch.arange(sc.tr_bw.shape[1]) // 128]


def test_gate_equals_jax_slab_groups(showcase48):
    """One lane at a time through ``_slab_groups`` (a tile of one ray),
    against the port's gate on all lanes at once."""
    from path_tracer_torch.ops.trwalk import group_gate
    from path_tracer_tpu.ops.pallas_trwalk import _slab_groups

    sc = showcase48
    o, d, g = _foliage_rays(sc, 21, R)
    d[::9, 0] = 0.0
    d[::11, 2] = -0.0
    t_hi = g.uniform(0.0, 30.0, R).astype(np.float32)
    t_hi[::5] = np.inf
    t_hi[::7] = -1.0
    grp = sc.tr_grp.numpy()
    one = jax.jit(jax.vmap(lambda oo, dd, th: _slab_groups(
        oo[0:1], oo[1:2], oo[2:3], dd[0:1], dd[1:2], dd[2:3], th[None],
        jnp.asarray(grp))))
    want = np.asarray(one(jnp.asarray(o), jnp.asarray(d),
                          jnp.asarray(t_hi))) > 0.0
    got = group_gate(*map(torch.from_numpy, (o, d, t_hi)),
                     sc.tr_grp).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[t_hi >= 0].any(axis=1).mean() > 0.3 and not got[::7].any()


def _dropped(sc, rays, widened: bool) -> int:
    """Candidates of the ungated ``_eval_cols`` outside the groups the gate
    (``_columns_gate``) admits, summed over t_hi infinite, at each lane's
    first candidate and one ulp either side."""
    from path_tracer_torch.ops.trwalk import _eval_cols
    from path_tracer_torch.scene.procedural import tie_rays

    if rays == "foliage":
        o, d, _ = _foliage_rays(sc, 22, 4 * R)
    elif rays == "aimed":
        o, d = _aimed_rays(sc, 23, 4 * R)
    elif rays == "far":
        o, d = _far_rays(sc, 26, 4 * R)
    else:
        o, d = tie_rays(4 * R, seed=23)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    inf = torch.full((o.shape[0],), float("inf"))
    first = _eval_cols(o, d, inf, sc.tr_bw)[0].amin(dim=1)
    hit = torch.isfinite(first)
    assert hit.float().mean() > 0.3
    n = 0
    for t_hi in (inf, first,
                 torch.nextafter(first, torch.tensor(-np.inf)),
                 torch.nextafter(first, torch.tensor(np.inf))):
        t_hi = torch.where(hit, t_hi, inf)
        cand = torch.isfinite(_eval_cols(o, d, t_hi, sc.tr_bw)[0])
        n += int((cand & ~_columns_gate(sc, o, d, t_hi, widened)).sum())
    return n


@pytest.mark.parametrize("scene,rays", [
    ("showcase48", "foliage"), ("showcase48", "aimed"), ("cards", "aimed"),
    ("cards", "tie"), ("showcase48", "far"), ("cards", "far")])
def test_widened_gate_keeps_every_candidate(request, scene, rays):
    sc = request.getfixturevalue(scene)
    assert _dropped(sc, rays, True) == 0


def test_unwidened_gate_drops_grazing_candidates(cards):
    """Why the kernels widen the boxes: on the exact boxes the rounded slab
    test misses candidates of rays aimed at the cards' vertices and edges
    where they lie on a group's box (hundreds of them on these rays)."""
    assert _dropped(cards, "aimed", False) > 100


def test_unwidened_gate_drops_far_candidates(cards):
    """The same from a far camera: rays from 10^2 to 10^3 group extents
    away lose hundreds of candidates on the exact boxes and intervals."""
    assert _dropped(cards, "far", False) > 100


def _list(t_mat, t_lo, k):
    """The kernels' sorted list: per lane the k smallest distinct t >
    t_lo of the gated candidate matrix, each with the lowest column that
    reaches it (what ascending columns and khit.cu's insertion rule keep),
    +inf and -1 past the end: ([N, KMAX] t, [N, KMAX] col, [N] count)."""
    m = torch.where(t_mat > t_lo[:, None], t_mat, float("inf"))
    srt, col = torch.sort(m, dim=1, stable=True)  # equal t: lowest column
    first = torch.ones_like(srt, dtype=torch.bool)
    first[:, 1:] = srt[:, 1:] != srt[:, :-1]
    first &= torch.isfinite(srt)
    rank = torch.cumsum(first.long(), dim=1) - 1
    keep = first & (rank < k)
    kt = torch.full((m.shape[0], KMAX), float("inf"))
    kc = torch.full((m.shape[0], KMAX), -1, dtype=torch.long)
    lane, pos = keep.nonzero(as_tuple=True)
    kt[lane, rank[lane, pos]] = srt[lane, pos]
    kc[lane, rank[lane, pos]] = col[lane, pos]
    return kt, kc, keep.sum(dim=1)


def _list_walk(t_mat, walking, t_prev, cap, step):
    """Steps through each walking lane's list, refilled from its last t
    when it uses all K and walks on; ``step(k, t, col, lanes)`` returns
    which of ``lanes`` walk on. Returns (walking, t_prev)."""
    k_list = max(1, min(cap, KMAX))
    kt, kc, n = _list(t_mat, t_prev, k_list)
    walking = walking & (n > 0)
    pos = torch.zeros_like(n)
    for k in range(cap):
        if not bool(walking.any()):
            break
        out = walking & (pos == n)
        walking &= ~(out & (n < k_list))
        refill = out & (n == k_list)
        if bool(refill.any()):
            kt2, kc2, n2 = _list(t_mat, t_prev, k_list)
            kt = torch.where(refill[:, None], kt2, kt)
            kc = torch.where(refill[:, None], kc2, kc)
            n = torch.where(refill, n2, n)
            pos = torch.where(refill, 0, pos)
            walking &= ~(refill & (n2 == 0))
        idx = torch.clamp(pos, max=KMAX - 1)[:, None]
        t, col = kt.gather(1, idx)[:, 0], kc.gather(1, idx)[:, 0]
        on = step(k, t, torch.clamp(col, min=0), walking)
        t_prev = torch.where(walking & on, t, t_prev)
        pos = torch.where(walking, pos + 1, pos)
        walking = walking & on
    return walking, t_prev


def _gated_eval(sc, o, d, t_hi):
    from path_tracer_torch.ops.trwalk import _eval_cols

    t, u, v, dn = _eval_cols(o, d, t_hi, sc.tr_bw)
    gate = _columns_gate(sc, o, d, t_hi, True)
    return torch.where(gate, t, float("inf")), u, v, dn


def alpha_list_walk(sc, o, d, t_op, rnd, cap):
    from path_tracer_torch.ops.trwalk import (
        ALPHA_MIN_OPACITY,
        AlphaWalk,
        _pick,
        texel,
    )

    rows = sc.tr_rows
    t_hi = torch.where(t_op < 0.0, -1.0, t_op)
    t_mat, u_mat, v_mat, dn_mat = _gated_eval(sc, o, d, t_hi)
    n = o.shape[0]
    sel = dict(t=torch.full((n,), float("inf")), u=torch.zeros(n),
               v=torch.zeros(n), dn=torch.zeros(n),
               col=torch.full((n,), -1, dtype=torch.long),
               seen=torch.zeros(n, dtype=torch.bool))
    accepted = torch.zeros(n, dtype=torch.bool)

    def step(k, t, col, lanes):
        nonlocal accepted
        u, v = _pick(u_mat, col), _pick(v_mat, col)
        fac = rows[6][col]
        op = fac
        if sc.tr_textured:
            uvx = rows[0][col] + u * rows[2][col] + v * rows[4][col]
            uvy = rows[1][col] + u * rows[3][col] + v * rows[5][col]
            tex = texel(sc, uvx, uvy, rows[8][col].long())
            op = torch.where(rows[7][col] > 0.0, tex * fac, fac)
        accept = (op >= 1.0) | ((op > ALPHA_MIN_OPACITY) & (rnd[k] < op))
        for key, x in (("t", t), ("u", u), ("v", v),
                       ("dn", _pick(dn_mat, col)), ("col", col)):
            sel[key] = torch.where(lanes, x, sel[key])
        sel["seen"] |= lanes
        accepted |= lanes & accept
        return ~accept

    still, t_prev = _list_walk(t_mat, t_op >= 0.0, torch.full((n,), -1.0),
                               cap, step)
    return AlphaWalk(sel["t"], sel["u"], sel["v"], sel["dn"], sel["seen"],
                     accepted, still, t_prev, sel["col"].to(torch.int32))


def trans_list_walk(sc, o, d, pd, is_pt, surf_pos, orig_uv, orig_simple,
                    walking0, cap):
    from path_tracer_torch.ops.trwalk import TransWalk, _pick, texel

    rows = sc.tr_rows
    pd = torch.where(walking0, pd, -1.0)
    live = pd >= 0.0
    t_mat, u_mat, v_mat, _ = _gated_eval(
        sc, o, d, torch.where(live, float("inf"), -1.0))
    n, n_cols = t_mat.shape
    loop = live & ~is_pt if sc.tr_textured else torch.zeros_like(live)
    dense = live & ~loop
    # Point lanes: the cut pass, then the product pass in ascending column
    # order over the gated candidates.
    finite = torch.isfinite(t_mat)
    tc = torch.where(finite, t_mat, 0.0)
    oc3 = [o[:, k:k + 1] + tc * d[:, k:k + 1] - surf_pos[:, k:k + 1]
           for k in range(3)]
    occ = torch.sqrt(oc3[0] * oc3[0] + oc3[1] * oc3[1] + oc3[2] * oc3[2])
    behind = finite & is_pt[:, None] & (occ > pd[:, None])
    cut = torch.where(behind, t_mat, float("inf")).amin(dim=1)
    trans = torch.ones(n)
    for c in range(n_cols):
        inc = dense & finite[:, c] & (t_mat[:, c] < cut)
        if not bool(inc.any()):
            continue
        fac = rows[6][c].expand(n)
        op = fac
        if sc.tr_textured and bool(rows[7][c] > 0.0):
            tex = texel(sc, orig_uv[:, 0], orig_uv[:, 1],
                        rows[8][c].long().expand(n))
            op = torch.where(orig_simple, fac, tex * fac)
        trans = torch.where(inc, trans * (1.0 - op), trans)

    def step(k, t, col, lanes):
        nonlocal trans
        u, v = _pick(u_mat, col), _pick(v_mat, col)
        fac = rows[6][col]
        uvx = rows[0][col] + u * rows[2][col] + v * rows[4][col]
        uvy = rows[1][col] + u * rows[3][col] + v * rows[5][col]
        tex = texel(sc, uvx, uvy, rows[8][col].long())
        op = torch.where(rows[7][col] <= 0.0, fac, tex * fac)
        trans = torch.where(lanes, trans * (1.0 - op), trans)
        return trans != 0.0

    still, t_prev = _list_walk(t_mat, loop, torch.full((n,), -1.0), cap,
                               step)
    return TransWalk(trans, t_prev, still)


def _tie_lanes(sc, seed, r):
    """Tie rays from above through every layer of the card scene, or
    foliage rays on showcase48."""
    from path_tracer_torch.scene.procedural import tie_rays

    if sc.tr_bw.shape[1] > 2048:  # the card scene
        o, d = tie_rays(r, seed=seed)
        return o, d, np.random.default_rng(seed)
    return _foliage_rays(sc, seed, r)


def _past_the_list(sc, o, d, t_prev) -> bool:
    """Did some lane walk past its KMAX-th distinct candidate (a
    refill)?"""
    from path_tracer_torch.ops.trwalk import _eval_cols

    inf = torch.full((o.shape[0],), float("inf"))
    kt = _list(_eval_cols(o, d, inf, sc.tr_bw)[0], -inf, KMAX)[0]
    return bool((t_prev > kt[:, KMAX - 1]).any())


def _same(got, want):
    for f in got._fields:
        a, b = getattr(got, f), getattr(want, f)
        assert torch.equal(a, b), f


@pytest.mark.parametrize("cap", [0, 1, 8, 12])
@pytest.mark.parametrize("scene", ["cards", "showcase48"])
def test_alpha_list_walk_equals_plain(request, scene, cap):
    from path_tracer_torch.ops.trwalk import _eval_cols, alpha_walk_plain

    sc = request.getfixturevalue(scene)
    o, d, g = _tie_lanes(sc, 24, R)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    # t_op: past every layer, at a lane's first candidate, random, dead.
    first = _eval_cols(o, d, torch.full((R,), float("inf")),
                       sc.tr_bw)[0].amin(dim=1)
    t_op = torch.from_numpy(g.uniform(0.5, 8.0, R).astype(np.float32))
    t_op[::3] = float("inf")
    t_op[1::3] = torch.where(torch.isfinite(first), first, 2.0)[1::3]
    t_op[::7] = -1.0
    rnd = torch.from_numpy(g.uniform(size=(max(cap, 1), R)).astype(
        np.float32))
    rnd[:, ::2] = 0.95  # above every card's opacity: no accept
    got = alpha_list_walk(sc, o, d, t_op, rnd, cap)
    _same(got, alpha_walk_plain(sc, o, d, t_op, rnd, cap))
    if cap:
        assert got.seen.float().mean() > 0.1 and not got.seen[::7].any()
    if scene == "cards" and cap:
        assert _past_the_list(sc, o, d, got.t_prev) == (cap > KMAX)


@pytest.mark.parametrize("cap", [0, 1, 8, 12])
@pytest.mark.parametrize("scene", ["cards", "showcase48"])
def test_trans_list_walk_equals_plain(request, scene, cap):
    """Stacked lanes: a directional light, then point lights at random
    distances (some in front of the cards), sphere originals and idle
    lanes mixed in."""
    from path_tracer_torch.ops.trwalk import trans_walk_plain

    sc = request.getfixturevalue(scene)
    o, d, g = _tie_lanes(sc, 25, R)
    o3 = np.tile(o, (3, 1))
    d3 = np.tile(d, (3, 1))
    pd = np.concatenate([np.full(R, np.inf), g.uniform(0.5, 9.0, 2 * R)])
    t = lambda x, dt=np.float32: torch.from_numpy(np.asarray(x, dt))
    args = (t(o3), t(d3), t(pd), t(np.arange(3 * R) >= R, bool), t(o3),
            t(g.uniform(-1.0, 2.0, (3 * R, 2))),
            t(g.uniform(size=3 * R) < 0.2, bool),
            t(g.uniform(size=3 * R) > 0.1, bool))
    got = trans_list_walk(sc, *args, cap)
    _same(got, trans_walk_plain(sc, *args, cap))
    assert (got.trans < 1.0).float().mean() > 0.02
    if scene == "cards" and cap:
        assert _past_the_list(sc, args[0], args[1], got.t_prev) == (
            cap > KMAX)


KHIT_K = 6  # the dense route's K


def _khit_off(sc, o, d) -> list:
    """Lanes where row 3's plain producer differs, within t_max, from the
    ungated producer (every group box at +-1e30: brute-force MT over all
    columns), at t_max = +inf, the ungated first hit, and an ulp below and
    above it: an entry with t <= t_max missing, added, or at another t or
    column."""
    from path_tracer_torch.ops.cuda_khit import k_nearest_tr_hits_plain

    o, d = torch.from_numpy(o), torch.from_numpy(d)
    inf = torch.full((o.shape[0],), float("inf"))
    everywhere = sc.khit_gbox.clone()
    everywhere[0:3], everywhere[3:6] = -1e30, 1e30
    want_t, want_c = k_nearest_tr_hits_plain(o, d, inf, sc.khit_tris,
                                             everywhere, KHIT_K)
    first = want_t[0]
    off = []
    for t_max in (inf, first, torch.nextafter(first, torch.tensor(-1.0)),
                  torch.nextafter(first, inf)):
        got_t, got_c = k_nearest_tr_hits_plain(o, d, t_max, sc.khit_tris,
                                               sc.khit_gbox, KHIT_K,
                                               sc.khit_sbox)
        w_in, g_in = want_t <= t_max, got_t <= t_max
        bad = (w_in != g_in) | (w_in & ((got_t != want_t)
                                        | (got_c != want_c)))
        off.append(int(bad.any(0).sum()))
    return off


def _khit_rays(sc, rays: str):
    if rays == "aimed":
        return _aimed_rays(sc, 23, R)
    if rays == "far":
        return _far_rays(sc, 26, R)
    if rays == "tie":
        return _tie_lanes(sc, 5, R)[:2]
    return _foliage_rays(sc, 7, R)[:2]


@pytest.mark.parametrize("rays", ["aimed", "far", "tie", "foliage"])
@pytest.mark.parametrize("scene", ["cards", "showcase48"])
def test_khit_gate_keeps_every_hit_within_t_max(request, scene, rays):
    """Row 3's widened group gate loses no hit of the ungated producer
    within t_max, on any lane, at any of the four t_max."""
    sc = request.getfixturevalue(scene)
    assert _khit_off(sc, *_khit_rays(sc, rays)) == [0, 0, 0, 0]


def test_khit_exact_gate_drops_hits(cards, monkeypatch):
    """Why row 3 widens its gate: on the exact group boxes and intervals a
    lane's own rounded slab test rejects the group holding a hit its MT
    test finds, on rays aimed at the cards' vertices, edges and box faces
    and on rays from far away."""
    from path_tracer_torch.ops import slab

    for name in ("BOX_PAD_EXT", "BOX_PAD_MAG", "BOX_PAD_T"):
        monkeypatch.setattr(slab, name, 0.0)
    for rays in ("aimed", "far"):
        off = _khit_off(cards, *_khit_rays(cards, rays))
        assert max(off) > 0, (rays, off)
