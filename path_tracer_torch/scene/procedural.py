"""Procedural scenes built in code, file-free.

Port of ``path_tracer_tpu/scene/procedural.py``: the Cornell-style box
(``cornell_scene``: coloured walls, a mirror and a diffuse sphere, one
point light; what ``examples/torch_inverse_rendering.py`` fits) and the
sphere grid: an n x n grid of analytic spheres varying metalness along
one axis and roughness along the other, lit by two point lights.
``sphere_grid_scene(70)`` (4,900 spheres) takes the sphere block walk, as
it does in the JAX package.

``duplicate_sphere_scene`` and ``sphere_tie_rays`` are the tie-rule
check of the sphere block walk: a few spheres each listed 150 times, so
each one's copies fill two blocks with one AABB, and rays aimed at their
centres, silhouettes and the points where they touch their blocks' faces.
``duplicate_sphere_device_scene(margin=...)`` grows each sphere's later
block so that a nearest-first walk meets the higher-slot copy first.
``duplicate_grid_scene`` and ``tie_rays`` are the tie-rule check of the
closest-hit casts: a mesh whose every triangle is listed twice, and rays
aimed at triangle centres, shared edges and vertices.
``duplicate_card_scene`` is the same mesh as transparent cards, the
tie-rule check of the transparent walks.
"""
from __future__ import annotations

import math

from path_tracer_torch.scene import isf


def _quad(a, b, c, d, normal):
    """Two triangles for the quad a-b-c-d (counter-clockwise), uv 0-1."""

    def vert(p, uv):
        return isf.Vertex(position=tuple(p), normal=tuple(normal),
                          tex_coords=uv)

    return [
        (vert(a, (0.0, 0.0)), vert(b, (1.0, 0.0)), vert(c, (1.0, 1.0))),
        (vert(a, (0.0, 0.0)), vert(c, (1.0, 1.0)), vert(d, (0.0, 1.0))),
    ]


def _mat(albedo=(1.0, 1.0, 1.0), emissive=(0.0, 0.0, 0.0), opacity=1.0,
         metalness=0.0, roughness=1.0) -> isf.Material:
    return isf.Material(
        albedo=isf.Channel3(factor=albedo),
        emissive=isf.Channel3(factor=emissive),
        opacity=isf.Channel1(factor=opacity),
        metalness=isf.Channel1(factor=metalness),
        roughness=isf.Channel1(factor=roughness),
    )


def _camera(pos=(0.0, 1.0, 3.2), fov_deg=60.0) -> isf.Camera:
    """Identity rotation looking down -z, translated to ``pos`` (ISF's
    column-major matrix: transform[3] is the translation column)."""
    t = [
        [1.0, 0.0, 0.0, 0.0],
        [0.0, 1.0, 0.0, 0.0],
        [0.0, 0.0, 1.0, 0.0],
        [float(pos[0]), float(pos[1]), float(pos[2]), 1.0],
    ]
    return isf.Camera(transform=t, fov=math.radians(fov_deg), zfar=100.0,
                      znear=0.01)


def cornell_scene() -> isf.Scene:
    """Cornell-style box: coloured walls, two spheres, one point light."""
    s = 1.5  # half-extent
    tris = []
    # floor (y=0), ceiling (y=2s), back wall (z=-s)
    tris += _quad((-s, 0, s), (s, 0, s), (s, 0, -s), (-s, 0, -s), (0, 1, 0))
    tris += _quad((-s, 2 * s, -s), (s, 2 * s, -s), (s, 2 * s, s),
                  (-s, 2 * s, s), (0, -1, 0))
    tris += _quad((-s, 0, -s), (s, 0, -s), (s, 2 * s, -s), (-s, 2 * s, -s),
                  (0, 0, 1))
    white = isf.Mesh(triangles=tris, material=_mat(albedo=(0.73, 0.73, 0.73)))
    left = isf.Mesh(
        triangles=_quad((-s, 0, s), (-s, 0, -s), (-s, 2 * s, -s),
                        (-s, 2 * s, s), (1, 0, 0)),
        material=_mat(albedo=(0.65, 0.05, 0.05)))
    right = isf.Mesh(
        triangles=_quad((s, 0, -s), (s, 0, s), (s, 2 * s, s), (s, 2 * s, -s),
                        (-1, 0, 0)),
        material=_mat(albedo=(0.12, 0.45, 0.15)))
    mirror = isf.Sphere(radius=0.5, center=(-0.55, 0.5, -0.4),
                        material=_mat(albedo=(0.9, 0.9, 0.9), metalness=1.0,
                                      roughness=0.05))
    diffuse = isf.Sphere(radius=0.45, center=(0.6, 0.45, 0.3),
                         material=_mat(albedo=(0.7, 0.6, 0.2), roughness=0.6))
    light = isf.PointLight(position=(0.0, 2.6, 0.5),
                           color=(120.0, 120.0, 120.0))
    return isf.Scene(models=[white, left, right, mirror, diffuse],
                     camera=_camera(), lights=[light],
                     background=(0.0, 0.0, 0.0))


def cornell_device_scene(device="cuda"):
    """``cornell_scene`` built on ``device``."""
    from path_tracer_torch.scene.device_scene import build_scene

    return build_scene(cornell_scene(), root=".", device=device)


def sphere_grid_scene(n: int = 5) -> isf.Scene:
    """n x n analytic-sphere metalness x roughness grid with two point
    lights, the shape of the reference's ``spheres`` scene."""
    models = []
    for i in range(n):
        for j in range(n):
            metal = i / max(1, n - 1)
            rough = max(0.05, j / max(1, n - 1))
            models.append(
                isf.Sphere(
                    radius=0.4,
                    center=(1.1 * (i - (n - 1) / 2), 1.1 * (j - (n - 1) / 2),
                            0.0),
                    material=_mat(albedo=(0.8, 0.3, 0.3), metalness=metal,
                                  roughness=rough),
                )
            )
    lights = [
        isf.PointLight(position=(3.0, 3.0, 4.0), color=(400.0, 400.0, 400.0)),
        isf.PointLight(position=(-3.0, -3.0, 4.0), color=(200.0, 200.0, 250.0)),
    ]
    return isf.Scene(models=models, camera=_camera(pos=(0.0, 0.0, 7.0)),
                     lights=lights, background=(0.05, 0.05, 0.08))


def sphere_grid_device_scene(n: int = 5, device="cuda"):
    """``sphere_grid_scene(n)`` built on ``device``."""
    from path_tracer_torch.scene.device_scene import build_scene

    return build_scene(sphere_grid_scene(n), root=".", device=device)


# duplicate_sphere_scene's spheres: (center, radius), each listed
# DUPLICATE_SPHERE_COPIES times in a row.
DUPLICATE_SPHERES = (((-2.5, 0.0, 0.0), 1.0), ((2.5, 0.0, 0.0), 0.6),
                     ((0.0, 2.5, 0.5), 0.8), ((0.0, -2.5, -0.5), 1.2))
DUPLICATE_SPHERE_COPIES = 150


def duplicate_sphere_scene() -> isf.Scene:
    """Four spheres, each listed DUPLICATE_SPHERE_COPIES times in a row
    (600 in all: the sphere block walk). Copies give bit-identical roots,
    so only the tie rule decides between them: the lowest sorted slot. The
    BVH build cannot split equal centroids and halves each run of copies,
    so every sphere's copies fill two 128-slot blocks of one AABB."""
    models = [isf.Sphere(radius=r, center=c,
                         material=_mat(albedo=(0.3 + 0.15 * k, 0.5, 0.6)))
              for k, (c, r) in enumerate(DUPLICATE_SPHERES)
              for _ in range(DUPLICATE_SPHERE_COPIES)]
    return isf.Scene(
        models=models, camera=_camera(pos=(0.0, 0.0, 9.0)),
        lights=[isf.PointLight(position=(0.0, 5.0, 5.0),
                               color=(100.0, 100.0, 100.0))],
        background=(0.1, 0.1, 0.1))


def duplicate_sphere_device_scene(device="cuda", margin: float = 0.0):
    """``duplicate_sphere_scene()`` built on ``device``. With ``margin`` > 0
    the AABB of each sphere's later block (its higher sorted slots) grows
    by ``margin`` on every side. That block's slab entry then comes before
    the earlier block's along every ray, so a walk that visits the nearest
    entry first finds the higher-slot copy first, and reaches the
    lower-slot copy only if its cut at the lane's best t admits the
    earlier block, whose tight entry a root may round past. A grown box
    still holds its spheres: the tables stay a valid walk input."""
    import dataclasses

    from path_tracer_torch.scene.device_scene import build_scene

    sc = build_scene(duplicate_sphere_scene(), root=".", device=device)
    if margin <= 0.0:
        return sc
    n_blk = int((sc.sph_blkid[0] >= 0).sum())
    sphere = (sc.sph_smap.view(-1, 128)[:n_blk, 0]
              // DUPLICATE_SPHERE_COPIES).tolist()
    blk = sc.sph_blk.clone()
    for b, s in enumerate(sphere):
        if s in sphere[:b]:
            blk[0:3, b] -= margin
            blk[3:6, b] += margin
    return dataclasses.replace(sc, sph_blk=blk)


def sphere_tie_rays(r: int, seed: int = 0):
    """(o, d) float32 numpy [r, 3]: rays from up to 9 units around the
    origin aimed, in equal shares, at the centre of a random sphere of
    ``duplicate_sphere_scene``, at a grazing point of its silhouette (1e-4
    of the radius or less inside it), at a point where it touches the face
    of its AABB (its centre plus or minus the radius along one axis), and
    at a point of that face's plane near the touching point."""
    import numpy as np

    g = np.random.default_rng(seed)
    c = np.array([x for x, _ in DUPLICATE_SPHERES], np.float64)
    rad = np.array([x for _, x in DUPLICATE_SPHERES], np.float64)
    k = g.integers(0, len(rad), r)
    o = g.normal(size=(r, 3))
    o *= (g.uniform(4.0, 9.0, r) / np.linalg.norm(o, axis=1))[:, None]
    tgt = c[k].copy()
    q = r // 4
    # Silhouette: off the centre, perpendicular to the view, just inside.
    view = c[k] - o
    view /= np.linalg.norm(view, axis=1, keepdims=True)
    side = np.cross(view, g.normal(size=(r, 3)))
    side /= np.linalg.norm(side, axis=1, keepdims=True)
    graze = rad[k] * (1.0 - g.uniform(0.0, 1e-4, r))
    tgt[q:2 * q] += (graze[:, None] * side)[q:2 * q]
    # The touching points of the AABB's faces, and near them on the face.
    axis = g.integers(0, 3, r)
    sign = np.where(g.integers(0, 2, r) == 1, 1.0, -1.0)
    touch = c[k].copy()
    touch[np.arange(r), axis] += sign * rad[k]
    tgt[2 * q:3 * q] = touch[2 * q:3 * q]
    near = touch + g.uniform(-0.05, 0.05, (r, 3)) * rad[k, None]
    near[np.arange(r), axis] = touch[np.arange(r), axis]
    tgt[3 * q:] = near[3 * q:]
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _grid_point(i: int, j: int, n: int) -> tuple:
    """Vertex (i, j) of ``duplicate_grid_scene``'s n x n grid: unit cells
    centred on the origin in x and z, a gentle bump in y."""
    return (float(i - n / 2), 0.1 * math.sin(i) * math.cos(0.7 * j),
            float(j - n / 2))


def duplicate_grid_scene(n: int = 8, stack: int = 300) -> isf.Scene:
    """An n x n grid of quads (2 n^2 triangles), each triangle listed twice
    in a row, then ``stack`` more copies of the first triangle. Identical
    rows give bit-identical t, so only the tie rule decides between copies:
    the lower index (brute force) or packed slot (block walks). A pair has
    one centroid, so the BVH build mostly keeps it in one block; a stack
    longer than a block must be split across blocks."""
    verts = [[isf.Vertex(position=_grid_point(i, j, n), normal=(0.0, 1.0, 0.0),
                         tex_coords=(i / n, j / n))
              for j in range(n + 1)] for i in range(n + 1)]
    tris = []
    for i in range(n):
        for j in range(n):
            v00, v10 = verts[i][j], verts[i + 1][j]
            v01, v11 = verts[i][j + 1], verts[i + 1][j + 1]
            for tri in ((v00, v11, v10), (v00, v01, v11)):
                tris += [tri, tri]
    tris += [tris[0]] * stack
    return isf.Scene(
        models=[isf.Mesh(triangles=tris, material=_mat(albedo=(0.7, 0.7,
                                                              0.7)))],
        camera=_camera(pos=(0.0, 6.0, n)),
        lights=[isf.PointLight(position=(0.0, 5.0, 0.0),
                               color=(100.0, 100.0, 100.0))],
        background=(0.1, 0.1, 0.1))


def duplicate_card_scene() -> isf.Scene:
    """``duplicate_grid_scene``'s triangles as transparent cards over an
    opaque floor one unit below them: the grid's pairs cut out by the
    textured showcase's ``leaf_alpha.png`` (factor 0.9, so no card is
    opaque), repeated in 12 layers 0.2 apart upward (more than the walk
    kernels' list of 8), and 300 copies of the first triangle half
    transparent by their factor alone: 3,372 transparent triangles. Copies
    give bit-identical t, so the transparent walks' tie rule (the lowest
    compact column) picks the copy and its opacity, and their strict
    t > t_prev advance visits an equal t once; a ray from ``tie_rays``
    crosses every layer. Build it with the showcase textures' directory as
    its root (``duplicate_card_device_scene``)."""
    n, stack, layers = 8, 300, 12
    grid = duplicate_grid_scene(n, 0)

    def lift(vx, dy):
        return isf.Vertex(position=(vx.position[0], vx.position[1] + dy,
                                    vx.position[2]),
                          normal=vx.normal, tex_coords=vx.tex_coords)

    base = grid.models[0].triangles
    tris = [tuple(lift(vx, 0.2 * k) for vx in tri)
            for k in range(layers) for tri in base]
    leaf = isf.Material(
        albedo=isf.Channel3(factor=(0.4, 0.7, 0.3)),
        emissive=isf.Channel3(factor=(0.0, 0.0, 0.0)),
        opacity=isf.Channel1(factor=0.9, texture="leaf_alpha.png"),
        metalness=isf.Channel1(factor=0.0),
        roughness=isf.Channel1(factor=0.9))
    h = n / 2 + 1.0
    fl = [isf.Vertex(position=(x, -1.0, z), normal=(0.0, 1.0, 0.0),
                     tex_coords=(0.0, 0.0))
          for x, z in ((-h, -h), (h, -h), (h, h), (-h, h))]
    return isf.Scene(
        models=[isf.Mesh(triangles=[(fl[0], fl[2], fl[1]),
                                    (fl[0], fl[3], fl[2])],
                         material=_mat(albedo=(0.7, 0.7, 0.7))),
                isf.Mesh(triangles=tris, material=leaf),
                isf.Mesh(triangles=[base[0]] * stack,
                         material=_mat(albedo=(0.3, 0.3, 0.8),
                                       opacity=0.5))],
        camera=grid.camera, lights=grid.lights + [isf.DirectionalLight(
            direction=(0.2, -1.0, 0.1), color=(2.0, 2.0, 2.0))],
        background=grid.background)


def duplicate_card_device_scene(device):
    """``duplicate_card_scene()`` built on ``device`` over the BVH in
    128-slot blocks (opaque floor and transparent cards partitioned;
    textures generated on first use)."""
    from path_tracer_torch.scene.device_scene import build_scene
    from path_tracer_torch.scene.showcase import (
        default_texture_dir,
        generate_showcase_textures,
    )

    root = default_texture_dir()
    generate_showcase_textures(root)
    return build_scene(duplicate_card_scene(), root, device,
                       use_bvh=True, sl_block=128)


def tie_rays(r: int, n: int = 8, seed: int = 0):
    """(o, d) float32 numpy [r, 3]: rays from 3 units above, slightly
    tilted, aimed in equal shares at the centroids of random triangles of
    ``duplicate_grid_scene(n)``, at the stacked triangle's centroid, at the
    midpoints of shared edges (quad diagonals and cell sides) and at
    interior grid vertices."""
    import numpy as np

    g = np.random.default_rng(seed)
    p = np.array([[_grid_point(i, j, n) for j in range(n + 1)]
                  for i in range(n + 1)])
    k = r // 4
    i, j = g.integers(0, n, (2, r))
    ii, jj = g.integers(1, n, (2, r))  # interior vertices
    upper = g.integers(0, 2, r).astype(bool)
    far = np.where(upper[:, None], p[i, j + 1], p[i + 1, j])
    tgt = (p[i, j] + p[i + 1, j + 1] + far) / 3.0  # a cell's triangle
    tgt[k:2 * k] = (p[0, 0] + p[1, 1] + p[1, 0]) / 3.0  # the stack
    side = np.where(upper[:, None], p[ii, j + 1], p[i + 1, jj])
    diag = 0.5 * (p[i, j] + p[i + 1, j + 1])
    edge = np.where(g.integers(0, 2, (r, 1)).astype(bool), diag,
                    0.5 * (p[ii, j] + side))
    tgt[2 * k:3 * k] = edge[2 * k:3 * k]
    tgt[3 * k:] = p[ii, jj][3 * k:]
    o = tgt + np.stack([g.uniform(-0.3, 0.3, r), np.full(r, 3.0),
                        g.uniform(-0.3, 0.3, r)], axis=1)
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def tie_winners(scene):
    """For each real triangle of a built scene, the copy the tie rule picks
    among the triangles identical to it (equal v0, e1, e2 rows): (by lowest
    index, the brute-force rule; by lowest packed slot, the block walks'
    rule, None without the BVH), int64 numpy arrays [T] of triangle ids."""
    import numpy as np

    n = scene.num_real_triangles
    rows = np.concatenate([x[:n].cpu().numpy() for x in (
        scene.tri_v0, scene.tri_e1, scene.tri_e2)], axis=1)
    inv = np.unique(rows, axis=0, return_inverse=True)[1].ravel()
    first = np.full(inv.max() + 1, n)
    np.minimum.at(first, inv, np.arange(n))
    if not scene.use_bvh:
        return first[inv], None
    slot = scene.sl_inv[:n].cpu().numpy().astype(np.int64)
    low = np.full(inv.max() + 1, np.iinfo(np.int64).max)
    np.minimum.at(low, inv, slot)
    return first[inv], scene.sl_map.cpu().numpy()[low[inv]].astype(np.int64)
