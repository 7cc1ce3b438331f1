"""The plain reference path tracer, for checking what a timed render made.

Plain PyTorch, written from the renderer's specification (the Rust
reference's semantics, as ``path_tracer_torch/models/integrator.py``'s
docstring lists them), sharing no code with the program: it builds
nothing the program builds (no BVH, no tables, no atlas rows) and tests
every ray against every triangle and sphere. It imports neither the
program nor JAX. It traces chosen (pixel, sample id) paths of a raw scene
(``benchmark/scenes``'s ``RawScene``) in float32, or in the ``dtype``
it is given (the control: bfloat16), and returns each path's radiance.

Semantics, per bounce (``bounces`` + 1 of them):

- camera ray with the pixel jittered by two uniforms (sites 0, 1);
- the stochastic alpha walk: hits in distance order (t > the last one),
  a hit accepted when op >= 1 or (op > 0.001 and u < op), u the uniform
  of site 2 + k + stride * bounce at step k; no accepted hit: the last
  hit visited shades; no hit at all: background, the path ends;
- the shading point: barycentric vertex normal (not normalised), normal
  map through the UV tangent frame, backface flip; spheres shade with
  their factors and their outward (far root: inward) normal;
- emission added, then each light (directional ones first, their raw
  direction): the transmittance walk along the shadow ray from the point
  lifted by 1e-5 along the unflipped normal, trans *= 1 - op over every
  occluder in distance order until 0; a point light's walk stops at the
  first occluder farther from the point than the light and samples its
  opacity at the shaded hit's uv and kind; point radiance
  colour / (4 pi r^2); Cook-Torrance (GGX, Smith-Schlick, Schlick
  Fresnel) plus the emissive term, added where the light's radiance is
  not zero;
- the bounce: GGX-sampled microfacet normal (two uniforms), reflected
  view, throughput *= the sample's weight; the path ends past the last
  bounce or when |T|^2 < 1e-5; Russian roulette after bounce 3.

Every intersection is brute force: Moller-Trumbore (|det| >= 1e-6,
1e-6 <= t, u, v >= 0, u + v <= 1) and the centred sphere quadratic (a
root counts from t >= 0), the nearest hit past t_prev winning, ties to
the lower index and to the triangle over the sphere.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import rng

PI = 3.14159265358979323846
NORMAL_BIAS = 1e-5
DET_EPS = 1e-6
T_MIN = 1e-6
ALPHA_MIN = 0.001
# Ray x triangle elements per intersection block: bounds the block's
# [rays, triangles] temporaries (about 20 of them) to a few GB.
BLOCK_ELEMS = 1 << 25


class RefScene:
    """A raw scene as flat tensors on ``device`` in ``dtype``."""

    def __init__(self, raw, device, dtype=torch.float32):
        self.device, self.dtype = device, dtype
        f = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                      device=device).to(dtype)
        meshes = [(i, m) for i, m in enumerate(raw.models)
                  if not hasattr(m, "radius")]
        spheres = [(i, m) for i, m in enumerate(raw.models)
                   if hasattr(m, "radius")]
        pos = np.concatenate([m.pos for _, m in meshes]).astype(np.float32)
        nrm = np.concatenate([m.nrm for _, m in meshes]).astype(np.float32)
        uv = np.concatenate([m.uv for _, m in meshes]).astype(np.float32)
        self.n_tri = pos.shape[0]
        v0, v1, v2 = pos[:, 0], pos[:, 1], pos[:, 2]
        e1, e2 = v1 - v0, v2 - v0
        self.v0, self.e1, self.e2 = f(v0), f(e1), f(e2)
        self.n = [f(nrm[:, k]) for k in range(3)]
        self.uv = [f(uv[:, k]) for k in range(3)]
        # Tangent from the UV deltas (0 where they are degenerate).
        du1, du2 = uv[:, 1] - uv[:, 0], uv[:, 2] - uv[:, 0]
        with np.errstate(divide="ignore", invalid="ignore"):
            inv = 1.0 / (du1[:, 0] * du2[:, 1] - du2[:, 0] * du1[:, 1])
            tan = inv[:, None] * (du2[:, 1:2] * e1 - du1[:, 1:2] * e2)
            tan = tan / np.sqrt((tan * tan).sum(-1, keepdims=True))
        self.tangent = f(np.where(np.isfinite(tan), tan, 0.0))
        self.tri_model = torch.as_tensor(np.concatenate(
            [np.full(m.pos.shape[0], i) for i, m in meshes]),
            device=device, dtype=torch.long)
        self.n_sph = len(spheres)
        self.sph_c = f([m.center for _, m in spheres]).reshape(-1, 3)
        self.sph_r = f([m.radius for _, m in spheres])
        self.sph_model = torch.as_tensor([i for i, _ in spheres],
                                         device=device, dtype=torch.long)

        # Materials, one row per model; textures in one flat texel list.
        names = sorted(raw.textures)
        texels, offs, dims = [np.zeros((1, 3), np.float32)], [], []
        at = 1
        for name in names:
            t = raw.textures[name].astype(np.float32) / 255.0
            if t.ndim == 2:
                t = np.repeat(t[:, :, None], 3, axis=2)
            offs.append(at)
            dims.append(t.shape[:2])
            texels.append(t.reshape(-1, 3))
            at += t.shape[0] * t.shape[1]
        self.texels = f(np.concatenate(texels))
        tid = {n: i for i, n in enumerate(names)}
        mats = [m.material for m in raw.models]
        get = lambda key: [getattr(m, key) for m in mats]
        self.albedo_f = f(get("albedo")).reshape(-1, 3)
        self.emissive_f = f(get("emissive")).reshape(-1, 3)
        self.opacity_f, self.metal_f, self.rough_f = (
            f(get(k)) for k in ("opacity", "metalness", "roughness"))
        self.tex = {}
        for ch in ("albedo", "emissive", "opacity", "metalness", "roughness",
                   "normal"):
            ids = [tid[n] if n is not None else -1 for n in get(ch + "_tex")]
            if all(i < 0 for i in ids):
                continue
            off = [offs[i] if i >= 0 else 0 for i in ids]
            w = [dims[i][1] if i >= 0 else 1 for i in ids]
            h = [dims[i][0] if i >= 0 else 1 for i in ids]
            self.tex[ch] = tuple(torch.as_tensor(x, device=device)
                                 for x in (ids, off, w, h))
        self.emissive_any = any(tuple(m.emissive) != (0.0, 0.0, 0.0)
                                or m.emissive_tex is not None for m in mats)

        self.dir_d = [f(d) for d, _ in raw.dir_lights]
        self.dir_c = [f(c) for _, c in raw.dir_lights]
        self.pt_p = [f(p) for p, _ in raw.point_lights]
        self.pt_c = [f(c) for _, c in raw.point_lights]
        self.cam = f(raw.cam_transform).T  # row-major
        self.fov = f(raw.fov)
        self.background = f(raw.background)
        self.alpha_steps = transparent_hits(raw) + 1

    # -- textures ---------------------------------------------------------

    def _texel(self, ch: str, model, uv):
        """(texel [R,3], has [R]) of channel ``ch`` at ``uv``: nearest
        texel, (trunc(u*w) mod w, trunc(v*h) mod h)."""
        ids, off, w, h = self.tex[ch]
        tid, o, ww, hh = ids[model], off[model], w[model], h[model]
        ix = (uv[:, 0] * ww.to(self.dtype)).to(torch.int64)
        iy = (uv[:, 1] * hh.to(self.dtype)).to(torch.int64)
        idx = torch.remainder(iy, hh) * ww + torch.remainder(ix, ww)
        return self.texels[o + idx], tid >= 0

    def _gray(self, ch, factor, model, uv, simple):
        if ch not in self.tex:
            return factor
        tx, has = self._texel(ch, model, uv)
        return torch.where(has & ~simple, tx[:, 0] * factor, factor)

    def opacity(self, model, uv, simple):
        return self._gray("opacity", self.opacity_f[model], model, uv, simple)

    def material(self, model, uv, simple):
        def rgb(ch, factor, linear):
            if ch not in self.tex:
                return factor
            tx, has = self._texel(ch, model, uv)
            if linear:
                tx = torch.pow(tx, 2.2)
            return torch.where((has & ~simple)[:, None], tx * factor, factor)

        return dict(
            albedo=rgb("albedo", self.albedo_f[model], True),
            emissive=rgb("emissive", self.emissive_f[model], False),
            opacity=self.opacity(model, uv, simple),
            metal=self._gray("metalness", self.metal_f[model], model, uv,
                             simple),
            rough=torch.clamp(self._gray("roughness", self.rough_f[model],
                                         model, uv, simple), min=1e-4))

    # -- intersection -----------------------------------------------------

    def closest(self, o, d, t_prev):
        """Nearest hit past t_prev of every ray: (t [R] (+inf: none),
        is_tri, prim, u, v, backface)."""
        r = o.shape[0]
        dev = o.device
        best = torch.full((r,), float("inf"), device=dev, dtype=self.dtype)
        prim = torch.zeros((r,), dtype=torch.long, device=dev)
        bu = torch.zeros((r,), device=dev, dtype=self.dtype)
        bv = torch.zeros_like(bu)
        back = torch.zeros((r,), dtype=torch.bool, device=dev)
        if r == 0:
            return best, back.clone(), prim, bu, bv, back
        tc = min(self.n_tri, max(256, BLOCK_ELEMS // max(r, 1)))
        rc = max(1, BLOCK_ELEMS // tc)
        for a in range(0, r, rc):
            rs = slice(a, a + rc)
            oc, dc, tp = o[rs], d[rs], t_prev[rs]
            for b in range(0, self.n_tri, tc):
                t, u, v, det, ok = _mt(oc, dc, self.v0[b:b + tc],
                                       self.e1[b:b + tc], self.e2[b:b + tc])
                t = torch.where(ok & (t > tp[:, None]), t, float("inf"))
                tj, j = t.min(dim=1)  # lowest index among equal minima
                better = tj < best[rs]
                jj = j[:, None]
                best[rs] = torch.where(better, tj, best[rs])
                prim[rs] = torch.where(better, j + b, prim[rs])
                bu[rs] = torch.where(better, u.gather(1, jj)[:, 0], bu[rs])
                bv[rs] = torch.where(better, v.gather(1, jj)[:, 0], bv[rs])
                back[rs] = torch.where(better, det.gather(1, jj)[:, 0] < 0.0,
                                       back[rs])
        is_tri = torch.isfinite(best)
        if self.n_sph:
            st, sj, sback = self._spheres(o, d, t_prev)
            sph = st < best  # the triangle keeps ties
            best = torch.where(sph, st, best)
            prim = torch.where(sph, sj, prim)
            back = torch.where(sph, sback, back)
            is_tri = is_tri & ~sph
        return best, is_tri, prim, bu, bv, back

    def _spheres(self, o, d, t_prev):
        c, rad = self.sph_c, self.sph_r
        a = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2])[:, None]
        ocx = o[:, 0:1] - c[None, :, 0]
        ocy = o[:, 1:2] - c[None, :, 1]
        ocz = o[:, 2:3] - c[None, :, 2]
        b = 2.0 * (ocx * d[:, 0:1] + ocy * d[:, 1:2] + ocz * d[:, 2:3])
        cc = ocx * ocx + ocy * ocy + ocz * ocz - (rad * rad)[None, :]
        disc = b * b - 4.0 * a * cc
        has = disc >= 0.0
        sq = torch.sqrt(torch.where(has, disc, 0.0))
        t1, t2 = (-b - sq) / (2.0 * a), (-b + sq) / (2.0 * a)
        tp = t_prev[:, None]
        v1 = has & (t1 >= 0.0) & (t1 > tp)
        v2 = has & (t2 >= 0.0) & (t2 > tp)
        t = torch.where(v1, t1, torch.where(v2, t2, float("inf")))
        tj, j = t.min(dim=1)
        far = (~v1 & v2).gather(1, j[:, None])[:, 0]
        return tj, j, far

    def hit_attrs(self, is_tri, prim, u, v):
        """(model, uv, simple) of hits (misses read triangle 0)."""
        tri = torch.where(is_tri, prim, 0)
        uv0 = self.uv[0][tri]
        uvh = (uv0 + u[:, None] * (self.uv[1][tri] - uv0)
               + v[:, None] * (self.uv[2][tri] - uv0))
        model = self.tri_model[tri]
        if self.n_sph:
            sph = torch.where(is_tri, 0, prim)
            model = torch.where(is_tri, model, self.sph_model[sph])
        uvh = torch.where(is_tri[:, None], uvh, 0.0)
        return model, uvh, ~is_tri


def _mt(o, d, v0, e1, e2):
    """Moller-Trumbore of [R] rays against [B] triangles: (t, u, v, det,
    ok) [R,B]."""
    ox, oy, oz = (o[:, k:k + 1] for k in range(3))
    dx, dy, dz = (d[:, k:k + 1] for k in range(3))
    v0x, v0y, v0z = (v0[None, :, k] for k in range(3))
    e1x, e1y, e1z = (e1[None, :, k] for k in range(3))
    e2x, e2y, e2z = (e2[None, :, k] for k in range(3))
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    ok = det.abs() >= DET_EPS
    invdet = 1.0 / torch.where(ok, det, 1.0)
    tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * invdet
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * invdet
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * invdet
    ok = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t >= T_MIN)
    return t, u, v, det, ok


def transparent_hits(raw) -> int:
    """The hits a walk may have to pass, which sets the uniforms' site
    layout: every triangle of a mesh whose opacity is not certainly 1 (a
    texture with factor >= 1 is certainly 1 over a triangle when its
    smallest texel over the triangle's UV box, one texel wider each way
    and wrapped, is 255), and two for each sphere that is not opaque."""
    n = 0
    for m in raw.models:
        mat = m.material
        transparent = mat.opacity < 1.0 or mat.opacity_tex is not None
        if not transparent:
            continue
        if hasattr(m, "radius"):
            n += 2
            continue
        if mat.opacity < 1.0:
            n += m.pos.shape[0]
            continue
        gray = raw.textures[mat.opacity_tex]
        if gray.ndim == 3:
            raise ValueError("an opacity texture is gray")
        th, tw = gray.shape
        for tu, tv in zip(m.uv[:, :, 0], m.uv[:, :, 1]):
            x0 = int(np.floor(tu.min() * tw)) - 1
            x1 = int(np.floor(tu.max() * tw)) + 1
            y0 = int(np.floor(tv.min() * th)) - 1
            y1 = int(np.floor(tv.max() * th)) + 1
            xs = np.arange(x0, min(x1, x0 + tw) + 1) % tw
            ys = np.arange(y0, min(y1, y0 + th) + 1) % th
            low = float(np.float32(gray[np.ix_(ys, xs)].min()) / np.float32(255))
            n += int(not low * mat.opacity >= 1.0)
    return n


# --- BRDF -----------------------------------------------------------------

def _dot(a, b):
    return (a * b).sum(-1)


def _normalize(x):
    return x * torch.rsqrt(torch.clamp((x * x).sum(-1, keepdim=True),
                                       min=1e-24))


def _fresnel(f0, cos):
    return f0 + (1.0 - f0) * ((1.0 - cos) ** 5)[:, None]


def _smith(rough, n, v, l):
    ndv = torch.clamp(_dot(n, v), min=0.0)
    ndl = torch.clamp(_dot(n, l), min=0.0)
    k = (rough + 1.0) ** 2 / 8.0
    return (ndv / (ndv * (1.0 - k) + k)) * (ndl / (ndl * (1.0 - k) + k))


def _diffuse(ks, mat, n, l):
    kd = (1.0 - ks) * (1.0 - mat["metal"])[:, None]
    return kd * mat["albedo"] / PI * torch.clamp(_dot(n, l), min=0.0)[:, None]


def eval_direct(mat, f0, n, v, l):
    h = _normalize(v + l)
    a2 = mat["rough"] ** 4
    ndh = torch.clamp(_dot(n, h), min=0.0)
    den = ndh * ndh * (a2 - 1.0) + 1.0
    dist = a2 / (PI * den * den)
    f = _fresnel(f0, torch.clamp(_dot(h, v), min=0.0))
    g = _smith(mat["rough"], n, v, l)
    denom = torch.clamp(4.0 * torch.clamp(_dot(n, v), min=0.0)
                        * torch.clamp(_dot(n, l), min=0.0), min=1e-4)
    cos = torch.clamp(_dot(n, l), min=0.0)
    spec = (dist * g / denom * cos)[:, None] * f
    return _diffuse(f, mat, n, l) + spec + mat["emissive"]


def sample_dir(mat, n, v, r1, r2):
    """(reflected direction, microfacet normal) of a GGX sample."""
    a2 = mat["rough"] ** 4
    arg = torch.clamp((1.0 - r1) / (r1 * (a2 - 1.0) + 1.0), 0.0, 1.0)
    theta = torch.arccos(torch.sqrt(arg))
    phi = 2.0 * PI * r2
    st = torch.sin(theta)
    local = _normalize(torch.stack([st * torch.cos(phi), torch.cos(theta),
                                    st * torch.sin(phi)], -1))
    # Y-up local frame to world, on |n.x| > |n.y|.
    use_x = n[:, 0].abs() > n[:, 1].abs()
    inv_a = 1.0 / torch.sqrt(torch.where(use_x, n[:, 0] ** 2 + n[:, 2] ** 2,
                                         n[:, 1] ** 2 + n[:, 2] ** 2))
    z = torch.zeros_like(inv_a)
    nt = torch.where(use_x[:, None],
                     torch.stack([n[:, 2], z, -n[:, 0]], -1),
                     torch.stack([z, -n[:, 2], n[:, 1]], -1)) * inv_a[:, None]
    nb = torch.linalg.cross(n, nt)
    wm = _normalize(local[:, 0:1] * nb + local[:, 1:2] * n
                    + local[:, 2:3] * nt)
    refl = 2.0 * torch.clamp(_dot(v, wm), min=0.0)[:, None] * wm - v
    return _normalize(refl), wm


def eval_indirect(mat, f0, n, v, l, wm):
    h = _normalize(v + l)
    f = _fresnel(f0, torch.clamp(_dot(h, v), min=0.0))
    g = _smith(mat["rough"], n, v, l)
    w = _dot(v, wm).abs() / torch.clamp(_dot(v, n).abs() * _dot(wm, n).abs(),
                                        min=1e-20)
    spec = torch.where((_dot(n, l) > 0.0)[:, None], (g * w)[:, None] * f, 0.0)
    return _diffuse(f, mat, n, l) + spec


# --- the integrator ---------------------------------------------------------

def camera_rays(sc: RefScene, pix, sample, width: int, height: int, seed: int):
    x = (pix % width).to(sc.dtype)
    y = torch.div(pix, width, rounding_mode="floor").to(sc.dtype)
    jx = rng.uniform(pix, sample, rng.SITE_CAM_X, seed).to(sc.dtype)
    jy = rng.uniform(pix, sample, rng.SITE_CAM_Y, seed).to(sc.dtype)
    aspect = float(np.float32(width) / np.float32(height))
    tan_half = torch.tan(sc.fov * 0.5)
    sx = ((x + jx) / width * 2.0 - 1.0) * tan_half * aspect
    sy = (1.0 - (y + jy) / height * 2.0) * tan_half
    dc = torch.stack([sx, sy, -torch.ones_like(sx)], -1)
    dc = dc / torch.sqrt((dc * dc).sum(-1, keepdim=True))
    m = sc.cam
    d = torch.stack([(dc * m[k, :3]).sum(-1) for k in range(3)], -1)
    return m[:3, 3].expand_as(d).clone(), d


def _walk(sc, o, d, lanes, step_fn, steps: int):
    """Visit the hits of rays ``lanes`` (bool [R]) in distance order:
    ``step_fn(k, idx, hit)`` gets step k's hits of the lanes still walking
    (indices ``idx``) and returns which of them walk on."""
    t_prev = torch.full((o.shape[0],), -1.0, device=o.device, dtype=sc.dtype)
    walking = lanes.clone()
    for k in range(steps):
        idx = torch.nonzero(walking)[:, 0]
        if idx.numel() == 0:
            break
        hit = sc.closest(o[idx], d[idx], t_prev[idx])
        on = step_fn(k, idx, hit)
        walking[idx] = on
        t_prev[idx] = torch.where(on, hit[0], t_prev[idx])


def trace(sc: RefScene, pix, sample, width: int, height: int, bounces: int,
          seed: int = 0):
    """Radiance [N,3] (float32) of the paths (pixel ``pix`` [N], sample id
    ``sample`` [N], int64)."""
    dev, dt = sc.device, sc.dtype
    o, d = camera_rays(sc, pix, sample, width, height, seed)
    r = o.shape[0]
    color = torch.zeros((r, 3), device=dev, dtype=dt)
    thr = torch.ones((r, 3), device=dev, dtype=dt)
    alive = torch.ones((r,), dtype=torch.bool, device=dev)
    g1, g2, s_rr, stride = rng.site_layout(sc.alpha_steps)
    u_at = lambda site, idx=None: rng.uniform(
        pix if idx is None else pix[idx],
        sample if idx is None else sample[idx], site, seed).to(dt)
    for bounce in range(bounces + 1):
        # The alpha walk.
        sel_t = torch.full((r,), float("inf"), device=dev, dtype=dt)
        sel_tri = torch.zeros((r,), dtype=torch.bool, device=dev)
        sel_prim = torch.zeros((r,), dtype=torch.long, device=dev)
        sel_u = torch.zeros((r,), device=dev, dtype=dt)
        sel_v = torch.zeros_like(sel_u)
        sel_back = torch.zeros_like(sel_tri)
        seen = torch.zeros_like(sel_tri)

        def alpha_step(k, idx, hit):
            t, is_tri, prim, u, v, back = hit
            found = torch.isfinite(t)
            model, uv, simple = sc.hit_attrs(is_tri, prim, u, v)
            op = sc.opacity(model, uv, simple)
            rnd = u_at(rng.SITE_ALPHA + k + stride * bounce, idx)
            accept = (op >= 1.0) | ((op > ALPHA_MIN) & (rnd < op))
            for dst, src in ((sel_t, t), (sel_tri, is_tri), (sel_prim, prim),
                             (sel_u, u), (sel_v, v), (sel_back, back)):
                dst[idx] = torch.where(found, src, dst[idx])
            seen[idx] = seen[idx] | found
            return found & ~accept

        _walk(sc, o, d, alive, alpha_step, sc.alpha_steps)
        missed = alive & ~seen
        color = torch.where(missed[:, None], color + thr * sc.background,
                            color)
        alive = alive & ~missed

        # The shading point.
        t = torch.where(torch.isfinite(sel_t), sel_t, 0.0)
        pos = o + d * t[:, None]
        model, uv, simple = sc.hit_attrs(sel_tri, sel_prim, sel_u, sel_v)
        tri = torch.where(sel_tri, sel_prim, 0)
        w1, w2 = sel_u[:, None], sel_v[:, None]
        n_int = (1.0 - w1 - w2) * sc.n[0][tri] + w1 * sc.n[1][tri] \
            + w2 * sc.n[2][tri]
        shade_n = n_int
        if "normal" in sc.tex:
            tx, has = sc._texel("normal", model, uv)
            nm = tx * 2.0 - 1.0
            tng = sc.tangent[tri]
            btg = torch.linalg.cross(n_int, tng)
            mapped = _normalize(tng * nm[:, 0:1] + btg * nm[:, 1:2]
                                + n_int * nm[:, 2:3])
            shade_n = torch.where((has & sel_tri)[:, None], mapped, n_int)
        shade_n = torch.where((sel_back & sel_tri)[:, None], -shade_n,
                              shade_n)
        geom_n = n_int
        if sc.n_sph:
            sph = torch.where(sel_tri, 0, sel_prim)
            sn = _normalize(pos - sc.sph_c[sph])
            sn = torch.where(sel_back[:, None], -sn, sn)
            geom_n = torch.where(sel_tri[:, None], n_int, sn)
            shade_n = torch.where(sel_tri[:, None], shade_n, sn)
        mat = sc.material(model, uv, simple)
        f0 = 0.04 * (1.0 - mat["metal"])[:, None] \
            + mat["albedo"] * mat["metal"][:, None]
        view = -d
        color = torch.where(alive[:, None], color + thr * mat["emissive"],
                            color)
        s_o = pos + geom_n * NORMAL_BIAS
        emissive = (mat["emissive"].abs().sum(-1) != 0.0
                    if sc.emissive_any else torch.zeros_like(alive))

        lights = ([(-ld).expand_as(d), lc, None] for ld, lc in
                  zip(sc.dir_d, sc.dir_c))
        pts = []
        for lp, lc in zip(sc.pt_p, sc.pt_c):
            to_surf = pos - lp
            dist = torch.sqrt((to_surf * to_surf).sum(-1))
            pts.append([-(to_surf / dist[:, None]), lc, dist])
        for l_dir, l_col, dist in list(lights) + pts:
            active = alive & ((_dot(shade_n, l_dir) > 0.0) | emissive)
            col = l_col if dist is None else torch.ones_like(l_col)
            att0 = torch.where(active[:, None], col.expand(r, 3), 0.0)
            trans = torch.ones((r,), device=dev, dtype=dt)

            def shadow_step(k, idx, hit, l_dir=l_dir, dist=dist):
                t_h, is_tri, prim, u, v, _ = hit
                found = torch.isfinite(t_h)
                mdl, huv, hsimple = sc.hit_attrs(is_tri, prim, u, v)
                if dist is not None:
                    tt = torch.where(found, t_h, 0.0)
                    oc = s_o[idx] + l_dir[idx] * tt[:, None] - pos[idx]
                    od = torch.sqrt(oc[:, 0] * oc[:, 0] + oc[:, 1] * oc[:, 1]
                                    + oc[:, 2] * oc[:, 2])
                    found = found & ~(od > dist[idx])
                    huv, hsimple = uv[idx], simple[idx]
                op = sc.opacity(mdl, huv, hsimple)
                tr = torch.where(found, trans[idx] * (1.0 - op), trans[idx])
                trans[idx] = tr
                return found & (tr != 0.0)

            _walk(sc, s_o, l_dir, active & (att0.abs().sum(-1) != 0.0),
                  shadow_step, sc.alpha_steps)
            rad = att0 * trans[:, None]
            if dist is not None:
                rad = rad * (l_col / (4.0 * PI * dist * dist)[:, None])
            lit = alive & (rad.sum(-1) != 0.0)
            ev = eval_direct(mat, f0, shade_n, view, l_dir)
            color = torch.where(lit[:, None], color + thr * ev * rad, color)

        # The bounce.
        indirect = alive & (bounce < bounces)
        r1 = u_at(g1 + stride * bounce)
        r2 = u_at(g2 + stride * bounce)
        new_d, wm = sample_dir(mat, shade_n, view, r1, r2)
        ind = eval_indirect(mat, f0, shade_n, view, new_d, wm)
        thr = torch.where(indirect[:, None], thr * ind, thr)
        o = torch.where(indirect[:, None], pos + geom_n * NORMAL_BIAS, o)
        d = torch.where(indirect[:, None], new_d, d)
        alive = alive & (bounce < bounces)
        alive = alive & (_dot(thr, thr) >= 1e-5)
        rr = alive & (bounce > 3)
        p = torch.amax(thr, dim=-1)
        p_safe = torch.where(rr, torch.clamp(p, min=1e-30), 1.0)
        thr = torch.where(rr[:, None], thr / p_safe[:, None], thr)
        alive = alive & ~(rr & (u_at(s_rr + stride * bounce) > p))
    return color.float()


def pixel_sums(sc: RefScene, pixels, sample_start: int, n_samples: int,
               width: int, height: int, bounces: int, seed: int = 0,
               paths_per_call: int = 1 << 15):
    """[P,3] float32: each pixel's radiance summed over sample ids
    sample_start .. sample_start + n_samples - 1, sample by sample."""
    pixels = torch.as_tensor(pixels, dtype=torch.int64, device=sc.device)
    p = pixels.shape[0]
    acc = torch.zeros((p, 3), device=sc.device)
    per = max(1, paths_per_call // max(p, 1))
    for s0 in range(0, n_samples, per):
        k = min(per, n_samples - s0)
        pix = pixels.repeat(k)
        ids = (torch.arange(k, device=sc.device, dtype=torch.int64)
               .repeat_interleave(p) + sample_start + s0)
        rad = trace(sc, pix, ids, width, height, bounces, seed).view(k, p, 3)
        for j in range(k):
            acc += rad[j]
    return acc
