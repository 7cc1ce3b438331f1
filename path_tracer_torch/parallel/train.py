"""The differentiable render step ("training step") on one device.

Port of ``path_tracer_tpu/parallel/train.py``: differentiate the rendered
image with respect to continuous scene parameters (material factors,
lights, emission, background, camera, sphere geometry, the texture atlas)
and fit them to a target image by gradient descent (inverse rendering),
through torch autograd. Discrete events (hit selection, alpha accepts, RR
kills, sampled directions) are detached inside the integrator
(``IntegratorSpec.differentiable``); geometry-moving parameters
(``point_pos``, ``cam_to_world``) therefore get the detached-sampling
estimator: exact through shading terms, biased where a parameter would
move the hit point itself.

The JAX package's step is sharded over a device mesh, its pixel tiles
split across devices and its loss and gradients summed with ``psum``. The
port's step runs on one device, or, given a mesh (``parallel/mesh.py``),
on each rank's shard of the pixels with the loss and the gradients summed
over the mesh's group before the update, so every rank applies the same
update.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from path_tracer_torch.models.integrator import IntegratorSpec, render_wavefront
from path_tracer_torch.ops import trwalk
from path_tracer_torch.scene import device_scene as ds

# The scene's tensors that gradients flow into (the JAX package's list).
PARAM_FIELDS = (
    "mat_albedo_factor",
    "mat_emissive_factor",
    "mat_metalness_factor",
    "mat_roughness_factor",
    "point_color",
    "point_pos",
    "dir_color",
    # Used raw (never normalized) in eval_direct and the shadow direction.
    "dir_dir",
    "background",
    "cam_to_world",
    # Vertical fov in radians, through camera ray generation.
    "cam_fov",
    # First-order exact through the quadratic-root reparameterization of
    # the hit point (the root choice stays a detached discrete event).
    "sph_center",
    "sph_radius",
    # The whole atlas [P,3]: each texture fetch is a gather, whose backward
    # scatters into the texels.
    "tex_data",
)


def get_params(scene) -> dict:
    """The trainable tensors of a scene, by field name."""
    return {f: getattr(scene, f) for f in PARAM_FIELDS}


def apply_params(scene, params: dict):
    """The scene with ``params`` (field name -> tensor) in place, and what
    the port bakes from them refreshed: ``sl_attr``'s material columns and
    the walk table's opacity-factor row after a ``mat_*`` update (a
    forward render reads those), the sphere kernels' packed table after a
    sphere update. A trained ``tex_data`` needs no refresh during training
    (the differentiable path and the live walk kernels read it live); call
    ``refresh_baked_textures`` once before rendering the fitted scene
    forward."""
    scene = _with_params(scene, params)
    if any(f.startswith("mat_") for f in params):
        scene = rebake_material_rows(scene)
    return scene


def _with_params(scene, params: dict):
    """The scene with ``params`` in place and the sphere kernels' packed
    table refreshed: all that a differentiable render reads. It reads the
    ``mat_*`` tables and rebuilds the walk kernels' opacity row live, so
    a training step skips ``rebake_material_rows`` (which copies all of
    ``sl_attr``, 384 MB on scene A) where the JAX package's jitted step
    drops it as dead code."""
    scene = dataclasses.replace(scene, **params)
    if "sph_center" in params or "sph_radius" in params:
        scene = repack_spheres(scene)
    return scene


@torch.no_grad()
def repack_spheres(scene):
    """Refresh the dense sphere kernels' table ``sph_packed_t`` [4, S] from
    the live ``sph_center`` and ``sph_radius`` (padding columns stay
    misses). As in the JAX package, the sphere block walk's tables of a
    scene of more than 512 spheres (``sph_sorted_t``, ``sph_blk``) are
    left as they are."""
    sp = scene.sph_packed_t.clone()
    ns = scene.sph_center.shape[0]
    sp[0:3, :ns] = scene.sph_center.T
    sp[3, :ns] = scene.sph_radius
    return dataclasses.replace(scene, sph_packed_t=sp)


def rebake_material_rows(scene):
    """Refresh what the port bakes from the ``mat_*`` tables: the material
    factors of every ``sl_attr`` row (the model id in column 27), as the
    JAX package does, and the walk kernels' ``tr_rows``, whose row 6 holds
    each column's opacity factor. A forward render of the updated scene
    then reads the new factors in its shading and its kernel walks.
    Neither table carries a gradient: the differentiable path reads the
    ``mat_*`` tables."""
    with torch.no_grad():
        attr = scene.sl_attr.clone()
        mid = attr[:, 27].long()
        attr[:, ds.ATTR_ALBEDO_F:ds.ATTR_ALBEDO_F + 3] = \
            scene.mat_albedo_factor[mid]
        attr[:, ds.ATTR_EMISSIVE_F:ds.ATTR_EMISSIVE_F + 3] = \
            scene.mat_emissive_factor[mid]
        for col, table in ((ds.ATTR_OPACITY_F, scene.mat_opacity_factor),
                           (ds.ATTR_METAL_F, scene.mat_metalness_factor),
                           (ds.ATTR_ROUGH_F, scene.mat_roughness_factor),
                           (ds.ATTR_IOR, scene.mat_ior)):
            attr[:, col] = table[mid]
    scene = dataclasses.replace(scene, sl_attr=attr)
    if not scene.tr_kernel_ok:
        return scene
    return dataclasses.replace(scene, tr_rows=trwalk.live_rows(scene))


@torch.no_grad()
def refresh_baked_textures(scene):
    """Rebuild the texel tables baked from ``tex_data`` from its live
    values, on the host: call it once after training that updated the
    atlas, before rendering the fitted scene forward
    (differentiable=False). ``tex_wide`` is rebuilt value for value (the
    layout depends only on the texture sizes, which training keeps). The
    walk kernels' u8 page plane ``tr_tex8`` is re-quantized where every
    texel of the opacity pages is still exactly ``tr_lut[round(255 x)]``;
    otherwise ``tr_kernel_ok`` is cleared, so forward walks take the exact
    cast walks instead of quantizing."""
    atlas = scene.tex_data.detach().cpu().numpy()
    if not scene.no_textures and any(scene.wide_covered):
        mats = {k: getattr(scene, f).cpu().numpy() for k, f in (
            ("albedo_t", "mat_albedo_tex"), ("emissive_t", "mat_emissive_tex"),
            ("opacity_t", "mat_opacity_tex"),
            ("metal_t", "mat_metalness_tex"),
            ("rough_t", "mat_roughness_tex"), ("normal_t", "mat_normal_tex"))}
        wide, _, _, _, covered = ds._build_wide_tex(
            mats, atlas, scene.tex_offset.cpu().numpy(),
            scene.tex_width.cpu().numpy(), scene.tex_height.cpu().numpy())
        if covered != scene.wide_covered or wide.shape != tuple(
                scene.tex_wide.shape):
            raise ValueError("tex_wide's layout changed: rebuild the scene")
        scene = dataclasses.replace(scene, tex_wide=torch.from_numpy(
            wide).to(scene.tex_wide.device))
    if not (scene.tr_kernel_ok and scene.tr_textured):
        return scene
    lut = scene.tr_lut[0].cpu().numpy()
    tex8 = np.zeros(tuple(scene.tr_tex8.shape), np.uint8)
    for off, w, h, yb in scene.tr_pages:
        plane = atlas[off:off + w * h, 0]
        ru = np.round(plane.astype(np.float64) * 255.0)
        if not np.array_equal(plane,
                              lut[np.clip(ru, 0, 255).astype(np.int32)]):
            return dataclasses.replace(scene, tr_kernel_ok=False)
        tex8[yb:yb + h, :w] = ru.reshape(h, w)
    return dataclasses.replace(
        scene, tr_tex8=torch.from_numpy(tex8).to(scene.tr_tex8.device))


def value_and_grad(params: dict, scene, ids, target, sample_id: int,
                   width: int, height: int, spec: IntegratorSpec,
                   n_samples: int = 1):
    """(loss, grads) of one step: the sum over pixels of the squared
    difference between the mean of ``n_samples`` renders of ``ids`` (sample
    ids ``sample_id`` ...) and ``target`` [R,3], and its gradient for each
    parameter (zeros for a parameter the loss does not reach, as jax.grad
    gives). ``spec.differentiable`` must be set."""
    if not spec.differentiable:
        raise ValueError("gradients need IntegratorSpec(differentiable=True)")
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    s = _with_params(scene, leaves)
    acc = torch.zeros((ids.shape[0], 3), device=ids.device)
    for k in range(n_samples):
        acc = acc + render_wavefront(s, ids, width, height, sample_id + k,
                                     spec)
    loss = ((acc / float(n_samples) - target) ** 2).sum()
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    return loss.detach(), {
        k: torch.zeros_like(v) if g is None else g
        for (k, v), g in zip(leaves.items(), grads)}


def make_train_step(width: int, height: int, spec: IntegratorSpec,
                    n_samples: int = 1, lr: float = 1e-2, mesh=None):
    """One SGD step: ``step(params, scene, ids, target, sample_id) ->
    (new_params, loss)``, with ``new = p - lr * grad`` for every parameter
    (``value_and_grad``). With a ``mesh`` every rank of it calls the step
    with its own shard of ``ids`` and ``target``; the loss and every
    gradient are summed over the mesh's group (one flattened buffer)
    before the update, so every rank returns the same loss and
    parameters."""

    def step(params, scene, ids, target, sample_id):
        loss, grads = value_and_grad(params, scene, ids, target, sample_id,
                                     width, height, spec, n_samples)
        if mesh is not None:
            loss, grads = _sum_over_mesh(mesh, loss, grads)
        with torch.no_grad():
            new = {k: p.detach() - lr * grads[k] for k, p in params.items()}
        return new, loss

    return step


def _sum_over_mesh(mesh, loss, grads: dict) -> tuple:
    """(loss, grads) summed over the mesh's group: one all_reduce of the
    loss and every gradient flattened into one buffer."""
    from path_tracer_torch.parallel.mesh import all_reduce_sum, mesh_rank

    group, _, _ = mesh_rank(mesh)
    names = list(grads)
    total = all_reduce_sum(torch.cat(
        [loss.reshape(1)] + [grads[k].reshape(-1) for k in names]), group)
    first, *rest = total.split([1] + [grads[k].numel() for k in names])
    return first[0], {k: r.view_as(grads[k]) for k, r in zip(names, rest)}
