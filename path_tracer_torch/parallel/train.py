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
port's runs on one device; the mesh and the ``psum`` wait for the port's
multi-device slice.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from path_tracer_torch.models.integrator import IntegratorSpec, render_wavefront
from path_tracer_torch.ops import trwalk

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
    the port bakes from them refreshed: the walk table's opacity-factor
    row after a ``mat_*`` update, the sphere kernels' packed table after a
    sphere update. A trained ``tex_data`` needs no refresh during training
    (the differentiable path and the live walk kernels read it live); call
    ``refresh_baked_textures`` once before rendering the fitted scene
    forward."""
    scene = dataclasses.replace(scene, **params)
    if any(f.startswith("mat_") for f in params):
        scene = rebake_material_rows(scene)
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
    """Refresh what the port bakes from the ``mat_*`` tables. The JAX
    package rebakes the material columns of its wide ``sl_attr`` rows,
    which the port does not have (its shading reads the tables); the one
    table the port bakes from them is the walk kernels' ``tr_rows``, whose
    row 6 holds each column's opacity factor. A forward render of the
    updated scene then reads the live factors in the kernel walks too."""
    if not scene.tr_kernel_ok:
        return scene
    return dataclasses.replace(scene, tr_rows=trwalk.live_rows(scene))


@torch.no_grad()
def refresh_baked_textures(scene):
    """Rebuild the walk kernels' u8 page plane ``tr_tex8`` from the live
    ``tex_data``, on the host: call it once after training that updated
    the atlas, before rendering the fitted scene forward
    (differentiable=False). Where every texel of the opacity pages is
    still exactly ``tr_lut[round(255 x)]`` the plane is re-quantized;
    otherwise ``tr_kernel_ok`` is cleared, so forward walks take the exact
    cast walks instead of quantizing. (The JAX package also rebuilds its
    wide texel table, which the port does not have.)"""
    if not (scene.tr_kernel_ok and scene.tr_textured):
        return scene
    atlas = scene.tex_data.cpu().numpy()
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
    s = apply_params(scene, leaves)
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
                    n_samples: int = 1, lr: float = 1e-2):
    """One SGD step on one device: ``step(params, scene, ids, target,
    sample_id) -> (new_params, loss)``, with ``new = p - lr * grad`` for
    every parameter (``value_and_grad``)."""

    def step(params, scene, ids, target, sample_id):
        loss, grads = value_and_grad(params, scene, ids, target, sample_id,
                                     width, height, spec, n_samples)
        with torch.no_grad():
            new = {k: p.detach() - lr * grads[k] for k, p in params.items()}
        return new, loss

    return step
