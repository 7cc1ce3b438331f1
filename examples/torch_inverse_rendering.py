"""Inverse rendering with the PyTorch port: recover the Cornell box's
albedos from a target image by gradient descent through torch autograd
(``render_wavefront`` with ``IntegratorSpec(differentiable=True)``).

The target is rendered independently of the fitting estimator (another
RNG seed, more samples), so the fit cannot match per-sample noise: the
loss falls to the Monte Carlo noise floor (not zero) while the recovered
albedos approach the true values.

Usage: python examples/torch_inverse_rendering.py [steps] [--device cuda|cpu]
           [--size 24]
"""
import argparse
import dataclasses
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import torch

from path_tracer_torch.models.integrator import IntegratorSpec, render_wavefront
from path_tracer_torch.scene.procedural import cornell_device_scene

TARGET_SEED = 1234  # independent of the fit estimator's seed (0)
TARGET_SPP = 32
FIT_SPP = 4
LR = 2.0


def render_avg(scene, spec, ids, w, h, sample_start, n_samples):
    acc = torch.zeros((ids.shape[0], 3), device=ids.device)
    for k in range(n_samples):
        acc = acc + render_wavefront(scene, ids, w, h, sample_start + k, spec)
    return acc / n_samples


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("steps", nargs="?", type=int, default=80)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--size", type=int, default=24)
    args = parser.parse_args(argv)

    scene = cornell_device_scene(args.device)
    w = h = args.size
    ids = torch.arange(w * h, dtype=torch.int32, device=scene.device)

    # Independently rendered target: another seed, more samples.
    target_albedo = scene.mat_albedo_factor.clone()
    with torch.no_grad():
        target = render_avg(scene, IntegratorSpec(bounces=1,
                                                  seed=TARGET_SEED),
                            ids, w, h, 1, TARGET_SPP)

    fit_spec = IntegratorSpec(bounces=1, seed=0, differentiable=True)
    albedo = torch.clamp(target_albedo * 0.4 + 0.2, 0.0, 1.0)  # wrong start
    for i in range(args.steps):
        leaf = albedo.detach().requires_grad_(True)
        s = dataclasses.replace(scene, mat_albedo_factor=leaf)
        # Fresh sample ids every step: stochastic gradient descent over the
        # estimator's sample stream, not repeated descent on one draw.
        img = render_avg(s, fit_spec, ids, w, h, 1 + i * FIT_SPP, FIT_SPP)
        loss = torch.mean((img - target) ** 2)
        (grad,) = torch.autograd.grad(loss, [leaf])
        albedo = torch.clamp(albedo - LR * grad, 0.0, 1.0)
        if i % 10 == 0 or i == args.steps - 1:
            err = float((albedo - target_albedo).abs().max())
            print(f"step {i:3d}  loss {float(loss.detach()):.6f}  "
                  f"max albedo err {err:.4f}", flush=True)
    err = float((albedo - target_albedo).abs().max())
    print(f"final max albedo err {err:.4f} (loss floor = MC noise, not 0)")
    print("recovered albedos:\n", albedo.cpu().numpy())


if __name__ == "__main__":
    main()
