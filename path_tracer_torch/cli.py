"""CLI entry point: ``path-tracer-torch render``.

Port of ``path_tracer_tpu/cli.py``'s ``render``:

  render INPUT [-o/--output render.png] [-q/--quiet] [-p/--profile FILE]
         [--device cuda|cpu]

``--device`` (default ``cuda``) names where the render runs; without a CUDA
device the command fails rather than falling back to the CPU. Flags of
features this package does not carry yet (the viewer, AOV dumps,
checkpoints, profiler traces, ``convert``) are rejected with a message.
Errors print one line to stderr and exit with code 2, as the reference's
CLI does. OUTPUT and PROFILE fall back to environment variables.
"""
from __future__ import annotations

import argparse
import os
import sys

_NOT_PORTED = {
    "viewer": "--viewer",
    "debug_textures": "--debug-textures",
    "checkpoint": "--checkpoint",
    "profile_trace": "--profile-trace",
}


def _build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="path-tracer-torch",
                                     description="Path-trace awesome things")
    sub = parser.add_subparsers(dest="command", required=True)

    render = sub.add_parser("render", help="Render an ISF scene")
    render.add_argument("input", help="Input file name ISF format")
    render.add_argument("-o", "--output",
                        default=os.environ.get("OUTPUT", "render.png"),
                        help="Output image name")
    render.add_argument("-q", "--quiet", action="store_true",
                        help="No progress line printed")
    render.add_argument("-p", "--profile", default=os.environ.get("PROFILE"),
                        help="YAML file with the rendering profile")
    render.add_argument("--device", default="cuda",
                        help="torch device to render on (default: cuda)")
    render.add_argument("-v", "--viewer", action="store_true",
                        help=argparse.SUPPRESS)
    render.add_argument("--debug-textures", action="store_true",
                        help=argparse.SUPPRESS)
    render.add_argument("--checkpoint", default=None, help=argparse.SUPPRESS)
    render.add_argument("--profile-trace", default=None,
                        help=argparse.SUPPRESS)

    convert = sub.add_parser("convert", help="(not ported yet)")
    convert.add_argument("input")
    convert.add_argument("output")
    return parser


def _device(name: str):
    import torch

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available")
    if device.type not in ("cuda", "cpu"):
        raise RuntimeError(f"--device {name}: only cuda and cpu are supported")
    return device


def run_render(args) -> None:
    from path_tracer_torch.config import Profile
    from path_tracer_torch.models.renderer import render
    from path_tracer_torch.scene import load_scene
    from path_tracer_torch.utils.image_io import save_png

    for attr, flag in _NOT_PORTED.items():
        if getattr(args, attr):
            raise RuntimeError(f"{flag} is not ported to path-tracer-torch yet")
    device = _device(args.device)
    profile = Profile.load(args.profile) if args.profile else Profile()
    scene = load_scene(args.input, device=device)
    save_png(render(scene, profile, progress=not args.quiet), args.output)


def main(argv=None) -> None:
    args = _build_parser().parse_args(argv)
    try:
        if args.command != "render":
            raise RuntimeError("convert is not ported to path-tracer-torch "
                               "yet; use path-tracer-tpu convert")
        run_render(args)
    except Exception as e:  # noqa: BLE001 — one-line error, exit 2
        print(e, file=sys.stderr)
        sys.exit(2)


if __name__ == "__main__":
    main()
