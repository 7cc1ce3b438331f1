"""CLI entry point: ``path-tracer-torch render`` and ``convert``.

Port of ``path_tracer_tpu/cli.py``:

  render INPUT [-o/--output render.png] [-q/--quiet] [-v/--viewer]
         [--debug-textures] [-p/--profile FILE] [--checkpoint PATH]
         [--checkpoint-every N] [--profile-trace DIR] [--device cuda|cpu]
  convert INPUT OUTPUT_DIR

``--device`` (default ``cuda``) names where the render runs; without a CUDA
device the command fails rather than falling back to the CPU.
``--profile-trace`` wraps the render in ``torch.profiler`` (CPU activity,
and CUDA on the card) and writes a Chrome trace into DIR. ``convert``
turns a glTF or GLB file into ``OUTPUT_DIR/scene.isf`` and its PNG
textures (``scene/gltf.py``); it is host tooling with no tensor work, so
it takes no ``--device``. Errors print one line to stderr and exit with
code 2, as the reference's CLI does. OUTPUT and PROFILE fall back to
environment variables.

Under ``torchrun`` (``WORLD_SIZE`` > 1) ``render`` runs one rank per
process: it joins the process group (``parallel.multihost.initialize``:
NCCL on ``cuda:LOCAL_RANK``, gloo on the CPU), renders through
``render_multihost`` and writes the PNG from rank 0, the same image as
one process writes. ``--checkpoint``, ``--viewer`` and
``--debug-textures`` are refused there, and ``--profile-trace`` traces
rank 0::

    torchrun --nproc-per-node 2 -m path_tracer_torch.cli render scene.isf
"""
from __future__ import annotations

import argparse
import contextlib
import os
import sys
from pathlib import Path

TRACE_FILE = "render_trace.json"


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
                        help="No progress bar printed")
    render.add_argument("-v", "--viewer", action="store_true",
                        help="Display a viewer (might slow down the "
                             "rendering)")
    render.add_argument("--debug-textures", action="store_true",
                        help="Generate debug textures (AOV dump)")
    render.add_argument("-p", "--profile", default=os.environ.get("PROFILE"),
                        help="YAML file with the rendering profile")
    render.add_argument("--checkpoint", default=None, metavar="PATH",
                        help="Persist/resume the accumulation buffer at PATH "
                             "(the reference never persists progressive "
                             "passes)")
    render.add_argument("--checkpoint-every", type=int, default=0,
                        metavar="N", help="Checkpoint every N samples "
                                          "(0 = every pass batch)")
    render.add_argument("--profile-trace", default=None, metavar="DIR",
                        help="Capture a torch.profiler trace of the render "
                             f"into DIR/{TRACE_FILE} (open with Perfetto or "
                             "chrome://tracing)")
    render.add_argument("--device", default="cuda",
                        help="torch device to render on (default: cuda)")

    convert = sub.add_parser("convert", help="Convert scenes into ISF format")
    convert.add_argument("input", help="Input glTF/GLB file name")
    convert.add_argument("output", help="Output directory")
    return parser


def _device(name: str):
    import torch

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available")
    if device.type not in ("cuda", "cpu"):
        raise RuntimeError(f"--device {name}: only cuda and cpu are supported")
    return device


def _trace(trace_dir, device):
    """A context that profiles the render into trace_dir/TRACE_FILE, or
    does nothing without a directory."""
    if not trace_dir:
        return contextlib.nullcontext()
    import torch.profiler as tp

    activities = [tp.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(tp.ProfilerActivity.CUDA)

    @contextlib.contextmanager
    def traced():
        with tp.profile(activities=activities) as prof:
            yield
        out = Path(trace_dir)
        out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out / TRACE_FILE))

    return traced()


def run_render(args) -> None:
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        run_render_ranks(args)
        return
    from path_tracer_torch.config import Profile
    from path_tracer_torch.models.renderer import render
    from path_tracer_torch.scene import load_scene
    from path_tracer_torch.utils.image_io import save_png

    device = _device(args.device)
    profile = Profile.load(args.profile) if args.profile else Profile()
    scene = load_scene(args.input, device=device)

    if args.debug_textures:
        from path_tracer_torch.models.debug_aov import debug_render

        debug_render(scene, profile.resolution)
        return

    viewer = None
    if args.viewer:
        from path_tracer_torch.viewer import ProgressiveViewer

        viewer = ProgressiveViewer(profile.resolution)
    try:
        with _trace(args.profile_trace, device):
            image = render(scene, profile, progress=not args.quiet,
                           viewer=viewer, checkpoint_path=args.checkpoint,
                           checkpoint_every=args.checkpoint_every)
        save_png(image, args.output)
        if viewer is not None:
            # The reference waits for its window to close after the render;
            # the viewer serves the final frame until /stop or Ctrl-C.
            viewer.wait_for_close()
    finally:
        if viewer is not None:
            viewer.close()


def run_render_ranks(args) -> None:
    """``render`` in one rank of a ``torchrun`` world."""
    import torch.distributed as dist

    from path_tracer_torch.config import Profile
    from path_tracer_torch.parallel import multihost
    from path_tracer_torch.scene import load_scene
    from path_tracer_torch.utils.image_io import save_png

    for flag, given in (("--checkpoint", args.checkpoint),
                        ("--viewer", args.viewer),
                        ("--debug-textures", args.debug_textures)):
        if given:
            raise RuntimeError(f"{flag} is not supported in a render of "
                               "more than one rank")
    profile = Profile.load(args.profile) if args.profile else Profile()
    device = multihost.initialize(args.device)
    try:
        rank = dist.get_rank()
        scene = load_scene(args.input, device=device)
        with _trace(args.profile_trace if rank == 0 else None, device):
            image = multihost.render_multihost(scene, profile)
        if rank == 0:
            save_png(image, args.output)
    finally:
        dist.destroy_process_group()


def run_convert(args) -> None:
    from path_tracer_torch.scene.gltf import convert_gltf_to_isf

    convert_gltf_to_isf(args.input, args.output)


def main(argv=None) -> None:
    args = _build_parser().parse_args(argv)
    try:
        if args.command == "render":
            run_render(args)
        else:
            run_convert(args)
    except Exception as e:  # noqa: BLE001 — one-line error, exit 2
        print(e, file=sys.stderr)
        sys.exit(2)


if __name__ == "__main__":
    main()
