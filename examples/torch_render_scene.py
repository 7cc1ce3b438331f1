"""Render any ISF scene from Python with the PyTorch port (see also the
`path-tracer-torch` CLI).

Usage: python examples/torch_render_scene.py scene.isf out.png [spp]
           [bounces] [--device cuda|cpu] [--width 640] [--height 360]
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from path_tracer_torch import Profile, Resolution, load_scene, render
from path_tracer_torch.utils.image_io import save_png


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("scene")
    parser.add_argument("out", nargs="?", default="render.png")
    parser.add_argument("spp", nargs="?", type=int, default=16)
    parser.add_argument("bounces", nargs="?", type=int, default=4)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--width", type=int, default=640)
    parser.add_argument("--height", type=int, default=360)
    args = parser.parse_args(argv)

    scene = load_scene(args.scene, device=args.device)
    profile = Profile(resolution=Resolution(args.width, args.height),
                      samples=args.spp, bounces=args.bounces, tonemap="ACES")
    image = render(scene, profile, progress=True)
    save_png(image, args.out)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
