"""The port's CLI flags on ``--device cpu``: --checkpoint (a resumed render's
PNG equals the straight render's), --checkpoint-every, --debug-textures,
--viewer, --profile-trace and the progress bar."""
import json
import urllib.request

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(reference_scenes, tmp_path, out: str, samples: int, *flags,
         spl: int = 1):
    from path_tracer_torch import cli

    prof = tmp_path / f"p{samples}_{spl}.yaml"
    prof.write_text("resolution: {width: 16, height: 12}\n"
                    f"samples: {samples}\nbounces: 2\n"
                    f"samples_per_launch: {spl}\n")
    cli.main(["render", str(reference_scenes / "cube" / "scene.isf"), "-o",
              str(tmp_path / out), "-p", str(prof), "--device", "cpu",
              *flags])
    return tmp_path / out


def test_cli_checkpoint_resume_equals_straight(reference_scenes, tmp_path):
    from path_tracer_torch.utils.image_io import read_png

    ckpt = tmp_path / "r.ckpt"
    straight = _run(reference_scenes, tmp_path, "straight.png", 4, "-q")
    _run(reference_scenes, tmp_path, "half.png", 2, "-q", "--checkpoint",
         str(ckpt))
    resumed = _run(reference_scenes, tmp_path, "resumed.png", 4, "-q",
                   "--checkpoint", str(ckpt))
    want = read_png(straight)
    np.testing.assert_array_equal(read_png(resumed), want)
    assert want.std() > 0
    with np.load(ckpt) as z:
        assert int(z["samples_done"]) == 4


def test_cli_checkpoint_every(reference_scenes, tmp_path, monkeypatch):
    """--checkpoint-every 2 over 5 samples, one a batch: saved at samples
    2, 4 and the last, 5."""
    from path_tracer_torch.utils import checkpoint

    saved = []
    save = checkpoint.save
    monkeypatch.setattr(checkpoint, "save", lambda path, accum, done, fp: (
        saved.append(done), save(path, accum, done, fp)))
    _run(reference_scenes, tmp_path, "x.png", 5, "-q", "--checkpoint",
         str(tmp_path / "r.ckpt"), "--checkpoint-every", "2")
    assert saved == [2, 4, 5]


def test_cli_debug_textures(reference_scenes, tmp_path, monkeypatch):
    """Seven AOV PNGs in the working directory, at the profile's
    resolution, and no render."""
    from path_tracer_torch.utils.image_io import read_png

    monkeypatch.chdir(tmp_path)
    out = _run(reference_scenes, tmp_path, "x.png", 1, "-q",
               "--debug-textures")
    assert not out.exists()
    for name in ("normal", "albedo", "opacity", "metalness", "roughness",
                 "emissive", "ior"):
        assert read_png(tmp_path / f"{name}.png").shape == (12, 16, 3)


def test_cli_viewer(reference_scenes, tmp_path, monkeypatch):
    """--viewer serves the render (port 0 here) and, after it, waits until
    /stop; the PNG equals the last frame served."""
    from path_tracer_torch import viewer as viewer_pkg
    from path_tracer_torch.utils.image_io import read_png
    from path_tracer_torch.viewer import http_viewer

    frames = []

    class Viewer(http_viewer.ProgressiveViewer):
        def __init__(self, resolution=None, port=8642):
            super().__init__(resolution, port=0)

        def wait_for_close(self):
            frames.append(urllib.request.urlopen(self.url + "frame.png",
                                                 timeout=5).read())
            urllib.request.urlopen(self.url + "stop", timeout=5).read()
            super().wait_for_close()

    monkeypatch.setattr(viewer_pkg, "ProgressiveViewer", Viewer)
    out = _run(reference_scenes, tmp_path, "v.png", 2, "-q", "--viewer")
    assert len(frames) == 1
    np.testing.assert_array_equal(read_png(frames[0]), read_png(out))


def test_cli_profile_trace(reference_scenes, tmp_path):
    """--profile-trace DIR writes a Chrome trace of the render's ops."""
    from path_tracer_torch.cli import TRACE_FILE

    _run(reference_scenes, tmp_path, "t.png", 1, "-q", "--profile-trace",
         str(tmp_path / "trace"))
    events = json.loads((tmp_path / "trace" / TRACE_FILE).read_text())
    names = {e.get("name", "") for e in events["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)


def test_cli_progress_bar(reference_scenes, tmp_path, capsys):
    """Without -q the bar counts samples to the end and the summary line
    follows."""
    _run(reference_scenes, tmp_path, "b.png", 3)
    out = capsys.readouterr().out
    assert "Rendering: [" in out and "3/3" in out and "Done: " in out
