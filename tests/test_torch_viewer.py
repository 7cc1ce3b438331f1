"""The port's progressive HTTP viewer (tests/test_viewer.py's cases): the
page, the latest frame (decoded with the port's own PNG reader), /status
and /stop, and a render that ends early when the viewer asks, over the
samples done. The render stopped over HTTP equals a straight render of
that many samples."""
import json
import threading
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


def _get(url: str) -> bytes:
    return urllib.request.urlopen(url, timeout=5).read()


def _frame(viewer) -> np.ndarray:
    from path_tracer_torch.utils.image_io import read_png

    return read_png(_get(viewer.url + "frame.png"))


def test_viewer_serves_frames():
    from path_tracer_torch.viewer import ProgressiveViewer

    viewer = ProgressiveViewer(resolution=None, port=0)
    assert viewer.url is not None
    try:
        img = np.zeros((8, 8, 3), np.uint8)
        img[:, :, 0] = 200
        img[2, 5] = (1, 2, 3)
        viewer.update(img)
        assert b"frame.png" in _get(viewer.url)
        np.testing.assert_array_equal(_frame(viewer), img)
    finally:
        viewer.close()


def test_viewer_status_and_stop():
    from path_tracer_torch.viewer import ProgressiveViewer

    viewer = ProgressiveViewer(resolution=None, port=0)
    try:
        viewer.update(np.zeros((4, 4, 3), np.uint8), samples_done=3,
                      samples_total=8, rays_done=1000)
        status = json.loads(_get(viewer.url + "status"))
        assert status["samples_done"] == 3 and status["samples_total"] == 8
        assert status["mrays_per_s"] >= 0.0 and not status["done"]
        assert not viewer.stop_requested
        _get(viewer.url + "stop")
        assert viewer.stop_requested
        assert json.loads(_get(viewer.url + "status"))["stopping"]
        viewer.wait_for_close()  # returns at once: stop already set
    finally:
        viewer.close()


def _scene():
    from path_tracer_torch.scene.device_scene import (
        ARRAY_FIELDS,
        STATIC_FIELDS,
        from_numpy,
    )
    from path_tracer_tpu.scene.procedural import cornell_device_scene

    js = cornell_device_scene()
    return from_numpy({f: np.asarray(getattr(js, f)) for f in ARRAY_FIELDS},
                      {s: getattr(js, s) for s in STATIC_FIELDS}, "cpu")


def _profile(samples, spl):
    from path_tracer_torch.config import Profile, Resolution

    return Profile(resolution=Resolution(16, 12), bounces=1, samples=samples,
                   samples_per_launch=spl, alpha_walk_steps=2,
                   shadow_walk_steps=2)


def test_render_stops_early_on_viewer_stop():
    """A minimal viewer asking to stop after the first batch: one batch
    runs, and the image is the 2-spp render's."""
    from path_tracer_torch.models.renderer import render

    class StopAfterFirstPass:
        def __init__(self):
            self.updates = []
            self.stop_requested = False

        def update(self, image, samples_done=0, samples_total=0,
                   rays_done=0):
            self.updates.append(samples_done)
            self.stop_requested = True

    scene = _scene()
    viewer = StopAfterFirstPass()
    img = render(scene, _profile(8, 2), viewer=viewer)
    assert viewer.updates == [2]
    np.testing.assert_array_equal(img, render(scene, _profile(2, 2)))


def test_render_through_http_viewer_and_stop():
    """A 3-spp render, one sample a batch, through the HTTP viewer: /status
    advances with each pass and the last frame equals the returned image;
    then a /stop sent after the first pass ends a second render over one
    sample, equal to a 1-spp render."""
    from path_tracer_torch.models.renderer import render
    from path_tracer_torch.viewer import ProgressiveViewer

    scene = _scene()
    viewer = ProgressiveViewer(port=0)
    seen = []
    update = viewer.update

    def watched(image, samples_done=0, samples_total=0, rays_done=0):
        update(image, samples_done, samples_total, rays_done)
        # /status over HTTP after every pass
        seen.append(json.loads(_get(viewer.url + "status"))["samples_done"])

    try:
        viewer.update = watched
        img = render(scene, _profile(3, 1), viewer=viewer)
        assert seen == [1, 2, 3]
        np.testing.assert_array_equal(_frame(viewer), img)
    finally:
        viewer.close()

    viewer = ProgressiveViewer(port=0)
    update = viewer.update

    def stop_after_first(image, samples_done=0, samples_total=0,
                         rays_done=0):
        update(image, samples_done, samples_total, rays_done)
        if samples_done == 1:  # from another thread, as a browser
            t = threading.Thread(target=_get, args=(viewer.url + "stop",))
            t.start()
            t.join()

    try:
        viewer.update = stop_after_first
        img = render(scene, _profile(3, 1), viewer=viewer)
        assert viewer.stop_requested
        np.testing.assert_array_equal(img, render(scene, _profile(1, 1)))
        np.testing.assert_array_equal(_frame(viewer), img)
    finally:
        viewer.close()
