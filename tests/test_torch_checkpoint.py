"""Checkpoint and resume in the port (tests/test_checkpoint.py's cases):
an interrupted render resumed from its checkpoint equals the straight
render bit for bit, since the counter-based RNG makes the sample ids the
only state; a checkpoint of another render raises; a finished one
short-circuits. The scene is the JAX package's Cornell box carried across.
"""
import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    from path_tracer_torch.scene.device_scene import (
        ARRAY_FIELDS,
        STATIC_FIELDS,
        from_numpy,
    )
    from path_tracer_tpu.scene.procedural import cornell_device_scene

    js = cornell_device_scene()
    return from_numpy({f: np.asarray(getattr(js, f)) for f in ARRAY_FIELDS},
                      {s: getattr(js, s) for s in STATIC_FIELDS}, "cpu")


def _profile(samples, **kw):
    from path_tracer_torch.config import Profile, Resolution

    return Profile(**{**dict(resolution=Resolution(16, 12), samples=samples,
                             bounces=1, alpha_walk_steps=2,
                             shadow_walk_steps=2, samples_per_launch=2),
                      **kw})


def test_resume_matches_straight_render(scene, tmp_path):
    from path_tracer_torch.models.renderer import render

    ckpt = tmp_path / "render.ckpt"
    full = render(scene, _profile(8))
    render(scene, _profile(4), checkpoint_path=ckpt)  # 4 samples, saved
    assert ckpt.exists() and not list(tmp_path.glob("*.tmp"))
    resumed = render(scene, _profile(8), checkpoint_path=ckpt)  # 5..8
    np.testing.assert_array_equal(full, resumed)
    assert full.std() > 0


def test_mismatched_checkpoint_rejected(scene, tmp_path):
    from path_tracer_torch.config import Resolution
    from path_tracer_torch.models.renderer import render

    ckpt = tmp_path / "render.ckpt"
    render(scene, _profile(2), checkpoint_path=ckpt)
    bad = _profile(2, resolution=Resolution(8, 8), samples_per_launch=1)
    with pytest.raises(ValueError, match="different render config"):
        render(scene, bad, checkpoint_path=ckpt)


def test_completed_checkpoint_short_circuits(scene, tmp_path):
    from path_tracer_torch.models.renderer import render

    ckpt = tmp_path / "render.ckpt"
    first = render(scene, _profile(4), checkpoint_path=ckpt)
    again = render(scene, _profile(4), checkpoint_path=ckpt)
    np.testing.assert_array_equal(first, again)


def test_fingerprint_covers_inputs_not_tables(scene):
    """A changed material, light or seed changes the fingerprint; a derived
    table (the packed triangle rows, the block tables) does not enter it."""
    import dataclasses

    from path_tracer_torch.utils.checkpoint import fingerprint

    fp = fingerprint(16, 12, 1, 0, scene)
    alb = scene.mat_albedo_factor.clone()
    alb[0, 0] += 0.125
    assert fingerprint(16, 12, 1, 0, dataclasses.replace(
        scene, mat_albedo_factor=alb)) != fp
    assert fingerprint(16, 12, 1, 0, dataclasses.replace(
        scene, point_color=scene.point_color * 2)) != fp
    assert fingerprint(16, 12, 1, 1, scene) != fp
    assert fingerprint(16, 12, 1, 0, dataclasses.replace(
        scene, tri_packed_t=torch.zeros_like(scene.tri_packed_t),
        sl_bw_t=torch.zeros_like(scene.sl_bw_t))) == fp
