"""Samples-per-wavefront packing in the port, against its unpacked render and
the JAX package's packed tile, and the per-lane sample ids it rests on.

spw packs each pixel spw times into a 128-lane packet with consecutive
per-lane sample ids. The (pixel, sample) RNG streams are those of spw = 1,
so only the float summation order changes: packed against unpacked within
rtol 2e-5 / atol 2e-6 (the JAX package's tests/test_spw.py tolerance).
The per-lane ids must draw the JAX package's uniforms bit for bit for every
uint32 id, the ones at and past 2^31 included.
"""
import numpy as np
import pytest
import torch

W, H = 32, 24


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _lane_ids(n: int, seed: int) -> np.ndarray:
    """n uint32 sample ids spread over [0, 2^32), with the edges of the
    int32 and uint32 ranges among them."""
    g = np.random.default_rng(seed)
    edges = np.array([0, 1, 2**31 - 1, 2**31, 2**31 + 1, 2**32 - 1],
                     np.uint64)
    ids = g.integers(0, 2**32, n - edges.size, dtype=np.uint64)
    return np.concatenate([edges, ids]).astype(np.uint32)


@pytest.mark.parametrize("site, seed", [(0, 0), (41, 7), (2 + 64 * 4,
                                                           123456789)])
def test_uniform_per_lane_ids_match_jax(site, seed):
    """[R] per-lane ids (as int64 and as int32 wrapping past 2^31) draw the
    JAX package's uniforms exactly."""
    import jax.numpy as jnp

    from path_tracer_torch.ops import rng
    from path_tracer_tpu.ops import rng as jax_rng

    pix = np.random.default_rng(1).integers(0, 2**31 - 1, 4096
                                            ).astype(np.int32)
    ids = _lane_ids(4096, seed)
    want = np.asarray(jax_rng.uniform(jnp.asarray(pix), jnp.asarray(ids),
                                      site, seed))
    for as_torch in (ids.astype(np.int64), ids.view(np.int32)):
        got = rng.uniform(torch.from_numpy(pix), torch.from_numpy(as_torch),
                          site, seed).numpy()
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


@pytest.mark.parametrize("sample_id", [0, 3, 2**31 + 7])
def test_uniform_constant_id_tensor_equals_int(sample_id):
    """A tensor holding one id per lane, all equal, draws what the int
    path draws."""
    from path_tracer_torch.ops import rng

    pix = torch.arange(5000, dtype=torch.int32)
    want = rng.uniform(pix, sample_id, 40, 3)
    got = rng.uniform(pix, torch.full((5000,), sample_id, dtype=torch.int64),
                      40, 3)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _spec(**kw):
    from path_tracer_torch.models.integrator import IntegratorSpec

    return IntegratorSpec(bounces=3, alpha_walk_steps=4, shadow_walk_steps=4,
                          **kw)


@pytest.mark.parametrize("name", ["spheres", "head", "alpha_transparency"])
@pytest.mark.parametrize("spw", [2, 4])
def test_spw_matches_unpacked(reference_scenes, name, spw):
    """render_pixel_sums over spw samples, packed (256-lane tiles of
    256/spw pixels) against unpacked."""
    from path_tracer_torch.models.renderer import render_pixel_sums
    from path_tracer_torch.scene import load_scene

    scene = load_scene(reference_scenes / name / "scene.isf", device="cpu")
    base = render_pixel_sums(scene, W, H, 1, spw, _spec(), tile_rays=256)
    packed = render_pixel_sums(scene, W, H, 1, spw, _spec(), tile_rays=256,
                               samples_per_launch=spw,
                               samples_per_wavefront=spw)
    assert base.std() > 0
    np.testing.assert_allclose(packed, base, rtol=2e-5, atol=2e-6)


def test_packed_tile_matches_jax(reference_scenes):
    """The port's packed tile (two packets of 64 pixels x 2 samples)
    against the JAX package's _accumulate_tile(..., spw=2) on the same
    lanes."""
    import jax.numpy as jnp

    from path_tracer_torch.models.renderer import (
        accumulate_tile,
        packed_lanes,
    )
    from path_tracer_torch.scene import load_scene
    from path_tracer_tpu.models.integrator import IntegratorSpec
    from path_tracer_tpu.models.renderer import _accumulate_tile
    from path_tracer_tpu.scene import load_scene as jax_load_scene

    path = reference_scenes / "head" / "scene.isf"
    lanes = packed_lanes(np.arange(128, dtype=np.int32) * 5 % (W * H), 2)
    spec = IntegratorSpec(bounces=3, alpha_walk_steps=4, shadow_walk_steps=4,
                          differentiable=False)
    want = np.asarray(_accumulate_tile(
        jnp.zeros((128, 3), jnp.float32), jax_load_scene(path),
        jnp.asarray(lanes), W, H, jnp.int32(1), 2, spec, spw=2))
    got = accumulate_tile(torch.zeros((128, 3)), load_scene(path, "cpu"),
                          torch.from_numpy(lanes), W, H, 1, 2, _spec(),
                          spw=2).numpy()
    assert want.std() > 0
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("case", ["compact", "samples", "ray_tile", "tile",
                                  "frame"])
def test_spw_falls_back_loudly(reference_scenes, capsys, case):
    """Where packing cannot apply, the driver says so and renders with
    spw 1: compaction, a sample count spw does not divide, an spw that
    does not divide the packet, a tile that is no multiple of the packet,
    a tile holding more pixels than the frame."""
    from path_tracer_torch.models.renderer import render_pixel_sums
    from path_tracer_torch.scene import load_scene

    scene = load_scene(reference_scenes / "cube" / "scene.isf", device="cpu")
    w, h, n, spw, tile, kw = 16, 12, 2, 2, 128, {}
    if case == "compact":
        kw = {"compact": True}
    elif case == "samples":
        n = 3
    elif case == "ray_tile":
        spw = 3
    elif case == "tile":
        tile = 192
    else:
        tile = 512  # 256 pixels a tile, more than the 192 of the frame
    spec = _spec(**kw)
    want = render_pixel_sums(scene, w, h, 1, n, spec, tile_rays=tile)
    capsys.readouterr()
    got = render_pixel_sums(scene, w, h, 1, n, spec, tile_rays=tile,
                            samples_per_wavefront=spw)
    out = capsys.readouterr().out
    assert (f"samples_per_wavefront={spw} unsupported for this config; "
            "falling back to 1") in out
    np.testing.assert_array_equal(got, want)


def test_render_profile_with_spw(reference_scenes):
    """``render`` with a profile of samples_per_wavefront 2 packs (its
    sums within the packing tolerance of spw 1, so the u8 images within
    one step) and prints no fallback."""
    from path_tracer_torch.config import Profile, Resolution
    from path_tracer_torch.models.renderer import render
    from path_tracer_torch.scene import load_scene

    scene = load_scene(reference_scenes / "spheres" / "scene.isf", "cpu")
    prof = dict(resolution=Resolution(W, H), samples=4, bounces=2,
                tile_rays=256)
    want = render(scene, Profile(**prof))
    got = render(scene, Profile(samples_per_wavefront=2, **prof))
    assert np.abs(got.astype(int) - want).max() <= 1
    assert want.std() > 0
