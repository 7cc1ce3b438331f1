"""Live-ray compaction and lane tracking in the port's wavefront.

Compaction permutes lanes (live first) at every bounce and scatters the
radiance back; every RNG draw keys off the lane's travelling pixel id and
the kernels' plain versions are lane-wise, so a compacted render equals the
uncompacted one bit for bit. The live counts per bounce are integers and
equal the JAX package's. A permuting ``exchange`` hook returns (color,
orig) in exchanged order: orig equal to the JAX package's, colour within
the port-against-JAX tolerance of tests/test_torch_render.py (rtol 1e-3,
atol 1e-4).
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


@pytest.fixture(scope="module")
def showcase_tex16():
    """The textured showcase at grid 16: partitioned, with the walk
    kernels' tables (their plain versions run here)."""
    from path_tracer_torch.scene.device_scene import partitioned
    from path_tracer_torch.scene.showcase import showcase_device_scene

    sc = showcase_device_scene(16, "cpu", use_bvh=True, sl_block=256,
                               textured=True)
    assert partitioned(sc) and sc.tr_kernel_ok
    return sc


def _sums(scene, w, h, spp, **kw):
    from path_tracer_torch.models.integrator import IntegratorSpec
    from path_tracer_torch.models.renderer import render_pixel_sums

    return render_pixel_sums(scene, w, h, 1, spp,
                             IntegratorSpec(bounces=5, **kw), tile_rays=256)


@pytest.mark.parametrize("name", ["alpha_transparency", "showcase_tex16",
                                  "showcase_tex16_tree"])
def test_compact_equals_uncompacted(reference_scenes, showcase_tex16, name,
                                    monkeypatch):
    """2 spp, 5 bounces: compacted sums equal uncompacted ones exactly, on
    a brute-force alpha scene and on the partitioned textured showcase
    through the flat and walk kernels' plain versions and under
    PT_BVH_KERNEL=tree."""
    from path_tracer_torch.scene import load_scene

    if name == "alpha_transparency":
        scene = load_scene(reference_scenes / name / "scene.isf", "cpu")
        w, h = W, H
    else:
        scene, w, h = showcase_tex16, 16, 12
        if name.endswith("tree"):
            monkeypatch.setenv("PT_BVH_KERNEL", "tree")
    want = _sums(scene, w, h, 2)
    got = _sums(scene, w, h, 2, compact=True)
    assert want.std() > 0
    np.testing.assert_array_equal(got, want)


def _jax_wavefront(path, pix, sample, compact=False, **kw):
    """The JAX package's render_wavefront at 5 bounces."""
    import jax.numpy as jnp

    from path_tracer_tpu.models.integrator import (
        IntegratorSpec,
        render_wavefront,
    )
    from path_tracer_tpu.scene import load_scene

    spec = IntegratorSpec(bounces=5, differentiable=False, compact=compact)
    return render_wavefront(load_scene(path), jnp.asarray(pix), W, H,
                            jnp.int32(sample), spec, **kw)


@pytest.mark.parametrize("name", ["cube", "alpha_transparency"])
def test_live_counts_match_jax(reference_scenes, name):
    """collect_live_counts, compacted and not, against the JAX package's
    (its compacted wavefront): the live lanes before each of the 6
    bounces; the radiance unchanged by counting."""
    from path_tracer_torch.models.integrator import (
        IntegratorSpec,
        render_wavefront,
    )
    from path_tracer_torch.scene import load_scene

    path = reference_scenes / name / "scene.isf"
    pix = np.arange(W * H, dtype=np.int32)
    _, want = _jax_wavefront(path, pix, 3, compact=True,
                             collect_live_counts=True)
    scene = load_scene(path, "cpu")
    plain = render_wavefront(scene, torch.from_numpy(pix), W, H, 3,
                             IntegratorSpec(bounces=5))
    for compact in (False, True):
        color, live = render_wavefront(
            scene, torch.from_numpy(pix), W, H, 3,
            IntegratorSpec(bounces=5, compact=compact),
            collect_live_counts=True)
        assert live.dtype == torch.int32 and live.shape == (6,)
        np.testing.assert_array_equal(live.numpy(), np.asarray(want))
        assert torch.equal(color, plain)
    assert int(want[0]) == W * H and int(want[1]) > 0


def test_exchange_matches_jax(reference_scenes):
    """An exchange hook that applies a fixed random permutation to the
    whole state at every bounce, with lane ids offset as a shard's would
    be: (color, orig) against the JAX package's under the same hook."""
    import jax.numpy as jnp

    from path_tracer_torch.models.integrator import (
        IntegratorSpec,
        render_wavefront,
    )
    from path_tracer_torch.scene import load_scene

    path = reference_scenes / "alpha_transparency" / "scene.isf"
    pix = np.arange(W * H, dtype=np.int32)
    perm = np.random.default_rng(5).permutation(W * H)
    lane_ids = (np.arange(W * H) + 1000).astype(np.int32)
    want_c, want_o = _jax_wavefront(
        path, pix, 2, lane_ids=jnp.asarray(lane_ids),
        exchange=lambda st: tuple(x[jnp.asarray(perm)] for x in st))
    tperm = torch.from_numpy(perm)
    got_c, got_o = render_wavefront(
        load_scene(path, "cpu"), torch.from_numpy(pix), W, H, 2,
        IntegratorSpec(bounces=5), lane_ids=torch.from_numpy(lane_ids),
        exchange=lambda st: tuple(x[tperm] for x in st))
    np.testing.assert_array_equal(got_o.numpy(), np.asarray(want_o))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=1e-3,
                               atol=1e-4)
    # Placed back, the exchanged render is the plain one.
    plain = render_wavefront(load_scene(path, "cpu"), torch.from_numpy(pix),
                             W, H, 2, IntegratorSpec(bounces=5))
    placed = torch.zeros_like(got_c)
    placed[got_o.long() - 1000] = got_c
    assert torch.equal(placed, plain)


def test_lane_tracking_takes_one_sample_id(reference_scenes):
    """Per-lane sample ids do not follow permuted lanes: compaction with
    them raises rather than mixing ids and lanes."""
    from path_tracer_torch.models.integrator import (
        IntegratorSpec,
        render_wavefront,
    )
    from path_tracer_torch.scene import load_scene

    scene = load_scene(reference_scenes / "cube" / "scene.isf", "cpu")
    pix = torch.arange(256, dtype=torch.int32)
    with pytest.raises(ValueError, match="per-lane sample ids"):
        render_wavefront(scene, pix, 16, 16, torch.ones_like(pix),
                         IntegratorSpec(bounces=1, compact=True))
