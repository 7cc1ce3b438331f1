"""The port's elementwise ops against the JAX package on the same inputs.

Inputs are made from a seed with numpy and handed to both packages; the
port runs on the CPU. Tolerances:
- RNG: bit-identical (the port reproduces the uint32 mixer exactly).
- camera, BRDF, tonemap: rtol 1e-5. The arithmetic is the same in the same
  order, but XLA and ATen evaluate tan/acos/sin/cos/pow with their own
  float32 polynomials, which may differ by an ulp or two.
- texture fetches: exact (pure gathers and integer index math); sampled
  albedo through pow 2.2 at rtol 1e-5 for the same reason as above.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_tracer_torch.scene import from_numpy
from path_tracer_torch.scene.device_scene import ARRAY_FIELDS, STATIC_FIELDS


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Tier-1 runs several workers at once: keep torch's pool small."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _carry(js):
    """The JAX package's DeviceScene carried across with from_numpy."""
    return from_numpy({f: np.asarray(getattr(js, f)) for f in ARRAY_FIELDS},
                      {s: getattr(js, s) for s in STATIC_FIELDS}, "cpu")


@pytest.fixture(scope="module")
def head(reference_scenes):
    from path_tracer_tpu.scene import load_scene

    js = load_scene(reference_scenes / "head" / "scene.isf")
    return js, _carry(js)


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1, 2**31 + 5, 2**32 - 1,
                                  123456789012])
def test_rng_uniform_bit_identical(seed):
    from path_tracer_torch.ops import rng as trng
    from path_tracer_tpu.ops import rng as jrng

    g = np.random.default_rng(seed % 2**32)
    pix = g.integers(0, 2**31 - 1, 1000, dtype=np.int64).astype(np.int32)
    pix[:3] = [0, 1, 2**31 - 1]
    n = 0
    # sites below and past the 64-wide stride, incl. widened layouts
    for site in (0, 1, 2, 40, 41, 42, 63, 64, 106, 300, 1000):
        for sample in (0, 1, 17, 65535, 2**31 - 1):
            got = trng.uniform(torch.from_numpy(pix), sample, site, seed)
            want = np.asarray(jrng.uniform(jnp.asarray(pix), sample, site,
                                           seed))
            np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                          want.view(np.uint32))
            n += pix.size
    assert n >= 5 * 10**4


def test_rng_site_layout_matches():
    from path_tracer_torch.ops import rng as trng
    from path_tracer_tpu.ops import rng as jrng

    for steps in (1, 2, 38, 39, 55, 200):
        assert trng.site_layout(steps) == jrng.site_layout(steps)


@pytest.mark.parametrize("name", ["cube", "spheres", "reflection"])
def test_camera_rays(reference_scenes, name):
    from path_tracer_torch.ops.camera import generate_rays as tgen
    from path_tracer_tpu.ops.camera import generate_rays as jgen
    from path_tracer_tpu.scene import load_scene

    js = load_scene(reference_scenes / name / "scene.isf")
    ts = _carry(js)
    w, h = 97, 61
    pix = np.random.default_rng(1).permutation(w * h).astype(np.int32)
    for sample, seed in ((1, 0), (5, 2**31 + 3)):
        jo, jd = jgen(jnp.asarray(pix), w, h, js, jnp.int32(sample), seed)
        to, td = tgen(torch.from_numpy(pix), w, h, ts, sample, seed)
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                                   atol=1e-6)


def _material_arrays(g, r):
    return dict(
        albedo=g.uniform(0, 1, (r, 3)).astype(np.float32),
        emissive=(g.uniform(0, 0.5, (r, 3))
                  * (g.uniform(size=(r, 1)) < 0.3)).astype(np.float32),
        opacity=np.ones(r, np.float32),
        metalness=g.uniform(0, 1, r).astype(np.float32),
        roughness=g.uniform(1e-4, 1, r).astype(np.float32),
        ior=np.ones(r, np.float32),
    )


def _unit(g, r):
    v = g.normal(size=(r, 3)).astype(np.float32)
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def test_brdf_matches_jax():
    from path_tracer_torch.ops import brdf as tb
    from path_tracer_torch.ops.texturing import MaterialSample as TMat
    from path_tracer_tpu.ops import brdf as jb
    from path_tracer_tpu.ops.texturing import MaterialSample as JMat

    g = np.random.default_rng(3)
    r = 4096
    m = _material_arrays(g, r)
    n, v, l = _unit(g, r), _unit(g, r), _unit(g, r)
    r1 = g.uniform(0, 1, r).astype(np.float32)
    r2 = g.uniform(0, 1, r).astype(np.float32)
    tm = TMat(**{k: torch.from_numpy(x) for k, x in m.items()})
    jm = JMat(**{k: jnp.asarray(x) for k, x in m.items()})
    T = lambda x: torch.from_numpy(np.array(x))
    J = jnp.asarray
    close = lambda a, b: np.testing.assert_allclose(
        a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)

    tf0 = tb.compute_f0(tm.metalness, tm.albedo)
    jf0 = jb.compute_f0(jm.metalness, jm.albedo)
    close(tf0, jf0)
    close(tb.eval_direct(tm, tf0, T(n), T(v), T(l)),
          jb.eval_direct(jm, jf0, J(n), J(v), J(l)))
    td, twm = tb.sample(tm, T(n), T(v), T(r1), T(r2))
    jd, jwm = jb.sample(jm, J(n), J(v), J(r1), J(r2))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(twm.numpy(), np.asarray(jwm), rtol=1e-4,
                               atol=1e-5)
    # eval_indirect on the SAME sampled direction (the JAX one) for both.
    close(tb.eval_indirect(tm, tf0, T(n), T(v), T(np.asarray(jd)),
                           T(np.asarray(jwm))),
          jb.eval_indirect(jm, jf0, J(n), J(v), jd, jwm))


@pytest.mark.parametrize("kind", ["REINHARD", "FILMIC", "ACES"])
def test_tonemap_matches_jax(kind):
    from path_tracer_torch.ops import tonemap as ttm
    from path_tracer_tpu.ops import tonemap as jtm

    g = np.random.default_rng(4)
    c = np.concatenate([g.uniform(0, 1, (1000, 3)), g.uniform(0, 50, (1000, 3)),
                        np.zeros((1, 3))]).astype(np.float32)
    tp = ttm.post_process(kind, torch.from_numpy(c))
    jp = jtm.post_process(kind, jnp.asarray(c))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5, atol=1e-4)
    # The u8 cast is the same truncation on the same floats.
    np.testing.assert_array_equal(
        ttm.to_u8(torch.from_numpy(np.array(jp))).numpy(),
        np.asarray(jtm.to_u8(jp)))


def test_texture_fetch_on_head_atlas(head):
    from path_tracer_torch.ops import texturing as tt
    from path_tracer_tpu.ops import texturing as jt

    js, ts = head
    assert not ts.no_textures
    g = np.random.default_rng(5)
    r = 5000
    n_tex = int(np.asarray(js.tex_offset).shape[0])
    tex_id = g.integers(-1, n_tex, r).astype(np.int32)
    uv = g.uniform(-2.5, 3.5, (r, 2)).astype(np.float32)
    got = tt._fetch(ts, torch.from_numpy(tex_id), torch.from_numpy(uv))
    want = jt._fetch(js, jnp.asarray(tex_id), jnp.asarray(uv))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sample_material_on_head(head):
    from path_tracer_torch.ops import texturing as tt
    from path_tracer_tpu.ops import texturing as jt

    js, ts = head
    g = np.random.default_rng(6)
    r = 5000
    n_models = int(np.asarray(js.mat_albedo_factor).shape[0])
    model = g.integers(0, n_models, r).astype(np.int32)
    uv = g.uniform(-1.5, 2.5, (r, 2)).astype(np.float32)
    simple = g.uniform(size=r) < 0.2
    got = tt.sample_material(ts, torch.from_numpy(model), torch.from_numpy(uv),
                             torch.from_numpy(simple))
    want = jt.sample_material(js, jnp.asarray(model), jnp.asarray(uv),
                              jnp.asarray(simple))
    for name, a, b in zip(got._fields, got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-7, err_msg=name)
    tn = tt.sample_normal_map(ts, torch.from_numpy(model), torch.from_numpy(uv))
    jn = jt.sample_normal_map(js, jnp.asarray(model), jnp.asarray(uv))
    if jn[0] is None:
        assert tn == (None, None)
    else:
        np.testing.assert_array_equal(tn[0].numpy(), np.asarray(jn[0]))
        np.testing.assert_array_equal(tn[1].numpy(), np.asarray(jn[1]))


def test_morton_pixel_order_matches():
    from path_tracer_torch.ops.sorting import morton_pixel_order as tm
    from path_tracer_tpu.ops.sorting import morton_pixel_order as jm

    for w, h in ((32, 24), (128, 96), (100, 37)):
        np.testing.assert_array_equal(tm(w, h), jm(w, h))
