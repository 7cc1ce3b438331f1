"""The JPEG kinds Pillow decodes beyond baseline and progressive Huffman
(lossless, arithmetic-coded, CMYK and YCCK, sampling factors 3 and 4),
through the port's decoder (``utils/jpeg.py``, ``utils/jpeg_arith.py``)
and loaders (``utils/image_io.py``), against Pillow and the JAX package.

Pillow writes none of these but CMYK, so tests/tools/torch_jpeg_writer.py
writes them, and is itself held to Pillow: a lossless file decodes in
Pillow to its source samples, an arithmetic-coded file (a Pillow file's
coefficients and scans, transcoded) to the texels of the Huffman file it
came from. The port then decodes every file to Pillow's texels (the count
of texels off is stated, and is 0); what Pillow refuses, the port refuses
with a ``ValueError`` naming the image.
"""
import io
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from path_tracer_torch.utils.image_io import (
    cmyk_to_rgb,
    decode_image_rgba,
    load_texture_gray,
    load_texture_rgb,
    read_png,
)
from path_tracer_torch.utils.jpeg import decode_jpeg

sys.path.insert(0, str(Path(__file__).parent / "tools"))
import torch_gen_test_glb as glb_gen  # noqa: E402
import torch_jpeg_writer as jw  # noqa: E402

FIXTURES = Path(__file__).parent / "fixtures" / "torch_images"
H, W = 29, 37


def _image(h=H, w=W, seed=3):
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = np.stack([(xx * 5) % 256, (yy * 7) % 256,
                       ((xx + yy) * 3) % 256], -1)
    noise = np.random.default_rng(seed).integers(0, 256, (h, w, 3))
    return np.where(((xx // 8 + yy // 8) % 2 == 0)[..., None], smooth,
                    noise).astype(np.uint8)


def _pillow_jpeg(img, mode=None, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img, mode).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _pillow(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)))


def _texels_off(data: bytes) -> int:
    """Texels of the port's decode that differ from Pillow's, both as
    decoded (Pillow's mode) and as ``convert("RGBA")``."""
    im = Image.open(io.BytesIO(data))
    want = np.asarray(im)
    got = decode_jpeg(data, "t.jpg")
    assert got.shape == want.shape
    rgba = np.asarray(im.convert("RGBA"))
    return int((got != want).sum() + (decode_image_rgba(data) != rgba).sum())


def _lossless_cases(predictor: int):
    """(file, the samples Pillow must give) for one predictor: gray and
    three components (no colour marker, and Adobe transform 0), point
    transforms 0 and 1, restart intervals of 0, 1 and 2 MCU rows, one
    interleaved scan and a scan per component, and 2x2-sampled luma
    with restarts inside an iMCU row of its own scan."""
    img = _image(13, 17, seed=predictor)
    for pt in (0, 1):
        want = (img >> pt) << pt
        for rows in (0, 1, 2):
            yield (jw.lossless([img[..., 1]], [(1, 1)], 17, 13, predictor,
                               pt=pt, restart_rows=rows), want[..., 1])
            for app in (b"", jw.adobe(0)):
                for inter in (True, False):
                    yield (jw.lossless([img[..., i] for i in range(3)],
                                       [(1, 1)] * 3, 17, 13, predictor,
                                       pt=pt, restart_rows=rows, app=app,
                                       interleaved=inter), want)
    luma, chroma = img[..., 0], img[:7, :9, 1:]
    for inter in (True, False):
        for rows in (0, 1, 3):
            data = jw.lossless([luma, chroma[..., 0], chroma[..., 1]],
                               [(2, 2), (1, 1), (1, 1)], 17, 13, predictor,
                               restart_rows=rows, interleaved=inter,
                               ids=[82, 71, 66])
            up = np.repeat(np.repeat(chroma, 2, 0), 2, 1)[:13, :17]
            yield data, np.concatenate([luma[..., None], up], axis=2)


@pytest.mark.parametrize("predictor", range(1, 8))
def test_lossless_writer_held_to_pillow(predictor):
    """Each lossless file decodes in Pillow to its source samples (point
    transformed), replication upsampling 2x2 chroma."""
    n = 0
    for data, want in _lossless_cases(predictor):
        assert b"\xff\xc3" in data
        np.testing.assert_array_equal(_pillow(data), want)
        n += 1
    assert n == 36


@pytest.mark.parametrize("predictor", range(1, 8))
def test_lossless_decodes_as_pillow(predictor):
    off = sum(_texels_off(data) for data, _ in _lossless_cases(predictor))
    assert off == 0, f"{off} texels off"


def _huffman_sources(progressive: bool, subsampling: int):
    img = _image(61, 83)
    for kw in ({}, {"restart_marker_blocks": 3}, {"restart_marker_rows": 1}):
        yield _pillow_jpeg(img, quality=75, subsampling=subsampling,
                           progressive=progressive, **kw)
    yield _pillow_jpeg(img[..., 1], quality=90, progressive=progressive)


def _arithmetic_cases(progressive: bool, subsampling: int):
    """(arithmetic-coded file, the Huffman file it came from): Pillow's
    files with and without restart markers, gray, and one with DAC
    conditioning other than the defaults and its own restart interval."""
    for src in _huffman_sources(progressive, subsampling):
        yield jw.to_arithmetic(src), src
    src = next(_huffman_sources(progressive, subsampling))
    dac = {("dc", 0): (2, 5), ("dc", 1): (1, 1), ("ac", 0): 20,
           ("ac", 1): 2}
    yield jw.to_arithmetic(src, dac=dac, interval=5), src


ARITH = [(p, s) for p in (False, True) for s in (0, 1, 2)]


@pytest.mark.parametrize("progressive,subsampling", ARITH)
def test_arithmetic_writer_held_to_pillow(progressive, subsampling):
    """A transcoded file decodes in Pillow to the Huffman file's texels."""
    sof = b"\xff\xca" if progressive else b"\xff\xc9"
    for data, src in _arithmetic_cases(progressive, subsampling):
        assert sof in data and b"\xff\xc4" not in data
        np.testing.assert_array_equal(_pillow(data), _pillow(src))


@pytest.mark.parametrize("progressive,subsampling", ARITH)
def test_arithmetic_decodes_as_pillow(progressive, subsampling):
    """Sequential and progressive (DC and AC first and refine scans), at
    4:4:4, 4:2:2 and 4:2:0, with restarts: Pillow's texels, and those of
    the Huffman file the port decodes."""
    for data, src in _arithmetic_cases(progressive, subsampling):
        off = _texels_off(data)
        assert off == 0, f"{off} texels off"
        np.testing.assert_array_equal(decode_jpeg(data), decode_jpeg(src))


def _cmyk_files(kw):
    img = _image(61, 83)
    cmyk = np.concatenate([img, img[..., 2:] // 2], axis=2)
    cmyk_file = _pillow_jpeg(cmyk, "CMYK", **kw)
    ycck = bytearray(cmyk_file)
    at = ycck.index(b"Adobe") + 11
    assert ycck[at] == 0  # Pillow's CMYK: Adobe transform 0
    ycck[at] = 2
    start = cmyk_file.index(b"\xff\xee")
    end = start + 2 + int.from_bytes(cmyk_file[start + 2:start + 4], "big")
    no_adobe = cmyk_file[:start] + cmyk_file[end:]
    return {"cmyk": cmyk_file, "ycck": bytes(ycck),
            "cmyk without Adobe": no_adobe,
            "ycck arithmetic": jw.to_arithmetic(bytes(ycck))}


@pytest.mark.parametrize("kw", [{"quality": 50}, {"quality": 90},
                                {"quality": 75, "progressive": True},
                                {"quality": 75, "restart_marker_rows": 1}],
                         ids=["q50", "q90", "progressive", "restart"])
def test_cmyk_and_ycck_decode_as_pillow(kw):
    """Pillow's own CMYK files; YCCK made by setting their Adobe transform
    to 2; a CMYK file without its Adobe marker (Pillow inverts it all the
    same): the CMYK Pillow gives, and its ``convert("RGBA")``."""
    for label, data in _cmyk_files(kw).items():
        assert _pillow(data).shape == (61, 83, 4)
        off = _texels_off(data)
        assert off == 0, (label, f"{off} texels off")


def test_cmyk_to_rgb_is_pillows():
    """Every texel of a 17^4 grid of (c, m, y, k), and every (channel,
    k) pair, as Pillow's ``convert("RGB")`` of mode ``CMYK``."""
    v = np.linspace(0, 255, 17).round().astype(np.uint8)
    grid = np.stack(np.meshgrid(v, v, v, v, indexing="ij"), -1)
    grid = grid.reshape(289, 289, 4)
    want = np.asarray(Image.fromarray(grid, "CMYK").convert("RGB"))
    assert int((cmyk_to_rgb(grid) != want).sum()) == 0
    x, k = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    every = np.stack([x, 255 - x, x ^ 0x5A, k], -1).astype(np.uint8)
    want = np.asarray(Image.fromarray(every, "CMYK").convert("RGB"))
    assert int((cmyk_to_rgb(every) != want).sum()) == 0


LAYOUTS = {
    "4:1:1": [(4, 1), (1, 1), (1, 1)],
    "3x1": [(3, 1), (1, 1), (1, 1)],
    "1x3": [(1, 3), (1, 1), (1, 1)],
    "4x1 over 2x1": [(4, 1), (2, 1), (2, 1)],
    "1x4 over 1x2": [(1, 4), (1, 2), (1, 2)],
    "4x2": [(4, 2), (1, 1), (1, 1)],
    "2x4": [(2, 4), (1, 1), (1, 1)],
    "3x2": [(3, 2), (1, 1), (1, 1)],
    "4x4 scans apart": [(4, 4), (2, 2), (1, 1)],
    "3x3 scans apart": [(3, 3), (1, 3), (3, 1)],
    "cmyk 2x1 k 2x1": [(2, 1), (1, 1), (1, 1), (2, 1)],
}
SIZES = ((61, 83), (9, 13), (3, 5), (1, 1))


def _dct_file(factors, h, w, coding, separate=False) -> bytes:
    """The writer's DCT file of ``_image`` with ``factors``: each
    component's samples taken nearest, forward-DCT'd, a restart marker
    every 3 MCUs; JFIF YCbCr, or Adobe CMYK for four components."""
    img = _image(61, 83)[:h, :w]
    planes = jw.ycbcr(img)
    planes = np.concatenate([planes, planes[..., :1]], axis=2)
    hmax = max(a for a, _ in factors)
    vmax = max(b for _, b in factors)
    lay, _, _ = jw.layout(w, h, [dict(h=a, v=b) for a, b in factors])
    q = np.full(64, 6)
    q[0] = 4
    comps = []
    for i, ((a, b), (cw, ch, bw, bh)) in enumerate(zip(factors, lay)):
        ys = (np.arange(ch) * vmax // b).clip(0, h - 1)
        xs = (np.arange(cw) * hmax // a).clip(0, w - 1)
        plane = planes[..., i][ys][:, xs].clip(0, 255)
        comps.append(dict(id=i + 1, h=a, v=b, tq=0, scan=i if separate else 0,
                          coef=jw.fdct(plane, q, bh, bw)))
    app = jw.adobe(0) if len(factors) == 4 else jw.JFIF
    return jw.dct(comps, w, h, {0: q}, coding=coding, interval=3, app=app)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_sampling_factors_3_and_4_decode_as_pillow(layout):
    """Whole ratios of 3 and 4 replicate (int_upsample), ratio 2 under a
    largest factor of 4 filters (fancy), Huffman and arithmetic-coded,
    from 83 x 61 down to 1 x 1; and the same factors lossless."""
    factors = LAYOUTS[layout]
    for coding in ("huffman", "arithmetic"):
        for h, w in SIZES:
            data = _dct_file(factors, h, w, coding, "apart" in layout)
            off = _texels_off(data)
            assert off == 0, (coding, h, w, f"{off} texels off")
    hmax = max(a for a, _ in factors)
    vmax = max(b for _, b in factors)
    img = np.concatenate([_image(), _image()[..., :1]], axis=2)
    comps = [img[:-(-H * b // vmax), :-(-W * a // hmax), i]
             for i, (a, b) in enumerate(factors)]
    data = jw.lossless(comps, factors, W, H, 5, restart_rows=2,
                       interleaved="apart" not in layout)
    off = _texels_off(data)
    assert off == 0, ("lossless", f"{off} texels off")


def _refused():
    """Files Pillow refuses: (label, bytes)."""
    img = _image()
    ll = jw.lossless([img[..., i] for i in range(3)], [(1, 1)] * 3, W, H, 1)
    sof11 = bytearray(ll)
    sof11[sof11.index(b"\xff\xc3") + 1] = 0xCB
    q = np.full(64, 8)
    lay, _, _ = jw.layout(W, H, [dict(h=3, v=1), dict(h=2, v=1),
                                 dict(h=1, v=1)])
    frac = [dict(id=i + 1, h=a, v=1, tq=0,
                 coef=np.zeros((bh, bw, 64), np.int64))
            for i, (a, (_, _, bw, bh)) in enumerate(zip((3, 2, 1), lay))]
    big = [dict(id=i + 1, h=a, v=a, tq=0,
                coef=np.zeros((bh, bw, 64), np.int64))
           for i, (a, (_, _, bw, bh)) in enumerate(zip((4, 1, 1), jw.layout(
               W, H, [dict(h=a, v=a) for a in (4, 1, 1)])[0]))]
    cmyk = np.concatenate([img, img[..., :1]], axis=2)
    return {
        "lossless YCbCr (JFIF)": jw.lossless(
            [img[..., i] for i in range(3)], [(1, 1)] * 3, W, H, 1,
            app=jw.JFIF),
        "lossless YCbCr (Adobe 1)": jw.lossless(
            [img[..., i] for i in range(3)], [(1, 1)] * 3, W, H, 1,
            app=jw.adobe(1)),
        "lossless YCCK": jw.lossless(
            [cmyk[..., i] for i in range(4)], [(1, 1)] * 4, W, H, 1,
            app=jw.adobe(2)),
        "arithmetic lossless (SOF11)": bytes(sof11),
        "sampling 3x1 over 2x1": jw.dct(frac, W, H, {0: q}),
        "16 blocks in an MCU": jw.dct(big, W, H, {0: q}),
    }


@pytest.mark.parametrize("label", list(_refused()))
def test_what_pillow_refuses_raises(label):
    data = _refused()[label]
    with pytest.raises(OSError):
        Image.open(io.BytesIO(data)).load()
    with pytest.raises(ValueError, match=r"^refused\.jpg: "):
        decode_jpeg(data, "refused.jpg")


def _texture_kinds():
    """One JPEG of each new kind: name -> bytes."""
    img = _image()
    kinds = {p.name: p.read_bytes() for p in sorted(FIXTURES.glob("*.jpg"))}
    kinds["ll_rgb_2x1.jpg"] = jw.lossless(
        [img[..., 0], img[:, :19, 1], img[:, :19, 2]],
        [(2, 1), (1, 1), (1, 1)], W, H, 3, restart_rows=4)
    kinds["arith_gray.jpg"] = jw.to_arithmetic(_pillow_jpeg(
        img[..., 2], quality=80, progressive=True))
    return kinds


@pytest.mark.parametrize("kind", list(_texture_kinds()))
def test_texture_loaders_match_the_jax_loaders(tmp_path, kind):
    """The port's ISF loaders against the JAX package's (Pillow) on a
    JPEG of each kind in a scene's texture directory."""
    from path_tracer_tpu.utils import image_io as jax_io

    path = tmp_path / "textures" / kind
    path.parent.mkdir()
    path.write_bytes(_texture_kinds()[kind])
    np.testing.assert_array_equal(load_texture_rgb(path),
                                  jax_io.load_texture_rgb(path))
    np.testing.assert_array_equal(load_texture_gray(path),
                                  jax_io.load_texture_gray(path))


def test_isf_scene_with_jpeg_texture_renders_as_jax(tmp_path,
                                                    reference_scenes):
    """``alpha_transparency`` with its albedo PNG replaced by an
    arithmetic-coded progressive 4:2:0 JPEG of the same texels: the
    port's scene loads it, and its render agrees with the JAX package's
    (op by op) at the texture-parity tolerance of
    tests/test_torch_alpha_render.py (rtol 1e-3, atol 1e-4; at most 1% of
    values outside)."""
    import jax
    import jax.numpy as jnp
    import torch

    from path_tracer_torch.models.integrator import IntegratorSpec
    from path_tracer_torch.models.renderer import render_pixel_sums
    from path_tracer_torch.scene import load_scene
    from path_tracer_tpu.models.integrator import IntegratorSpec as JSpec
    from path_tracer_tpu.models.integrator import render_wavefront
    from path_tracer_tpu.scene import load_scene as jax_load

    src = reference_scenes / "alpha_transparency"
    shutil.copytree(src, tmp_path / "s")
    albedo = np.asarray(Image.open(src / "albedo_tex_0.png").convert("RGB"))
    jpeg = jw.to_arithmetic(_pillow_jpeg(albedo, quality=90, subsampling=2,
                                         progressive=True))
    (tmp_path / "s" / "albedo_tex_0.jpg").write_bytes(jpeg)
    (tmp_path / "s" / "albedo_tex_0.png").unlink()
    isf = tmp_path / "s" / "scene.isf"
    doc = json.loads(isf.read_text())
    doc["models"][0]["material"]["albedo"]["texture"] = "albedo_tex_0.jpg"
    isf.write_text(json.dumps(doc))
    w, h, bounces = 16, 12, 2
    scene = load_scene(isf, "cpu")
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        got = render_pixel_sums(scene, w, h, 1, 1,
                                IntegratorSpec(bounces=bounces))
    finally:
        torch.set_num_threads(n)
    assert np.isfinite(got).all() and got.std() > 0
    with jax.disable_jit():
        want = np.asarray(render_wavefront(
            jax_load(isf), jnp.arange(w * h, dtype=jnp.int32), w, h,
            jnp.int32(1), JSpec(bounces=bounces, differentiable=False)))
    outside = np.abs(got - want) > 1e-4 + 1e-3 * np.abs(want)
    assert outside.mean() <= 0.01


def test_glb_with_new_kinds_converts_as_jax(tmp_path):
    """The port's glb generator with the fixtures' JPEGs of the new kinds
    as its textures: ``path-tracer-torch convert`` gives the JAX
    converter's ISF bytes, texture names and texels, and the PNG bytes
    of its own conversion of the same glb with Pillow's decodes
    (``.pillow.png``) in the JPEGs' place."""
    from path_tracer_torch import cli
    from path_tracer_tpu.scene.gltf import convert_gltf_to_isf

    kinds = [p for p in sorted(FIXTURES.glob("*.jpg"))
             if not p.name.startswith(("gray_q", "rgb_4"))
             or p.name.startswith("rgb_411")]
    assert len(kinds) == 7
    for tag, files in (("jpeg", kinds), ("png", [
            p.with_name(p.name + ".pillow.png") for p in kinds])):
        glb_gen.write_glb(tmp_path / f"{tag}.glb",
                          textures=[p.read_bytes() for p in files])
        cli.main(["convert", str(tmp_path / f"{tag}.glb"),
                  str(tmp_path / tag)])
    convert_gltf_to_isf(tmp_path / "jpeg.glb", tmp_path / "jax")
    port, want, png = tmp_path / "jpeg", tmp_path / "jax", tmp_path / "png"
    names = sorted(p.name for p in want.iterdir())
    assert sorted(p.name for p in port.iterdir()) == names
    assert sum(n.startswith("albedo_tex_") for n in names) == 7
    assert (port / "scene.isf").read_bytes() == \
        (want / "scene.isf").read_bytes()
    for name in names:
        if name.endswith(".png"):
            a, b = Image.open(port / name), Image.open(want / name)
            assert a.mode == b.mode, name
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), name)
            assert (port / name).read_bytes() == (png / name).read_bytes()
    texels = read_png(port / "albedo_tex_0.png")
    assert texels.shape[:2] == (H, W)
