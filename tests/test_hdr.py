"""Radiance .hdr loader tests (render/hdr.py).

The reference ships .hdr equirect panoramas and samples them in ShadePass
(shade_pass.h:180-237) with a decode cache (ray_renderer.cpp:679-704);
these tests cover the RGBE decode (flat + RLE scanlines), the write/read
round trip, and the (path, mtime) cache keying.
"""

import os

import numpy as np

from messyerraytracer.render.hdr import (
    load_panorama,
    read_hdr,
    write_hdr,
)


def test_roundtrip_flat(tmp_path):
    rng = np.random.default_rng(0)
    img = (rng.uniform(0, 1, (16, 32, 3)) ** 2 * 40).astype(np.float32)
    p = str(tmp_path / "a.hdr")
    write_hdr(p, img)
    back = read_hdr(p)
    assert back.shape == (16, 32, 3)
    # RGBE: shared exponent across channels => ~1/128 of the max channel
    scale = np.maximum(img.max(axis=-1, keepdims=True), 1e-6)
    assert np.max(np.abs(back - img) / scale) < 0.02


def test_zero_and_dark_pixels(tmp_path):
    img = np.zeros((8, 8, 3), np.float32)
    img[2, 3] = [1e-4, 2e-4, 3e-4]
    p = str(tmp_path / "z.hdr")
    write_hdr(p, img)
    back = read_hdr(p)
    assert back[0, 0].tolist() == [0.0, 0.0, 0.0]
    assert np.allclose(back[2, 3], img[2, 3], rtol=0.02)


def test_rle_scanlines(tmp_path):
    """Hand-build a new-style RLE file: one 16-wide scanline with a run
    and a literal span per channel."""
    w, h = 16, 1
    header = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n" + \
        f"-Y {h} +X {w}\n".encode()
    body = bytearray([2, 2, w >> 8, w & 0xFF])
    for val in (64, 128, 32, 129):  # r, g, b, e channels
        body += bytes([128 + 8] + [val])          # run of 8
        body += bytes([8] + [val] * 8)            # literal span of 8
    p = str(tmp_path / "rle.hdr")
    with open(p, "wb") as f:
        f.write(header + bytes(body))
    img = read_hdr(p)
    assert img.shape == (1, 16, 3)
    # e=129 -> scale 2^(129-136) = 1/128
    np.testing.assert_allclose(img[0, 0], [64 / 128, 128 / 128, 32 / 128])
    np.testing.assert_allclose(img[0, 15], img[0, 0])


def test_panorama_cache(tmp_path):
    img = np.full((4, 8, 3), 0.5, np.float32)
    p = str(tmp_path / "c.hdr")
    write_hdr(p, img)
    a = load_panorama(p)
    b = load_panorama(p)
    assert a is b  # cached
    img2 = np.full((4, 8, 3), 2.0, np.float32)
    write_hdr(p, img2)
    os.utime(p, (os.path.getmtime(p) + 5, os.path.getmtime(p) + 5))
    c = load_panorama(p)
    assert c is not a
    assert float(np.asarray(c)[0, 0, 0]) > 1.5


def test_feeds_sample_panorama(tmp_path):
    import jax.numpy as jnp

    from messyerraytracer.render.shade import sample_panorama

    img = np.zeros((8, 16, 3), np.float32)
    img[:, :, 0] = np.linspace(0, 1, 16)[None, :]
    p = str(tmp_path / "s.hdr")
    write_hdr(p, img)
    pan = load_panorama(p)
    u = jnp.asarray([0.25, 0.75])
    v = jnp.asarray([0.5, 0.5])
    rgb = sample_panorama(pan, u, v, 1.0)
    assert float(rgb[1, 0]) > float(rgb[0, 0])
