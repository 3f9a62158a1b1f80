"""Radiance .hdr loader/writer tests (reference parity: the HDR skybox
assets Assets/3rdParty/Skybox/Cubemaps/*.hdr sampled on miss by
RaytraceCompute.compute:117-126)."""

import numpy as np
import pytest

from raytracingtest_tpu.io import hdr


def test_roundtrip_flat(tmp_path):
    rng = np.random.default_rng(0)
    # dynamic range spanning ~12 stops including true HDR values
    img = (rng.random((33, 47, 3), dtype=np.float32) ** 2) * 300.0
    img[0, 0] = 0.0                      # exact zero pixel
    img[5, 5] = (1e-4, 50.0, 0.3)        # high contrast within one pixel
    path = str(tmp_path / "rtt_test_roundtrip.hdr")
    hdr.save_hdr(path, img)
    out = hdr.load_hdr(path)
    assert out.shape == img.shape
    # RGBE carries ~8 bits of mantissa on the brightest channel: 1%
    # relative (anchored to the pixel max, which sets the exponent)
    scale = np.maximum(img.max(axis=-1, keepdims=True), 1e-9)
    assert np.all(np.abs(out - img) <= 0.01 * scale + 1e-9)
    assert np.all(out[0, 0] == 0.0)


def test_roundtrip_marker_adjacent_values(tmp_path):
    # dim pixels near the RLE-marker byte patterns: the encoder's
    # brightest-channel-in-[128,255] invariant keeps actual markers
    # unreachable, so these must round-trip exactly like any other value
    w = 300
    img = np.zeros((3, w, 3), np.float32)
    img[1, :] = (1.5 / 256, 1.5 / 256, 1.5 / 256)       # encodes (1,1,1,E)
    img[2, 0] = (2.5 / 256 * 2.0 ** (w % 256 - 128 + 8),) * 3
    path = str(tmp_path / "rtt_test_markers.hdr")
    hdr.save_hdr(path, img)
    out = hdr.load_hdr(path)
    assert out.shape == img.shape
    scale = np.maximum(img.max(axis=-1, keepdims=True), 1e-9)
    assert np.all(np.abs(out - img) <= 0.02 * scale + 1e-9)


def test_new_rle_decode(tmp_path):
    # hand-build a new-style RLE file: runs + literals per component
    w, h = 16, 2
    row = np.zeros((w, 4), np.uint8)
    row[:, 0] = 10                        # R: one run of 16
    row[:, 1] = np.arange(w)              # G: literals
    row[:, 2] = 7
    row[:, 3] = 128                       # E=128 -> scale 1/256
    payload = b""
    for y in range(h):
        payload += bytes([2, 2, w >> 8, w & 0xFF])
        payload += bytes([128 + w, 10])               # R run
        payload += bytes([w]) + bytes(range(w))       # G literal
        payload += bytes([128 + w, 7])                # B run
        payload += bytes([128 + w, 128])              # E run
    data = (b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"
            + f"-Y {h} +X {w}\n".encode() + payload)
    path = str(tmp_path / "rtt_test_newrle.hdr")
    with open(path, "wb") as f:
        f.write(data)
    out = hdr.load_hdr(path)
    exp = hdr._decode_rgbe(np.broadcast_to(row, (h, w, 4)))
    np.testing.assert_allclose(out, exp, rtol=0, atol=0)


def test_old_rle_decode(tmp_path):
    # flat scanline containing an old-style repeat marker
    w, h = 6, 1
    px = bytes([40, 50, 60, 130])
    rep = bytes([1, 1, 1, 4])             # repeat previous pixel 4x
    tail = bytes([70, 80, 90, 130])
    data = (b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"
            + f"-Y {h} +X {w}\n".encode() + px + rep + tail)
    path = str(tmp_path / "rtt_test_oldrle.hdr")
    with open(path, "wb") as f:
        f.write(data)
    out = hdr.load_hdr(path)
    assert out.shape == (1, 6, 3)
    np.testing.assert_array_equal(out[0, 0], out[0, 3])
    assert not np.array_equal(out[0, 0], out[0, 5])


def test_flip_orientation(tmp_path):
    img = np.zeros((4, 4, 3), np.float32)
    img[0, :] = 1.0
    path = str(tmp_path / "rtt_test_flip.hdr")
    hdr.save_hdr(path, img)
    with open(path, "rb") as f:
        data = f.read()
    with open(path, "wb") as f:
        f.write(data.replace(b"-Y 4", b"+Y 4"))
    out = hdr.load_hdr(path)
    assert np.all(out[3] > 0.9) and np.all(out[0] == 0.0)


def test_rejects_non_hdr(tmp_path):
    path = str(tmp_path / "rtt_test_bad.hdr")
    with open(path, "wb") as f:
        f.write(b"PNG nonsense")
    with pytest.raises(ValueError):
        hdr.load_hdr(path)


def test_render_with_hdr_skybox(tmp_path):
    """A frame rendered with a real environment map: sun-disc HDR values
    reach the image through sky_texture on miss rays."""
    import jax.numpy as jnp
    from raytracingtest_tpu import build_svo, get_scene
    from raytracingtest_tpu.ops.camera import Camera
    from raytracingtest_tpu.render import render_jax

    tex = hdr.make_sky_hdr(height=64, width=128, sun_dir=(0.0, 0.6, 0.8),
                           sun_radiance=25.0, sun_cos=0.98)
    path = str(tmp_path / "rtt_test_sky.hdr")
    hdr.save_hdr(path, tex)
    tex2 = hdr.load_hdr(path)

    svo = build_svo(get_scene("sphere"), 4).svo
    cam = Camera(position=(0.5, 0.5, -1.2), look_at=(0.5, 0.55, 0.5),
                 fov_y_deg=60.0, width=64, height=64)
    img = np.asarray(render_jax(svo, cam, skybox=jnp.asarray(tex2)))
    assert img.shape == (64, 64, 3)
    assert np.isfinite(img).all()
    # the sun disc (radiance >> 1) must appear on some miss pixel
    assert img.max() > 5.0
    # and hit pixels still shade below 2.0 (LDR surface shading)
    assert img.min() >= 0.0


def test_rejects_xyze_and_corrupt_rle(tmp_path):
    # XYZE shares the wire format but would decode to wrong colors
    data = (b"#?RADIANCE\nFORMAT=32-bit_rle_xyze\n\n-Y 1 +X 2\n"
            + bytes([10, 10, 10, 128]) * 2)
    path = str(tmp_path / "rtt_test_xyze.hdr")
    with open(path, "wb") as f:
        f.write(data)
    with pytest.raises(ValueError, match="XYZE"):
        hdr.load_hdr(path)
    # zero-length literal packet must raise, not loop forever
    w = 16
    payload = bytes([2, 2, 0, w]) + bytes([0])  # empty literal packet
    data = (b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"
            + f"-Y 1 +X {w}\n".encode() + payload)
    path = str(tmp_path / "rtt_test_corrupt.hdr")
    with open(path, "wb") as f:
        f.write(data)
    with pytest.raises(ValueError, match="empty packet"):
        hdr.load_hdr(path)
