"""Radiance RGBE (.hdr) image IO.

The reference samples real HDR environment maps on ray miss
(Assets/Shaders/RaytraceCompute.compute:117-126; assets
Assets/3rdParty/Skybox/Cubemaps/daytime.hdr, sunset.hdr — Unity decodes
them to a cubemap texture). This module is the framework's loader for
the same asset class: a Radiance RGBE file parsed to a float32 (H, W, 3)
equirectangular array, sampled on miss by render.sky_texture.

Format (Radiance picture file, Ward 1991):
  * ASCII header: "#?RADIANCE" (or #?RGBE) magic, FORMAT=32-bit_rle_rgbe,
    blank line, then the resolution line "-Y <H> +X <W>".
  * Pixels: 4 bytes R,G,B,E per pixel; component c decodes to
    (c + 0.5) / 256 * 2^(E-128), all zeros when E == 0.
  * Scanlines are either flat RGBE, old-style RLE (pixel 1,1,1,n repeats
    the previous pixel), or new-style per-component RLE (scanline starts
    0x02 0x02 hi lo, then 4 component streams of run/literal packets).

Both the reader and a writer (flat RGBE) are provided so tests can
round-trip without any binary asset in the repo.
"""

from __future__ import annotations

import numpy as np


def _decode_rgbe(rgbe: np.ndarray) -> np.ndarray:
    """(..., 4) uint8 RGBE -> (..., 3) float32 radiance."""
    rgbe = rgbe.astype(np.float32)
    e = rgbe[..., 3]
    scale = np.where(e == 0.0, 0.0, np.exp2(e - 136.0))  # 2^(E-128)/256
    return ((rgbe[..., :3] + 0.5) * scale[..., None]).astype(np.float32)


def _encode_rgbe(img: np.ndarray) -> np.ndarray:
    """(..., 3) float32 -> (..., 4) uint8 RGBE (Ward's frexp encoding)."""
    img = np.asarray(img, np.float32)
    bright = img.max(axis=-1)
    with np.errstate(divide="ignore"):
        mant, expo = np.frexp(bright)
    # component = floor(c * 2^-expo * 256); bright maps to [128, 255]
    scale = np.where(bright > 0, np.ldexp(256.0, -expo), 0.0)
    rgb = np.clip(img * scale[..., None], 0.0, 255.0).astype(np.uint8)
    e = np.where(bright > 0, expo + 128, 0).astype(np.uint8)
    return np.concatenate([rgb, e[..., None]], axis=-1)


def _read_new_rle_scanline(buf: memoryview, pos: int, width: int,
                           out_row: np.ndarray) -> int:
    """Decode one new-style RLE scanline into out_row (width, 4) uint8.
    Returns the new buffer position."""
    for c in range(4):
        x = 0
        while x < width:
            n = buf[pos]
            pos += 1
            if n > 128:           # run: next byte repeated n-128 times
                run = n - 128
                out_row[x:x + run, c] = buf[pos]
                pos += 1
                x += run
            else:                 # literal: n raw bytes
                if n == 0:        # corrupt: would loop forever
                    raise ValueError("corrupt RLE scanline (empty packet)")
                out_row[x:x + n, c] = np.frombuffer(
                    buf, np.uint8, count=n, offset=pos)
                pos += n
                x += n
        if x != width:
            raise ValueError("corrupt RLE scanline (component overrun)")
    return pos


def load_hdr(path: str) -> np.ndarray:
    """Load a Radiance .hdr file. Returns (H, W, 3) float32 radiance.

    Supports the standard "-Y H +X W" orientation (row 0 at the top) plus
    "+Y H +X W" (bottom-up, flipped on load); flat, old-RLE, and new-RLE
    pixel encodings.
    """
    with open(path, "rb") as f:
        data = f.read()
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError(f"{path}: not a Radiance RGBE file")
    # header: lines until the first empty line
    pos = 0
    fmt_ok = False
    while True:
        nl = data.index(b"\n", pos)
        line = data[pos:nl]
        pos = nl + 1
        if line.startswith(b"FORMAT="):
            if line.strip() == b"FORMAT=32-bit_rle_xyze":
                # XYZE shares the wire format but needs an XYZ->RGB
                # matrix; decoding it as RGBE would silently wreck colors
                raise ValueError(f"{path}: XYZE radiance files are not "
                                 "supported (RGBE only)")
            fmt_ok = line.strip() == b"FORMAT=32-bit_rle_rgbe"
        if line == b"":
            break
    if not fmt_ok:
        raise ValueError(f"{path}: missing FORMAT=32-bit_rle_rgbe header")
    nl = data.index(b"\n", pos)
    res = data[pos:nl].split()
    pos = nl + 1
    if len(res) != 4 or res[0] not in (b"-Y", b"+Y") or res[2] != b"+X":
        raise ValueError(f"{path}: unsupported resolution line {res}")
    height, width = int(res[1]), int(res[3])
    flip = res[0] == b"+Y"

    buf = memoryview(data)
    rows = np.zeros((height, width, 4), np.uint8)
    for y in range(height):
        # new-style RLE marker: 0x02 0x02 and 16-bit width < 32768
        if (width >= 8 and width < 32768 and buf[pos] == 2 and buf[pos + 1] == 2
                and ((buf[pos + 2] << 8) | buf[pos + 3]) == width):
            pos = _read_new_rle_scanline(buf, pos + 4, width, rows[y])
        else:
            # flat / old-style RLE. Fast path: read the whole scanline as
            # (W, 4); only fall back to the scalar expander when it
            # contains an old-style (1,1,1,n) repeat marker (a flat
            # megapixel file — save_hdr's own output — would otherwise
            # decode at ~1.5 us/pixel in the scalar loop)
            if len(buf) - pos >= 4 * width:
                flat = np.frombuffer(buf, np.uint8, count=4 * width,
                                     offset=pos).reshape(width, 4)
                if not ((flat[:, 0] == 1) & (flat[:, 1] == 1)
                        & (flat[:, 2] == 1)).any():
                    rows[y] = flat
                    pos += 4 * width
                    continue
            x = 0
            shift = 0
            while x < width:
                px = np.frombuffer(buf, np.uint8, count=4, offset=pos)
                pos += 4
                if px[0] == 1 and px[1] == 1 and px[2] == 1:
                    run = int(px[3]) << shift
                    rows[y, x:x + run] = rows[y, x - 1]
                    x += run
                    shift += 8
                else:
                    rows[y, x] = px
                    x += 1
                    shift = 0
    img = _decode_rgbe(rows)
    return img[::-1].copy() if flip else img


def save_hdr(path: str, img: np.ndarray) -> None:
    """Write (H, W, 3) float32 radiance as a flat (non-RLE) Radiance file.

    Flat scanlines are valid per the spec (every reader accepts them) and
    keep the writer trivially correct; files are 4 bytes/pixel.
    """
    img = np.asarray(img, np.float32)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3), got {img.shape}")
    h, w = img.shape[:2]
    rgbe = _encode_rgbe(img)
    # marker collisions are unreachable from this encoder: any nonzero
    # pixel's BRIGHTEST channel byte lands in [128, 255], so neither the
    # old-RLE marker (1,1,1,n — needs all of R,G,B <= 1) nor a scanline-
    # leading new-RLE marker (2,2,hi,lo — needs hi = max channel >= 128,
    # i.e. width >= 32768, where readers don't try new-RLE) can be emitted
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\n")
        f.write(b"FORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())


def make_sky_hdr(height: int = 128, width: int = 256,
                 sun_dir=(0.35, 0.55, 0.25), sun_radiance=40.0,
                 sun_cos: float = 0.9995) -> np.ndarray:
    """Procedurally bake a daytime environment map (HDR: the sun disc
    carries radiance far above 1.0) — a stand-in for the reference's
    daytime.hdr asset, generated rather than shipped as a binary."""
    from raytracingtest_tpu.render import sky_color

    v = (np.arange(height, dtype=np.float32) + 0.5) / height
    u = (np.arange(width, dtype=np.float32) + 0.5) / width
    theta = v * np.pi                 # 0 at zenith
    phi = (u - 0.5) * 2.0 * np.pi
    st = np.sin(theta)[:, None]
    d = np.stack([st * np.sin(phi)[None, :],
                  np.broadcast_to(np.cos(theta)[:, None], (height, width)),
                  st * -np.cos(phi)[None, :]], axis=-1)
    img = sky_color(d, np)            # baked == live miss shading
    sd = np.asarray(sun_dir, np.float32)
    sd = sd / np.linalg.norm(sd)
    cosang = d @ sd
    img = img + (cosang > sun_cos)[..., None] * np.float32(sun_radiance)
    return img.astype(np.float32)
