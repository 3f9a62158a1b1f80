"""Gradient noise, backend-parametrized (numpy or jax.numpy).

Role parity: the reference uses OpenSimplex noise for its terrain samplers
(reference: Assets/Scripts/Utility/Noise/Simplex.cs, used from
Assets/Scripts/Utility/SampleFunctions.cs:40-47) plus a native SIMD FastNoise
library (Assets/Scripts/Utility/FastNoise Unity/).  Here we implement one
hash-based 3D Perlin-style gradient noise that is:

  * identical under numpy and jax.numpy (pure integer/float elementwise math,
    no permutation tables to ship to device),
  * vectorized over arbitrarily-shaped coordinate arrays,
  * jit/grad-safe (no data-dependent control flow).

A C++/SIMD batch evaluator with the same hash lives in csrc/ for host-side
streaming builds (the FastNoiseSIMD analog).

The noise is C1-smooth with quintic fade; its Lipschitz constant per unit
input coordinate is bounded by ~3.1 (see ``NOISE3_LIPSCHITZ``): the per-axis
derivative of a single Perlin cell with unit gradients is bounded by
|g|*(1 + max|fade'|*...) — we use an empirically-validated conservative bound,
checked in tests/test_scenes.py by dense finite differences.
"""

from __future__ import annotations

import numpy as np

# Conservative Lipschitz bound for noise3 (per unit coordinate), validated by
# dense finite-difference sweep in tests.
NOISE3_LIPSCHITZ = 4.0


def _native():
    """Lazy import of the optional native library (None if unavailable)."""
    try:
        from raytracingtest_tpu import native
        return native if native.available() else None
    except Exception:
        return None

# 12 edge-gradient directions of classic Perlin noise.
_GRAD = np.array(
    [
        [1, 1, 0], [-1, 1, 0], [1, -1, 0], [-1, -1, 0],
        [1, 0, 1], [-1, 0, 1], [1, 0, -1], [-1, 0, -1],
        [0, 1, 1], [0, -1, 1], [0, 1, -1], [0, -1, -1],
    ],
    dtype=np.float32,
)


def _hash3(ix, iy, iz, seed, xp):
    """Integer lattice hash -> uint32. Identical in numpy and jnp (wrapping u32)."""
    u = xp.uint32
    h = (
        ix.astype(xp.uint32) * u(0x8DA6B343)
        ^ iy.astype(xp.uint32) * u(0xD8163841)
        ^ iz.astype(xp.uint32) * u(0xCB1AB31F)
        ^ u((int(seed) * 0x9E3779B9) & 0xFFFFFFFF)
    )
    h = h ^ (h >> u(13))
    h = h * u(0x5BD1E995)
    h = h ^ (h >> u(15))
    return h


def _fade(t):
    # quintic fade: 6t^5 - 15t^4 + 10t^3
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def noise3(x, y, z, xp=np, seed=0):
    """3D gradient noise in roughly [-1, 1]. Shape-preserving, elementwise.

    Large numpy batches dispatch to the threaded C++ twin in csrc/noise.cpp
    (bit-identical output; the FastNoiseSIMD role for host-side builds)."""
    if xp is np and np.size(x) >= 16384:
        native = _native()
        if native is not None:
            shape = np.shape(x)
            return native.noise3(
                np.broadcast_to(np.asarray(x, np.float32), shape).ravel(),
                np.broadcast_to(np.asarray(y, np.float32), shape).ravel(),
                np.broadcast_to(np.asarray(z, np.float32), shape).ravel(),
                seed=seed).reshape(shape)
    x = xp.asarray(x, xp.float32)
    y = xp.asarray(y, xp.float32)
    z = xp.asarray(z, xp.float32)

    x0 = xp.floor(x)
    y0 = xp.floor(y)
    z0 = xp.floor(z)
    fx = x - x0
    fy = y - y0
    fz = z - z0
    ix = x0.astype(xp.int32)
    iy = y0.astype(xp.int32)
    iz = z0.astype(xp.int32)

    u = _fade(fx)
    v = _fade(fy)
    w = _fade(fz)

    def corner(cx, cy, cz):
        h = _hash3(ix + cx, iy + cy, iz + cz, seed, xp)
        gi = (h % xp.uint32(12)).astype(xp.int32)
        # branch-free gradient decode (values identical to the _GRAD rows,
        # so results are bit-identical to a table lookup): a per-lane
        # xp.take here would be a random gather per sample, which made
        # device-side scene evaluation gather-bound on the original target
        one = xp.float32(1.0)
        s1 = one - xp.float32(2.0) * (gi & 1).astype(xp.float32)
        s2 = one - xp.float32(2.0) * ((gi >> 1) & 1).astype(xp.float32)
        lt4 = gi < 4
        lt8 = gi < 8
        zero = xp.float32(0.0)
        gx = xp.where(lt8, s1, zero)
        gy = xp.where(lt4, s2, xp.where(lt8, zero, s1))
        gz = xp.where(lt4, zero, s2)
        return gx * (fx - cx) + gy * (fy - cy) + gz * (fz - cz)

    # trilinear blend of the 8 corner gradients with faded weights
    n000 = corner(0, 0, 0)
    n100 = corner(1, 0, 0)
    n010 = corner(0, 1, 0)
    n110 = corner(1, 1, 0)
    n001 = corner(0, 0, 1)
    n101 = corner(1, 0, 1)
    n011 = corner(0, 1, 1)
    n111 = corner(1, 1, 1)

    nx00 = n000 + u * (n100 - n000)
    nx10 = n010 + u * (n110 - n010)
    nx01 = n001 + u * (n101 - n001)
    nx11 = n011 + u * (n111 - n011)
    nxy0 = nx00 + v * (nx10 - nx00)
    nxy1 = nx01 + v * (nx11 - nx01)
    return nxy0 + w * (nxy1 - nxy0)


def fbm3(x, y, z, xp=np, seed=0, octaves=2, lacunarity=2.0, gain=0.5):
    """Fractal sum of noise3 octaves (the reference's two-octave terrain,
    Assets/Scripts/Utility/SampleFunctions.cs:40-47).

    Precision note: the native path cascades amp/freq in float32 while the
    Python path uses float64 literals, so bit-identity between the two holds
    when gain/lacunarity are exactly representable binary fractions (the
    0.5/2.0 defaults; e.g. gain=0.7 may drift by ULPs between paths).
    """
    if xp is np:
        # gate on the broadcast size: the batch may live in any operand
        shape = np.broadcast_shapes(np.shape(x), np.shape(y), np.shape(z))
    if xp is np and int(np.prod(shape, dtype=np.int64)) >= 16384:
        native = _native()
        if native is not None:
            return native.fbm3(
                np.broadcast_to(np.asarray(x, np.float32), shape).ravel(),
                np.broadcast_to(np.asarray(y, np.float32), shape).ravel(),
                np.broadcast_to(np.asarray(z, np.float32), shape).ravel(),
                seed=seed, octaves=octaves, lacunarity=lacunarity,
                gain=gain).reshape(shape)
    total = xp.zeros_like(xp.asarray(x, xp.float32))
    amp = 1.0
    freq = 1.0
    for i in range(octaves):
        total = total + amp * noise3(x * freq, y * freq, z * freq, xp=xp, seed=seed + i)
        amp *= gain
        freq *= lacunarity
    return total


def fbm3_lipschitz(octaves=2, lacunarity=2.0, gain=0.5):
    """Lipschitz bound of fbm3 per unit input coordinate."""
    total = 0.0
    amp = 1.0
    freq = 1.0
    for _ in range(octaves):
        total += amp * freq * NOISE3_LIPSCHITZ
        amp *= gain
        freq *= lacunarity
    return total
