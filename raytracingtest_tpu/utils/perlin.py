"""Classic (improved) Perlin noise, vectorized (numpy / jax.numpy).

Parity port of the reference's `Assets/Scripts/Utility/Noise/Perlin.cs`
(Keijiro Takahashi's Unity port of Ken Perlin's reference implementation,
itself public domain: http://mrl.nyu.edu/~perlin/noise/). The permutation
table below is Ken Perlin's canonical 256-entry table — like the
OpenSimplex lattice tables (utils/opensimplex.py), the constants ARE the
algorithm: any faithful implementation contains them.

The reference class is dead code (never called from project code), ported
for component completeness (SURVEY.md §2.7 row "Perlin noise"). Semantics
mirrored exactly, restructured for array evaluation:

  * `Perlin.cs:17-23`  noise1 — 1D gradient noise, doubled amplitude
  * `Perlin.cs:25-36`  noise2 — 2D, hash chain perm[perm[X]+Y]
  * `Perlin.cs:43-66`  noise3 — 3D, hash chain perm[perm[perm[X]+Y]+Z]
  * `Perlin.cs:77-117` fbm    — octave sum, lacunarity 2, gain 1/2
  * `Perlin.cs:126-155` fade / lerp / grad variants

All math is float32 (the C# original computes in float); evaluation is
dense array ops — `jnp.take` on the 257-entry table instead of scalar
array indexing, branch-free `where` selects instead of ternaries — so the
whole lattice evaluation fuses into a handful of VPU kernels under jit.
Works with xp=numpy or xp=jax.numpy.
"""

from __future__ import annotations

import numpy as np

# Ken Perlin's canonical permutation (256 entries + wrap duplicate so the
# +1 reads at index 256 need no modulo — same layout as Perlin.cs:157-173)
PERM = np.array([
    151, 160, 137, 91, 90, 15,
    131, 13, 201, 95, 96, 53, 194, 233, 7, 225, 140, 36, 103, 30, 69, 142,
    8, 99, 37, 240, 21, 10, 23,
    190, 6, 148, 247, 120, 234, 75, 0, 26, 197, 62, 94, 252, 219, 203, 117,
    35, 11, 32, 57, 177, 33,
    88, 237, 149, 56, 87, 174, 20, 125, 136, 171, 168, 68, 175, 74, 165,
    71, 134, 139, 48, 27, 166,
    77, 146, 158, 231, 83, 111, 229, 122, 60, 211, 133, 230, 220, 105, 92,
    41, 55, 46, 245, 40, 244,
    102, 143, 54, 65, 25, 63, 161, 1, 216, 80, 73, 209, 76, 132, 187, 208,
    89, 18, 169, 200, 196,
    135, 130, 116, 188, 159, 86, 164, 100, 109, 198, 173, 186, 3, 64, 52,
    217, 226, 250, 124, 123,
    5, 202, 38, 147, 118, 126, 255, 82, 85, 212, 207, 206, 59, 227, 47, 16,
    58, 17, 182, 189, 28, 42,
    223, 183, 170, 213, 119, 248, 152, 2, 44, 154, 163, 70, 221, 153, 101,
    155, 167, 43, 172, 9,
    129, 22, 39, 253, 19, 98, 108, 110, 79, 113, 224, 232, 178, 185, 112,
    104, 218, 246, 97, 228,
    251, 34, 242, 193, 238, 210, 144, 12, 191, 179, 162, 241, 81, 51, 145,
    235, 249, 14, 239, 107,
    49, 192, 214, 31, 181, 199, 106, 157, 184, 84, 204, 176, 115, 121, 50,
    45, 127, 4, 150, 254,
    138, 236, 205, 93, 222, 114, 67, 29, 24, 72, 243, 141, 128, 195, 78,
    66, 215, 61, 156, 180,
    151,
], dtype=np.int32)


def _fade(t, xp):
    # 6t^5 - 15t^4 + 10t^3 (Perlin.cs:128-131)
    return t * t * t * (t * (t * np.float32(6) - np.float32(15))
                        + np.float32(10))


def _lerp(t, a, b):
    return a + t * (b - a)


def _grad1(h, x, xp):
    return xp.where((h & 1) == 0, x, -x)


def _grad2(h, x, y, xp):
    return (xp.where((h & 1) == 0, x, -x)
            + xp.where((h & 2) == 0, y, -y))


def _grad3(h, x, y, z, xp):
    # the 12-edge gradient select of improved noise (Perlin.cs:148-154)
    h = h & 15
    u = xp.where(h < 8, x, y)
    v = xp.where(h < 4, y, xp.where((h == 12) | (h == 14), x, z))
    return (xp.where((h & 1) == 0, u, -u)
            + xp.where((h & 2) == 0, v, -v))


def _floor_cell(x, xp):
    """(cell index & 0xff, float32 fractional part) — FloorToInt + frac."""
    fx = xp.floor(x)
    return xp.asarray(fx, np.int32) & 0xFF, (x - fx).astype(np.float32)


def noise1(x, xp=np):
    """1D Perlin noise, amplitude-doubled like the reference
    (Perlin.cs:17-23). x: float array; returns float32 array in ~[-1, 1]."""
    x = xp.asarray(x, np.float32)
    perm = xp.asarray(PERM)
    X, x = _floor_cell(x, xp)
    u = _fade(x, xp)
    g0 = _grad1(xp.take(perm, X), x, xp)
    g1 = _grad1(xp.take(perm, X + 1), x - np.float32(1), xp)
    return _lerp(u, g0, g1) * np.float32(2)


def noise2(x, y, xp=np):
    """2D Perlin noise (Perlin.cs:25-36). Returns float32 array."""
    x = xp.asarray(x, np.float32)
    y = xp.asarray(y, np.float32)
    perm = xp.asarray(PERM)
    X, x = _floor_cell(x, xp)
    Y, y = _floor_cell(y, xp)
    u = _fade(x, xp)
    v = _fade(y, xp)
    A = (xp.take(perm, X) + Y) & 0xFF
    B = (xp.take(perm, X + 1) + Y) & 0xFF
    one = np.float32(1)
    n00 = _grad2(xp.take(perm, A), x, y, xp)
    n10 = _grad2(xp.take(perm, B), x - one, y, xp)
    n01 = _grad2(xp.take(perm, A + 1), x, y - one, xp)
    n11 = _grad2(xp.take(perm, B + 1), x - one, y - one, xp)
    return _lerp(v, _lerp(u, n00, n10), _lerp(u, n01, n11))


def noise3(x, y, z, xp=np):
    """3D Perlin noise (Perlin.cs:43-66). Returns float32 array."""
    x = xp.asarray(x, np.float32)
    y = xp.asarray(y, np.float32)
    z = xp.asarray(z, np.float32)
    perm = xp.asarray(PERM)
    X, x = _floor_cell(x, xp)
    Y, y = _floor_cell(y, xp)
    Z, z = _floor_cell(z, xp)
    u = _fade(x, xp)
    v = _fade(y, xp)
    w = _fade(z, xp)
    A = (xp.take(perm, X) + Y) & 0xFF
    B = (xp.take(perm, X + 1) + Y) & 0xFF
    AA = (xp.take(perm, A) + Z) & 0xFF
    BA = (xp.take(perm, B) + Z) & 0xFF
    AB = (xp.take(perm, A + 1) + Z) & 0xFF
    BB = (xp.take(perm, B + 1) + Z) & 0xFF
    one = np.float32(1)
    n000 = _grad3(xp.take(perm, AA), x, y, z, xp)
    n100 = _grad3(xp.take(perm, BA), x - one, y, z, xp)
    n010 = _grad3(xp.take(perm, AB), x, y - one, z, xp)
    n110 = _grad3(xp.take(perm, BB), x - one, y - one, z, xp)
    n001 = _grad3(xp.take(perm, AA + 1), x, y, z - one, xp)
    n101 = _grad3(xp.take(perm, BA + 1), x - one, y, z - one, xp)
    n011 = _grad3(xp.take(perm, AB + 1), x, y - one, z - one, xp)
    n111 = _grad3(xp.take(perm, BB + 1), x - one, y - one, z - one, xp)
    return _lerp(w,
                 _lerp(v, _lerp(u, n000, n100), _lerp(u, n010, n110)),
                 _lerp(v, _lerp(u, n001, n101), _lerp(u, n011, n111)))


def fbm3(x, y, z, octaves, xp=np):
    """Octave sum of noise3: lacunarity 2, gain 1/2 (Perlin.cs:104-113)."""
    x = xp.asarray(x, np.float32)
    y = xp.asarray(y, np.float32)
    z = xp.asarray(z, np.float32)
    f = xp.zeros_like(x)
    wgt = np.float32(0.5)
    for _ in range(octaves):
        f = f + wgt * noise3(x, y, z, xp=xp)
        x = x * np.float32(2)
        y = y * np.float32(2)
        z = z * np.float32(2)
        wgt = np.float32(wgt * np.float32(0.5))
    return f


def fbm1(x, octaves, xp=np):
    """Octave sum of noise1 (Perlin.cs:77-86)."""
    x = xp.asarray(x, np.float32)
    f = xp.zeros_like(x)
    wgt = np.float32(0.5)
    for _ in range(octaves):
        f = f + wgt * noise1(x, xp=xp)
        x = x * np.float32(2)
        wgt = np.float32(wgt * np.float32(0.5))
    return f


# ---------------------------------------------------------------------------
# Certified Lipschitz bounds (for the builder's hierarchical pruning,
# scenes.py). Derivation for noise3 (within one lattice cell; improved
# noise is C1 across cells, so the within-cell bound is global):
#   corner values n = g . d with g from the 12-edge set (two +-1
#   components) and offsets d in [-1,1]^3  =>  |n| <= 2, |dn/daxis| <= 1.
#   Per axis (say x, with u = fade(x)): the innermost x-lerp contributes
#   |d/dx lerp_u(a,b)| <= max|dn/dx| + max|fade'| * |b-a|
#                      <= 1 + 1.875 * 4 = 8.5
#   (max fade' = 30 t^2 (1-t)^2 at t=1/2 = 1.875; |b - a| <= 4), and every
#   outer lerp in a different axis is a convex combination (<= max of its
#   operands). The same holds for y and z via their own fade factor, so
#   |df/daxis| <= 8.5 and |grad f| <= sqrt(3) * 8.5 < 14.73.
# fbm3: octave i samples at scale 2^i with weight 2^-(i+1), so each octave
# contributes L/2 and `octaves` octaves give octaves * L / 2.
# ---------------------------------------------------------------------------

PERLIN3_LIPSCHITZ = 14.73


def perlin_fbm3_lipschitz(octaves: int) -> float:
    return octaves * PERLIN3_LIPSCHITZ / 2.0
