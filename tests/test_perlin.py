"""Classic Perlin noise: vectorized vs scalar-twin parity + invariants.

Covers the reference's dead-code `Perlin.cs` (SURVEY.md §2.7) the same way
OpenSimplex is covered: a scalar float32 transcription of the reference
semantics is the oracle; the vectorized implementation must match it
bit-for-bit on both numpy and jit paths."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from raytracingtest_tpu.reference import perlin_scalar as ref
from raytracingtest_tpu.utils import perlin


@pytest.fixture(scope="module")
def coords():
    rng = np.random.default_rng(7)
    pts = rng.uniform(-64.0, 64.0, size=(512, 3)).astype(np.float32)
    # exercise cell-edge handling: exact integers and near-integer values
    pts[:8] = np.round(pts[:8])
    pts[8:16] = np.round(pts[8:16]) + np.float32(1e-6)
    return pts


def test_noise3_matches_scalar_twin(coords):
    want = np.array([ref.noise3(x, y, z) for x, y, z in coords],
                    dtype=np.float32)
    got = perlin.noise3(coords[:, 0], coords[:, 1], coords[:, 2], xp=np)
    np.testing.assert_array_equal(got, want)


def test_noise2_matches_scalar_twin(coords):
    want = np.array([ref.noise2(x, y) for x, y, _ in coords],
                    dtype=np.float32)
    got = perlin.noise2(coords[:, 0], coords[:, 1], xp=np)
    np.testing.assert_array_equal(got, want)


def test_noise1_matches_scalar_twin(coords):
    want = np.array([ref.noise1(x) for x in coords[:, 0]], dtype=np.float32)
    got = perlin.noise1(coords[:, 0], xp=np)
    np.testing.assert_array_equal(got, want)


def test_jit_matches_numpy(coords):
    host = perlin.noise3(coords[:, 0], coords[:, 1], coords[:, 2], xp=np)
    dev = jax.jit(lambda c: perlin.noise3(c[:, 0], c[:, 1], c[:, 2],
                                          xp=jnp))(jnp.asarray(coords))
    np.testing.assert_allclose(np.asarray(dev), host, rtol=0, atol=2e-6)


def test_zero_at_lattice_points():
    # improved 3D noise vanishes on the integer lattice (all grads dotted
    # with zero offsets at the chosen corner)
    g = np.arange(-8, 9, dtype=np.float32)
    xs, ys, zs = np.meshgrid(g, g, g, indexing="ij")
    out = perlin.noise3(xs.ravel(), ys.ravel(), zs.ravel(), xp=np)
    np.testing.assert_array_equal(out, np.zeros_like(out))


def test_range_bounded(coords):
    out = perlin.noise3(coords[:, 0], coords[:, 1], coords[:, 2], xp=np)
    assert np.all(np.abs(out) <= 1.0 + 1e-6)
    assert np.std(out) > 0.05      # actually varies


def test_fbm_octave_sum(coords):
    x, y, z = coords[:4, 0], coords[:4, 1], coords[:4, 2]
    got = perlin.fbm3(x, y, z, 3, xp=np)
    want = (np.float32(0.5) * perlin.noise3(x, y, z, xp=np)
            + np.float32(0.25) * perlin.noise3(2 * x, 2 * y, 2 * z, xp=np)
            + np.float32(0.125) * perlin.noise3(4 * x, 4 * y, 4 * z, xp=np))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
