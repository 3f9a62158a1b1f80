"""Traversal correctness: scalar oracle vs vectorized numpy vs XLA.

Role of the reference's golden-trace tests (Assets/Tests/SVOTests.cs:13-42:
fixed rays, intersected-leaf lists in hit order) plus cross-implementation
allclose checks mandated by SURVEY.md §4.
"""

import numpy as np
import pytest

from raytracingtest_tpu.ops.octree import build_svo
from raytracingtest_tpu.ops import traverse
from raytracingtest_tpu.reference import traverse as ref
from raytracingtest_tpu.scenes import get_scene


@pytest.fixture(scope="module")
def sphere5():
    return build_svo(get_scene("sphere"), 5)


@pytest.fixture(scope="module")
def cube4():
    return build_svo(get_scene("dense_cube"), 4)


def random_rays(n, seed, toward=(0.5, 0.5, 0.5), spread=0.35):
    """Rays from random points on a radius-2 shell aimed near `toward`."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    o = np.asarray(toward) + 2.0 * v
    target = np.asarray(toward) + rng.normal(0, spread, (n, 3))
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def test_scalar_hits_sphere_center_ray(sphere5):
    svo = sphere5.svo
    hits = ref.cast_ray(svo, (0.5, 0.5, -1.0), (0.0, 0.0, 1.0))
    assert len(hits) == 1
    h = hits[0]
    # analytic first intersection with the r=0.3 sphere: z = 0.5-0.3 => t = 1.2
    assert abs(h.t - 1.2) < 2 * (2.0 ** -5)
    assert 0 <= h.leaf_id < svo.n_leaves


def test_scalar_collect_all_ordered(sphere5):
    svo = sphere5.svo
    hits = ref.cast_ray(svo, (0.5, 0.5, -1.0), (0.0, 0.0, 1.0), collect_all=True)
    assert len(hits) >= 2  # front and back surface shells
    ts = [h.t for h in hits]
    assert ts == sorted(ts)
    ids = [h.leaf_id for h in hits]
    assert len(set(ids)) == len(ids)
    # back surface around z = 0.8 => t = 1.8
    assert abs(hits[-1].t - 1.8) < 2 * (2.0 ** -5)


def test_scalar_miss(sphere5):
    svo = sphere5.svo
    assert ref.cast_ray(svo, (0.5, 0.5, -1.0), (0.0, 1.0, 0.0)) == []
    assert ref.cast_ray(svo, (-1.0, -1.0, -1.0), (0.0, 0.0, 1.0)) == []
    # through the cube but missing the sphere (corner of the domain)
    assert ref.cast_ray(svo, (0.05, 0.05, -1.0), (0.0, 0.0, 1.0)) == []


def test_scalar_ray_from_inside(sphere5):
    svo = sphere5.svo
    hits = ref.cast_ray(svo, (0.5, 0.5, 0.5), (1.0, 0.0, 0.0))
    assert len(hits) == 1
    assert abs(hits[0].t - 0.3) < 2 * (2.0 ** -5)


def test_cube_face_hit(cube4):
    svo = cube4.svo
    hits = ref.cast_ray(svo, (0.5, 0.5, -1.0), (0.0, 0.0, 1.0))
    assert len(hits) == 1
    assert abs(hits[0].t - 1.25) < 2 * (2.0 ** -4)
    # hit voxel must be on the front face (z = quarter-plane)
    assert hits[0].voxel[2] == 4  # 0.25 * 16


@pytest.mark.parametrize("axis_dir", [
    ((0.5, 0.5, -1.0), (0, 0, 1)), ((0.5, 0.5, 2.0), (0, 0, -1)),
    ((-1.0, 0.5, 0.5), (1, 0, 0)), ((2.0, 0.5, 0.5), (-1, 0, 0)),
    ((0.5, -1.0, 0.5), (0, 1, 0)), ((0.5, 2.0, 0.5), (0, -1, 0)),
])
def test_axis_rays_all_directions(sphere5, axis_dir):
    o, d = axis_dir
    hits = ref.cast_ray(sphere5.svo, o, d)
    assert len(hits) == 1
    assert abs(hits[0].t - 1.2) < 2 * (2.0 ** -5)


def test_asymmetric_geometry_not_mirrored():
    """Regression: child-slot unmirroring must include the ^7 flip
    (the reference's hit_idx = idx^octant_mask^7, NVIDIASVO.compute:176).
    With the flip missing, symmetric scenes still pass while every
    asymmetric scene renders point-mirrored."""
    svo = build_svo(get_scene("flat_ground"), 5).svo  # solid below y=0.3
    # from above: surface shell voxel y=9 ([0.28125, 0.3125)), t = 2 - 0.3125
    h = ref.cast_ray(svo, (0.52, 2.0, 0.52), (0.0, -1.0, 0.0))
    assert len(h) == 1 and h[0].voxel[1] == 9
    assert abs(h[0].t - 1.6875) < 1e-6
    # from below: same voxel entered at y = 0.28125
    h2 = ref.cast_ray(svo, (0.52, -1.0, 0.52), (0.0, 1.0, 0.0))
    assert len(h2) == 1 and h2[0].voxel[1] == 9
    assert abs(h2[0].t - 1.28125) < 1e-6
    # vectorized agrees
    o = np.array([[0.52, 2.0, 0.52]], np.float32)
    d = np.array([[0.0, -1.0, 0.0]], np.float32)
    r = traverse.trace_numpy(svo, o, d)
    assert r.hit_leaf[0] == h[0].leaf_id


def test_leaf_attributes_match_hit_position(sphere5):
    """The hit leaf's stored normal must face the ray when hitting a sphere
    head-on from any axis (catches leaf-id <-> voxel mismatches)."""
    svo = sphere5.svo
    normals = np.asarray(svo.leaf_normal)
    cases = [
        ((0.5, 2.0, 0.5), (0, -1, 0), (0, 1, 0)),
        ((0.5, -1.0, 0.5), (0, 1, 0), (0, -1, 0)),
        ((2.0, 0.5, 0.5), (-1, 0, 0), (1, 0, 0)),
        ((-1.0, 0.5, 0.5), (1, 0, 0), (-1, 0, 0)),
        ((0.5, 0.5, 2.0), (0, 0, -1), (0, 0, 1)),
        ((0.5, 0.5, -1.0), (0, 0, 1), (0, 0, -1)),
    ]
    for o, d, expect_n in cases:
        hits = ref.cast_ray(svo, o, d)
        assert hits, (o, d)
        n = normals[hits[0].leaf_id]
        assert np.dot(n, expect_n) > 0.95, (o, d, n)


def test_vectorized_numpy_matches_scalar(sphere5):
    svo = sphere5.svo
    o, d = random_rays(300, seed=7)
    res = traverse.trace_numpy(svo, o, d)
    for i in range(o.shape[0]):
        hits = ref.cast_ray(svo, o[i], d[i])
        if hits:
            assert res.hit_leaf[i] == hits[0].leaf_id, i
            np.testing.assert_allclose(res.hit_t[i], hits[0].t, rtol=1e-5, atol=1e-6)
        else:
            assert res.hit_leaf[i] == -1, i


def test_vectorized_numpy_matches_scalar_terrain():
    svo = build_svo(get_scene("terrain"), 5).svo
    o, d = random_rays(200, seed=11)
    res = traverse.trace_numpy(svo, o, d)
    n_hits = 0
    for i in range(o.shape[0]):
        hits = ref.cast_ray(svo, o[i], d[i])
        if hits:
            n_hits += 1
            assert res.hit_leaf[i] == hits[0].leaf_id, i
            np.testing.assert_allclose(res.hit_t[i], hits[0].t, rtol=1e-5, atol=1e-6)
        else:
            assert res.hit_leaf[i] == -1, i
    assert n_hits > 20  # the check is vacuous if nothing hits


def test_jax_matches_numpy(sphere5):
    svo = sphere5.svo
    o, d = random_rays(500, seed=13)
    r_np = traverse.trace_numpy(svo, o, d)
    r_jx = traverse.trace_jax(svo.device(), o, d)
    np.testing.assert_array_equal(r_np.hit_leaf, np.asarray(r_jx.hit_leaf))
    np.testing.assert_allclose(
        r_np.hit_t, np.asarray(r_jx.hit_t), rtol=1e-4, atol=1e-6
    )
    np.testing.assert_array_equal(r_np.hit_parent, np.asarray(r_jx.hit_parent))
    np.testing.assert_array_equal(r_np.hit_child, np.asarray(r_jx.hit_child))


def test_jax_matches_numpy_deep():
    svo = build_svo(get_scene("sphere"), 7)
    o, d = random_rays(300, seed=17)
    r_np = traverse.trace_numpy(svo.svo, o, d)
    r_jx = traverse.trace_jax(svo.svo.device(), o, d)
    np.testing.assert_array_equal(r_np.hit_leaf, np.asarray(r_jx.hit_leaf))
    np.testing.assert_allclose(
        r_np.hit_t, np.asarray(r_jx.hit_t), rtol=1e-4, atol=1e-6
    )


def test_chunked_trace_matches(sphere5, monkeypatch):
    """The lax.map chunked path (used for big ray batches) must equal the
    direct path."""
    monkeypatch.setattr(traverse, "TRACE_CHUNK", 128)
    svo = sphere5.svo
    o, d = random_rays(512, seed=29)  # 4 chunks of 128
    r_np = traverse.trace_numpy(svo, o, d)
    r_jx = traverse.trace_jax(svo.device(), o, d)
    np.testing.assert_array_equal(r_np.hit_leaf, np.asarray(r_jx.hit_leaf))
    np.testing.assert_allclose(r_np.hit_t, np.asarray(r_jx.hit_t),
                               rtol=1e-4, atol=1e-6)


def test_compaction_path_matches(sphere5, monkeypatch):
    """Active-ray compaction (argsort + gather between while phases) must
    not change any result."""
    monkeypatch.setattr(traverse, "COMPACT_MIN", 16)
    svo = sphere5.svo
    o, d = random_rays(1024, seed=47)  # widths 1024 -> 256 -> 64 -> 16
    r_np = traverse.trace_numpy(svo, o, d)
    r_jx = traverse.trace_jax(svo.device(), o, d)
    np.testing.assert_array_equal(r_np.hit_leaf, np.asarray(r_jx.hit_leaf))
    np.testing.assert_allclose(r_np.hit_t, np.asarray(r_jx.hit_t),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(r_np.hit_parent, np.asarray(r_jx.hit_parent))


def test_hit_rate_sphere(sphere5):
    # rays aimed at the sphere from a shell: nearly all should hit
    svo = sphere5.svo
    o, d = random_rays(400, seed=19, spread=0.1)
    res = traverse.trace_numpy(svo, o, d)
    assert (res.hit_leaf >= 0).mean() > 0.9


def test_iteration_counts_bounded(sphere5):
    svo = sphere5.svo
    o, d = random_rays(200, seed=23)
    res = traverse.trace_numpy(svo, o, d)
    assert res.iters.max() < traverse.max_iters_for_depth(svo.depth)


def test_stackless_trip_bound_covers_grazing_rays():
    """The XLA path climbs one level per POP iteration, so a ray grazing the
    depth-9 terrain needs more trips than the stack-based bound
    (max_iters_for_depth); it must still reach the oracle's hit instead of
    being cut off as a miss."""
    from raytracingtest_tpu.ops.camera import Camera

    svo = build_svo(get_scene("terrain"), 9).svo
    cam = Camera(position=(0.5, 0.85, -0.6), look_at=(0.5, 0.4, 0.5),
                 fov_y_deg=50.0, width=256, height=256)
    o, d = cam.rays(np)
    sel = np.asarray([25262])               # the frame's longest walk
    res = traverse.trace_jax(svo, o[sel], d[sel])
    ref = traverse.trace_numpy(svo, o[sel], d[sel])
    assert int(res.iters[0]) > traverse.max_iters_for_depth(9)
    assert int(res.iters[0]) < traverse.max_iters_stackless(9)
    assert ref.hit_leaf[0] >= 0
    assert int(res.hit_leaf[0]) == ref.hit_leaf[0]
