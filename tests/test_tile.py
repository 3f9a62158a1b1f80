"""Tile-amortized traversal (ops/tile.py): exactness against the plain path.

The tile path amortizes structure gathers across camera tiles; resolved
rays' hits must be *bit-identical* to traverse.trace_jax, and every ray a
dropped candidate could affect must be flagged unresolved (no silent ray
loss). trace_tile_exact must equal the golden path exactly after fallback.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import raytracingtest_tpu as rt
from raytracingtest_tpu.ops import tile, traverse
from raytracingtest_tpu.ops.camera import Camera


def _setup(scene, depth, res_px=64, tile_px=16):
    res = rt.build_svo(rt.get_scene(scene), depth)
    svo = res.svo.device()
    ts = tile.make_tile_svo(res.svo).device()
    cam = Camera(position=(0.5, 0.85, -0.6), look_at=(0.5, 0.4, 0.5),
                 fov_y_deg=50.0, width=res_px, height=res_px)
    o, d, corners, grid = tile.tile_rays(cam, np, tile_px=tile_px)
    return svo, ts, o, d, corners


@pytest.mark.parametrize("scene,depth", [
    ("terrain", 6), ("sphere", 5), ("flat_ground", 6),
])
def test_tile_resolved_parity(scene, depth):
    svo, ts, o, d, corners = _setup(scene, depth)
    r1, un = tile.trace_tile(ts, o, d, corners)
    r0 = traverse.trace_jax(svo, jnp.asarray(o.reshape(-1, 3)),
                            jnp.asarray(d.reshape(-1, 3)))
    ok = ~np.asarray(un)
    np.testing.assert_array_equal(np.asarray(r0.hit_leaf)[ok],
                                  np.asarray(r1.hit_leaf)[ok])
    hit = ok & (np.asarray(r0.hit_leaf) >= 0)
    np.testing.assert_array_equal(np.asarray(r0.hit_t)[hit],
                                  np.asarray(r1.hit_t)[hit])
    assert hit.sum() > 100


@pytest.mark.parametrize("scene,depth", [("terrain", 6), ("sphere", 5)])
def test_tile_exact_equals_golden(scene, depth):
    svo, ts, o, d, corners = _setup(scene, depth)
    r0 = traverse.trace_jax(svo, jnp.asarray(o.reshape(-1, 3)),
                            jnp.asarray(d.reshape(-1, 3)))
    r2 = tile.trace_tile_exact(ts, o, d, corners)
    np.testing.assert_array_equal(np.asarray(r0.hit_leaf),
                                  np.asarray(r2.hit_leaf))
    hit = np.asarray(r0.hit_leaf) >= 0
    np.testing.assert_array_equal(np.asarray(r0.hit_t)[hit],
                                  np.asarray(r2.hit_t)[hit])


def test_tile_adversarial_tiny_caps():
    """Starved candidate caps must flag (not silently drop) affected rays:
    exactness holds after fallback even when most candidates are dropped."""
    svo, ts, o, d, corners = _setup("terrain", 6)
    caps = (1, 2, 2, 2)  # absurdly small: heavy cap dropping at every level
    r1, un = tile.trace_tile(ts, o, d, corners, k_max=2, caps=caps)
    r0 = traverse.trace_jax(svo, jnp.asarray(o.reshape(-1, 3)),
                            jnp.asarray(d.reshape(-1, 3)))
    ok = ~np.asarray(un)
    # whatever the tile path claims as resolved must already be exact
    np.testing.assert_array_equal(np.asarray(r0.hit_leaf)[ok],
                                  np.asarray(r1.hit_leaf)[ok])
    r2 = tile.trace_tile_exact(ts, o, d, corners, k_max=2, caps=caps)
    np.testing.assert_array_equal(np.asarray(r0.hit_leaf),
                                  np.asarray(r2.hit_leaf))


def test_pyramid_occupancy_matches_nodes():
    """Every pyramid bit corresponds to a node; finest-level rank == brick id
    (the builder's level layout is global morton order)."""
    res = rt.build_svo(rt.get_scene("sphere"), 5)
    ts = tile.make_tile_svo(res.svo)
    offs, n_words = tile._pyr_layout(ts.top_depth)
    pyr = np.asarray(ts.pyr)
    svo = res.svo
    # per-level set-bit counts equal per-level node counts
    for l in range(1, ts.top_depth + 1):
        end = offs[l + 1] if l < ts.top_depth else n_words
        bits = tile._popcount_np(pyr[offs[l]:end]).sum()
        assert bits == svo.level_start[l + 1] - svo.level_start[l]
    # finest-level morton rank enumerates bricks 0..n-1
    cm = np.asarray(ts.cellmap)
    total = cm[-1, 0] + tile._popcount_np(cm[-1:, 1].astype(np.uint32))[0]
    assert total == ts.bsvo.n_bricks


def test_morton_roundtrip():
    rng = np.random.default_rng(0)
    xyz = rng.integers(0, 1 << 10, (1000, 3))
    code = tile.morton3(xyz[:, 0], xyz[:, 1], xyz[:, 2])
    x, y, z = tile.unmorton3(code)
    np.testing.assert_array_equal(np.stack([x, y, z], 1), xyz)


def test_untile_roundtrip():
    cam = Camera(position=(0.5, 0.85, -0.6), look_at=(0.5, 0.4, 0.5),
                 fov_y_deg=50.0, width=64, height=32)
    o, d, corners, grid = tile.tile_rays(cam, np, tile_px=16)
    o_ref, d_ref = cam.rays(np)
    np.testing.assert_array_equal(
        tile.untile_image(d.reshape(-1, 3), grid, 16), d_ref)


def test_tile_rays_rejects_ortho_and_misaligned():
    cam = Camera(position=(0, 0, -2), look_at=(0, 0, 0), ortho_height=1.0,
                 width=64, height=64)
    with pytest.raises(ValueError):
        tile.tile_rays(cam, np)
    cam2 = Camera(position=(0, 0, -2), look_at=(0, 0, 0), width=60, height=64)
    with pytest.raises(ValueError):
        tile.tile_rays(cam2, np)


def test_tile_empty_scene_and_inside_camera():
    """Edge cases through the tile path: an empty scene renders all-miss
    without crashing; a camera inside the solid still matches the golden
    path exactly."""
    from raytracingtest_tpu.scenes import Scene

    empty = Scene("empty", lambda x, y, z, xp: xp.ones_like(
        xp.asarray(x, xp.float32)), 0.0)
    res = rt.build_svo(empty, 4)
    ts = tile.make_tile_svo(res.svo).device()
    cam = Camera(position=(0.5, 0.85, -0.6), look_at=(0.5, 0.4, 0.5),
                 fov_y_deg=50.0, width=32, height=32)
    o, d, corners, _ = tile.tile_rays(cam, np)
    r, un = tile.trace_tile(ts, o, d, corners)
    assert (np.asarray(r.hit_leaf) == -1).all()
    assert not np.asarray(un).any()

    # camera buried inside the terrain solid
    res2 = rt.build_svo(rt.get_scene("terrain"), 6)
    svo2 = res2.svo.device()
    ts2 = tile.make_tile_svo(res2.svo).device()
    cam2 = Camera(position=(0.5, 0.05, 0.5), look_at=(0.5, 0.5, 0.5),
                  fov_y_deg=60.0, width=32, height=32)
    o2, d2, corners2, _ = tile.tile_rays(cam2, np)
    r2 = tile.trace_tile_exact(ts2, o2, d2, corners2)
    r0 = traverse.trace_jax(svo2, jnp.asarray(o2.reshape(-1, 3)),
                            jnp.asarray(d2.reshape(-1, 3)))
    np.testing.assert_array_equal(np.asarray(r0.hit_leaf),
                                  np.asarray(r2.hit_leaf))


@pytest.mark.parametrize("split", [2, 4])
def test_subtile_rewalk_exact(split):
    """The fb2 sub-tile re-walk must resolve cap-starved tiles exactly:
    with tiny main caps and a tiny fb_k, the sub-tile pass (whose frustums
    are split^2 narrower) substitutes bit-identical hits."""
    svo, ts, o, d, corners = _setup("terrain", 6)
    caps = (1, 2, 2, 2)
    r0 = traverse.trace_jax(svo, jnp.asarray(o.reshape(-1, 3)),
                            jnp.asarray(d.reshape(-1, 3)))
    # fb starved too (fb_k=4) so fb2 has real work; fb2 budget covers all
    r1, un1 = tile.trace_tile_fb(ts, o, d, corners, k_max=2, caps=caps,
                                 fb_tiles=4, fb_k=4)
    r2, un2 = tile.trace_tile_fb(ts, o, d, corners, k_max=2, caps=caps,
                                 fb_tiles=4, fb_k=4,
                                 fb2_tiles=o.shape[0], fb2_split=split)
    # fb2 strictly reduces the residual set and never flips a resolved hit
    assert int(jnp.sum(un2)) <= int(jnp.sum(un1))
    ok = ~np.asarray(un2)
    np.testing.assert_array_equal(np.asarray(r0.hit_leaf)[ok],
                                  np.asarray(r2.hit_leaf)[ok])
    hit = ok & (np.asarray(r0.hit_leaf) >= 0)
    np.testing.assert_array_equal(np.asarray(r0.hit_t)[hit],
                                  np.asarray(r2.hit_t)[hit])


@pytest.mark.parametrize("passes", [1, 3])
def test_retrace_residual_in_jit(passes):
    """retrace_residual re-traces every unresolved ray on the brick path, in
    one pass or several, matching the golden hits; resolved rays are left
    as they were."""
    svo, ts, o, d, corners = _setup("terrain", 6)
    caps = (1, 2, 2, 2)
    r0 = traverse.trace_jax(svo, jnp.asarray(o.reshape(-1, 3)),
                            jnp.asarray(d.reshape(-1, 3)))
    r1, un1 = tile.trace_tile_fb(ts, o, d, corners, k_max=2, caps=caps,
                                 fb_tiles=1, fb_k=4)
    n_un = int(jnp.sum(un1))
    assert n_un > 2
    leaf, t, un2 = jax.jit(tile.retrace_residual, static_argnums=6)(
        ts.bsvo, jnp.asarray(o), jnp.asarray(d), r1.hit_leaf, r1.hit_t, un1,
        -(-n_un // passes))
    assert not np.asarray(un2).any()
    kept = ~np.asarray(un1)
    np.testing.assert_array_equal(np.asarray(r1.hit_leaf)[kept],
                                  np.asarray(leaf)[kept])
    np.testing.assert_array_equal(np.asarray(r0.hit_leaf), np.asarray(leaf))
    hit = np.asarray(r0.hit_leaf) >= 0
    np.testing.assert_array_equal(np.asarray(r0.hit_t)[hit],
                                  np.asarray(t)[hit])


def test_subtile_split_roundtrip():
    """_subtile_split regroups rays consistently with _subtile_merge, and
    sub-corner directions bound their sub-tile's rays (frustum planes
    through interpolated corners keep every contained ray inside)."""
    svo, ts, o, d, corners = _setup("terrain", 5)
    split = 4
    o2, d2, c2 = tile._subtile_split(jnp.asarray(o), jnp.asarray(d),
                                     jnp.asarray(corners), split)
    T, P = o.shape[0], o.shape[1]
    q = int(round(P ** 0.5)) // split
    # merge(split(x)) == x for a per-ray payload
    payload = jnp.arange(T * P, dtype=jnp.int32).reshape(T, P)
    osplit = tile._subtile_split(
        jnp.broadcast_to(payload[..., None], (T, P, 3)).astype(jnp.float32),
        jnp.asarray(d), jnp.asarray(corners), split)[0][..., 0]
    merged = tile._subtile_merge(osplit.astype(jnp.int32), T, split, q)
    np.testing.assert_array_equal(np.asarray(merged), np.asarray(payload))
    # every sub-tile ray direction lies inside its sub-frustum
    planes = tile._frustum_planes(c2, o2[:, 0])
    dd = np.asarray(d2)
    pd = np.einsum("tpx,trx->trp", np.asarray(planes), dd)
    assert (pd >= -1e-4).all()


def test_walk_scheduled_chunked_parity():
    """_walk_tiles_scheduled's chunked branch (lane_budget exceeded) must
    agree with the single-call walk — the depth-12 exactness configs
    (thousands of fb sub-tiles) ride this path. Hit ids, iters and the
    unresolved mask are exactly equal; hit_t is allclose-only on CPU,
    where the chunked program's different static shapes let LLVM contract
    multiply-adds differently (~1 ULP)."""
    svo, ts, o, d, corners = _setup("terrain", 6, res_px=128)
    caps = tile._default_caps(ts.top_depth, 32)
    codes, ids, t_codes, drop_t = tile._candidates(
        jnp.asarray(ts.pyr), jnp.asarray(ts.cellmap),
        jnp.asarray(corners, jnp.float32), jnp.asarray(o[0, 0]),
        ts.top_depth, caps, 32)
    bricks = jnp.asarray(ts.bsvo.bricks)
    kw = dict(depth=ts.depth, top_depth=ts.top_depth, k_max=32)
    single = tile._walk_tiles_chunk(
        bricks, jnp.asarray(o), jnp.asarray(d), codes, ids, t_codes,
        drop_t, **kw)
    # 64 tiles x 256 rays; budget 4096 lanes -> 16-row chunks (4 chunks)
    chunked = tile._walk_tiles_scheduled(
        bricks, jnp.asarray(o), jnp.asarray(d), codes, ids, t_codes,
        drop_t, lane_budget=4096, **kw)
    for i, (a, b) in enumerate(zip(single, chunked)):
        if i == 1:      # hit_t: CPU FMA-contraction wobble (docstring)
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-5, atol=1e-6)
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
