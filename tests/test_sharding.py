"""Multi-chip path on the virtual 8-device CPU mesh: sharded render equals
single-device render; sharded train step reduces loss and equals the
single-device gradients (psum correctness)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax

from raytracingtest_tpu import diff
from raytracingtest_tpu.ops.camera import Camera
from raytracingtest_tpu.ops.octree import build_svo
from raytracingtest_tpu.parallel.mesh import make_mesh
from raytracingtest_tpu.parallel.render_sharded import (
    make_train_step, render_sharded,
)
from raytracingtest_tpu.scenes import get_scene

LIGHT = jnp.asarray([-0.5, -1.0, -0.3], jnp.float32)


@pytest.fixture(scope="module")
def setup():
    res = build_svo(get_scene("sphere"), 4)
    svo = res.svo.device()
    cam = Camera(position=(0.5, 0.6, -1.0), look_at=(0.5, 0.5, 0.5),
                 fov_y_deg=45.0, width=32, height=32)  # 1024 rays / 8 devs
    o, d = cam.rays(np)
    return svo, jnp.asarray(o), jnp.asarray(d)


def test_mesh_has_8_devices():
    mesh = make_mesh()
    assert mesh.devices.size == 8


def test_sharded_render_matches_single(setup):
    svo, o, d = setup
    mesh = make_mesh()
    img_sharded = render_sharded(
        mesh, jnp.asarray(svo.leaf_albedo), jnp.asarray(svo.leaf_normal),
        jnp.asarray(svo.leaf_density), svo.masks, svo.child_base,
        svo.leaf_base, o, d, svo.depth, LIGHT)
    img_single = diff.render_diff(
        jnp.asarray(svo.leaf_albedo), jnp.asarray(svo.leaf_normal),
        jnp.asarray(svo.leaf_density), svo.masks, svo.child_base,
        svo.leaf_base, o, d, svo.depth, LIGHT)
    np.testing.assert_allclose(np.asarray(img_sharded),
                               np.asarray(img_single), rtol=1e-5, atol=1e-6)


def test_sharded_grads_match_single(setup):
    svo, o, d = setup
    mesh = make_mesh()
    rng = np.random.default_rng(1)
    target = jnp.asarray(rng.random((o.shape[0], 3), dtype=np.float32))
    params = {
        "albedo": jnp.asarray(svo.leaf_albedo),
        "normal": jnp.asarray(svo.leaf_normal),
        "density": jnp.asarray(svo.leaf_density),
    }
    opt = optax.adam(1e-2)
    step = make_train_step(mesh, svo.depth, opt)
    opt_state = opt.init(params)
    _, _, loss_sharded = step(params, opt_state, svo.masks, svo.child_base,
                              svo.leaf_base, o, d, LIGHT, target)

    loss_single, grads_single = diff.loss_and_grads(
        params["albedo"], params["normal"], params["density"],
        svo.masks, svo.child_base, svo.leaf_base, o, d, svo.depth, LIGHT,
        target)
    np.testing.assert_allclose(float(loss_sharded), float(loss_single),
                               rtol=1e-5)


def test_inverse_rendering_fit_converges(setup):
    """Mini config-4: optimize voxel albedo to match a target image rendered
    with known albedo, rays sharded over 8 devices."""
    svo, o, d = setup
    mesh = make_mesh()
    true_albedo = jnp.asarray(svo.leaf_albedo)
    target = diff.render_diff(
        true_albedo, jnp.asarray(svo.leaf_normal),
        jnp.asarray(svo.leaf_density), svo.masks, svo.child_base,
        svo.leaf_base, o, d, svo.depth, LIGHT)

    rng = np.random.default_rng(2)
    params = {
        "albedo": jnp.asarray(
            rng.random(true_albedo.shape, dtype=np.float32) * 0.5 + 0.25),
        "normal": jnp.asarray(svo.leaf_normal),
        "density": jnp.asarray(svo.leaf_density),
    }
    opt = optax.multi_transform(
        {"train": optax.adam(5e-2), "freeze": optax.set_to_zero()},
        {"albedo": "train", "normal": "freeze", "density": "freeze"},
    )
    step = make_train_step(mesh, svo.depth, opt)
    opt_state = opt.init(params)
    losses = []
    for _ in range(60):
        params, opt_state, loss = step(
            params, opt_state, svo.masks, svo.child_base, svo.leaf_base,
            o, d, LIGHT, target)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.05, losses[::10]


def test_brick_train_step_matches_plain():
    """The config-4 fit on the brick traversal produces the same loss and
    the same updated params as the plain-path step (hits are bit-identical,
    so the whole optimization trajectory coincides)."""
    import optax
    from raytracingtest_tpu.ops import brick as brick_mod
    from raytracingtest_tpu.parallel.render_sharded import (
        make_train_step, make_train_step_brick)
    from raytracingtest_tpu.parallel.mesh import make_mesh

    import raytracingtest_tpu as rt
    res = rt.build_svo(rt.get_scene("sphere"), 5)
    svo = res.svo.device()
    bsvo = brick_mod.make_brick_svo(res.svo).device()
    mesh = make_mesh()
    opt = optax.adam(1e-2)
    step_plain = make_train_step(mesh, svo.depth, opt)
    step_brick = make_train_step_brick(mesh, svo.depth, bsvo.top_depth, opt)

    rng = np.random.default_rng(0)
    n = 4096
    o = np.tile(np.asarray([[0.5, 0.85, -0.6]], np.float32), (n, 1))
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d[:, 2] = np.abs(d[:, 2]) + 0.3
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    light = jnp.asarray([-0.5, -1.0, -0.3], jnp.float32)
    target = jnp.zeros((n, 3), jnp.float32)
    params = {
        "albedo": jnp.asarray(res.svo.leaf_albedo),
        "normal": jnp.asarray(res.svo.leaf_normal),
        "density": jnp.asarray(res.svo.leaf_density),
    }
    st = opt.init(params)
    p1, _, l1 = step_plain(params, st, svo.masks, svo.child_base,
                           svo.leaf_base, jnp.asarray(o), jnp.asarray(d),
                           light, target)
    p2, _, l2 = step_brick(params, st, bsvo.top_masks, bsvo.top_child,
                           bsvo.top_parent, bsvo.bricks, jnp.asarray(o),
                           jnp.asarray(d), light, target)
    assert float(l1) == float(l2)
    for k in params:
        np.testing.assert_allclose(np.asarray(p1[k]), np.asarray(p2[k]),
                                   rtol=0, atol=0)


def test_tile_sharded_render_matches_single():
    """The tile hot path sharded over the 8-device mesh (tiles = the
    data-parallel axis) equals the single-device tile render exactly."""
    import raytracingtest_tpu as rt
    from raytracingtest_tpu.ops import tile as tile_mod
    from raytracingtest_tpu.parallel.render_sharded import render_tile_sharded
    from raytracingtest_tpu.ops.camera import Camera

    res = rt.build_svo(rt.get_scene("terrain"), 6)
    svo = res.svo
    tsvo = tile_mod.make_tile_svo(svo).device()
    cam = Camera(position=(0.5, 0.85, -0.6), look_at=(0.5, 0.4, 0.5),
                 fov_y_deg=50.0, width=128, height=128)
    o, d, corners, grid = tile_mod.tile_rays(cam, np, tile_px=16)
    albedo = jnp.asarray(svo.leaf_albedo)
    normal = jnp.asarray(svo.leaf_normal)
    density = jnp.asarray(svo.leaf_density)
    light = jnp.asarray([-0.5, -1.0, -0.3], jnp.float32)

    img1, res1 = diff.render_diff_tile(
        albedo, normal, density, tsvo, jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(corners), light, chunk_tiles=8, fb_tiles=16, fb_k=64)
    mesh = make_mesh()
    img8, res8 = render_tile_sharded(
        mesh, albedo, normal, density, tsvo, jnp.asarray(o),
        jnp.asarray(d), jnp.asarray(corners), light, chunk_tiles=8,
        fb_tiles=16, fb_k=64)
    np.testing.assert_allclose(np.asarray(img1), np.asarray(img8),
                               rtol=0, atol=1e-6)


def test_tile_train_step_matches_plain():
    """The tile-path sharded train step produces the same loss and updated
    params as the plain-path step on the same (tile-major) rays."""
    import raytracingtest_tpu as rt
    from raytracingtest_tpu.ops import tile as tile_mod
    from raytracingtest_tpu.parallel.render_sharded import (
        make_train_step, make_train_step_tile)
    from raytracingtest_tpu.ops.camera import Camera

    res = rt.build_svo(rt.get_scene("terrain"), 6)
    svo = res.svo.device()
    tsvo = tile_mod.make_tile_svo(res.svo).device()
    cam = Camera(position=(0.5, 0.85, -0.6), look_at=(0.5, 0.4, 0.5),
                 fov_y_deg=50.0, width=64, height=64)
    o, d, corners, grid = tile_mod.tile_rays(cam, np, tile_px=16)
    light = jnp.asarray([-0.5, -1.0, -0.3], jnp.float32)
    n = o.shape[0] * o.shape[1]
    target = jnp.zeros((n, 3), jnp.float32)
    params = {
        "albedo": jnp.asarray(res.svo.leaf_albedo),
        "normal": jnp.asarray(res.svo.leaf_normal),
        "density": jnp.asarray(res.svo.leaf_density),
    }
    mesh = make_mesh()
    opt = optax.adam(1e-2)
    st = opt.init(params)

    step_plain = make_train_step(mesh, svo.depth, opt)
    p1, _, l1 = step_plain(params, st, svo.masks, svo.child_base,
                           svo.leaf_base, jnp.asarray(o.reshape(-1, 3)),
                           jnp.asarray(d.reshape(-1, 3)), light, target)

    step_tile = make_train_step_tile(mesh, opt, chunk_tiles=2,
                                     fb_tiles=16, fb_k=512)
    p2, _, l2, resid = step_tile(params, st, tsvo, jnp.asarray(o),
                                 jnp.asarray(d), jnp.asarray(corners), light,
                                 target)
    assert int(resid) == 0
    assert abs(float(l1) - float(l2)) < 1e-6
    for k in params:
        np.testing.assert_allclose(np.asarray(p1[k]), np.asarray(p2[k]),
                                   atol=1e-6)


def test_tile_train_step_adversarial_caps_matches_brick():
    """Training-path twin of test_tile.test_tile_adversarial_tiny_caps
    (VERDICT r03 item 3): with a starved k_max the main walk drops
    candidates everywhere, yet the enlarged-K re-walk must restore exact
    hits — identical loss and updated params to the brick-path step, with
    residual == 0 reported (and any rays it could NOT restore counted,
    never silently trained on)."""
    import raytracingtest_tpu as rt
    from raytracingtest_tpu.ops import brick as brick_mod
    from raytracingtest_tpu.ops import tile as tile_mod
    from raytracingtest_tpu.parallel.render_sharded import (
        make_train_step_brick, make_train_step_tile)
    from raytracingtest_tpu.ops.camera import Camera

    res = rt.build_svo(rt.get_scene("terrain"), 6)
    bsvo = brick_mod.make_brick_svo(res.svo).device()
    tsvo = tile_mod.make_tile_svo(res.svo).device()
    cam = Camera(position=(0.5, 0.85, -0.6), look_at=(0.5, 0.4, 0.5),
                 fov_y_deg=50.0, width=64, height=64)
    o, d, corners, grid = tile_mod.tile_rays(cam, np, tile_px=16)
    light = jnp.asarray([-0.5, -1.0, -0.3], jnp.float32)
    n = o.shape[0] * o.shape[1]
    target = jnp.zeros((n, 3), jnp.float32)
    params = {
        "albedo": jnp.asarray(res.svo.leaf_albedo),
        "normal": jnp.asarray(res.svo.leaf_normal),
        "density": jnp.asarray(res.svo.leaf_density),
    }
    mesh = make_mesh()
    opt = optax.adam(1e-2)
    st = opt.init(params)

    step_brick = make_train_step_brick(mesh, res.svo.depth, bsvo.top_depth,
                                       opt)
    p1, _, l1 = step_brick(params, st, bsvo.top_masks, bsvo.top_child,
                           bsvo.top_parent, bsvo.bricks,
                           jnp.asarray(o.reshape(-1, 3)),
                           jnp.asarray(d.reshape(-1, 3)), light, target)

    # k_max=8: heavy cap dropping in the main walk on this terrain view
    step_tile = make_train_step_tile(mesh, opt, k_max=8, chunk_tiles=2,
                                     fb_tiles=16, fb_k=512)
    p2, _, l2, resid = step_tile(params, st, tsvo, jnp.asarray(o),
                                 jnp.asarray(d), jnp.asarray(corners), light,
                                 target)
    assert int(resid) == 0
    assert abs(float(l1) - float(l2)) < 1e-6
    for k in params:
        np.testing.assert_allclose(np.asarray(p1[k]), np.asarray(p2[k]),
                                   atol=1e-6)


def test_tile_train_step_overlap_groups_matches_ungrouped():
    """overlap_groups chunks the backward + per-group psum; losses/grads
    must equal the ungrouped step exactly (disjoint ray partition)."""
    import raytracingtest_tpu as rt
    from raytracingtest_tpu.ops import tile as tile_mod
    from raytracingtest_tpu.parallel.render_sharded import (
        make_train_step_tile)
    from raytracingtest_tpu.ops.camera import Camera

    res = rt.build_svo(rt.get_scene("terrain"), 6)
    tsvo = tile_mod.make_tile_svo(res.svo).device()
    cam = Camera(position=(0.5, 0.85, -0.6), look_at=(0.5, 0.4, 0.5),
                 fov_y_deg=50.0, width=64, height=64)
    o, d, corners, grid = tile_mod.tile_rays(cam, np, tile_px=16)
    light = jnp.asarray([-0.5, -1.0, -0.3], jnp.float32)
    n = o.shape[0] * o.shape[1]
    target = jnp.zeros((n, 3), jnp.float32)
    params = {
        "albedo": jnp.asarray(res.svo.leaf_albedo),
        "normal": jnp.asarray(res.svo.leaf_normal),
        "density": jnp.asarray(res.svo.leaf_density),
    }
    mesh = make_mesh()
    opt = optax.adam(1e-2)
    st = opt.init(params)
    args = (params, st, tsvo, jnp.asarray(o), jnp.asarray(d),
            jnp.asarray(corners), light, target)
    s1 = make_train_step_tile(mesh, opt, chunk_tiles=2, fb_tiles=16,
                              fb_k=512)
    s2 = make_train_step_tile(mesh, opt, chunk_tiles=1, fb_tiles=16,
                              fb_k=512, overlap_groups=2)
    p1, _, l1, r1 = s1(*args)
    p2, _, l2, r2 = s2(*args)
    assert int(r1) == 0 and int(r2) == 0
    assert abs(float(l1) - float(l2)) < 1e-6
    for k in params:
        np.testing.assert_allclose(np.asarray(p1[k]), np.asarray(p2[k]),
                                   atol=1e-6)


@pytest.fixture(scope="module")
def starved_tile_setup():
    """Terrain view whose tile walks, on starved budgets, leave cap-limited
    rays no re-walk restores; the brick-path step is the exact reference."""
    import raytracingtest_tpu as rt
    from raytracingtest_tpu.ops import brick as brick_mod
    from raytracingtest_tpu.ops import tile as tile_mod
    from raytracingtest_tpu.parallel.render_sharded import (
        make_train_step_brick)

    svo = rt.build_svo(rt.get_scene("terrain"), 6).svo
    bsvo = brick_mod.make_brick_svo(svo).device()
    tsvo = tile_mod.make_tile_svo(svo).device()
    cam = Camera(position=(0.5, 0.85, -0.6), look_at=(0.5, 0.4, 0.5),
                 fov_y_deg=50.0, width=64, height=64)
    o, d, corners, _grid = tile_mod.tile_rays(cam, np, tile_px=16)
    target = jnp.zeros((o.shape[0] * o.shape[1], 3), jnp.float32)
    params = {"albedo": jnp.asarray(svo.leaf_albedo),
              "normal": jnp.asarray(svo.leaf_normal),
              "density": jnp.asarray(svo.leaf_density)}
    mesh = make_mesh()
    opt = optax.adam(1e-2)
    st = opt.init(params)
    ref = make_train_step_brick(mesh, svo.depth, bsvo.top_depth, opt)(
        params, st, bsvo.top_masks, bsvo.top_child, bsvo.top_parent,
        bsvo.bricks, jnp.asarray(o.reshape(-1, 3)),
        jnp.asarray(d.reshape(-1, 3)), LIGHT, target)
    args = (params, st, tsvo, jnp.asarray(o), jnp.asarray(d),
            jnp.asarray(corners), LIGHT, target)
    return mesh, opt, args, ref


def _starved_step(mesh, opt, retrace_chunk):
    from raytracingtest_tpu.parallel.render_sharded import (
        make_train_step_tile)
    return make_train_step_tile(mesh, opt, k_max=4, chunk_tiles=2,
                                fb_tiles=1, fb_k=4,
                                retrace_chunk=retrace_chunk)


@pytest.mark.parametrize("retrace_chunk", [0, 8, 4096])
def test_tile_train_step_retraces_residual_exactly(starved_tile_setup,
                                                   retrace_chunk):
    """The tile train step re-traces every ray its tile walks leave
    cap-limited on the per-ray brick path, `retrace_chunk` rays per pass,
    and then equals the brick-path step with residual 0, whether one pass
    or many; with the re-trace off the residual is the walks' own count."""
    mesh, opt, args, (p_ref, _, l_ref) = starved_tile_setup
    r0 = int(_starved_step(mesh, opt, 0)(*args)[3])
    assert r0 > 8 * mesh.devices.size  # the budgets do starve the walks
    p, _, loss, resid = _starved_step(mesh, opt, retrace_chunk)(*args)
    resid = int(resid)
    if retrace_chunk == 0:
        assert resid == r0
    else:
        assert resid == 0
        assert abs(float(loss) - float(l_ref)) < 1e-6
        for k in p:
            np.testing.assert_allclose(np.asarray(p[k]), np.asarray(p_ref[k]),
                                       atol=1e-6)
