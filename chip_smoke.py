"""Smoke run of the renderer's main path on an NVIDIA GPU.

    python chip_smoke.py           # phases 0-6 on one card
    python chip_smoke.py --deep    # depth-12 split build + 2048^2 exact render
    python chip_smoke.py --four    # the sharded paths on four cards

Drives the user entry points (SurfaceRenderer, the diff render/loss entry
points, `cli fit`, `cli fly`) at the headline configuration, depth-10
terrain (~0.5M nodes, ~1.06M leaves) at 1024^2, and checks each result
against the repository's own references: the host builder, the scalar
numpy oracle (ops/traverse.trace_numpy) and the plain per-ray path. Every
phase prints its comparisons with their tolerances; any failed check ends
the run with a non-zero exit. The last line of stdout is one JSON object:
{"ok": true, "device": {"platform", "kind", "count"}}.

There is no CPU fallback: without a GPU the script exits non-zero and
prints no result. The phase functions take their sizes as arguments so the
tests can run them on the CPU at tiny sizes.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

from raytracingtest_tpu import diff
from raytracingtest_tpu.config import CameraConfig, RenderConfig
from raytracingtest_tpu.io import checkpoint as ckpt
from raytracingtest_tpu.ops import brick as brick_mod
from raytracingtest_tpu.ops import tile as tile_mod
from raytracingtest_tpu.ops import traverse
from raytracingtest_tpu.ops.camera import Camera
from raytracingtest_tpu.ops.octree import build_svo
from raytracingtest_tpu.ops.octree_device import (
    build_svo_device, build_svo_device_split)
from raytracingtest_tpu.scenes import get_scene
from raytracingtest_tpu.utils import runtime
from raytracingtest_tpu.utils.profiling import fenced_median_ms

# Tolerances, each with its reason.
# Hits: every path is expected to find the same leaf as the scalar oracle.
# A mismatch is investigated (an FMA-contracted tie at a voxel corner is the
# first suspect); a rate above this is a bug, not a tolerance.
HIT_MISMATCH_MAX_RATE = 1e-4
# Loss: one mean over identical per-pixel terms, summed in another order.
LOSS_RTOL = 1e-5
# Gradients: the segment cumsum reassociates f32 sums, and GPU atomics add
# the rank-1 backward's rows in an order that changes from run to run.
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
ADAM_B1 = 0.9                          # optax.adam's default

# the bench.py tile budgets (k_max, fb_tiles, fb_k, fb2_tiles)
TILE_BUDGETS = dict(k_max=96, fb_tiles=96, fb_k=160, fb2_tiles=16)
LIGHT = (-0.5, -1.0, -0.3)
CAM_POS, CAM_LOOK = (0.5, 0.85, -0.6), (0.5, 0.4, 0.5)


def _adam_mu(opt_state):
    """Adam's first moment (a params-shaped pytree) inside an optax state."""
    has_mu = lambda x: hasattr(x, "mu")
    for leaf in jax.tree_util.tree_leaves(opt_state, is_leaf=has_mu):
        if has_mu(leaf):
            return leaf.mu
    raise ValueError("no Adam state found")


# a matrix product in compiled HLO: a dot or convolution instruction, or a
# call into cuBLAS / cuDNN (where TF32 rounding could enter)
MATRIX_PRODUCT = re.compile(
    r"\s(dot|convolution)\(|custom_call_target=\"[^\"]*(cublas|cudnn)",
    re.IGNORECASE)


def check_no_matrix_products(label: str, lowered) -> None:
    """Compile `lowered` for the device and scan the compiled HLO."""
    found = sorted({m.group(0).strip()
                    for m in MATRIX_PRODUCT.finditer(
                        lowered.compile().as_text())})
    log(f"  compiled HLO of {label}: matrix products {found or 'none'} "
        "(required: none)")
    check(not found, f"{label} compiles to matrix products")


def log(msg: str) -> None:
    print(msg, flush=True)


def log_memory(phase: str) -> None:
    stats = jax.devices()[0].memory_stats() or {}
    log(f"[{phase}] peak_bytes_in_use="
        f"{stats.get('peak_bytes_in_use', 'not reported')}")


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _camera(res: int) -> Camera:
    return Camera(position=CAM_POS, look_at=CAM_LOOK, fov_y_deg=50.0,
                  width=res, height=res)


def compare_hits(label: str, ref_leaf, ref_t, got_leaf, got_t) -> int:
    """Compare per-ray hit leaves; print the mismatch count and the largest
    |dt| among mismatches; fail above HIT_MISMATCH_MAX_RATE."""
    ref_leaf, got_leaf = np.asarray(ref_leaf), np.asarray(got_leaf)
    bad = ref_leaf != got_leaf
    n_bad = int(bad.sum())
    dt = np.abs(np.asarray(ref_t)[bad] - np.asarray(got_t)[bad])
    dt = float(dt.max()) if n_bad else 0.0
    rate = n_bad / ref_leaf.size
    log(f"  hits {label}: {n_bad} of {ref_leaf.size} rays differ "
        f"(rate {rate:.2e}, max |dt| {dt:.3e}; limit rate "
        f"{HIT_MISMATCH_MAX_RATE:g}); {int((ref_leaf >= 0).sum())} hits")
    check(rate <= HIT_MISMATCH_MAX_RATE, f"hit mismatch rate {label}")
    return n_bad


def compare_arrays(label: str, ref, got, rtol: float, atol: float) -> None:
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    err = np.abs(ref - got)
    worst = float(np.max(err - rtol * np.abs(ref))) if err.size else 0.0
    log(f"  {label}: max |diff| {float(err.max()) if err.size else 0.0:.3e} "
        f"(rtol {rtol:g}, atol {atol:g})")
    check(np.isfinite(got).all(), f"{label} not finite")
    check(worst <= atol, f"{label} outside tolerance")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device() -> dict:
    info = runtime.device_info()
    log(f"[0 device] jax {jax.__version__}  platform {info['platform']}  "
        f"kind {info['kind']!r}  count {info['count']}")
    from raytracingtest_tpu.utils.profiling import PEAK_HBM_BYTES_PER_S
    log(f"[0 device] in the peak-rate table: "
        f"{info['kind'] in PEAK_HBM_BYTES_PER_S}")
    if info["platform"] == "gpu":
        log(f"[0 device] nvidia-smi: {runtime.gpu_name_and_power_limit()}")
    return info


def phase_build(depth: int, cache_dir: str | None = None):
    """Host and device builds of the terrain; structure must be identical.
    Returns the host SVO (saved in `cache_dir` under the name `cli` looks
    up, so later phases load it instead of rebuilding)."""
    scene = get_scene("terrain")
    t0 = time.perf_counter()
    host = build_svo(scene, depth).svo
    host_s = time.perf_counter() - t0
    times = []
    for _ in range(2):                      # cold (compiles), then warm
        t0 = time.perf_counter()
        dev = build_svo_device(scene, depth)
        jax.block_until_ready(dev.masks)
        times.append(time.perf_counter() - t0)
    log(f"[1 build] depth {depth}: {host.n_nodes} nodes, {host.n_leaves} "
        f"leaves; host {host_s:.2f} s, device {times[0]:.2f} s cold, "
        f"{times[1]:.2f} s warm")
    check(dev.n_nodes == host.n_nodes and dev.n_leaves == host.n_leaves,
          "device build node/leaf counts differ from the host build")
    for name in ("masks", "child_base", "leaf_base"):
        a, b = np.asarray(getattr(host, name)), np.asarray(getattr(dev, name))
        n_bad = int((a != b).sum())
        log(f"  {name}: {n_bad} entries differ (required: 0)")
        check(n_bad == 0, f"device build {name} differs")
    for name in ("leaf_albedo", "leaf_normal"):
        d = np.abs(np.asarray(getattr(host, name))
                   - np.asarray(getattr(dev, name)))
        log(f"  {name}: max |host - device| {float(d.max()):.3e} "
            "(informational)")
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
        ckpt.save_svo(host, os.path.join(cache_dir,
                                         f"svo_terrain_d{depth}.npz"))
    log_memory("1 build")
    return host


def phase_render(svo, res: int, n_sample: int, out_dir: str | None,
                 seed: int = 0) -> None:
    """SurfaceRenderer.render (tile path + trace_tile_exact); hit leaves of
    sampled pixels against the host oracle."""
    from raytracingtest_tpu.models import SurfaceRenderer
    from raytracingtest_tpu.models.renderers import _tile_of
    model = SurfaceRenderer(svo.device())
    cfg = CameraConfig(position=CAM_POS, look_at=CAM_LOOK, fov_y_deg=50.0,
                       width=res, height=res)
    times = []
    for _ in range(2):                      # cold (compiles), then warm
        t0 = time.perf_counter()
        img = model.render(cfg, RenderConfig())
        times.append(time.perf_counter() - t0)
    log(f"[2 render] {res}x{res}: {times[0]:.2f} s cold, {times[1]*1e3:.1f} "
        "ms warm (host clock, includes the host transfer)")
    check(img.shape == (res, res, 3), f"image shape {img.shape}")
    check(bool(np.isfinite(img).all()), "image has non-finite pixels")

    cam = _camera(res)
    o_t, d_t, corners, grid = tile_mod.tile_rays(cam, np)
    r = tile_mod.trace_tile_exact(_tile_of(model), jnp.asarray(o_t),
                                  jnp.asarray(d_t), jnp.asarray(corners))
    leaf = tile_mod.untile_image(np.asarray(r.hit_leaf), grid)
    t_hit = tile_mod.untile_image(np.asarray(r.hit_t), grid)
    o, d = cam.rays(np)
    idx = np.random.default_rng(seed).choice(o.shape[0], n_sample,
                                             replace=False)
    ref = traverse.trace_numpy(svo, o[idx], d[idx])
    compare_hits("tile exact vs host oracle", ref.hit_leaf, ref.hit_t,
                 leaf[idx], t_hit[idx])
    if out_dir:
        from PIL import Image
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"render_{res}.png")
        Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(path)
        log(f"  wrote {path}")
    log_memory("2 render")


def _inputs(svo, res):
    """Device SVO, brick and tile structures, and tile-major rays (the plain
    and brick paths take the same rays flattened, so every path sees one
    ray order)."""
    dsvo = svo.device()
    bsvo_host = brick_mod.make_brick_svo(svo)
    tsvo = tile_mod.make_tile_svo(svo, bsvo=bsvo_host).device()
    o_t, d_t, corners, _grid = tile_mod.tile_rays(_camera(res), np)
    o_t, d_t, corners = (jnp.asarray(x) for x in (o_t, d_t, corners))
    params = (jnp.asarray(svo.leaf_albedo), jnp.asarray(svo.leaf_normal),
              jnp.asarray(svo.leaf_density))
    return (dsvo, bsvo_host.device(), tsvo, o_t, d_t, corners, params,
            jnp.asarray(LIGHT, jnp.float32))


def phase_parity(svo, res: int, budgets=None) -> None:
    """Plain, brick and tile paths on the same rays: hits compared, frame
    times and iteration counts printed (informational)."""
    budgets = budgets or TILE_BUDGETS
    dsvo, bsvo, tsvo, o_t, d_t, corners, params, light = _inputs(svo, res)
    o, d = o_t.reshape(-1, 3), d_t.reshape(-1, 3)
    depth = svo.depth
    plain = traverse._trace_jax(dsvo.masks, dsvo.child_base, dsvo.leaf_base,
                                dsvo.parent_ptr, o, d, depth)
    brick = brick_mod._trace_brick_jax(bsvo.top_masks, bsvo.top_child,
                                       bsvo.top_parent, bsvo.bricks, o, d,
                                       depth, bsvo.top_depth)
    tile, unresolved = tile_mod.trace_tile_fb(tsvo, o_t, d_t, corners,
                                              **budgets)
    n_res = int(jnp.sum(unresolved))
    log(f"[3 parity] {res}x{res}, tile budgets {budgets}: tile residual "
        f"{n_res} rays")
    compare_hits("brick vs plain", plain.hit_leaf, plain.hit_t,
                 brick.hit_leaf, brick.hit_t)
    compare_hits("tile vs plain", plain.hit_leaf, plain.hit_t,
                 tile.hit_leaf, tile.hit_t)
    leaves = {name: np.asarray(r.hit_leaf)
              for name, r in (("plain", plain), ("brick", brick),
                              ("tile", tile))}
    bad = np.flatnonzero((leaves["plain"] != leaves["brick"])
                         | (leaves["plain"] != leaves["tile"]))
    if bad.size:                            # which path the oracle backs
        ref = traverse.trace_numpy(svo, np.asarray(o)[bad],
                                   np.asarray(d)[bad])
        log(f"  of the {bad.size} rays that differ, the host oracle agrees "
            "with " + ", ".join(
                f"{name} on {int((x[bad] == ref.hit_leaf).sum())}"
                for name, x in leaves.items()))

    runs = {
        "plain": lambda: diff.render_diff(
            *params, dsvo.masks, dsvo.child_base, dsvo.leaf_base, o, d, depth,
            light, parent_ptr=dsvo.parent_ptr),
        "brick": lambda: diff.render_diff_brick(
            *params, bsvo.top_masks, bsvo.top_child, bsvo.top_parent,
            bsvo.bricks, o, d, depth, bsvo.top_depth, light),
        "tile": lambda: diff.render_diff_tile(
            *params, tsvo, o_t, d_t, corners, light, **budgets),
    }
    check_no_matrix_products("render_diff", diff.render_diff.lower(
        *params, dsvo.masks, dsvo.child_base, dsvo.leaf_base, o, d, depth,
        light, parent_ptr=dsvo.parent_ptr))
    check_no_matrix_products("render_diff_tile", diff.render_diff_tile.lower(
        *params, tsvo, o_t, d_t, corners, light, **budgets))
    iters = {"plain": plain.iters, "brick": brick.iters, "tile": tile.iters}
    for name, fn in runs.items():
        it = np.asarray(iters[name])
        log(f"  {name}: median of 5 frames {fenced_median_ms(fn, 5):.2f} ms; "
            f"iters mean {float(it.mean()):.1f} max {int(it.max())} "
            "(informational)")
    log_memory("3 parity")


def phase_fwd_bwd(svo, res: int, budgets=None) -> None:
    """Tile-path loss and gradients against the plain path's."""
    budgets = budgets or TILE_BUDGETS
    dsvo, _bsvo, tsvo, o_t, d_t, corners, params, light = _inputs(svo, res)
    o, d = o_t.reshape(-1, 3), d_t.reshape(-1, 3)
    target = 0.5 * diff.render_diff(*params, dsvo.masks, dsvo.child_base,
                                    dsvo.leaf_base, o, d, svo.depth, light,
                                    parent_ptr=dsvo.parent_ptr)
    tile_fn = lambda: diff.loss_and_grads_tile(
        *params, tsvo, o_t, d_t, corners, light, target, **budgets)
    plain_fn = lambda: diff.loss_and_grads(
        *params, dsvo.masks, dsvo.child_base, dsvo.leaf_base, o, d,
        svo.depth, light, target, parent_ptr=dsvo.parent_ptr)
    (loss_t, resid), grads_t = tile_fn()
    loss_p, grads_p = plain_fn()
    log(f"[4 fwd+bwd] {res}x{res}: tile residual {int(resid)} (required: 0)")
    check(int(resid) == 0, "tile residual")
    compare_arrays("loss tile vs plain", loss_p, loss_t, LOSS_RTOL, 0.0)
    for name, gp, gt in zip(("d_albedo", "d_normal", "d_density"),
                            grads_p, grads_t):
        compare_arrays(f"{name} tile vs plain", gp, gt, GRAD_RTOL, GRAD_ATOL)
    check_no_matrix_products("loss_and_grads_tile",
                             diff.loss_and_grads_tile.lower(
                                 *params, tsvo, o_t, d_t, corners, light,
                                 target, **budgets))
    check_no_matrix_products("loss_and_grads", diff.loss_and_grads.lower(
        *params, dsvo.masks, dsvo.child_base, dsvo.leaf_base, o, d, svo.depth,
        light, target, parent_ptr=dsvo.parent_ptr))
    log(f"  tile fwd+bwd median of 5 {fenced_median_ms(tile_fn, 5):.2f} ms; "
        f"plain {fenced_median_ms(plain_fn, 5):.2f} ms (informational)")
    log_memory("4 fwd+bwd")


def phase_fit(depth: int, views: int, steps: int, res: int, cache_dir: str,
              out_dir: str) -> None:
    """`cli fit` in-process; its mesh is every local device."""
    from raytracingtest_tpu import cli
    t0 = time.perf_counter()
    out = cli.main(["--cache-dir", cache_dir, "fit", "--scene", "terrain",
                    "--depth", str(depth), "--views", str(views), "--steps",
                    str(steps), "--view-resolution", str(res), "--out-dir",
                    out_dir])
    losses, ms = out["losses"], out["step_ms"]
    log(f"[5 fit] depth {depth}, {views} views at {res}x{res}, {steps} "
        f"steps in {time.perf_counter() - t0:.1f} s: loss "
        f"{losses[0]:.4e} -> {losses[-1]:.4e}, residual {out['residual']} "
        f"(required: 0), mean |albedo error| {out['albedo_error']:.4f}")
    log(f"  step ms (host clock, informational): first {ms[0]:.1f}, median "
        f"of the rest {float(np.median(ms[1:] or ms)):.2f}")
    check(bool(np.isfinite(losses).all()), "fit loss not finite")
    check(losses[-1] < losses[0], "fit loss did not fall")
    check(out["residual"] == 0, "fit trained on cap-limited hits")
    log_memory("5 fit")


def phase_fly(frames: int, res: int, out_dir: str, extra=()) -> None:
    """`cli fly` in-process with every frame fetched (it raises on a frame
    with non-finite pixels)."""
    from raytracingtest_tpu import cli
    out = cli.main(["fly", "--scene", "terrain", "--frames", str(frames),
                    "--resolution", str(res), "--save-frames", "--out-dir",
                    out_dir, *extra])
    ms = out["frame_ms"]
    log(f"[6 fly] {len(ms)} frames at {res}x{res}, update+render ms per "
        f"frame: {' '.join(f'{m:.1f}' for m in ms)} (host clock, "
        "informational)")
    check(len(ms) >= frames, "fly rendered too few frames")
    log_memory("6 fly")


def phase_deep(depth: int, res: int, n_sample: int, out_dir: str | None,
               split_level: int = 2, seed: int = 0) -> None:
    """Split device build, then an exact tile render (trace_tile_exact)
    checked against the host oracle on sampled pixels."""
    t0 = time.perf_counter()
    svo = build_svo_device_split(get_scene("terrain"), depth,
                                 split_level=split_level)
    log(f"[deep build] depth {depth} split at level {split_level}: "
        f"{svo.n_nodes} nodes, {svo.n_leaves} leaves in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    tsvo = tile_mod.make_tile_svo(svo).device()
    log(f"  tile structure (host) {time.perf_counter() - t0:.1f} s")
    cam = _camera(res)
    o_t, d_t, corners, grid = tile_mod.tile_rays(cam, np)
    args = (tsvo, jnp.asarray(o_t), jnp.asarray(d_t), jnp.asarray(corners))
    times = []
    for _ in range(2):                      # cold (compiles), then warm
        t0 = time.perf_counter()
        r = tile_mod.trace_tile_exact(*args)
        jax.block_until_ready(r.hit_leaf)
        times.append(time.perf_counter() - t0)
    log(f"[deep render] {res}x{res} exact: {times[0]:.1f} s cold, "
        f"{times[1]*1e3:.1f} ms warm")
    leaf = tile_mod.untile_image(np.asarray(r.hit_leaf), grid)
    t_hit = tile_mod.untile_image(np.asarray(r.hit_t), grid)
    o, d = cam.rays(np)
    idx = np.random.default_rng(seed).choice(o.shape[0], n_sample,
                                             replace=False)
    ref = traverse.trace_numpy(svo, o[idx], d[idx])
    compare_hits("deep exact vs host oracle", ref.hit_leaf, ref.hit_t,
                 leaf[idx], t_hit[idx])
    if out_dir:
        from PIL import Image
        os.makedirs(out_dir, exist_ok=True)
        img = diff.shade_diff(r.hit_leaf, jnp.asarray(d_t.reshape(-1, 3)),
                              jnp.asarray(svo.leaf_albedo),
                              jnp.asarray(svo.leaf_normal),
                              jnp.asarray(svo.leaf_density),
                              jnp.asarray(LIGHT, jnp.float32), 1.3, 0.08)
        img = tile_mod.untile_image(np.asarray(img), grid).reshape(res, res, 3)
        check(bool(np.isfinite(img).all()), "deep image not finite")
        path = os.path.join(out_dir, f"deep_d{depth}_{res}.png")
        Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(path)
        log(f"  wrote {path}")
    log_memory("deep")


def phase_four(depth: int, fit_res: int, render_res: int, trace_res: int,
               n_devices: int = 4, fit_steps: int = 2) -> None:
    """The sharded paths on `n_devices` against one device: the tile train
    step, the tile render, and the level-sharded traces."""
    from raytracingtest_tpu.models import InverseRenderer
    from raytracingtest_tpu.parallel import level_sharded
    from raytracingtest_tpu.parallel.mesh import make_mesh
    from raytracingtest_tpu.parallel.render_sharded import render_tile_sharded

    check(jax.device_count() >= n_devices,
          f"needs {n_devices} devices, found {jax.device_count()}")
    t0 = time.perf_counter()
    svo = build_svo(get_scene("terrain"), depth).svo
    log(f"[four build] depth {depth} host build: {svo.n_nodes} nodes in "
        f"{time.perf_counter() - t0:.1f} s")
    dsvo = svo.device()
    light = jnp.asarray(LIGHT, jnp.float32)
    params = (jnp.asarray(svo.leaf_albedo), jnp.asarray(svo.leaf_normal),
              jnp.asarray(svo.leaf_density))

    # -- sharded train step, n devices vs one, through the user path
    # (InverseRenderer.step_view, Adam) on the first view `cli fit` poses.
    # Loss: rtol 1e-5 (psum order). Gradient of the first step, read from
    # Adam's first moment (mu = (1 - b1) * g after one step from zero):
    # rtol 1e-4 / atol 1e-6. Adam's first update is -lr * g / (|g| + eps),
    # about -lr * sign(g), so an entry whose gradient is f32 reassociation
    # noise (|g| <= atol, either sign) moves by up to lr on one side and not
    # the other; the updated albedo is held to rtol 1e-4 / atol 1e-6 on every
    # entry whose gradient the check above resolves (|g| > atol on both
    # sides, same sign), and the rest are printed.
    y0 = 0.6 + 0.25 * np.random.default_rng(0).random()
    cfg = CameraConfig(position=(1.6, y0, 0.5), look_at=(0.5, 0.5, 0.5),
                       fov_y_deg=45.0, width=fit_res, height=fit_res)
    o, d = Camera(position=cfg.position, look_at=cfg.look_at, fov_y_deg=45.0,
                  width=fit_res, height=fit_res).rays(np)
    target = np.asarray(diff.render_diff(
        *params, dsvo.masks, dsvo.child_base, dsvo.leaf_base,
        jnp.asarray(o), jnp.asarray(d), svo.depth, light,
        parent_ptr=dsvo.parent_ptr))
    results = {}
    for n in (1, n_devices):
        model = InverseRenderer(dsvo, n_devices=n)
        p, s = model.init_params(seed=0)
        losses, albedo = [], []
        t0 = time.perf_counter()
        for i in range(fit_steps):
            p, s, loss, resid = model.step_view(p, s, cfg, light, target)
            check(int(resid) == 0, f"n={n} train step {i} residual")
            losses.append(float(loss))
            albedo.append(np.asarray(p["albedo"]))
            if i == 0:
                grad = np.asarray(_adam_mu(s)["albedo"]) / (1 - ADAM_B1)
        results[n] = (losses, albedo, grad)
        log(f"[four fit] n_devices={n}: losses {losses} "
            f"({time.perf_counter() - t0:.1f} s, {fit_steps} steps)")
    (l1, a1, g1), (ln, an, gn) = results[1], results[n_devices]
    for i in range(fit_steps):
        compare_arrays(f"step {i} loss {n_devices} vs 1 device", l1[i], ln[i],
                       LOSS_RTOL, 0.0)
    compare_arrays(f"step 0 d_albedo {n_devices} vs 1 device", g1, gn,
                   GRAD_RTOL, GRAD_ATOL)
    resolved = ((g1 * gn > 0) & (np.abs(g1) > GRAD_ATOL)
                & (np.abs(gn) > GRAD_ATOL))
    rest = (g1 != 0) & ~resolved
    moved = np.abs(a1[0] - an[0])[rest]
    log(f"  step 0 albedo: {int(resolved.sum())} of {int((g1 != 0).sum())} "
        f"entries with a gradient have |g| > {GRAD_ATOL:g} on both sides; "
        f"the other {int(rest.sum())} moved apart by up to "
        f"{float(moved.max()) if moved.size else 0.0:.3e} (informational)")
    compare_arrays(f"step 0 updated albedo {n_devices} vs 1 device, resolved "
                   "entries", a1[0][resolved], an[0][resolved], GRAD_RTOL,
                   GRAD_ATOL)

    # -- tile render sharded over tiles vs one device, both exact (residual
    # 0 under the bench budgets; the fallback budgets apply per device, so
    # the sharded render resolves at least what one device does). Same hits
    # give the same pixels; a hit that differs changes a pixel by far more
    # than the f32 rounding of two differently fused programs (<= 1e-6).
    mesh = make_mesh(n_devices)
    tsvo = tile_mod.make_tile_svo(svo).device()
    o_t, d_t, corners, _g = tile_mod.tile_rays(_camera(render_res), np)
    o_t, d_t, corners = (jnp.asarray(x) for x in (o_t, d_t, corners))
    img_s, res_s = render_tile_sharded(mesh, *params, tsvo, o_t, d_t,
                                       corners, light, **TILE_BUDGETS)
    img_1, res_1 = diff.render_diff_tile(*params, tsvo, o_t, d_t, corners,
                                         light, **TILE_BUDGETS)
    delta = np.abs(np.asarray(img_s) - np.asarray(img_1)).max(axis=1)
    n_px = int((delta > 1e-5).sum())
    log(f"[four render] {render_res}x{render_res}: residual sharded "
        f"{int(np.sum(res_s))} single {int(res_1)} (required: 0); {n_px} "
        f"pixels differ by > 1e-5 (required: 0), max |diff| "
        f"{float(delta.max()):.3e}")
    check(int(np.sum(res_s)) == 0 and int(res_1) == 0,
          "tile render left cap-limited rays")
    check(n_px == 0, "sharded tile render differs from one device")

    # -- level-sharded traces vs the direct trace. They re-express each ray
    # in its octant's frame ((o - origin) / size) and step past empty
    # octants by eps 1e-5, so at depth 10 a ray that grazes a voxel corner
    # or an octant face can take another leaf than the direct trace (the
    # CPU shows it too: 13 of 262,144 rays at 512^2). They are held to the
    # mismatch-rate limit of the other paths, and the oracle's side of each
    # mismatch is printed.
    ls = level_sharded.split_svo(svo, split_level=2, n_devices=n_devices)
    o, d = _camera(trace_res).rays(np)
    o, d = jnp.asarray(o), jnp.asarray(d)
    direct = traverse._trace_jax(dsvo.masks, dsvo.child_base, dsvo.leaf_base,
                                 dsvo.parent_ptr, o, d, svo.depth)
    # arena-local leaf row -> global leaf id, per owner device
    table = np.full((n_devices, ls.arena_albedo.shape[1]), -1, np.int64)
    for i in range(len(ls.octant_owner)):
        off, n_l = int(ls.octant_leaf_off[i]), int(ls.octant_n_leaves[i])
        table[ls.octant_owner[i], off:off + n_l] = (
            ls.octant_leaf_lo[i] + np.arange(n_l))

    def global_leaf(leaf, owner):
        leaf, owner = np.asarray(leaf), np.asarray(owner)
        hit = leaf >= 0
        return np.where(hit, table[np.where(hit, owner, 0),
                                   np.where(hit, leaf, 0)], -1)

    def compare_with_direct(label, leaf, t_hit, owner):
        got = global_leaf(leaf, owner)
        compare_hits(f"{label} vs direct", direct.hit_leaf, direct.hit_t,
                     got, t_hit)
        ref_leaf = np.asarray(direct.hit_leaf)
        bad = np.flatnonzero(ref_leaf != got)
        if bad.size:
            ref = traverse.trace_numpy(svo, np.asarray(o)[bad],
                                       np.asarray(d)[bad]).hit_leaf
            log(f"  of the {bad.size} rays that differ, the host oracle "
                f"agrees with direct on {int((ref == ref_leaf[bad]).sum())}, "
                f"{label} on {int((ref == got[bad]).sum())}")

    trace = jax.jit(level_sharded.make_sharded_trace(mesh, ls))
    leaf, t_s, owner, trunc = trace(
        ls.trunk_masks, ls.trunk_child, ls.trunk_leaf, ls.octant_owner,
        ls.octant_root, ls.octant_leaf_off, ls.octant_origin,
        ls.arena_masks, ls.arena_child, ls.arena_leaf, o, d)
    n_tr = int(np.sum(np.asarray(trunc)))
    log(f"[four level-sharded] sharded trace {trace_res}x{trace_res}: "
        f"truncated {n_tr} (required: 0)")
    check(n_tr == 0, "sharded trace truncated rays")
    compare_with_direct("sharded trace", leaf, t_s, owner)

    ex = jax.jit(level_sharded.make_exchange_trace(mesh, ls))
    leaf, t_x, owner, traced, trunc = ex(
        ls.trunk_masks, ls.trunk_child, ls.trunk_leaf, ls.octant_owner,
        ls.octant_root, ls.octant_origin, ls.arena_masks, ls.arena_child,
        ls.arena_leaf, o, d)
    n_tr = int(np.sum(np.asarray(trunc)))
    log(f"[four level-sharded] exchange trace: truncated {n_tr} (required: "
        f"0), traced per device {np.asarray(traced).tolist()}")
    check(n_tr == 0, "exchange trace truncated rays")
    compare_with_direct("exchange trace", leaf, t_x, owner)
    log_memory("four")


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--deep", action="store_true",
                      help="depth-12 split device build + 2048^2 exact render")
    mode.add_argument("--four", action="store_true",
                      help="sharded fit, tile render and level-sharded "
                      "traces on 4 GPUs")
    ap.add_argument("--out-dir", default="smoke_out",
                    help="PNGs, fit state and fly-through frames")
    args = ap.parse_args(argv)

    runtime.setup_compile_cache()
    if jax.devices()[0].platform != "gpu":
        print(f"chip_smoke: no GPU found (JAX platform "
              f"{jax.devices()[0].platform!r}); nothing was run",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    info = phase_device()
    # the build cache `cli` and bench.py read: phase 1 writes the depth-10
    # host build there, so `cli fit` loads it instead of rebuilding
    cache_dir = os.path.join(runtime.REPO_ROOT, ".rtt_cache")
    if args.four:
        if info["count"] < 4:
            print(f"chip_smoke --four: needs 4 GPUs, found {info['count']}",
                  file=sys.stderr)
            return 1
        phase_four(depth=10, fit_res=512, render_res=1024, trace_res=1024)
    elif args.deep:
        phase_deep(depth=12, res=2048, n_sample=16384, out_dir=args.out_dir)
    else:
        svo = phase_build(10, cache_dir=cache_dir)
        phase_render(svo, 1024, 16384, args.out_dir)
        phase_parity(svo, 1024)
        phase_fwd_bwd(svo, 1024)
        phase_fit(10, views=32, steps=8, res=512, cache_dir=cache_dir,
                  out_dir=os.path.join(args.out_dir, "fit"))
        phase_fly(frames=8, res=512, out_dir=os.path.join(args.out_dir, "fly"))
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": info["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
