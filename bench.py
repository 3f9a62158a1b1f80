"""Benchmark: rays/s forward+backward at 1024^2 on a depth-10 SVO.

Prints the device (platform, device_kind, count, and nvidia-smi's name and
power limit) on stderr, then ONE JSON line {"metric", "value", "unit", ...}
on stdout. Every timed call is fenced with jax.block_until_ready; the value
is the median over BENCH_ITERS calls after one compiling call.

Needs a GPU: without one it exits non-zero, unless JAX_PLATFORMS=cpu was set
explicitly, in which case the JSON says "platform": "cpu" and its times are
CPU times, not device numbers.

Env knobs: BENCH_DEPTH (default 10), BENCH_RES (default 1024),
BENCH_SCENE (default terrain), BENCH_ITERS (default 16),
BENCH_MODE (fwdbwd|fwd, default fwdbwd), BENCH_PATH (tile|brick|plain,
default tile), BENCH_BUILD (cache|device, default cache).
"""

import json
import os
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

from raytracingtest_tpu.utils import runtime
from raytracingtest_tpu.utils.profiling import fenced_median_ms


def _load_svo(scene, depth, build_mode):
    """(host SVO, seconds, source). The host build is cached in the
    checkout under the name `cli` uses."""
    from raytracingtest_tpu import build_svo, get_scene
    from raytracingtest_tpu.io import checkpoint as ckpt

    t0 = time.perf_counter()
    if build_mode == "device":
        from raytracingtest_tpu.ops.octree_device import build_svo_device
        svo_dev = build_svo_device(get_scene(scene), depth)
        jax.block_until_ready(svo_dev.masks)
        return (jax.tree_util.tree_map(np.asarray, svo_dev),
                time.perf_counter() - t0, "device")
    cache = os.path.join(runtime.REPO_ROOT, ".rtt_cache",
                         f"svo_{scene}_d{depth}.npz")
    if os.path.exists(cache):
        return ckpt.load_svo(cache), time.perf_counter() - t0, "cache"
    svo = build_svo(get_scene(scene), depth).svo
    os.makedirs(os.path.dirname(cache), exist_ok=True)
    ckpt.save_svo(svo, cache)
    return svo, time.perf_counter() - t0, "host"


def main():
    runtime.setup_compile_cache()

    # multi-host entry (BASELINE config 5): a no-op on a single host; with
    # RAYT_MULTIHOST=auto or JAX_COORDINATOR_ADDRESS set, each process
    # joins the jax.distributed job and benches process-local ray rows
    from raytracingtest_tpu.parallel import multihost
    mh = multihost.init_from_env()

    info = runtime.device_info()
    print(f"# device: {info}", file=sys.stderr)
    gpu = None
    if info["platform"] == "gpu":
        gpu = runtime.gpu_name_and_power_limit()
        print(f"# nvidia-smi: {gpu}", file=sys.stderr)
    elif os.environ.get("JAX_PLATFORMS") != "cpu":
        print("bench.py: no GPU found (set JAX_PLATFORMS=cpu to run on the "
              "CPU on purpose)", file=sys.stderr)
        sys.exit(1)
    if mh["process_count"] > 1:
        return _main_multihost(mh, info)

    from raytracingtest_tpu import diff
    from raytracingtest_tpu.ops import brick as brick_mod
    from raytracingtest_tpu.ops import tile as tile_mod
    from raytracingtest_tpu.ops.camera import Camera

    depth = int(os.environ.get("BENCH_DEPTH", "10"))
    res_px = int(os.environ.get("BENCH_RES", "1024"))
    scene = os.environ.get("BENCH_SCENE", "terrain")
    iters = int(os.environ.get("BENCH_ITERS", "16"))
    mode = os.environ.get("BENCH_MODE", "fwdbwd")
    # tile  = the production tile-amortized traversal (ops/tile.py)
    # brick = the per-ray brick traversal (ops/brick.py)
    # plain = the per-ray ESVO loop (ops/traverse.py)
    path = os.environ.get("BENCH_PATH", "tile")

    svo_host, build_s, build_source = _load_svo(
        scene, depth, os.environ.get("BENCH_BUILD", "cache"))
    svo = svo_host.device()
    use_brick = path == "brick" and depth >= brick_mod.BRICK_LEVELS + 1
    use_tile = path == "tile" and depth >= brick_mod.BRICK_LEVELS + 1
    if use_brick:
        bsvo = brick_mod.make_brick_svo(svo_host).device()
    if use_tile:
        tsvo = tile_mod.make_tile_svo(svo_host).device()
    print(f"# build: depth={depth} scene={scene} nodes={svo.n_nodes} "
          f"leaves={svo.n_leaves} in {build_s:.1f}s ({build_source})",
          file=sys.stderr)

    cam = Camera(position=(0.5, 0.85, -0.6), look_at=(0.5, 0.4, 0.5),
                 fov_y_deg=50.0, width=res_px, height=res_px)
    o, d = cam.rays(np)
    o = jnp.asarray(o)
    d = jnp.asarray(d)
    if use_tile:
        o_t, d_t, corners, _grid = tile_mod.tile_rays(cam, np)
        o_t = jnp.asarray(o_t)
        d_t = jnp.asarray(d_t)
        corners = jnp.asarray(corners)
    light = jnp.asarray([-0.5, -1.0, -0.3], jnp.float32)
    albedo = jnp.asarray(svo.leaf_albedo)
    normal = jnp.asarray(svo.leaf_normal)
    density = jnp.asarray(svo.leaf_density)
    target = jnp.zeros((o.shape[0], 3), jnp.float32)
    n_rays = o.shape[0]

    # tile budgets: k_max / fb_tiles / fb_k / fb2_tiles (sub-tile re-walk,
    # 2x2 split); these reach residual 0 on the default scene
    tile_k = int(os.environ.get("BENCH_TILE_K", "96"))
    tile_fbt = int(os.environ.get("BENCH_FBT", "96"))
    tile_fb2 = int(os.environ.get("BENCH_FB2", "16"))
    tile_fbk = int(os.environ.get("BENCH_FBK", "160"))
    budgets = dict(k_max=tile_k, fb_tiles=tile_fbt, fb_k=tile_fbk,
                   fb2_tiles=tile_fb2)

    def run_tile_fwd():
        return diff.render_diff_tile(albedo, normal, density, tsvo, o_t, d_t,
                                     corners, light, **budgets)

    if use_tile and mode == "fwd":
        run = run_tile_fwd
    elif use_tile:
        def run():
            return diff.loss_and_grads_tile(
                albedo, normal, density, tsvo, o_t, d_t, corners, light,
                target, **budgets)
    elif use_brick and mode == "fwd":
        def run():
            return diff.render_diff_brick(
                albedo, normal, density, bsvo.top_masks, bsvo.top_child,
                bsvo.top_parent, bsvo.bricks, o, d, depth, bsvo.top_depth,
                light)
    elif use_brick:
        def run():
            return diff.loss_and_grads_brick(
                albedo, normal, density, bsvo.top_masks, bsvo.top_child,
                bsvo.top_parent, bsvo.bricks, o, d, depth, bsvo.top_depth,
                light, target)
    elif mode == "fwd":
        def run():
            return diff.render_diff(albedo, normal, density, svo.masks,
                                    svo.child_base, svo.leaf_base, o, d,
                                    depth, light)
    else:
        def run():
            return diff.loss_and_grads(
                albedo, normal, density, svo.masks, svo.child_base,
                svo.leaf_base, o, d, depth, light, target)

    t0 = time.perf_counter()
    jax.block_until_ready(run())
    print(f"# first call (compile+run): {time.perf_counter() - t0:.1f}s",
          file=sys.stderr)
    ms = fenced_median_ms(run, iters)
    rays_per_s = n_rays / (ms * 1e-3)
    print(f"# median: {ms:.2f} ms/frame at {res_px}x{res_px}",
          file=sys.stderr)

    out = {
        "metric": f"rays_per_s_{mode}_{res_px}px_depth{depth}",
        "value": rays_per_s,
        "unit": "rays/s",
        "mrays_per_s": rays_per_s / 1e6,
        "ms_per_frame": ms,
        "iters": iters,
        "timing": "median of fenced calls",
        "build_seconds": build_s,
        "build_source": build_source,
        "device": info,
        "gpu": gpu,
    }
    if use_tile:
        if mode == "fwdbwd":
            # forward-only companion number in the same process
            ms_f = fenced_median_ms(run_tile_fwd, iters)
            out["fwd_rays_per_s"] = n_rays / (ms_f * 1e-3)
            out["fwd_ms_per_frame"] = ms_f
        # the recorded number must be for EXACT hits: report the
        # unresolved-ray residual of the benchmarked config
        _img, residual = run_tile_fwd()
        out["residual_rays"] = int(residual)
    print(json.dumps(out))


def _main_multihost(mh, info):
    """Config-5 shape: rays sharded over ALL hosts' devices; each process
    generates only its pixel rows, assembles global arrays, and runs the
    sharded forward render. Throughput = global rays / frame time."""
    from raytracingtest_tpu.ops.camera import Camera
    from raytracingtest_tpu.parallel import multihost
    from raytracingtest_tpu.parallel.mesh import make_mesh
    from raytracingtest_tpu.parallel.render_sharded import render_sharded

    depth = int(os.environ.get("BENCH_DEPTH", "10"))
    res_px = int(os.environ.get("BENCH_RES", "1024"))
    scene = os.environ.get("BENCH_SCENE", "terrain")
    iters = int(os.environ.get("BENCH_ITERS", "4"))

    svo_host, _s, _src = _load_svo(scene, depth, "cache")
    svo = svo_host.device()
    cam = Camera(position=(0.5, 0.85, -0.6), look_at=(0.5, 0.4, 0.5),
                 fov_y_deg=50.0, width=res_px, height=res_px)
    mesh = make_mesh()
    pr = multihost.process_rows(res_px, res_px)
    o_l, d_l = multihost.local_camera_rays(cam, pr)
    o = multihost.global_ray_array(mesh, pr, o_l)
    d = multihost.global_ray_array(mesh, pr, d_l)
    light = jnp.asarray([-0.5, -1.0, -0.3], jnp.float32)

    def run():
        return render_sharded(mesh, jnp.asarray(svo.leaf_albedo),
                              jnp.asarray(svo.leaf_normal),
                              jnp.asarray(svo.leaf_density), svo.masks,
                              svo.child_base, svo.leaf_base, o, d, depth,
                              light)

    ms = fenced_median_ms(run, iters)
    n_rays = res_px * res_px
    if jax.process_index() == 0:
        print(f"# multihost: {mh['process_count']} processes x "
              f"{len(jax.local_devices())} local devices", file=sys.stderr)
        print(json.dumps({
            "metric": f"rays_per_s_fwd_{res_px}px_depth{depth}_multihost",
            "value": n_rays / (ms * 1e-3),
            "unit": "rays/s",
            "ms_per_frame": ms,
            "device": info,
        }))


if __name__ == "__main__":
    main()
