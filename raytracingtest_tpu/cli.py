"""Command-line driver: render / fit / info.

The reference's "drivers" are Unity scenes with keyboard rebuild hooks
(R = rebuild SVO, RaytracingMaster.cs:50-52; Q = recompile master octree,
Clipmap.cs:37-42) and Inspector-configured fields. Here:

  python -m raytracingtest_tpu.cli render --scene terrain --depth 8 \
      --width 512 --height 512 --out out.png
  python -m raytracingtest_tpu.cli fit --scene sphere --depth 6 \
      --views 16 --steps 100 --out-dir rtt_fit
  python -m raytracingtest_tpu.cli info --scene sphere --depth 6

Builds are cached on disk keyed by (scene, depth) — the rebuild-on-change
ergonomics of OnValidate without rebuilding for unchanged configs. `fit` and
`fly` return a summary dict (losses, frame times) to in-process callers.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def _load_or_build(scene_name: str, depth: int, cache_dir: str,
                   load: str = ""):
    from raytracingtest_tpu.io import checkpoint as ckpt
    from raytracingtest_tpu.ops.octree import build_svo
    from raytracingtest_tpu.scenes import get_scene

    if load:
        # render any saved SVO directly — e.g. a depth-12 device build or
        # a fitted checkpoint — without a scene rebuild (the role of the
        # reference's CompactSVO load-from-file ctor, CompactSVO.cs:69-71,
        # which upstream left an empty stub)
        return ckpt.load_svo(load)
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, f"svo_{scene_name}_d{depth}.npz")
    if os.path.exists(path):
        return ckpt.load_svo(path)
    t0 = time.time()
    svo = build_svo(get_scene(scene_name), depth).svo
    print(f"built {scene_name} depth={depth}: {svo.n_nodes} nodes, "
          f"{svo.n_leaves} leaves in {time.time()-t0:.1f}s", file=sys.stderr)
    ckpt.save_svo(svo, path)
    return svo


def _save_png(img: np.ndarray, path: str):
    from PIL import Image

    Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(path)
    print(f"wrote {path}", file=sys.stderr)


def cmd_render(args):
    from raytracingtest_tpu.config import CameraConfig, RenderConfig
    from raytracingtest_tpu.models import SurfaceRenderer, VolumetricRenderer
    from raytracingtest_tpu.utils.profiling import RaysPerSecond

    svo = _load_or_build(args.scene, args.depth, args.cache_dir,
                         getattr(args, "load", "")).device()
    cam = CameraConfig(
        position=tuple(args.camera_position),
        look_at=tuple(args.look_at), fov_y_deg=args.fov,
        width=args.width, height=args.height,
        ortho_height=args.ortho_height)
    rnd = RenderConfig(samples=args.samples, volumetric_k=args.volumetric_k)
    if args.skybox and (args.lod_coef > 0.0 or args.attachments
                        or args.volumetric_k > 0
                        or (args.specular > 0.0 and args.bounces > 1)):
        raise SystemExit("--skybox combines only with the surface render; "
                         "drop --lod-coef/--attachments/--volumetric-k/"
                         "--specular")
    if args.skybox:
        # real environment map on miss (the reference's HDR cubemap sample,
        # RaytraceCompute.compute:117-126 + daytime.hdr/sunset.hdr assets):
        # load a Radiance .hdr (io/hdr.py) or any PIL-readable image, or
        # bake the procedural daytime map with --skybox procedural
        from raytracingtest_tpu.io import hdr as hdr_mod
        if args.skybox == "procedural":
            tex = hdr_mod.make_sky_hdr()
        elif args.skybox.lower().endswith(".hdr"):
            tex = hdr_mod.load_hdr(args.skybox)
        else:
            from PIL import Image
            tex = np.asarray(Image.open(args.skybox).convert("RGB"),
                             np.float32) / 255.0
        model = SurfaceRenderer(svo)
        img = model.render_progressive(cam, rnd, skybox=tex)
    elif args.lod_coef > 0.0:
        # LOD render (Trace.cu:135-136 ray_size semantics) through the
        # production brick path; interior hits shade from averaged node
        # attributes (ops/lod.py)
        import numpy as _np
        import jax.numpy as jnp
        from raytracingtest_tpu.ops import brick as brick_mod
        from raytracingtest_tpu.ops import lod as lod_mod
        from raytracingtest_tpu.models.renderers import _camera
        camera = _camera(cam)
        o, d = camera.rays(_np)
        node_albedo, node_normal = lod_mod.compute_node_attributes(svo)
        if svo.depth >= brick_mod.BRICK_LEVELS + 1:
            bsvo = brick_mod.make_brick_svo(svo).device()
            res = brick_mod.trace_brick_lod_jax(
                bsvo, jnp.asarray(o), jnp.asarray(d), args.lod_coef)
            img = _np.asarray(lod_mod.shade_lod(
                svo, node_albedo, node_normal, res, d)).reshape(
                args.height, args.width, 3)
        else:
            img, _ = lod_mod.render_lod(svo, node_albedo, node_normal,
                                        jnp.asarray(o), jnp.asarray(d),
                                        args.lod_coef)
            img = _np.asarray(img).reshape(args.height, args.width, 3)
    elif args.attachments:
        # reference production shading: compressed 64-bit attachments
        # (AttachmentLookup.compute analog)
        import numpy as _np
        from raytracingtest_tpu import render as render_mod
        from raytracingtest_tpu.ops import codecs
        from raytracingtest_tpu.models.renderers import _camera
        camera = _camera(cam)
        o, d = camera.rays(_np)
        wa, wb = codecs.build_attachments(svo)
        img = _np.asarray(render_mod.render_attachment(
            svo, wa, wb, o, d)).reshape(args.height, args.width, 3)
    elif args.specular > 0.0 and args.bounces > 1:
        # live reflection continuation (the reference megakernel's bounce
        # loop, dead there with specular=0; RaytraceCompute.compute:159-166)
        from raytracingtest_tpu.ops import brick as brick_mod
        from raytracingtest_tpu.models.renderers import _camera
        from raytracingtest_tpu.render import Light, render_bounce
        bsvo = brick_mod.make_brick_svo(svo).device()
        img = render_bounce(bsvo, svo.leaf_albedo, svo.leaf_normal,
                            _camera(cam), light=Light(),
                            specular=args.specular, bounces=args.bounces)
    elif args.volumetric_k > 0:
        model = VolumetricRenderer(svo, k=args.volumetric_k)
        img = model.render(cam, rnd)
    else:
        model = SurfaceRenderer(svo)
        counter = RaysPerSecond()
        with counter.frame(args.width * args.height * max(args.samples, 1)):
            img = model.render_progressive(cam, rnd)
        print(counter.summary(), file=sys.stderr)
    _save_png(img, args.out)


def cmd_fit(args):
    """Inverse-rendering fit (BASELINE config 4): recover voxel albedo from
    posed target images, rays sharded over the local device mesh."""
    from raytracingtest_tpu.parallel import multihost
    multihost.init_from_env()
    import jax.numpy as jnp

    from raytracingtest_tpu import diff
    from raytracingtest_tpu.io import checkpoint as ckpt
    from raytracingtest_tpu.models import InverseRenderer
    from raytracingtest_tpu.ops.camera import Camera

    svo = _load_or_build(args.scene, args.depth, args.cache_dir).device()
    light = jnp.asarray([-0.5, -1.0, -0.3], jnp.float32)
    model = InverseRenderer(svo, optimize=("albedo",),
                            learning_rate=args.lr)

    # posed views on a circle around the scene
    from raytracingtest_tpu.config import CameraConfig
    rng = np.random.default_rng(args.seed)
    views = []
    res = args.view_resolution
    for v in range(args.views):
        ang = 2 * np.pi * v / args.views
        pos = (0.5 + 1.1 * np.cos(ang), 0.6 + 0.25 * rng.random(),
               0.5 + 1.1 * np.sin(ang))
        ccfg = CameraConfig(position=pos, look_at=(0.5, 0.5, 0.5),
                            fov_y_deg=45.0, width=res, height=res)
        cam = Camera(position=pos, look_at=(0.5, 0.5, 0.5), fov_y_deg=45.0,
                     width=res, height=res)
        o, d = cam.rays(np)
        target = diff.render_diff(
            jnp.asarray(svo.leaf_albedo), jnp.asarray(svo.leaf_normal),
            jnp.asarray(svo.leaf_density), svo.masks, svo.child_base,
            svo.leaf_base, jnp.asarray(o), jnp.asarray(d), svo.depth, light)
        views.append((ccfg, np.asarray(target)))
    print(f"synthesized {len(views)} posed target views at {res}x{res}",
          file=sys.stderr)

    params, opt_state = model.init_params(seed=args.seed,
                                          randomize=("albedo",))
    t0 = time.time()
    resid_total = 0
    losses, step_ms = [], []
    for step in range(args.steps):
        ccfg, target = views[step % len(views)]
        # the production path (tile > brick > plain); residual counts rays
        # whose loss terms used cap-limited hits
        t_step = time.perf_counter()
        params, opt_state, loss, resid = model.step_view(
            params, opt_state, ccfg, light, target)
        resid_total += int(resid)
        losses.append(float(loss))
        step_ms.append((time.perf_counter() - t_step) * 1e3)
        if step % max(args.steps // 10, 1) == 0 or step == args.steps - 1:
            print(f"step {step:5d}  loss {float(loss):.3e}  "
                  f"residual {int(resid)}  ({time.time()-t0:.1f}s)",
                  file=sys.stderr)
    if resid_total:
        print(f"WARNING: {resid_total} ray-steps trained on cap-limited "
              "hits", file=sys.stderr)
    err = float(jnp.abs(params["albedo"]
                        - jnp.asarray(svo.leaf_albedo)).mean())
    print(f"final mean |albedo error| = {err:.4f}", file=sys.stderr)
    os.makedirs(args.out_dir, exist_ok=True)
    ckpt.save_train_state(os.path.join(args.out_dir, "fit_state.npz"),
                          params, opt_state, step=args.steps,
                          meta={"scene": args.scene, "depth": args.depth})
    print(f"saved {args.out_dir}/fit_state.npz", file=sys.stderr)
    return {"losses": losses, "residual": resid_total, "albedo_error": err,
            "step_ms": step_ms}


def cmd_fly(args):
    """Main-scene integration (the reference's Main.unity loop): a fly
    camera drives the StreamingRenderer model — per-frame clipmap update
    -> arena sync -> stitched per-LOD pyramids -> one-dispatch tile-path
    render with on-device progressive accumulation. While the camera
    rests, jittered frames accumulate into a running average; any camera
    motion resets the sample counter (RaytracingMaster.cs:43-47 +
    AddShader.shader:42-46 semantics). --path brick keeps the per-ray
    stitched loop for A/B."""
    import jax.numpy as jnp

    from raytracingtest_tpu import diff
    from raytracingtest_tpu.models import StreamingRenderer
    from raytracingtest_tpu.ops.camera import Camera
    from raytracingtest_tpu.scenes import get_scene
    from raytracingtest_tpu.stream.clipmap import trace_clipmap_device_brick

    sr = StreamingRenderer(
        get_scene(args.scene), min_chunk_size=args.min_chunk,
        radius=args.radius, lods=args.lods, chunk_depth=args.chunk_depth,
        node_capacity=args.arena_nodes, leaf_capacity=args.arena_leaves)
    light = jnp.asarray([-0.5, -1.0, -0.3], jnp.float32)

    frames = []
    os.makedirs(args.out_dir, exist_ok=True)
    res = args.resolution
    stats_total = {"update_ms": 0.0, "render_ms": 0.0}
    frame_ms = []
    acc = None
    sample = 0
    # fly path: a lateral sweep above the terrain looking ahead/down,
    # then hold_frames at the final pose (camera at rest -> accumulation)
    total = args.frames + args.hold_frames
    for f in range(total):
        u = min(f, args.frames - 1) / max(args.frames - 1, 1)
        pos = np.array([0.18 + 0.55 * u, 0.72, 0.12 + 0.2 * u])
        look = np.array([0.5 + 0.3 * (u - 0.5), 0.3, 0.6])

        t0 = time.time()
        st = sr.update(pos)
        t_update = time.time() - t0

        cam = Camera(position=tuple(pos), look_at=tuple(look),
                     fov_y_deg=55.0, width=res, height=res)
        t0 = time.time()
        keep = (f % max(total // 8, 1) == 0) or f == total - 1
        if args.path == "tile":
            if keep or args.save_frames:
                px, n_un = sr.render(cam)
            else:
                _acc, un = sr.render(cam, fetch=False)
                n_un = int(np.asarray(un))   # scalar fence: frame done
                px = None
            sample = sr.sample_count
        else:
            # per-ray stitched loop A/B (the r1-r4 path)
            pose = (tuple(pos), tuple(look))
            if pose != getattr(cmd_fly, "_pose", None):
                acc, sample = None, 0
                cmd_fly._pose = pose
            o, d = cam.rays(np)
            clip, devb = sr.clipmap, sr.device_bricks
            trunk, roots, origins, sizes = clip.master_brick()
            leaf, t_hit, chunk_id, _trunc = trace_clipmap_device_brick(
                trunk, tuple(clip.octree.root.position),
                clip.octree.root.size, roots, origins, sizes,
                args.chunk_depth, devb, o, d)
            img = diff.shade_diff(leaf, jnp.asarray(d),
                                  sr.device_arena.leaf_albedo,
                                  sr.device_arena.leaf_normal,
                                  sr.device_arena.leaf_density,
                                  light, 1.3, 0.08)
            img = np.asarray(img).reshape(res, res, 3)
            acc = img if sample == 0 else acc + (img - acc) / (sample + 1)
            sample += 1
            px, n_un = acc, 0
        t_render = time.time() - t0

        stats_total["update_ms"] += t_update * 1e3
        stats_total["render_ms"] += t_render * 1e3
        frame_ms.append((t_update + t_render) * 1e3)
        print(f"frame {f:3d}  update {t_update*1e3:7.1f} ms "
              f"(+{st['added']}/-{st['evicted']} chunks, "
              f"{st['resident']} resident, "
              f"{st['node_spans']}+{st['brick_spans']} spans)  "
              f"render {t_render*1e3:7.1f} ms  samples {sample}"
              + (f"  residual {n_un}" if n_un else ""),
              file=sys.stderr)
        if px is not None:
            px = np.asarray(px).reshape(res, res, 3)
            if not np.isfinite(px).all():
                raise FloatingPointError(
                    f"frame {f}: {int((~np.isfinite(px)).sum())} non-finite "
                    "pixel values")
            if keep:
                frames.append(px.copy())
            if args.save_frames:
                _save_png(px, os.path.join(args.out_dir, f"fly_{f:03d}.png"))

    strip = np.concatenate(frames, axis=1)
    _save_png(strip, os.path.join(args.out_dir, "fly_strip.png"))
    n = total
    print(f"avg/frame: update+sync+master {stats_total['update_ms']/n:.1f} "
          f"ms  render {stats_total['render_ms']/n:.1f} ms",
          file=sys.stderr)
    return {"frame_ms": frame_ms}


def cmd_info(args):
    svo = _load_or_build(args.scene, args.depth, args.cache_dir,
                         getattr(args, "load", ""))
    src = args.load if getattr(args, "load", "") else args.scene
    print(f"scene={src} depth={svo.depth}")
    print(f"nodes={svo.n_nodes} leaves={svo.n_leaves}")
    for l in range(svo.depth):
        lo, hi = svo.level_start[l], svo.level_start[l + 1]
        print(f"  level {l:2d}: {hi - lo:9d} nodes")
    bytes_total = svo.n_nodes * 12 + svo.n_leaves * (12 + 12 + 4)
    print(f"memory: {bytes_total/1e6:.1f} MB (nodes + fp leaf attributes)")


def cmd_debug(args):
    """Visual/ray debug probe — the SVODriver + gizmo analog
    (SVODriver.cs:74-90, OnDrawGizmos): node-box overlay render and/or a
    textual dump of every leaf a probe ray intersects."""
    import numpy as np
    from raytracingtest_tpu import viz
    from raytracingtest_tpu.ops.camera import Camera
    from raytracingtest_tpu.render import render_jax

    svo = _load_or_build(args.scene, args.depth, args.cache_dir)
    if args.ray is not None:
        o = args.ray[:3]
        d = args.ray[3:]
        entries = viz.ray_probe(svo, o, d, max_hits=args.max_hits)
        print(viz.format_probe(entries))
    if args.out:
        cam = Camera(position=tuple(args.camera_position),
                     look_at=tuple(args.look_at), fov_y_deg=args.fov,
                     width=args.width, height=args.height)
        img = np.array(render_jax(svo, cam))  # writable copy for the overlay
        origins, size = viz.node_boxes(svo, args.level)
        viz.draw_boxes(img, cam, origins, size,
                       max_boxes=args.max_boxes)
        _save_png(img, args.out)
        print(f"wrote {args.out} ({len(origins)} level-{args.level} boxes)")


def cmd_probe(args):
    """Interactive probe session — the SVODriver + OctreeDebugger loop,
    headless (SVODriver.cs:30-33 draggable ray endpoints re-probing on
    every change; OctreeDebugger.cs:14-32 live insert/delete of cubes
    into a chunk octree with gizmo redraws; OnValidate rebuild-on-change,
    SVODriver.cs:48-51). Commands come from stdin (or --commands for
    scripted use, ';'-separated); every state change re-runs the probe
    and, with --out, re-renders the overlay frame:

      from X Y Z | to X Y Z   move a ray endpoint (re-probes)
      scene NAME | depth N    rebuild the SVO (re-probes)
      level N                 gizmo box level for render overlays
      render [PATH]           render + node boxes + probe ray -> PNG
      insert X Y Z S          insert a cube into the debug chunk octree
      delete X Y Z S          remove it (prints the octree box list)
      boxes                   print chunk-octree boxes
      probe                   re-print the current ray's leaf list
      quit
    """
    import numpy as _np
    from raytracingtest_tpu import viz
    from raytracingtest_tpu.ops.camera import Camera
    from raytracingtest_tpu.render import render_jax
    from raytracingtest_tpu.stream.chunk_octree import ChunkOctree

    state = {
        "scene": args.scene, "depth": args.depth, "level": args.level,
        "from": _np.asarray([0.1, 0.9, 0.1], _np.float64),
        "to": _np.asarray([0.9, 0.1, 0.9], _np.float64),
        "svo": None,
    }
    octree = ChunkOctree(origin=(0.0, 0.0, 0.0), size=1.0)
    boxes = {}

    def rebuild():
        state["svo"] = _load_or_build(state["scene"], state["depth"],
                                      args.cache_dir)
        print(f"svo: {state['scene']} depth={state['depth']} "
              f"{state['svo'].n_nodes} nodes")

    def probe():
        d = state["to"] - state["from"]
        n = _np.linalg.norm(d)
        if n < 1e-12:
            print("(degenerate ray)")
            return
        entries = viz.ray_probe(state["svo"], state["from"], d / n,
                                max_hits=args.max_hits)
        print(f"ray {state['from'].tolist()} -> {state['to'].tolist()}")
        print(viz.format_probe(entries))

    def render(path):
        cam = Camera(position=tuple(args.camera_position),
                     look_at=tuple(args.look_at), fov_y_deg=args.fov,
                     width=args.width, height=args.height)
        img = _np.array(render_jax(state["svo"].device(), cam))
        origins, size = viz.node_boxes(state["svo"], state["level"])
        viz.draw_boxes(img, cam, origins, size, max_boxes=args.max_boxes)
        for pos, s in boxes.values():
            viz.draw_boxes(img, cam, _np.asarray([pos], _np.float32),
                           float(s), color=(1.0, 1.0, 0.2))
        viz.draw_segment(img, cam, state["from"], state["to"])
        _save_png(img, path)

    rebuild()
    probe()
    if args.commands:
        lines = [c.strip() for c in args.commands.split(";") if c.strip()]
    else:
        print("probe> reading commands from stdin (see --help)",
              file=sys.stderr)
        lines = (ln.strip() for ln in sys.stdin)
    for line in lines:
        if not line or line.startswith("#"):
            continue
        tok = line.split()
        cmd, rest = tok[0], tok[1:]
        try:
            if cmd == "quit":
                break
            elif cmd in ("from", "to"):
                state[cmd] = _np.asarray([float(v) for v in rest[:3]])
                probe()
            elif cmd == "scene":
                state["scene"] = rest[0]
                rebuild(); probe()
            elif cmd == "depth":
                state["depth"] = int(rest[0])
                rebuild(); probe()
            elif cmd == "level":
                state["level"] = int(rest[0])
                print(f"level {state['level']}")
            elif cmd == "render":
                render(rest[0] if rest else (args.out or "probe.png"))
            elif cmd == "insert":
                x, y, z, s = (float(v) for v in rest[:4])
                octree.add_chunk((x, y, z), s, chunk=(x, y, z, s))
                boxes[(x, y, z, s)] = ((x, y, z), s)
                print(f"inserted ({x},{y},{z}) size {s}; "
                      f"{len(boxes)} cubes")
            elif cmd == "delete":
                x, y, z, s = (float(v) for v in rest[:4])
                ok = octree.remove_chunk((x, y, z), s)
                boxes.pop((x, y, z, s), None)
                print("removed" if ok else "not found")
            elif cmd == "boxes":
                for (pos, s) in boxes.values():
                    print(f"cube at {pos} size {s}")
                print(f"octree root size {octree.root.size}")
            elif cmd == "probe":
                probe()
            else:
                print(f"? unknown command {cmd!r}")
        except (ValueError, IndexError) as e:
            print(f"! {e}")


def main(argv=None):
    from raytracingtest_tpu.utils.runtime import REPO_ROOT, setup_compile_cache
    p = argparse.ArgumentParser(prog="raytracingtest_tpu")
    p.add_argument("--cache-dir",
                   default=os.path.join(REPO_ROOT, ".rtt_cache"),
                   help="built SVOs, keyed by scene and depth")
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render", help="render a scene to PNG")
    pr.add_argument("--attachments", action="store_true",
                    help="shade from the compressed 64-bit attachment words "
                    "(R5G6B5 palette + normal16) instead of fp attributes")
    pr.add_argument("--lod-coef", type=float, default=0.0,
                    help="LOD footprint coefficient (>0 enables ray-size "
                    "early exit through the brick path; ~2*tan(fov/2)/H "
                    "matches one pixel)")
    pr.add_argument("--scene", default="terrain")
    pr.add_argument("--depth", type=int, default=8)
    pr.add_argument("--width", type=int, default=512)
    pr.add_argument("--height", type=int, default=512)
    pr.add_argument("--fov", type=float, default=50.0)
    pr.add_argument("--ortho-height", type=float, default=0.0)
    pr.add_argument("--camera-position", type=float, nargs=3,
                    default=[0.5, 0.85, -0.6])
    pr.add_argument("--look-at", type=float, nargs=3, default=[0.5, 0.4, 0.5])
    pr.add_argument("--samples", type=int, default=1)
    pr.add_argument("--bounces", type=int, default=1,
                    help="reflection bounces (with --specular > 0)")
    pr.add_argument("--specular", type=float, default=0.0,
                    help="mirror reflectance per bounce (ref ships 0)")
    pr.add_argument("--volumetric-k", type=int, default=0)
    pr.add_argument("--skybox", default="",
                    help="environment map sampled on miss: a Radiance .hdr "
                    "file, any image file, or 'procedural' (baked daytime "
                    "map with an HDR sun disc)")
    pr.add_argument("--load", default="",
                    help="render a saved SVO checkpoint (.npz) instead of "
                    "building --scene/--depth")
    pr.add_argument("--out", default="render.png")
    pr.set_defaults(fn=cmd_render)

    pf = sub.add_parser("fit", help="inverse-rendering fit of voxel albedo")
    pf.add_argument("--scene", default="sphere")
    pf.add_argument("--depth", type=int, default=6)
    pf.add_argument("--views", type=int, default=32)
    pf.add_argument("--view-resolution", type=int, default=128)
    pf.add_argument("--steps", type=int, default=200)
    pf.add_argument("--lr", type=float, default=5e-2)
    pf.add_argument("--seed", type=int, default=0)
    pf.add_argument("--out-dir", default="rtt_fit")
    pf.set_defaults(fn=cmd_fit)

    pfly = sub.add_parser("fly", help="flythrough: streaming clipmap world "
                          "rendered per frame (Main scene)")
    pfly.add_argument("--scene", default="terrain")
    pfly.add_argument("--frames", type=int, default=16)
    pfly.add_argument("--resolution", type=int, default=256)
    pfly.add_argument("--min-chunk", type=float, default=0.25)
    pfly.add_argument("--radius", type=int, default=2)
    pfly.add_argument("--lods", type=int, default=2)
    pfly.add_argument("--chunk-depth", type=int, default=5)
    pfly.add_argument("--arena-nodes", type=int, default=2_000_000)
    pfly.add_argument("--arena-leaves", type=int, default=4_000_000)
    pfly.add_argument("--save-frames", action="store_true")
    pfly.add_argument("--out-dir", default="rtt_fly")
    pfly.add_argument("--path", choices=["tile", "brick"], default="tile",
                      help="tile = stitched pyramids through the "
                      "production tile walk (default); brick = the "
                      "per-ray two-phase stitched loop (A/B)")
    pfly.add_argument("--hold-frames", type=int, default=4,
                      help="extra frames at the final pose: the camera "
                      "rests, so jittered samples accumulate "
                      "(RaytracingMaster _Sample semantics)")
    pfly.set_defaults(fn=cmd_fly)

    pi = sub.add_parser("info", help="print SVO statistics")
    pi.add_argument("--load", default="",
                    help="inspect a saved SVO checkpoint (.npz)")
    pi.add_argument("--scene", default="terrain")
    pi.add_argument("--depth", type=int, default=8)
    pi.set_defaults(fn=cmd_info)

    pd = sub.add_parser("debug",
                        help="node-box overlay + ray probe (SVODriver)")
    pd.add_argument("--scene", default="sphere")
    pd.add_argument("--depth", type=int, default=5)
    pd.add_argument("--level", type=int, default=3)
    pd.add_argument("--ray", type=float, nargs=6, default=None,
                    metavar=("OX", "OY", "OZ", "DX", "DY", "DZ"))
    pd.add_argument("--max-hits", type=int, default=32)
    pd.add_argument("--max-boxes", type=int, default=4096)
    pd.add_argument("--width", type=int, default=512)
    pd.add_argument("--height", type=int, default=512)
    pd.add_argument("--fov", type=float, default=50.0)
    pd.add_argument("--camera-position", type=float, nargs=3,
                    default=[0.5, 0.85, -0.6])
    pd.add_argument("--look-at", type=float, nargs=3, default=[0.5, 0.4, 0.5])
    pd.add_argument("--out", default="")
    pd.set_defaults(fn=cmd_debug)

    pp = sub.add_parser("probe", help="interactive probe session "
                        "(SVODriver draggable-ray + OctreeDebugger live "
                        "insert/delete, headless)")
    pp.add_argument("--scene", default="sphere")
    pp.add_argument("--depth", type=int, default=5)
    pp.add_argument("--level", type=int, default=3)
    pp.add_argument("--max-hits", type=int, default=32)
    pp.add_argument("--max-boxes", type=int, default=4096)
    pp.add_argument("--width", type=int, default=512)
    pp.add_argument("--height", type=int, default=512)
    pp.add_argument("--fov", type=float, default=50.0)
    pp.add_argument("--camera-position", type=float, nargs=3,
                    default=[0.5, 0.85, -0.6])
    pp.add_argument("--look-at", type=float, nargs=3,
                    default=[0.5, 0.4, 0.5])
    pp.add_argument("--out", default="")
    pp.add_argument("--commands", default="",
                    help="';'-separated commands (scripted mode); "
                    "omit to read stdin interactively")
    pp.set_defaults(fn=cmd_probe)

    args = p.parse_args(argv)
    setup_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    main()
