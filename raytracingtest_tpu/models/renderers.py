"""Model-level API: the framework's "model families".

Three renderer models over the same packed SVO representation:

  * SurfaceRenderer    — hard-surface Lambert megakernel path
                         (the reference's RaytraceCompute pipeline)
  * VolumetricRenderer — k-segment emission-absorption path with density
                         (north-star extension; Plenoxels-style)
  * InverseRenderer    — the trainable model: voxel parameter pytree +
                         optax optimizer + sharded train step
                         (BASELINE config 4 fit)

Each wraps the functional ops (ops/, diff.py, parallel/) behind a compact
object API for drivers; everything stateful is an explicit pytree.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp
import optax

from raytracingtest_tpu import diff
from raytracingtest_tpu.config import CameraConfig, RenderConfig
from raytracingtest_tpu.ops.camera import Camera, OctreeFrame
from raytracingtest_tpu.ops.octree import SVO
from raytracingtest_tpu.parallel.mesh import make_mesh, ray_sharding
from raytracingtest_tpu.parallel.render_sharded import (
    make_train_step, make_train_step_brick)


def _camera(cfg: CameraConfig) -> Camera:
    return Camera(position=cfg.position, look_at=cfg.look_at, up=cfg.up,
                  fov_y_deg=cfg.fov_y_deg, ortho_height=cfg.ortho_height,
                  width=cfg.width, height=cfg.height)


def _accel_of(obj):
    """Lazy cached acceleration structures for a model's SVO: (device
    BrickSVO, device TileSVO). Either can be None: bricks need depth >=
    BRICK_LEVELS+1 (shallow trees use the plain path), the tile pyramid
    additionally needs top_depth <= 10 (deeper trees fall back to the
    per-ray brick path). The cache pins the SVO OBJECT itself (identity
    compare with `is`) so reassigning `renderer.svo` always invalidates it —
    an id()-keyed cache could silently serve a stale structure after CPython
    reuses a freed object's id. The host brick decomposition is built once
    and its device arrays shared by both structures."""
    from raytracingtest_tpu.ops import brick as brick_mod
    from raytracingtest_tpu.ops import tile as tile_mod
    cache = getattr(obj, "_accel_cache", None)
    if cache is None or cache[0] is not obj.svo:
        bsvo_dev = tsvo_dev = None
        if obj.svo.depth >= brick_mod.BRICK_LEVELS + 1:
            bsvo_host = brick_mod.make_brick_svo(obj.svo)
            bsvo_dev = bsvo_host.device()
            if bsvo_host.top_depth <= 10:
                tsvo_host = tile_mod.make_tile_svo(obj.svo, bsvo=bsvo_host)
                # share the already-uploaded brick arrays instead of
                # re-uploading a second device copy inside TileSVO
                tsvo_dev = tile_mod.TileSVO(
                    bsvo=bsvo_dev, pyr=jnp.asarray(tsvo_host.pyr),
                    cellmap=jnp.asarray(tsvo_host.cellmap))
        cache = (obj.svo, bsvo_dev, tsvo_dev)
        object.__setattr__(obj, "_accel_cache", cache)
    return cache[1], cache[2]


def _brick_of(obj):
    return _accel_of(obj)[0]


def _tile_of(obj):
    return _accel_of(obj)[1]


@dataclasses.dataclass
class SurfaceRenderer:
    svo: SVO

    def render(self, camera_cfg: CameraConfig, render_cfg: RenderConfig,
               jitter=None, skybox=None) -> np.ndarray:
        cam = _camera(camera_cfg)
        # pinhole cameras with tile-aligned resolutions ride the tile-
        # amortized hot path (exact: in-jit fallback + host-side residual
        # retrace); everything else falls back to the per-ray brick path.
        # skybox: optional (H, W, 3) equirect environment texture sampled
        # on miss (io/hdr.py loads the reference's .hdr assets)
        if (cam.ortho_height <= 0.0 and camera_cfg.width % 16 == 0
                and camera_cfg.height % 16 == 0):
            tsvo = _tile_of(self)
            if tsvo is not None:
                from raytracingtest_tpu.ops import tile as tile_mod
                o_t, d_t, corners, grid = tile_mod.tile_rays(
                    cam, np, jitter=jitter)
                light = jnp.asarray(render_cfg.light_direction, jnp.float32)
                res = tile_mod.trace_tile_exact(
                    tsvo, jnp.asarray(o_t), jnp.asarray(d_t),
                    jnp.asarray(corners))
                img = diff.shade_diff(
                    jax.lax.stop_gradient(res.hit_leaf),
                    jnp.asarray(d_t.reshape(-1, 3)),
                    jnp.asarray(self.svo.leaf_albedo),
                    jnp.asarray(self.svo.leaf_normal),
                    jnp.asarray(self.svo.leaf_density), light,
                    render_cfg.light_intensity, render_cfg.light_ambient,
                    skybox=None if skybox is None
                    else jnp.asarray(skybox, jnp.float32))
                img = tile_mod.untile_image(np.asarray(img), grid)
                return img.reshape(camera_cfg.height, camera_cfg.width, 3)
        if skybox is not None:
            # non-tile cameras: the plain jitted path supports env maps
            from raytracingtest_tpu.render import Light, render_jax
            return np.asarray(render_jax(
                self.svo, cam,
                light=Light(direction=render_cfg.light_direction,
                            intensity=render_cfg.light_intensity,
                            ambient=render_cfg.light_ambient),
                jitter=jitter, skybox=skybox))
        o, d = cam.rays(np, jitter=jitter)
        light = jnp.asarray(render_cfg.light_direction, jnp.float32)
        bsvo = _brick_of(self)
        if bsvo is not None:
            img = diff.render_diff_brick(
                jnp.asarray(self.svo.leaf_albedo),
                jnp.asarray(self.svo.leaf_normal),
                jnp.asarray(self.svo.leaf_density),
                bsvo.top_masks, bsvo.top_child, bsvo.top_parent, bsvo.bricks,
                jnp.asarray(o), jnp.asarray(d), self.svo.depth,
                bsvo.top_depth, light,
                render_cfg.light_intensity, render_cfg.light_ambient)
        else:
            img = diff.render_diff(
                jnp.asarray(self.svo.leaf_albedo),
                jnp.asarray(self.svo.leaf_normal),
                jnp.asarray(self.svo.leaf_density),
                self.svo.masks, self.svo.child_base, self.svo.leaf_base,
                jnp.asarray(o), jnp.asarray(d), self.svo.depth, light,
                render_cfg.light_intensity, render_cfg.light_ambient)
        return np.asarray(img).reshape(camera_cfg.height, camera_cfg.width, 3)

    def render_progressive(self, camera_cfg: CameraConfig,
                           render_cfg: RenderConfig, seed=0,
                           skybox=None) -> np.ndarray:
        rng = np.random.default_rng(seed)
        acc = None
        for s in range(max(render_cfg.samples, 1)):
            img = self.render(camera_cfg, render_cfg,
                              jitter=rng.random(2, dtype=np.float32),
                              skybox=skybox)
            acc = img if acc is None else acc + (img - acc) / (s + 1)
        return acc


@dataclasses.dataclass
class VolumetricRenderer:
    svo: SVO
    k: int = 4
    density_scale: float = 64.0

    def render(self, camera_cfg: CameraConfig, render_cfg: RenderConfig,
               jitter=None) -> np.ndarray:
        cam = _camera(camera_cfg)
        o, d = cam.rays(np, jitter=jitter)
        light = jnp.asarray(render_cfg.light_direction, jnp.float32)
        bsvo = _brick_of(self)
        if bsvo is not None:
            img = diff.render_volumetric_brick(
                jnp.asarray(self.svo.leaf_albedo),
                jnp.asarray(self.svo.leaf_normal),
                jnp.asarray(self.svo.leaf_density),
                bsvo.top_masks, bsvo.top_child, bsvo.top_parent, bsvo.bricks,
                jnp.asarray(o), jnp.asarray(d), self.svo.depth,
                bsvo.top_depth, light,
                k=self.k, light_intensity=render_cfg.light_intensity,
                light_ambient=render_cfg.light_ambient,
                density_scale=self.density_scale)
        else:
            img = diff.render_volumetric(
                jnp.asarray(self.svo.leaf_albedo),
                jnp.asarray(self.svo.leaf_normal),
                jnp.asarray(self.svo.leaf_density),
                self.svo.masks, self.svo.child_base, self.svo.leaf_base,
                jnp.asarray(o), jnp.asarray(d), self.svo.depth, light,
                k=self.k, light_intensity=render_cfg.light_intensity,
                light_ambient=render_cfg.light_ambient,
                density_scale=self.density_scale)
        return np.asarray(img).reshape(camera_cfg.height, camera_cfg.width, 3)


@dataclasses.dataclass
class InverseRenderer:
    """Trainable voxel-parameter model with a sharded train step."""

    svo: SVO
    optimize: tuple = ("albedo",)
    learning_rate: float = 5e-2
    n_devices: Optional[int] = None

    def __post_init__(self):
        self.mesh = make_mesh(self.n_devices)
        labels = {
            "albedo": "train" if "albedo" in self.optimize else "freeze",
            "normal": "train" if "normal" in self.optimize else "freeze",
            "density": "train" if "density" in self.optimize else "freeze",
        }
        self.optimizer = optax.multi_transform(
            {"train": optax.adam(self.learning_rate),
             "freeze": optax.set_to_zero()}, labels)
        # the fit runs on the production traversal hierarchy: tile step
        # (exact: cap-limited rays are re-traced per ray inside the step)
        # when the tree supports the pyramid, else brick, else the plain ESVO
        # loop — identical hits -> identical loss/grads (tested)
        self._bsvo, self._tsvo = _accel_of(self)
        self._step_tile = None
        if self._tsvo is not None:
            from raytracingtest_tpu.parallel.render_sharded import (
                make_train_step_tile)
            self._step_tile = make_train_step_tile(self.mesh, self.optimizer)
        if self._bsvo is not None:
            self._step = make_train_step_brick(
                self.mesh, self.svo.depth, self._bsvo.top_depth,
                self.optimizer)
        else:
            self._step = make_train_step(self.mesh, self.svo.depth,
                                         self.optimizer)

    def init_params(self, seed: int = 0, randomize=("albedo",)):
        rng = np.random.default_rng(seed)
        params = {
            "albedo": jnp.asarray(self.svo.leaf_albedo),
            "normal": jnp.asarray(self.svo.leaf_normal),
            "density": jnp.asarray(self.svo.leaf_density),
        }
        for name in randomize:
            params[name] = jnp.asarray(
                rng.random(params[name].shape, dtype=np.float32))
        return params, self.optimizer.init(params)

    def shard_rays(self, o, d, target=None):
        sh = ray_sharding(self.mesh)
        o = jax.device_put(jnp.asarray(o), sh)
        d = jax.device_put(jnp.asarray(d), sh)
        if target is None:
            return o, d
        return o, d, jax.device_put(jnp.asarray(target), sh)

    def step(self, params, opt_state, o, d, light, target):
        if self._bsvo is not None:
            b = self._bsvo
            return self._step(params, opt_state, b.top_masks, b.top_child,
                              b.top_parent, b.bricks, o, d, light, target)
        return self._step(params, opt_state, self.svo.masks,
                          self.svo.child_base, self.svo.leaf_base, o, d,
                          light, target)

    def step_view(self, params, opt_state, camera_cfg, light, target_img):
        """One train step against a posed target image: tile-amortized when
        the camera is pinhole with tile-aligned resolution and the tree
        supports the pyramid, else the brick/plain flat-ray step.
        target_img: (H*W, 3) row-major pixels.

        Returns (params, opt_state, loss, residual). residual > 0 would mean
        some rays' loss terms used cap-limited (inexact) hits; the tile
        step re-traces them exactly, so it is 0, and training drivers
        surface it (no silent ray loss in training; the forward path's
        guarantee, kept here)."""
        import jax.numpy as jnp
        from raytracingtest_tpu.ops import tile as tile_mod
        from raytracingtest_tpu.parallel.mesh import ray_sharding
        cam = _camera(camera_cfg)
        if (self._step_tile is not None and cam.ortho_height <= 0.0
                and camera_cfg.width % 16 == 0
                and camera_cfg.height % 16 == 0):
            o_t, d_t, corners, grid = tile_mod.tile_rays(cam, np)
            tgt = tile_mod.tile_pixels(np.asarray(target_img), grid)
            sh = ray_sharding(self.mesh)
            put = lambda x: jax.device_put(jnp.asarray(x), sh)
            return self._step_tile(params, opt_state, self._tsvo,
                                   put(o_t), put(d_t), put(corners), light,
                                   put(tgt.reshape(-1, 3)))
        o, d = cam.rays(np)
        o_s, d_s, t_s = self.shard_rays(o, d, target_img)
        params, opt_state, loss = self.step(params, opt_state, o_s, d_s,
                                            light, t_s)
        return params, opt_state, loss, jnp.zeros((), jnp.int32)
