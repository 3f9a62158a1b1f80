"""Multi-chip rendering + inverse-rendering training via shard_map.

The multi-device replacement for the reference's single-GPU dispatch
(RaytracingMaster.cs:66-68): rays are sharded over the device mesh's "rays"
axis (the analog of data/sequence parallelism for this workload, SURVEY.md
§2.8), the packed octree and voxel parameters are replicated, and voxel-
parameter gradients are reduced with an explicit psum over the mesh, which
XLA hands to NCCL on GPUs.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
import optax
from jax import shard_map
from jax.sharding import PartitionSpec as P

from raytracingtest_tpu import diff
from raytracingtest_tpu.ops import traverse
from raytracingtest_tpu.parallel.mesh import RAY_AXIS


def _pvary_tree(tree, axis):
    """Mark every leaf of a replicated pytree as VARYING over `axis`.

    The diff.gather_voxel_params custom VJP routes ray-varying cotangents
    back to the voxel-parameter rows, so inside a vma-checked shard_map its
    backward outputs are varying over the rays axis. Differentiating w.r.t.
    the replicated (unvarying) params then fails JAX's custom-VJP bwd type
    check ("varying manual axes do not match" — the recorded
    MULTICHIP_r04.json regression; the check is skipped when
    jax_disable_bwd_checks is on, which is why the failure was
    environment-sensitive). Casting the params to varying BEFORE
    value_and_grad makes the program vma-correct by construction: grads come
    back varying (per-device partials) and the explicit psum below reduces
    them, exactly as before."""
    cast = lambda x: jax.lax.pcast(x, axis, to="varying")
    return jax.tree_util.tree_map(cast, tree)


def render_sharded(mesh, albedo, normal, density,
                   masks, child_base, leaf_base, o, d, depth,
                   light_dir):
    """Forward render with rays sharded across the mesh. (N,3) radiance.

    N must be divisible by the mesh size (pad rays to a multiple upstream).
    """

    @partial(
        shard_map, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(), P(), P(RAY_AXIS), P(RAY_AXIS), P()),
        out_specs=P(RAY_AXIS),
        # the traversal carry mixes ray-varying state with constant-initialized
        # registers (parent=0, stack=0), which trips the varying-manual-axes
        # checker even though the program is correct
        check_vma=True,
    )
    def _render(albedo, normal, density, masks, child_base, leaf_base,
                o_s, d_s, light_dir):
        return diff.render_diff(albedo, normal, density, masks, child_base,
                                leaf_base, o_s, d_s, depth, light_dir)

    return jax.jit(_render)(albedo, normal, density, masks, child_base,
                            leaf_base, o, d, light_dir)


def make_train_step(mesh, depth, optimizer):
    """Build a jitted sharded train step for the inverse-rendering fit.

    Loss: mean squared error between rendered radiance and target pixels,
    rays sharded over the mesh; voxel-parameter grads psum'ed across shards
    inside the shard_map (overlappable with remaining backward work by XLA).
    """

    def local_loss(params, masks, child_base, leaf_base, o_s, d_s,
                   light_dir, target_s, n_total):
        img = diff.render_diff(
            params["albedo"], params["normal"], params["density"],
            masks, child_base, leaf_base, o_s, d_s, depth, light_dir)
        # sum (not mean) so psum over shards + /n_total == global mean
        return jnp.sum((img - target_s) ** 2) / n_total

    @partial(
        shard_map, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(RAY_AXIS), P(RAY_AXIS), P(),
                  P(RAY_AXIS)),
        out_specs=(P(), P()),
        check_vma=True,
    )
    def _loss_grads(params, masks, child_base, leaf_base, o_s, d_s,
                    light_dir, target_s):
        n_total = target_s.size * jax.lax.psum(1, RAY_AXIS)
        # differentiate w.r.t. ray-VARYING params (see _pvary_tree)
        loss, grads = jax.value_and_grad(local_loss)(
            _pvary_tree(params, RAY_AXIS), masks, child_base, leaf_base,
            o_s, d_s, light_dir, target_s, n_total)
        # gradient all-reduce over the ray mesh (ICI collective)
        grads = jax.tree_util.tree_map(
            lambda g: jax.lax.psum(g, RAY_AXIS), grads)
        loss = jax.lax.psum(loss, RAY_AXIS)
        return loss, grads

    @jax.jit
    def train_step(params, opt_state, masks, child_base, leaf_base,
                   o, d, light_dir, target):
        loss, grads = _loss_grads(params, masks, child_base, leaf_base,
                                  o, d, light_dir, target)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return train_step


def make_train_step_brick(mesh, depth, top_depth, optimizer):
    """Brick-backed sharded train step: the config-4 fit on the production
    traversal (diff.render_diff_brick) instead of the plain ESVO loop —
    VERDICT r02 item 4. Same psum gradient all-reduce; same loss semantics
    (hits are bit-identical between the paths, so losses/grads match the
    plain step exactly — tested)."""

    def local_loss(params, top_masks, top_child, top_parent, bricks, o_s,
                   d_s, light_dir, target_s, n_total):
        img = diff.render_diff_brick(
            params["albedo"], params["normal"], params["density"],
            top_masks, top_child, top_parent, bricks, o_s, d_s, depth,
            top_depth, light_dir)
        return jnp.sum((img - target_s) ** 2) / n_total

    @partial(
        shard_map, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(), P(RAY_AXIS), P(RAY_AXIS), P(),
                  P(RAY_AXIS)),
        out_specs=(P(), P()),
        check_vma=True,
    )
    def _loss_grads(params, top_masks, top_child, top_parent, bricks, o_s,
                    d_s, light_dir, target_s):
        n_total = target_s.size * jax.lax.psum(1, RAY_AXIS)
        # differentiate w.r.t. ray-VARYING params (see _pvary_tree)
        loss, grads = jax.value_and_grad(local_loss)(
            _pvary_tree(params, RAY_AXIS), top_masks, top_child, top_parent,
            bricks, o_s, d_s, light_dir, target_s, n_total)
        grads = jax.tree_util.tree_map(
            lambda g: jax.lax.psum(g, RAY_AXIS), grads)
        loss = jax.lax.psum(loss, RAY_AXIS)
        return loss, grads

    @jax.jit
    def train_step(params, opt_state, top_masks, top_child, top_parent,
                   bricks, o, d, light_dir, target):
        loss, grads = _loss_grads(params, top_masks, top_child, top_parent,
                                  bricks, o, d, light_dir, target)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return train_step


def render_tile_sharded(mesh, albedo, normal, density, tsvo, o, d, corners,
                        light_dir, k_max=96, chunk_tiles=256,
                        fb_tiles=128, fb_k=256, fb2_tiles=0):
    """Forward render on the PRODUCTION tile path with tiles sharded over
    the mesh (the data/sequence-parallel axis of this workload at tile
    granularity — each device walks its own tiles' frustums; no cross-
    device communication in the forward pass). Returns ((T*P, 3) radiance,
    per-device residual counts)."""
    from raytracingtest_tpu import diff as diff_mod

    @partial(
        shard_map, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(RAY_AXIS), P(RAY_AXIS),
                  P(RAY_AXIS), P()),
        out_specs=(P(RAY_AXIS), P(RAY_AXIS)),
        check_vma=True,
    )
    def _render(albedo, normal, density, tsvo, o_s, d_s, corners_s,
                light_dir):
        img, residual = diff_mod.render_diff_tile(
            albedo, normal, density, tsvo, o_s, d_s, corners_s, light_dir,
            k_max=k_max, chunk_tiles=chunk_tiles, fb_tiles=fb_tiles,
            fb_k=fb_k, fb2_tiles=fb2_tiles)
        return img, residual.reshape(1)

    return jax.jit(_render)(albedo, normal, density, tsvo, o, d, corners,
                            light_dir)


def make_train_step_tile(mesh, optimizer, k_max=96, chunk_tiles=256,
                         fb_tiles=128, fb_k=256, fb2_tiles=0,
                         retrace_chunk=4096, overlap_groups=1):
    """Sharded train step on the tile hot path: tiles sharded over the
    mesh, voxel-parameter grads psum'ed. Hits equal the brick path's, so
    the optimization trajectory coincides with the brick/plain steps
    (tested). Rays must be tile-major (tile.tile_rays).

    Rays the tile walks leave cap-limited (grazing depth-10 views leave
    hundreds to thousands after the enlarged-K re-walk) are re-traced
    exactly on the per-ray brick path inside the step, `retrace_chunk` rays
    per pass (tile.retrace_residual). The step returns (params, opt_state,
    loss, residual): residual is the psum'ed count of rays whose loss/grad
    contributions still use inexact hits, 0 unless retrace_chunk is 0.
    Training drivers must check it (no silent ray loss in training).

    overlap_groups > 1 chunks the backward over tile groups and launches
    each group's gradient psum as soon as that group's backward finishes:
    group i's all-reduce has no data dependency on group i+1's compute, so
    the XLA scheduler can run the collective under the remaining backward
    work (config 5's overlapped gradient all-reduce; unmeasured on the
    H100, ROADMAP.md Speed 9). Group losses/grads sum
    to exactly the ungrouped values (disjoint ray partition)."""
    from raytracingtest_tpu import diff as diff_mod

    def local_loss(params, tsvo, o_s, d_s, corners_s, light_dir, target_s,
                   n_total):
        img, residual = diff_mod.render_diff_tile(
            params["albedo"], params["normal"], params["density"], tsvo,
            o_s, d_s, corners_s, light_dir, k_max=k_max,
            chunk_tiles=chunk_tiles, fb_tiles=fb_tiles, fb_k=fb_k,
            fb2_tiles=fb2_tiles, retrace_chunk=retrace_chunk)
        return jnp.sum((img - target_s) ** 2) / n_total, residual

    @partial(
        shard_map, mesh=mesh,
        in_specs=(P(), P(), P(RAY_AXIS), P(RAY_AXIS), P(RAY_AXIS), P(),
                  P(RAY_AXIS)),
        out_specs=(P(), P(), P()),
        check_vma=True,
    )
    def _loss_grads(params, tsvo, o_s, d_s, corners_s, light_dir, target_s):
        n_total = target_s.size * jax.lax.psum(1, RAY_AXIS)
        # differentiate w.r.t. ray-VARYING params (see _pvary_tree)
        params = _pvary_tree(params, RAY_AXIS)
        T = o_s.shape[0]
        groups = overlap_groups if overlap_groups > 1 and             T % overlap_groups == 0 else 1
        gsz = T // groups
        ppx = target_s.shape[0] // T                 # rays per tile
        vg = jax.value_and_grad(local_loss, has_aux=True)
        loss = residual = None
        grads = None
        for i in range(groups):
            ts = slice(i * gsz, (i + 1) * gsz)
            rs = slice(i * gsz * ppx, (i + 1) * gsz * ppx)
            (li, ri), gi = vg(params, tsvo, o_s[ts], d_s[ts],
                              corners_s[ts], light_dir, target_s[rs],
                              n_total)
            # per-group all-reduce: launched while later groups' backward
            # still computes (no data dependency)
            gi = jax.tree_util.tree_map(
                lambda g: jax.lax.psum(g, RAY_AXIS), gi)
            if grads is None:
                loss, residual, grads = li, ri, gi
            else:
                loss = loss + li
                residual = residual + ri
                grads = jax.tree_util.tree_map(jnp.add, grads, gi)
        loss = jax.lax.psum(loss, RAY_AXIS)
        residual = jax.lax.psum(residual, RAY_AXIS)
        return loss, grads, residual

    @jax.jit
    def train_step(params, opt_state, tsvo, o, d, corners, light_dir,
                   target):
        loss, grads, residual = _loss_grads(params, tsvo, o, d, corners,
                                            light_dir, target)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss, residual

    return train_step
