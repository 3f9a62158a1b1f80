"""Differentiable rendering: pixel gradients -> per-voxel parameters.

New capability mandated by the north star (BASELINE.json) with no reference
counterpart (the reference renderer is forward-only): the traversal output
(hit leaf index, t) is treated as non-differentiable discrete structure, and
shading is a differentiable function of per-voxel parameters (albedo,
normal, density as float arrays — the compressed attachment codec in
ops/codecs.py is kept for parity/IO only; the gradient path uses fp params).

The backward pass routes millions of per-pixel cotangents to few voxel rows
inside a custom VJP (the segment-sum scatter of SURVEY.md §7.3.6): sort by
leaf id + running column sums + one boundary gather at production row counts
(_segment_reduce_cols, deterministic up to its one count histogram), or
seven rank-1 scatter-adds below SEG_MIN_ROWS. On the GPU a scatter-add lowers
to atomics, whose order of summation changes from run to run, so the rank-1
result matches builtin autodiff only to f32 reassociation there (on the CPU
the adds are serialized and it matches bit for bit).
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from raytracingtest_tpu.ops import traverse
from raytracingtest_tpu.render import sky_color


# ---------------------------------------------------------------------------
# gather with deterministic segment-sum backward
# ---------------------------------------------------------------------------

@jax.custom_vjp
def gather_voxel_params(albedo, normal, density, leaf_id):
    """Gather per-voxel parameter rows for each ray's hit leaf.

    leaf_id must be pre-clamped to [0, n_leaves); masking of misses happens
    in the shading function (their cotangents are zero, so the backward
    scatter is unaffected).

    The three parameter arrays are packed into one (n_leaves, 7) row so the
    forward pass is ONE row gather instead of three (the pack itself is a
    cheap streaming concat). The choice was made for the gather cost of the
    original target and is unmeasured on the H100 (ROADMAP.md, Design 3).
    """
    packed = jnp.concatenate(
        [albedo, normal, density[:, None]], axis=1)
    rows = jnp.take(packed, leaf_id, axis=0)
    return rows[:, 0:3], rows[:, 3:6], rows[:, 6]


def _gather_fwd(albedo, normal, density, leaf_id):
    out = gather_voxel_params(albedo, normal, density, leaf_id)
    return out, (leaf_id, albedo.shape[0])


import os as _os

# backward scatter scheme: "seg" (sort + cumsum + boundary gather, the
# default) or "rank1" (seven rank-1 scatter-adds). Which is faster on the
# H100, where scatter-adds are atomics, is unmeasured (ROADMAP.md, Design 3).
SCATTER_MODE = _os.environ.get("RTT_SCATTER", "seg")
# below this row count the rank-1 path runs regardless: row counts this small
# are scatter-cheap, and on the CPU it adds in builtin autodiff's order.
# Overridable (RTT_SEG_MIN_ROWS) so reproducibility comparisons across
# resolutions can pin one scheme (the two differ by f32 reassociation, ~1e-4).
SEG_MIN_ROWS = int(_os.environ.get("RTT_SEG_MIN_ROWS", 1 << 16))


def _segment_reduce_cols(leaf_id, cols, n_out):
    """Key-grouped column reduction without a row scatter.

    sort rows by leaf id -> running f32 column sums -> per-leaf boundaries
    from a count histogram -> ONE (n_out+1)-row gather of the running sums
    -> adjacent difference. It replaced seven rank-1 scatter-adds because
    scatters were slow on the original target; on the H100 the two are
    unmeasured (ROADMAP.md, Design 3). Deterministic (stable sort, fixed reduction
    tree; the histogram counts integers, so atomics cannot change it).
    Differs from a serialized scatter only by f32 reassociation in the
    cumsum: max abs deviation ~1e-4 on 1M uniform(-.5,.5) rows whose
    running sums random-walk to ~2.5 — far inside training noise, and the
    rank-1 path still runs below SEG_MIN_ROWS (so the tight
    oracle-equality gradcheck in tests/test_grad.py exercises it)."""
    n, C = cols.shape
    order = jnp.argsort(leaf_id)
    rows = jnp.take(cols, order, axis=0)
    S = jnp.cumsum(rows, axis=0)
    S = jnp.concatenate([jnp.zeros((1, C), cols.dtype), S], axis=0)
    # per-leaf start offsets via a scalar scatter-add histogram (the
    # alternative, searchsorted over one merged sort, was slower on the
    # original target; unmeasured on the H100)
    cnt = jnp.zeros(n_out, jnp.int32).at[leaf_id].add(1)
    start = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(cnt).astype(jnp.int32)])
    G = jnp.take(S, start, axis=0)
    return G[1:] - G[:-1]


def _gather_bwd(res, cot):
    leaf_id, n_leaves = res
    g_alb, g_nrm, g_den = cot
    if SCATTER_MODE == "seg" and leaf_id.shape[0] >= SEG_MIN_ROWS:
        cols7 = jnp.concatenate([g_alb, g_nrm, g_den[:, None]], axis=1)
        out = _segment_reduce_cols(leaf_id, cols7, n_leaves)
        return out[:, 0:3], out[:, 3:6], out[:, 6], None
    # seven RANK-1 scatter-adds (one per column; on the original target a
    # scalar scatter was far cheaper per element than a (N,7)-row one). On
    # the GPU they lower to atomics: the sums are reassociated in an order
    # that changes from run to run
    cols = (g_alb[:, 0], g_alb[:, 1], g_alb[:, 2],
            g_nrm[:, 0], g_nrm[:, 1], g_nrm[:, 2], g_den)
    outs = [jnp.zeros((n_leaves,), jnp.float32).at[leaf_id].add(c)
            for c in cols]
    d_alb = jnp.stack(outs[0:3], axis=1)
    d_nrm = jnp.stack(outs[3:6], axis=1)
    return d_alb, d_nrm, outs[6], None


gather_voxel_params.defvjp(_gather_fwd, _gather_bwd)


# ---------------------------------------------------------------------------
# differentiable shading + rendering
# ---------------------------------------------------------------------------

def shade_diff(hit_leaf, direction, albedo, normal, density,
               light_dir, light_intensity, light_ambient, skybox=None):
    """Differentiable Lambert shading of traced rays. (N,3) radiance.

    Misses shade to the sky — the procedural gradient, or an equirect
    environment texture when `skybox` is given (the reference's HDR
    cubemap sample on miss, RaytraceCompute.compute:117-126); either way
    the miss gradient contribution to voxel params is exactly zero.
    Density scales hit opacity (alpha-composited against the sky), giving
    density a gradient path even in the single-hit renderer.
    """
    from raytracingtest_tpu.render import sky_texture
    if skybox is not None:
        sky = sky_texture(direction, jax.lax.stop_gradient(skybox), jnp)
    else:
        sky = sky_color(direction, jnp)
    if albedo.shape[0] == 0:
        # empty scene: every ray misses; sky only (no empty-axis gather)
        return sky
    hit = hit_leaf >= 0
    safe_leaf = jnp.where(hit, hit_leaf, 0)
    alb, nrm, den = gather_voxel_params(albedo, normal, density, safe_leaf)
    ldir = light_dir / jnp.sqrt(jnp.sum(light_dir * light_dir))
    # normalize stored normals through the graph so normal grads stay tangent
    nn = nrm / jnp.sqrt(jnp.maximum(jnp.sum(nrm * nrm, -1, keepdims=True), 1e-12))
    ndotl = jnp.maximum(jnp.sum(nn * (-ldir)[None, :], axis=-1), 0.0)
    lit = alb * (ndotl * light_intensity + light_ambient)[:, None]
    alpha = jnp.clip(den, 0.0, 1.0)[:, None] * hit[:, None]
    return alpha * lit + (1.0 - alpha) * sky


@partial(jax.jit, static_argnames=("depth",))
def render_diff(albedo, normal, density, masks, child_base, leaf_base,
                o, d, depth, light_dir,
                light_intensity=1.3, light_ambient=0.08, parent_ptr=None):
    """Differentiable render of a flat ray batch. Returns (N, 3) radiance.

    Traversal runs under stop_gradient (discrete structure); shading is
    differentiable in (albedo, normal, density). parent_ptr (optional) skips
    the in-jit derivation — pass svo.parent_ptr on hot paths.
    """
    if parent_ptr is None:
        parent_ptr = traverse.derive_parent_ptr_jnp(masks, child_base)
    res = traverse._trace_jax(masks, child_base, leaf_base, parent_ptr, o, d,
                              depth)
    hit_leaf = jax.lax.stop_gradient(res.hit_leaf)
    return shade_diff(hit_leaf, d, albedo, normal, density,
                      light_dir, light_intensity, light_ambient)


def l2_loss(albedo, normal, density, masks, child_base, leaf_base,
            o, d, depth, light_dir, target, parent_ptr=None):
    img = render_diff(albedo, normal, density, masks, child_base, leaf_base,
                      o, d, depth, light_dir, parent_ptr=parent_ptr)
    return jnp.mean((img - target) ** 2)


loss_and_grads = jax.jit(
    jax.value_and_grad(l2_loss, argnums=(0, 1, 2)),
    static_argnames=("depth",),
)


# ---------------------------------------------------------------------------
# volumetric (multi-hit) rendering: density gradients along the ray
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("depth", "k"))
def render_volumetric(albedo, normal, density, masks, child_base, leaf_base,
                      o, d, depth, light_dir, k=4,
                      light_intensity=1.3, light_ambient=0.08,
                      density_scale=64.0, parent_ptr=None):
    """Differentiable emission-absorption rendering over the first k leaf
    segments of each ray (Plenoxels-style alpha compositing; the
    extension beyond the reference's hard-surface model required by the
    north star's albedo/density wording, SURVEY.md §7.3.5).

    Per segment i: alpha_i = 1 - exp(-softplus(density) * len_i * scale);
    radiance = sum_i T_i alpha_i c_i + T_final * sky, with c_i the
    Lambert-shaded voxel color. Gradients flow to albedo, normal and density
    through the same sorted segment-sum VJP."""
    if parent_ptr is None:
        parent_ptr = traverse.derive_parent_ptr_jnp(masks, child_base)
    res = traverse._trace_multi_jax(masks, child_base, leaf_base, parent_ptr,
                                    o, d, depth, k)
    hit_leaf = jax.lax.stop_gradient(res.hit_leaf)      # (N, k)
    t_in = jax.lax.stop_gradient(res.t_in)
    t_out = jax.lax.stop_gradient(res.t_out)
    return _composite_segments(albedo, normal, density, hit_leaf, t_in,
                               t_out, o, d, light_dir, k, light_intensity,
                               light_ambient, density_scale)


def volumetric_l2_loss(albedo, normal, density, masks, child_base, leaf_base,
                       o, d, depth, light_dir, target, k=4, parent_ptr=None):
    img = render_volumetric(albedo, normal, density, masks, child_base,
                            leaf_base, o, d, depth, light_dir, k=k,
                            parent_ptr=parent_ptr)
    return jnp.mean((img - target) ** 2)


# ---------------------------------------------------------------------------
# brick-accelerated hot path (ops/brick.py): same differentiable shading,
# traversal via the gather-light brick traversal. Used by bench.py and the
# production fit/render drivers for depth >= 4 SVOs.
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("depth", "top_depth"))
def render_diff_brick(albedo, normal, density, top_masks, top_child,
                      top_parent, bricks, o, d, depth, top_depth, light_dir,
                      light_intensity=1.3, light_ambient=0.08):
    """Differentiable render through the brick traversal (bit-identical hits
    to render_diff — tested). Returns (N, 3) radiance."""
    from raytracingtest_tpu.ops import brick as brick_mod
    res = brick_mod._trace_brick_jax(top_masks, top_child, top_parent,
                                     bricks, o, d, depth, top_depth)
    hit_leaf = jax.lax.stop_gradient(res.hit_leaf)
    return shade_diff(hit_leaf, d, albedo, normal, density,
                      light_dir, light_intensity, light_ambient)


def l2_loss_brick(albedo, normal, density, top_masks, top_child, top_parent,
                  bricks, o, d, depth, top_depth, light_dir, target):
    img = render_diff_brick(albedo, normal, density, top_masks, top_child,
                            top_parent, bricks, o, d, depth, top_depth,
                            light_dir)
    return jnp.mean((img - target) ** 2)


loss_and_grads_brick = jax.jit(
    jax.value_and_grad(l2_loss_brick, argnums=(0, 1, 2)),
    static_argnames=("depth", "top_depth"),
)


# ---------------------------------------------------------------------------
# tile-amortized hot path (ops/tile.py): the production forward traversal —
# frustum-shared structure walks + in-jit exact fallback. Rays must be
# tile-major (tile.tile_rays); same differentiable shading VJP.
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("k_max", "chunk_tiles", "fb_tiles",
                                   "fb_k", "fb2_tiles", "fb2_split",
                                   "retrace_chunk"))
def render_diff_tile(albedo, normal, density, tsvo, o, d, corners,
                     light_dir, light_intensity=1.3, light_ambient=0.08,
                     k_max=64, chunk_tiles=256, fb_tiles=128, fb_k=256,
                     fb2_tiles=0, fb2_split=2, retrace_chunk=0, skybox=None):
    """Differentiable render via the tile traversal. o/d: (T, P, 3)
    tile-major; returns ((T*P, 3) radiance, residual-unresolved count).
    retrace_chunk > 0 re-traces every ray the tile walks left cap-limited
    on the per-ray brick path in the same program, that many rays per pass
    (tile.retrace_residual), so the residual is 0.
    skybox: optional (H, W, 3) equirect environment texture sampled on miss.

    Hits equal render_diff's on the CPU tests; on the H100 at depth 10 /
    1024² they equal the brick path's on every ray and differ from the
    plain path's on 8 of 1,048,576 rays (voxel-corner ties; chip_smoke.py
    phase 3). When the fallback walks chunk (budgets past ~65536 lanes,
    _walk_tiles_scheduled), hit_t may differ by ~1 ULP."""
    from raytracingtest_tpu.ops import tile as tile_mod
    caps = tile_mod._default_caps(tsvo.top_depth, k_max)
    b = tsvo.bsvo
    res, residual = tile_mod._trace_tile_fb(
        tsvo.pyr, tsvo.cellmap, b.bricks, o, d, corners, o[0, 0],
        tsvo.depth, tsvo.top_depth,
        caps, k_max, chunk_tiles, fb_tiles, fb_k, fb2_tiles, fb2_split)
    hit_leaf = res.hit_leaf
    if retrace_chunk:
        hit_leaf, _t, residual = tile_mod.retrace_residual(
            b, o, d, hit_leaf, res.hit_t, residual, retrace_chunk)
    hit_leaf = jax.lax.stop_gradient(hit_leaf)
    img = shade_diff(hit_leaf, d.reshape(-1, 3), albedo, normal, density,
                     light_dir, light_intensity, light_ambient,
                     skybox=skybox)
    return img, jnp.sum(residual)


def l2_loss_tile(albedo, normal, density, tsvo, o, d, corners, light_dir,
                 target, k_max=64, chunk_tiles=256, fb_tiles=128, fb_k=256,
                 fb2_tiles=0, fb2_split=2):
    """Tile-path training loss. Returns (loss, residual count): residual is
    the number of rays whose hits are still cap-limited after the enlarged-K
    re-walk (loss/grads over them use inexact hits) — callers must surface
    it instead of silently training on wrong pixels."""
    img, residual = render_diff_tile(
        albedo, normal, density, tsvo, o, d, corners, light_dir,
        k_max=k_max, chunk_tiles=chunk_tiles, fb_tiles=fb_tiles, fb_k=fb_k,
        fb2_tiles=fb2_tiles, fb2_split=fb2_split)
    return jnp.mean((img - target) ** 2), residual


loss_and_grads_tile = jax.jit(
    jax.value_and_grad(l2_loss_tile, argnums=(0, 1, 2), has_aux=True),
    static_argnames=("k_max", "chunk_tiles", "fb_tiles", "fb_k",
                     "fb2_tiles", "fb2_split"),
)


@partial(jax.jit, static_argnames=("depth", "top_depth", "k"))
def render_volumetric_brick(albedo, normal, density, top_masks, top_child,
                            top_parent, bricks, o, d, depth, top_depth,
                            light_dir, k=4, light_intensity=1.3,
                            light_ambient=0.08, density_scale=64.0):
    """render_volumetric through the brick all-hits traversal (identical
    segments — tested)."""
    from raytracingtest_tpu.ops import brick as brick_mod
    res = brick_mod._trace_brick_multi_jax(top_masks, top_child, top_parent,
                                           bricks, o, d, depth, top_depth, k)
    hit_leaf = jax.lax.stop_gradient(res.hit_leaf)
    t_in = jax.lax.stop_gradient(res.t_in)
    t_out = jax.lax.stop_gradient(res.t_out)
    return _composite_segments(albedo, normal, density, hit_leaf, t_in,
                               t_out, o, d, light_dir, k, light_intensity,
                               light_ambient, density_scale)


def _composite_segments(albedo, normal, density, hit_leaf, t_in, t_out, o, d,
                        light_dir, k, light_intensity, light_ambient,
                        density_scale):
    n = o.shape[0]
    valid = hit_leaf >= 0
    safe = jnp.where(valid, hit_leaf, 0).reshape(-1)
    alb, nrm, den = gather_voxel_params(albedo, normal, density, safe)
    alb = alb.reshape(n, k, 3)
    nrm = nrm.reshape(n, k, 3)
    den = den.reshape(n, k)

    ldir = light_dir / jnp.sqrt(jnp.sum(light_dir * light_dir))
    nn = nrm / jnp.sqrt(jnp.maximum(jnp.sum(nrm * nrm, -1, keepdims=True),
                                    1e-12))
    ndotl = jnp.maximum(jnp.sum(nn * (-ldir)[None, None, :], axis=-1), 0.0)
    color = alb * (ndotl * light_intensity + light_ambient)[..., None]

    seg_len = jnp.maximum(t_out - t_in, 0.0)
    sigma = jax.nn.softplus(den) * density_scale
    alpha = (1.0 - jnp.exp(-sigma * seg_len)) * valid
    trans = jnp.cumprod(1.0 - alpha + 1e-9, axis=1)
    t_before = jnp.concatenate(
        [jnp.ones((n, 1), jnp.float32), trans[:, :-1]], axis=1)
    weights = t_before * alpha
    sky = sky_color(d, jnp)
    t_final = t_before[:, -1] * (1.0 - alpha[:, -1])
    return jnp.sum(weights[..., None] * color, axis=1) + t_final[:, None] * sky
