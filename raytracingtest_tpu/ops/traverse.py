"""Vectorized ESVO traversal — lane-parallel PUSH/ADVANCE/POP over ray batches.

This re-designs the reference's per-thread traversal loop
(Assets/Shaders/NVIDIASVO.compute:57-156, Assets/Scripts/SVO/CompactSVO/
Trace.cu) as array code: every lane executes every iteration and
PUSH/ADVANCE/POP become masked `where` selects (SURVEY.md §7.3.1).
Per-ray traversal stacks are (depth, n_rays) arrays addressed with
vectorized gather/scatter instead of per-thread local memory
(NVIDIASVO.compute:13).

The step function is written once against a minimal backend shim and driven
two ways:
  * numpy  — python while loop over the active mask (CPU reference images)
  * jax    — lax.while_loop under jit (the XLA compute path)

Bit-level scheme identical to reference/traverse.py (same float-mantissa
scale recovery, mirroring, popcount child ranks).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp

S_MAX = 23


def popc8(v, xp):
    """8-bit popcount via bit tricks (reference uses a 256-entry LUT,
    NVIDIAIterativeTracer.cs:319-342, and HLSL countbits,
    NVIDIASVO.compute:104)."""
    v = v & 0xFF
    v = v - ((v >> 1) & 0x55)
    v = (v & 0x33) + ((v >> 2) & 0x33)
    return (v + (v >> 4)) & 0x0F


def _f2i(x, xp):
    if xp is np:
        return np.asarray(x, np.float32).view(np.int32)
    return jax.lax.bitcast_convert_type(x, jnp.int32)


def _i2f(x, xp):
    if xp is np:
        return np.asarray(x, np.int32).view(np.float32)
    return jax.lax.bitcast_convert_type(x, jnp.float32)


class TraceState(NamedTuple):
    # per-ray traversal registers; shapes (N,) or (N, 3)
    pos: object        # f32 (N,3) mirrored lower corner of current child voxel
    idx: object        # i32 (N,)  mirrored child index bits
    parent: object     # i32 (N,)  current node row
    scale: object      # i32 (N,)
    scale_exp2: object  # f32 (N,)
    t_min: object      # f32 (N,)
    t_max: object      # f32 (N,)
    h: object          # f32 (N,)  last pushed tc_max (stack-write filter)
    octant_mask: object  # i32 (N,)
    t_coef: object     # f32 (N,3)
    t_bias: object     # f32 (N,3)
    done: object       # bool (N,)
    hit_leaf: object   # i32 (N,)  leaf row or -1
    hit_t: object      # f32 (N,)
    hit_parent: object  # i32 (N,)
    hit_child: object  # i32 (N,)
    stack_node: object  # i32 (S, N)
    stack_tmax: object  # f32 (S, N)
    iters: object      # i32 (N,)


class TraceResult(NamedTuple):
    hit_leaf: object   # i32 (N,) leaf row, -1 on miss
    hit_t: object      # f32 (N,) entry t (octree-local units)
    hit_parent: object  # i32 (N,)
    hit_child: object  # i32 (N,) unmirrored child slot
    iters: object      # i32 (N,)
    # LOD early-exit only (trace with ray_size): interior node row whose
    # projected size fell below the ray footprint, -1 otherwise
    hit_node: object = None


def vconst(ref, fill=0, dtype=None, shape=None, xp=jnp):
    """Constant array inheriting ref's varying-manual-axes (vma) type.

    Inside shard_map, jnp.zeros/full/arange create UNVARYING constants; when
    such a constant initializes a while_loop carry that the loop body updates
    to a varying value, the vma checker rejects the program — the reason the
    parallel/ shard_maps used to opt out with check_vma=False. Deriving the
    constant from a varying operand (zeros_like) keeps carry types
    consistent, so checking can stay on. Works for numpy too (plain zeros)."""
    z = xp.zeros_like(ref, dtype=dtype)
    if shape is not None:
        z = xp.broadcast_to(z.ravel()[:1].reshape((1,) * len(shape)), shape)
    return z if fill == 0 else z + xp.asarray(fill, z.dtype)


def init_state(origin, direction, depth, xp, root=None):
    """Vectorized traversal init (mirroring + cube entry), octree-local coords
    in [0,1]^3 mapped to the [1,2]^3 traversal cube (NVIDIASVO.compute:15-38)."""
    f32, i32 = xp.float32, xp.int32
    o = xp.asarray(origin, f32) + f32(1.0)
    d = xp.asarray(direction, f32)
    n = o.shape[0]

    eps = f32(2.0 ** -S_MAX)
    d = xp.where(xp.abs(d) < eps, xp.where(d >= 0, eps, -eps), d)

    t_coef = f32(-1.0) / xp.abs(d)
    t_bias = t_coef * o

    pos_dir = d > 0.0
    bit = xp.asarray([1, 2, 4], i32)
    octant_mask = xp.int32(7) ^ xp.sum(
        xp.where(pos_dir, bit[None, :], xp.int32(0)), axis=1, dtype=i32
    )
    t_bias = xp.where(pos_dir, f32(3.0) * t_coef - t_bias, t_bias)

    t_min = xp.max(f32(2.0) * t_coef - t_bias, axis=1)
    t_max = xp.min(t_coef - t_bias, axis=1)
    t_min = xp.maximum(t_min, f32(0.0))

    miss = t_min >= t_max

    # first child of the root
    t_half = f32(1.5) * t_coef - t_bias
    upper = t_half > t_min[:, None]
    idx = xp.sum(xp.where(upper, bit[None, :], xp.int32(0)), axis=1, dtype=i32)
    pos = xp.where(upper, f32(1.5), f32(1.0))

    S = depth
    # constants derive from varying operands (vconst) so the traversal's
    # while_loop carries stay vma-consistent under shard_map (see vconst)
    zi = vconst(octant_mask, xp=xp)
    zf = vconst(t_min, dtype=f32, xp=xp)
    if root is None:
        parent0 = zi
    else:
        parent0 = zi + xp.asarray(root, i32)
    return TraceState(
        pos=pos,
        idx=idx,
        parent=parent0,
        scale=zi + i32(S_MAX - 1),
        scale_exp2=zf + f32(0.5),
        t_min=t_min.astype(f32),
        t_max=t_max.astype(f32),
        h=t_max.astype(f32),
        octant_mask=octant_mask,
        t_coef=t_coef.astype(f32),
        t_bias=t_bias.astype(f32),
        done=miss,
        hit_leaf=zi - 1,
        hit_t=zf,
        hit_parent=zi - 1,  # -1 = no hit (matches hit_leaf)
        hit_child=zi,
        stack_node=vconst(zi, shape=(S, n), xp=xp),
        stack_tmax=vconst(zf, shape=(S, n), xp=xp),
        iters=zi,
    )


def step(state: TraceState, masks, child_base, leaf_base, depth, xp):
    """One masked PUSH/ADVANCE/POP iteration over all rays."""
    f32, i32 = xp.float32, xp.int32
    s = state
    n = s.parent.shape[0]
    ray_ids = xp.arange(n)
    s0 = S_MAX - depth  # lowest scale in use; stack slot = scale - s0
    active = ~s.done

    desc = xp.take(masks, s.parent)
    vm = (desc >> 8) & 0xFF
    lm = desc & 0xFF

    t_corner = s.pos * s.t_coef - s.t_bias            # (N,3)
    tc_max = xp.min(t_corner, axis=1)

    # true child slot = mirrored idx flipped on mirrored axes (= ^ octant ^ 7,
    # see reference/traverse.py)
    child_shift = s.idx ^ s.octant_mask ^ 7
    child_valid = ((vm >> child_shift) & 1) != 0
    can = child_valid & (s.t_min <= s.t_max) & active

    tv_max = xp.minimum(s.t_max, tc_max)
    half = s.scale_exp2 * f32(0.5)
    t_center = half[:, None] * s.t_coef + t_corner

    enter = can & (s.t_min <= tv_max)
    below = (xp.int32(1) << child_shift) - 1
    leaf_bit = ((lm >> child_shift) & 1) != 0

    # ---- leaf hit ----
    hit_now = enter & leaf_bit
    leaf_rank = popc8(vm & lm & below, xp)
    hit_leaf = xp.where(hit_now, xp.take(leaf_base, s.parent) + leaf_rank, s.hit_leaf)
    hit_t = xp.where(hit_now, s.t_min, s.hit_t)
    hit_parent = xp.where(hit_now, s.parent, s.hit_parent)
    hit_child = xp.where(hit_now, child_shift, s.hit_child)
    done = s.done | hit_now

    # ---- PUSH ----
    push = enter & ~leaf_bit
    stack_slot = xp.clip(s.scale - s0, 0, depth - 1)
    write = push & (tc_max < s.h)
    if xp is np:
        stack_node = s.stack_node.copy()
        stack_tmax = s.stack_tmax.copy()
        old_n = stack_node[stack_slot, ray_ids]
        old_t = stack_tmax[stack_slot, ray_ids]
        stack_node[stack_slot, ray_ids] = np.where(write, s.parent, old_n)
        stack_tmax[stack_slot, ray_ids] = np.where(write, s.t_max, old_t)
    else:
        stack_node = s.stack_node.at[stack_slot, ray_ids].set(
            xp.where(write, s.parent, s.stack_node[stack_slot, ray_ids])
        )
        stack_tmax = s.stack_tmax.at[stack_slot, ray_ids].set(
            xp.where(write, s.t_max, s.stack_tmax[stack_slot, ray_ids])
        )
    h = xp.where(push, tc_max, s.h)

    node_rank = popc8(vm & ~lm & below, xp)
    parent = xp.where(push, xp.take(child_base, s.parent) + node_rank, s.parent)

    upper = t_center > s.t_min[:, None]
    bit = xp.asarray([1, 2, 4], i32)
    idx_descend = xp.sum(xp.where(upper, bit[None, :], xp.int32(0)), axis=1, dtype=i32)
    pos_descend = s.pos + xp.where(upper, half[:, None], f32(0.0))

    idx = xp.where(push, idx_descend, s.idx)
    pos = xp.where(push[:, None], pos_descend, s.pos)
    scale = xp.where(push, s.scale - 1, s.scale)
    scale_exp2 = xp.where(push, half, s.scale_exp2)
    t_max = xp.where(push, tv_max, s.t_max)

    # ---- ADVANCE ----
    adv = active & ~push & ~hit_now
    step_bits = t_corner <= tc_max[:, None]
    step_mask = xp.sum(xp.where(step_bits, bit[None, :], xp.int32(0)), axis=1, dtype=i32)
    pos_adv = pos - xp.where(step_bits & adv[:, None], scale_exp2[:, None], f32(0.0))
    t_min = xp.where(adv, xp.maximum(s.t_min, tc_max), s.t_min)
    idx_adv = xp.where(adv, idx ^ step_mask, idx)
    pos = xp.where(adv[:, None], pos_adv, pos)

    # ---- POP ----
    pop = adv & ((idx_adv & step_mask) != 0)
    xor_bits = _f2i(pos, xp) ^ _f2i(pos + scale_exp2[:, None], xp)
    differing = xp.sum(
        xp.where(step_bits, xor_bits, xp.int32(0)), axis=1, dtype=i32
    ) | xp.int32(1)  # |1 keeps the f32 cast well-defined on inactive lanes
    new_scale = (_f2i(differing.astype(f32), xp) >> 23) - 127
    oob = pop & ((new_scale >= S_MAX) | (new_scale < s0))
    pop_ok = pop & ~oob
    done = done | oob

    scale = xp.where(pop_ok, new_scale, scale)
    scale_exp2 = xp.where(
        pop_ok, _i2f((xp.clip(new_scale, s0, S_MAX - 1) - S_MAX + 127) << 23, xp),
        scale_exp2,
    )
    slot = xp.clip(scale - s0, 0, depth - 1)
    parent = xp.where(pop_ok, stack_node[slot, ray_ids], parent)
    t_max = xp.where(pop_ok, stack_tmax[slot, ray_ids], t_max)

    shift = xp.clip(scale, 0, 31)
    sh = _f2i(pos, xp) >> shift[:, None]
    pos = xp.where(pop_ok[:, None], _i2f(sh << shift[:, None], xp), pos)
    idx = xp.where(
        pop_ok,
        (sh[:, 0] & 1) | ((sh[:, 1] & 1) << 1) | ((sh[:, 2] & 1) << 2),
        idx_adv,
    )
    h = xp.where(pop_ok, f32(0.0), h)

    return TraceState(
        pos=pos,
        idx=idx,
        parent=parent,
        scale=scale,
        scale_exp2=scale_exp2,
        t_min=t_min,
        t_max=t_max,
        h=h,
        octant_mask=s.octant_mask,
        t_coef=s.t_coef,
        t_bias=s.t_bias,
        done=done,
        hit_leaf=hit_leaf,
        hit_t=hit_t,
        hit_parent=hit_parent,
        hit_child=hit_child,
        stack_node=stack_node,
        stack_tmax=stack_tmax,
        iters=s.iters + active.astype(i32),
    )


def max_iters_for_depth(depth: int) -> int:
    # Typical worst-case step count of the stack-based step on ordinary
    # rays (the reference bounds work by scale < s_max only,
    # NVIDIASVO.compute:57). Not a safe loop cap: see max_iters_stackless.
    return 24 * depth + 48


def max_iters_stackless(depth: int) -> int:
    """Trip cap of the traversal loops: every iteration enters or leaves a
    cell (the stackless XLA step climbs ONE level per POP iteration), and a
    ray crosses at most 3 * 2^l cells of level l, so 2 * sum_l 3 * 2^l
    bounds a ray's trips. Grazing rays over the depth-10 terrain need more
    than max_iters_for_depth's 288 and were cut short by it (missing their
    hit). The loops exit once every ray is done, so the cap only guarantees
    termination and costs nothing on ordinary rays."""
    return 12 * (1 << depth) + 48


def trace_numpy(svo, origin, direction, root=None) -> TraceResult:
    """Numpy driver: python loop until every lane is done."""
    masks = np.asarray(svo.masks)
    child_base = np.asarray(svo.child_base)
    leaf_base = np.asarray(svo.leaf_base)
    st = init_state(np.asarray(origin), np.asarray(direction), svo.depth, np,
                    root=root)
    for _ in range(max_iters_stackless(svo.depth)):
        if bool(np.all(st.done)):
            break
        st = step(st, masks, child_base, leaf_base, svo.depth, np)
    return TraceResult(st.hit_leaf, st.hit_t, st.hit_parent, st.hit_child, st.iters)


def _fast_step(st, nodes_packed, depth, lod=None):
    """One traversal iteration of the XLA path. STACKLESS re-design:

      * ONE packed row gather (masks|child_base|parent_ptr) per step — the
        in-loop gather was the dominant cost on the original target, so
        everything else is arranged around doing exactly one of them
      * NO traversal stack: the parent node's exit t is recomputed from `pos`
        (round the child corner up to the parent grid, take the min corner-
        plane t, clip by the root exit — bit-identical to the value ESVO
        keeps on its stack because with mirrored directions a child's exit t
        never exceeds its parent's), and POP ascends ONE level per iteration
        through the parent pointer instead of jumping to the float-mantissa
        scale (a multi-level pop simply takes one iteration per level; `pos`
        never leaves the current parent, so no stale state is possible)
      * scale_exp2 is recomputed from scale (one bitcast) instead of carried

    The loop state shrinks from ~(20 + 2*depth) arrays to 13. Hit results
    (leaf id, t) are bit-identical to step()/the scalar oracle (tested);
    only `iters` differs.

    st is a dict; nodes_packed is int32 (n_nodes, 3)."""
    f32, i32 = jnp.float32, jnp.int32
    active = ~st["done"]

    nd = jnp.take(nodes_packed, st["parent"], axis=0)  # (N, 3)
    desc = nd[:, 0]
    cbase = nd[:, 1]
    pptr = nd[:, 2]
    vm = (desc >> 8) & 0xFF
    lm = desc & 0xFF

    scale = st["scale"]
    scale_exp2 = _i2f((scale - S_MAX + 127) << 23, jnp)  # 2^(scale-S_MAX)
    pos = st["pos"]
    t_corner = pos * st["t_coef"] - st["t_bias"]
    tc_max = jnp.min(t_corner, axis=1)

    # parent cube exit t (the value ESVO stacks as t_max): round pos up to
    # the parent grid, min of its corner-plane t's, clipped by the root exit
    pshift = scale + 1  # pop target grid; scale <= S_MAX-1 so shift <= S_MAX
    psh = _f2i(pos, jnp) >> pshift[:, None]
    parent_pos = _i2f(psh << pshift[:, None], jnp)
    t_root = jnp.min(st["t_coef"] - st["t_bias"], axis=1)
    t_max = jnp.minimum(
        jnp.min(parent_pos * st["t_coef"] - st["t_bias"], axis=1), t_root)

    child_shift = st["idx"] ^ st["octant_mask"] ^ 7
    child_valid = ((vm >> child_shift) & 1) != 0
    # `popped` marks a ray that ascended last iteration: its current child is
    # the node it just exited (t_min sits exactly on its boundary), so entry
    # is suppressed for one iteration and the ray ADVANCEs at this level —
    # stepping to the sibling, or popping again if the exit crossed this
    # parent's boundary too
    can = child_valid & (st["t_min"] <= t_max) & active & ~st["popped"]

    tv_max = jnp.minimum(t_max, tc_max)
    half = scale_exp2 * f32(0.5)
    enter = can & (st["t_min"] <= tv_max)
    below = (jnp.int32(1) << child_shift) - 1
    leaf_bit = ((lm >> child_shift) & 1) != 0

    hit_leafy = enter & leaf_bit
    if lod is not None:
        # LOD early-exit (Trace.cu:135-136, dropped by the reference's own
        # C#/HLSL ports): stop descending when the child voxel's size falls
        # below the ray's footprint at this distance
        coef, bias = lod
        small = enter & ~leaf_bit & (tc_max * coef + bias >= half * 2.0)
        hit_now = hit_leafy | small
    else:
        small = None
        hit_now = hit_leafy
    hit_parent = jnp.where(hit_now, st["parent"], st["hit_parent"])
    hit_child = jnp.where(hit_now, child_shift, st["hit_child"])
    hit_t = jnp.where(hit_now, st["t_min"], st["hit_t"])
    done = st["done"] | hit_now

    node_rank = popc8(vm & ~lm & below, jnp)
    if lod is not None:
        hit_node = jnp.where(small, cbase + node_rank, st["hit_node"])

    # ---- PUSH (descend into the entered non-leaf child) ----
    push = enter & ~leaf_bit
    if lod is not None:
        push = push & ~small
    parent = jnp.where(push, cbase + node_rank, st["parent"])

    t_center = half[:, None] * st["t_coef"] + t_corner
    upper = t_center > st["t_min"][:, None]
    bit = jnp.asarray([1, 2, 4], i32)
    idx_descend = jnp.sum(jnp.where(upper, bit[None, :], 0), axis=1,
                          dtype=i32)
    pos_descend = pos + jnp.where(upper, half[:, None], f32(0.0))

    idx = jnp.where(push, idx_descend, st["idx"])
    pos = jnp.where(push[:, None], pos_descend, pos)
    scale = jnp.where(push, scale - 1, scale)

    # ---- ADVANCE / POP decision ----
    adv_any = active & ~push & ~hit_now
    step_bits = t_corner <= tc_max[:, None]
    step_mask = jnp.sum(jnp.where(step_bits, bit[None, :], 0), axis=1,
                        dtype=i32)
    idx_adv = st["idx"] ^ step_mask
    pop = adv_any & ((idx_adv & step_mask) != 0)  # step leaves the parent
    move = adv_any & ~pop
    t_min = jnp.where(adv_any, jnp.maximum(st["t_min"], tc_max), st["t_min"])

    # MOVE: step to the sibling within the parent
    pos = pos - jnp.where(step_bits & move[:, None], scale_exp2[:, None],
                          f32(0.0))
    idx = jnp.where(move, idx_adv, idx)

    # POP: ascend exactly one level (pos stays put — it is already inside the
    # parent; rounding it to the parent grid gives the parent's corner)
    new_scale = st["scale"] + 1
    exit_root = pop & (new_scale >= S_MAX)
    done = done | exit_root
    pop_ok = pop & ~exit_root
    pos = jnp.where(pop_ok[:, None], parent_pos, pos)
    idx = jnp.where(
        pop_ok,
        (psh[:, 0] & 1) | ((psh[:, 1] & 1) << 1) | ((psh[:, 2] & 1) << 2),
        idx)
    parent = jnp.where(pop_ok, pptr, parent)
    scale = jnp.where(pop_ok, new_scale, scale)

    out = dict(
        pos=pos, idx=idx, parent=parent, scale=scale, t_min=t_min,
        octant_mask=st["octant_mask"], t_coef=st["t_coef"],
        t_bias=st["t_bias"], done=done, popped=pop_ok,
        hit_parent=hit_parent, hit_child=hit_child, hit_t=hit_t,
        iters=st["iters"] + active.astype(i32),
    )
    if lod is not None:
        out["hit_node"] = hit_node
    return out


# Rays are processed in fixed-size chunks via lax.map: the while_loop body
# compiles once at CHUNK shape, and each camera-coherent chunk exits its
# loop as soon as its own rays converge instead of paying the worst ray of
# the whole image. The 64K chunk and the unrolled steps were sized for the
# original target, where a while_loop iteration carried a large fixed cost
# and wide loop bodies compiled slowly; their best values on the H100 are
# unmeasured (ROADMAP.md, Design 3).
import os as _os
TRACE_CHUNK = int(_os.environ.get("RTT_TRACE_CHUNK", "65536"))

# Traversal steps per while_loop iteration: amortizes the loop's fixed
# per-iteration cost at the price of up to STEP_UNROLL-1 masked no-op steps
# per ray at exit.
STEP_UNROLL = int(_os.environ.get("RTT_STEP_UNROLL", "4"))
if STEP_UNROLL < 1:
    raise ValueError(f"RTT_STEP_UNROLL={STEP_UNROLL} < 1 would hang the "
                     "traversal while_loop")


@partial(jax.jit, static_argnames=("depth",))
def _trace_jax(masks, child_base, leaf_base, parent_ptr, origin, direction,
               depth, root=None):
    n = origin.shape[0]
    if n > TRACE_CHUNK and n % TRACE_CHUNK == 0:
        g = n // TRACE_CHUNK
        o_c = origin.reshape(g, TRACE_CHUNK, 3)
        d_c = direction.reshape(g, TRACE_CHUNK, 3)
        if root is None:
            res = jax.lax.map(
                lambda od: _trace_core(masks, child_base, leaf_base,
                                       parent_ptr, od[0], od[1], depth, None),
                (o_c, d_c))
        else:
            r_c = jnp.broadcast_to(jnp.asarray(root, jnp.int32), (n,)).reshape(
                g, TRACE_CHUNK)
            res = jax.lax.map(
                lambda odr: _trace_core(masks, child_base, leaf_base,
                                        parent_ptr, odr[0], odr[1], depth,
                                        odr[2]),
                (o_c, d_c, r_c))
        return TraceResult(
            res.hit_leaf.reshape(n), res.hit_t.reshape(n),
            res.hit_parent.reshape(n), res.hit_child.reshape(n),
            res.iters.reshape(n))
    return _trace_core(masks, child_base, leaf_base, parent_ptr, origin,
                       direction, depth, root)


# Compaction schedule: once fewer than 1/COMPACT_FACTOR of a batch's rays
# remain active, the survivors are gathered into a batch that much smaller
# (profiled on the depth-10 terrain: mean 22 iterations/ray but batch maxima
# of ~100-200 — straggler rays otherwise keep every lane busy).
COMPACT_FACTOR = 4
COMPACT_MIN = 2048  # don't bother below this width


def _compact_take(st, perm):
    return {k: jnp.take(v, perm, axis=0) for k, v in st.items()}


def _trace_core(masks, child_base, leaf_base, parent_ptr, origin, direction,
                depth, root=None):
    nodes_packed = jnp.stack([masks, child_base, parent_ptr], axis=1)
    st0 = init_state(origin, direction, depth, jnp, root=root)
    n = origin.shape[0]
    st = dict(
        pos=st0.pos, idx=st0.idx, parent=st0.parent, scale=st0.scale,
        t_min=st0.t_min, octant_mask=st0.octant_mask, t_coef=st0.t_coef,
        t_bias=st0.t_bias, done=st0.done, popped=jnp.zeros_like(st0.done),
        hit_parent=st0.hit_parent,
        hit_child=st0.hit_child, hit_t=st0.hit_t, iters=st0.iters,
    )
    n_max = max_iters_stackless(depth)

    # output accumulators at full width; each phase scatters its terminated
    # rays back by original index
    out_parent = st0.hit_parent
    out_child = jnp.zeros_like(st0.idx)
    out_t = jnp.zeros_like(st0.hit_t)
    out_iters = jnp.zeros_like(st0.iters)
    orig = jnp.zeros_like(st0.idx) + jnp.arange(n, dtype=jnp.int32)
    st["orig"] = orig
    st["base_iters"] = jnp.zeros_like(st0.iters)

    widths = [n]
    w = n
    while w // COMPACT_FACTOR >= COMPACT_MIN:
        w = w // COMPACT_FACTOR
        widths.append(w)

    i_total = jnp.int32(0)
    for phase, width in enumerate(widths):
        is_last = phase == len(widths) - 1
        next_width = None if is_last else widths[phase + 1]

        def cond(carry, _next=next_width, _last=is_last):
            i, st = carry
            go = (i < n_max) & jnp.any(~st["done"])
            if not _last:
                # keep running until survivors fit the next width
                go = go & (jnp.sum(~st["done"]) > _next)
            return go

        def body(carry):
            i, st = carry
            extra = {"orig": st["orig"], "base_iters": st["base_iters"]}
            core = {k: v for k, v in st.items() if k not in extra}
            for _ in range(STEP_UNROLL):
                core = _fast_step(core, nodes_packed, depth)
            core.update(extra)
            return i + STEP_UNROLL, core

        i_total, st = jax.lax.while_loop(cond, body, (i_total, st))

        # write results (terminated rays are final; survivors will be
        # overwritten by a later phase). Phase 0's orig is the identity.
        if phase == 0:
            out_parent = st["hit_parent"]
            out_child = st["hit_child"]
            out_t = st["hit_t"]
            out_iters = st["base_iters"] + st["iters"]
        else:
            out_parent = out_parent.at[st["orig"]].set(st["hit_parent"])
            out_child = out_child.at[st["orig"]].set(st["hit_child"])
            out_t = out_t.at[st["orig"]].set(st["hit_t"])
            out_iters = out_iters.at[st["orig"]].set(
                st["base_iters"] + st["iters"])
        if not is_last:
            perm = jnp.argsort(st["done"])[:next_width]  # actives first
            st = _compact_take(st, perm)
            st["base_iters"] = st["base_iters"] + st["iters"]
            st["iters"] = jnp.zeros_like(st["base_iters"])

    # leaf resolution outside the loop
    hit = out_parent >= 0
    safe_parent = jnp.where(hit, out_parent, 0)
    desc = jnp.take(masks, safe_parent)
    vm = (desc >> 8) & 0xFF
    lm = desc & 0xFF
    below = (jnp.int32(1) << out_child) - 1
    rank = popc8(vm & lm & below, jnp)
    hit_leaf = jnp.where(hit, jnp.take(leaf_base, safe_parent) + rank, -1)
    return TraceResult(hit_leaf, out_t, out_parent, out_child, out_iters)


def derive_parent_ptr_jnp(masks, child_base):
    """Device-side parent-pointer derivation (see octree.compute_parent_ptr):
    scatter each parent id at its child-block start, forward-fill by running
    max. O(n_nodes) once per call — used when a caller has only the raw
    arrays; hot paths pass a precomputed parent_ptr instead."""
    n = masks.shape[0]
    vm = (masks >> 8) & 0xFF
    lm = masks & 0xFF
    has = (vm & ~lm) != 0
    iota = jnp.arange(n, dtype=jnp.int32)
    seed = jnp.zeros(n, jnp.int32).at[
        jnp.where(has, child_base, 0)].max(jnp.where(has, iota, 0))
    return jax.lax.cummax(seed, axis=0)


def parent_ptr_of(svo):
    """svo.parent_ptr, deriving it on the fly for SVOs built without one."""
    if svo.parent_ptr is not None:
        return jnp.asarray(svo.parent_ptr)
    from raytracingtest_tpu.ops.octree import compute_parent_ptr
    return jnp.asarray(compute_parent_ptr(np.asarray(svo.masks),
                                          np.asarray(svo.child_base)))


def trace_jax(svo, origin, direction) -> TraceResult:
    """XLA driver: jitted lax.while_loop over the whole ray batch."""
    return _trace_jax(
        jnp.asarray(svo.masks),
        jnp.asarray(svo.child_base),
        jnp.asarray(svo.leaf_base),
        parent_ptr_of(svo),
        origin,
        direction,
        svo.depth,
    )


class MultiTraceResult(NamedTuple):
    """Up to K ordered leaf intersections per ray (for volumetric
    rendering / the reference Trace()'s all-hits list, CompactSVO.cs:92-94)."""

    hit_leaf: object  # i32 (N, K) leaf rows in t-order, -1 padded
    t_in: object      # f32 (N, K) segment entry t
    t_out: object     # f32 (N, K) segment exit t
    count: object     # i32 (N,)
    iters: object     # i32 (N,)


@partial(jax.jit, static_argnames=("depth", "k"))
def _trace_multi_jax(masks, child_base, leaf_base, parent_ptr, origin,
                     direction, depth, k, root=None):
    n = origin.shape[0]
    if n > TRACE_CHUNK and n % TRACE_CHUNK == 0:
        g = n // TRACE_CHUNK
        o_c = origin.reshape(g, TRACE_CHUNK, 3)
        d_c = direction.reshape(g, TRACE_CHUNK, 3)
        res = jax.lax.map(
            lambda od: _trace_multi_core(masks, child_base, leaf_base,
                                         parent_ptr, od[0], od[1], depth, k,
                                         None),
            (o_c, d_c))
        return MultiTraceResult(
            res.hit_leaf.reshape(n, k), res.t_in.reshape(n, k),
            res.t_out.reshape(n, k), res.count.reshape(n),
            res.iters.reshape(n))
    return _trace_multi_core(masks, child_base, leaf_base, parent_ptr,
                             origin, direction, depth, k, root)


def _trace_multi_core(masks, child_base, leaf_base, parent_ptr, origin,
                      direction, depth, k, root=None):
    """K-hit traversal: like _trace_core but a leaf hit records a segment
    (leaf, t_in, t_out) into its slot and the ray continues via ADVANCE
    (the scalar oracle's collect_all mode, reference/traverse.py). Stackless
    like _fast_step (recomputed t_max, one-level POP via parent_ptr)."""
    f32, i32 = jnp.float32, jnp.int32
    nodes_packed = jnp.stack([masks, child_base, parent_ptr], axis=1)
    st0 = init_state(origin, direction, depth, jnp, root=root)
    n = origin.shape[0]
    st = dict(
        pos=st0.pos, idx=st0.idx, parent=st0.parent, scale=st0.scale,
        t_min=st0.t_min, octant_mask=st0.octant_mask, t_coef=st0.t_coef,
        t_bias=st0.t_bias, done=st0.done, popped=jnp.zeros_like(st0.done),
        iters=st0.iters,
        hits_leaf=vconst(st0.idx, -1, shape=(k, n)),
        hits_tin=vconst(st0.hit_t, shape=(k, n)),
        hits_tout=vconst(st0.hit_t, shape=(k, n)),
        count=jnp.zeros_like(st0.idx),
    )
    k_iota = jax.lax.broadcasted_iota(jnp.int32, (k, n), 0)
    # allow extra iterations for pass-through rays
    n_max = max_iters_stackless(depth) + 8 * k

    def cond(carry):
        i, st = carry
        return (i < n_max) & jnp.any(~st["done"])

    def body(carry):
        i, st = carry
        active = ~st["done"]

        nd = jnp.take(nodes_packed, st["parent"], axis=0)
        desc = nd[:, 0]
        cbase = nd[:, 1]
        pptr = nd[:, 2]
        vm = (desc >> 8) & 0xFF
        lm = desc & 0xFF

        scale = st["scale"]
        scale_exp2 = _i2f((scale - S_MAX + 127) << 23, jnp)
        pos = st["pos"]
        t_corner = pos * st["t_coef"] - st["t_bias"]
        tc_max = jnp.min(t_corner, axis=1)

        pshift = scale + 1
        psh = _f2i(pos, jnp) >> pshift[:, None]
        parent_pos = _i2f(psh << pshift[:, None], jnp)
        t_root = jnp.min(st["t_coef"] - st["t_bias"], axis=1)
        t_max = jnp.minimum(
            jnp.min(parent_pos * st["t_coef"] - st["t_bias"], axis=1), t_root)

        child_shift = st["idx"] ^ st["octant_mask"] ^ 7
        child_valid = ((vm >> child_shift) & 1) != 0
        can = child_valid & (st["t_min"] <= t_max) & active & ~st["popped"]

        tv_max = jnp.minimum(t_max, tc_max)
        half = scale_exp2 * f32(0.5)
        enter = can & (st["t_min"] <= tv_max)
        below = (jnp.int32(1) << child_shift) - 1
        leaf_bit = ((lm >> child_shift) & 1) != 0

        # ---- record hit segment into slot `count`, keep going ----
        hit_now = enter & leaf_bit
        leaf_rank = popc8(vm & lm & below, jnp)
        leaf_id = jnp.take(leaf_base, st["parent"]) + leaf_rank
        sel_k = (k_iota == st["count"][None]) & hit_now[None]
        hits_leaf = jnp.where(sel_k, leaf_id[None], st["hits_leaf"])
        hits_tin = jnp.where(sel_k, st["t_min"][None], st["hits_tin"])
        hits_tout = jnp.where(sel_k, tv_max[None], st["hits_tout"])
        count = st["count"] + hit_now.astype(i32)
        done = st["done"] | (count >= k)

        # ---- PUSH (only for non-leaf entries) ----
        push = enter & ~leaf_bit
        node_rank = popc8(vm & ~lm & below, jnp)
        parent = jnp.where(push, cbase + node_rank, st["parent"])

        t_center = half[:, None] * st["t_coef"] + t_corner
        upper = t_center > st["t_min"][:, None]
        bit = jnp.asarray([1, 2, 4], i32)
        idx_descend = jnp.sum(jnp.where(upper, bit[None, :], 0), axis=1,
                              dtype=i32)
        pos_descend = pos + jnp.where(upper, half[:, None], f32(0.0))

        idx = jnp.where(push, idx_descend, st["idx"])
        pos = jnp.where(push[:, None], pos_descend, pos)
        scale = jnp.where(push, scale - 1, scale)

        # ---- ADVANCE / POP (hit rays advance too unless they filled up) --
        adv_any = active & ~push & ~(count >= k)
        step_bits = t_corner <= tc_max[:, None]
        step_mask = jnp.sum(jnp.where(step_bits, bit[None, :], 0), axis=1,
                            dtype=i32)
        idx_adv = st["idx"] ^ step_mask
        pop = adv_any & ((idx_adv & step_mask) != 0)
        move = adv_any & ~pop
        t_min = jnp.where(adv_any, jnp.maximum(st["t_min"], tc_max),
                          st["t_min"])

        pos = pos - jnp.where(step_bits & move[:, None], scale_exp2[:, None],
                              f32(0.0))
        idx = jnp.where(move, idx_adv, idx)

        new_scale = st["scale"] + 1
        exit_root = pop & (new_scale >= S_MAX)
        done = done | exit_root
        pop_ok = pop & ~exit_root
        pos = jnp.where(pop_ok[:, None], parent_pos, pos)
        idx = jnp.where(
            pop_ok,
            (psh[:, 0] & 1) | ((psh[:, 1] & 1) << 1) | ((psh[:, 2] & 1) << 2),
            idx)
        parent = jnp.where(pop_ok, pptr, parent)
        scale = jnp.where(pop_ok, new_scale, scale)

        st = dict(
            pos=pos, idx=idx, parent=parent, scale=scale, t_min=t_min,
            octant_mask=st["octant_mask"], t_coef=st["t_coef"],
            t_bias=st["t_bias"], done=done, popped=pop_ok,
            iters=st["iters"] + active.astype(i32),
            hits_leaf=hits_leaf, hits_tin=hits_tin, hits_tout=hits_tout,
            count=count,
        )
        return i + 1, st

    _, st = jax.lax.while_loop(cond, body, (jnp.int32(0), st))
    return MultiTraceResult(
        st["hits_leaf"].T, st["hits_tin"].T, st["hits_tout"].T, st["count"],
        st["iters"])


def _trace_lod_core(masks, child_base, leaf_base, parent_ptr, origin,
                    direction, depth, coef, bias):
    nodes_packed = jnp.stack([masks, child_base, parent_ptr], axis=1)
    st0 = init_state(origin, direction, depth, jnp)
    n = origin.shape[0]
    st = dict(
        pos=st0.pos, idx=st0.idx, parent=st0.parent, scale=st0.scale,
        t_min=st0.t_min, octant_mask=st0.octant_mask, t_coef=st0.t_coef,
        t_bias=st0.t_bias, done=st0.done, popped=jnp.zeros_like(st0.done),
        hit_parent=st0.hit_parent, hit_child=st0.hit_child,
        hit_t=st0.hit_t, hit_node=st0.hit_parent,
        iters=st0.iters,
    )
    n_max = max_iters_stackless(depth)
    lod = (jnp.float32(coef), jnp.float32(bias))

    def cond(carry):
        i, st = carry
        return (i < n_max) & jnp.any(~st["done"])

    def body(carry):
        i, st = carry
        return i + 1, _fast_step(st, nodes_packed, depth, lod=lod)

    _, st = jax.lax.while_loop(cond, body, (jnp.int32(0), st))

    is_node = st["hit_node"] >= 0
    hit = (st["hit_parent"] >= 0) & ~is_node
    safe_parent = jnp.where(hit, st["hit_parent"], 0)
    desc = jnp.take(masks, safe_parent)
    vm = (desc >> 8) & 0xFF
    lm = desc & 0xFF
    below = (jnp.int32(1) << st["hit_child"]) - 1
    rank = popc8(vm & lm & below, jnp)
    hit_leaf = jnp.where(hit, jnp.take(leaf_base, safe_parent) + rank, -1)
    return TraceResult(hit_leaf, st["hit_t"], st["hit_parent"],
                       st["hit_child"], st["iters"], st["hit_node"])


@partial(jax.jit, static_argnames=("depth",))
def _trace_lod_jax(masks, child_base, leaf_base, parent_ptr, origin,
                   direction, depth, coef, bias):
    """Trace with LOD early-exit: descent stops when the child voxel size
    drops below the ray footprint (t * coef + bias), reporting the interior
    node instead of a leaf (Trace.cu:135-136 ray_size_coef semantics)."""
    n = origin.shape[0]
    if n > TRACE_CHUNK and n % TRACE_CHUNK == 0:
        g = n // TRACE_CHUNK
        o_c = origin.reshape(g, TRACE_CHUNK, 3)
        d_c = direction.reshape(g, TRACE_CHUNK, 3)
        res = jax.lax.map(
            lambda od: _trace_lod_core(masks, child_base, leaf_base,
                                       parent_ptr, od[0], od[1], depth,
                                       coef, bias),
            (o_c, d_c))
        return TraceResult(
            res.hit_leaf.reshape(n), res.hit_t.reshape(n),
            res.hit_parent.reshape(n), res.hit_child.reshape(n),
            res.iters.reshape(n), res.hit_node.reshape(n))
    return _trace_lod_core(masks, child_base, leaf_base, parent_ptr, origin,
                           direction, depth, coef, bias)


def trace_lod_jax(svo, origin, direction, pixel_size_coef,
                  pixel_size_bias=0.0) -> TraceResult:
    """LOD trace: pixel footprint grows as t * coef + bias (octree-local
    units). For a perspective camera, coef ~= 2*tan(fov/2)/image_height."""
    return _trace_lod_jax(
        jnp.asarray(svo.masks), jnp.asarray(svo.child_base),
        jnp.asarray(svo.leaf_base), parent_ptr_of(svo),
        jnp.asarray(origin, jnp.float32),
        jnp.asarray(direction, jnp.float32), svo.depth,
        float(pixel_size_coef), float(pixel_size_bias))


def trace_multi_jax(svo, origin, direction, k=4) -> MultiTraceResult:
    return _trace_multi_jax(
        jnp.asarray(svo.masks), jnp.asarray(svo.child_base),
        jnp.asarray(svo.leaf_base), parent_ptr_of(svo),
        jnp.asarray(origin, jnp.float32),
        jnp.asarray(direction, jnp.float32), svo.depth, k)
