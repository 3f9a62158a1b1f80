"""Brick-accelerated traversal: bottom octree levels as 512-bit occupancy bricks.

Designed for the original target (README), where the traversal's only
expensive operation was the in-loop random row gather (cheaper for small
tables) while elementwise work was nearly free; on the H100 the trade is
unmeasured (ROADMAP.md, Speed 2). The plain ESVO loop (ops/traverse.py) pays one gather per
PUSH/ADVANCE/POP step against the full node table (517K nodes at depth 10).
This module restructures the deepest BRICK_LEVELS=3 levels so that:

  * the *structure* table shrinks to the top levels only (38K nodes at
    depth 10), and
  * the bottom three levels collapse into one 512-bit brick per level-
    (depth-3) node: an 8x8x8 voxel occupancy bitmask fetched with ONE row
    gather, then walked with a gather-free DDA (pure elementwise selects).

The traversal runs phased: a structure loop (one small gather per iteration)
parks rays at brick entries; one batched brick fetch; a DDA loop (zero
gathers) resolves voxel hits or exits; exited rays resume the structure loop
via the stackless `popped` mechanism. Hits are bit-identical to
traverse.trace_jax / the scalar oracle: the DDA advance uses the same
corner-plane arithmetic on the same dyadic f32 coordinates, so every t value
maxed into t_min coincides exactly with the full ESVO path's.

Brick bit order is hierarchical Morton ((slot_l1<<6)|(slot_l2<<3)|slot_l3),
which equals the leaf attribute array order (children are packed Morton,
parent-major — ops/octree.py layout invariant), so a hit's global leaf id is
brick_leaf_base + prefix-popcount. This plays the role of the reference's
leaf voxels within the NVIDIA ESVO format (Assets/Scripts/SVO/CompactSVO/
NaiveCreator.cs child descriptors; Assets/Shaders/NVIDIASVO.compute traversal)
re-blocked so that most steps fetch no structure.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any

import numpy as np

import jax
import jax.numpy as jnp

from raytracingtest_tpu.ops.traverse import (
    S_MAX, TraceResult, init_state, popc8, _f2i, _i2f, max_iters_for_depth,
    vconst,
)

BRICK_LEVELS = 3  # bottom levels folded into 8^3 bit bricks

# Exit the structure loop once runnable rays drop below 1/TOP_DRAIN of the
# still-active set: parked rays then take their brick-DDA round instead of
# idling behind structure-loop stragglers (every structure iteration costs a
# full-width gather whether or not a lane needs it).
TOP_DRAIN = 8

# Steps executed per while_loop iteration (each cond evaluation carries a
# fixed per-iteration cost; unrolling amortizes it at the price of up to
# UNROLL-1 wasted masked steps per ray at loop exit).
import os as _os


def _env_int(name, default, minimum):
    v = int(_os.environ.get(name, str(default)))
    if v < minimum:
        raise ValueError(
            f"{name}={v} is invalid (< {minimum}): an unroll below 1 makes "
            "the while_loop counter never advance (device hang)")
    return v


TOP_UNROLL = _env_int("RTT_TOP_UNROLL", 4, 1)
DDA_UNROLL = _env_int("RTT_DDA_UNROLL", 6, 1)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BrickSVO:
    """Brick-decomposed SVO (derived from ops.octree.SVO, same world frame).

    Top tree = original levels 0..top_depth-1 with the level-(top_depth-1)
    nodes' children re-marked as leaves; their child_base column holds the
    first child's *brick id* instead of a node row. bricks[:, :16] are the
    512 occupancy bits (uint32 words, hierarchical-Morton bit order);
    bricks[:, 16] is the brick's first global leaf id.
    """

    top_masks: Any    # int32 [n_top]  (valid<<8)|leaf
    top_child: Any    # int32 [n_top]  child node row / first brick id at the cut
    top_parent: Any   # int32 [n_top]  parent row (stackless POP)
    bricks: Any       # uint32 [n_bricks, 17]
    depth: int = dataclasses.field(metadata=dict(static=True))
    top_depth: int = dataclasses.field(metadata=dict(static=True))

    @property
    def n_top(self) -> int:
        return self.top_masks.shape[0]

    @property
    def n_bricks(self) -> int:
        return self.bricks.shape[0]

    def device(self) -> "BrickSVO":
        return BrickSVO(
            top_masks=jnp.asarray(self.top_masks),
            top_child=jnp.asarray(self.top_child),
            top_parent=jnp.asarray(self.top_parent),
            bricks=jnp.asarray(self.bricks),
            depth=self.depth,
            top_depth=self.top_depth,
        )


def _expand_children(masks, child_base, rows):
    """Vectorized one-level expansion of non-leaf children.

    Returns (child_rows, parent_pos, slots) sorted by (parent position in
    `rows`, slot) — the canonical contiguous-child order."""
    m = masks[rows]
    nl = ((m >> 8) & 0xFF) & ~(m & 0xFF)
    hit = ((nl[:, None] >> np.arange(8)) & 1).astype(bool)  # (m, 8)
    ranks = np.cumsum(hit, axis=1) - 1
    pidx, slots = np.nonzero(hit)
    crows = child_base[rows][pidx] + ranks[pidx, slots]
    return crows.astype(np.int64), pidx.astype(np.int64), slots.astype(np.int32)


def make_brick_svo(svo) -> BrickSVO:
    """Host-side brick decomposition of a packed SVO (leaves at the finest
    level only — the ops.octree builder invariant)."""
    depth = svo.depth
    if depth < BRICK_LEVELS + 1:
        raise ValueError(f"depth must be >= {BRICK_LEVELS + 1} for bricks")
    top_depth = depth - BRICK_LEVELS
    ls = svo.level_start
    masks = np.asarray(svo.masks)
    child_base = np.asarray(svo.child_base)
    leaf_base = np.asarray(svo.leaf_base)
    if svo.parent_ptr is not None:
        parent_ptr = np.asarray(svo.parent_ptr)
    else:
        from raytracingtest_tpu.ops.octree import compute_parent_ptr
        parent_ptr = compute_parent_ptr(masks, child_base)

    nb_start, nb_end = int(ls[top_depth]), int(ls[top_depth + 1])
    n_bricks = nb_end - nb_start
    n_top = nb_start

    top_masks = masks[:n_top].copy()
    top_child = child_base[:n_top].copy()
    top_parent = parent_ptr[:n_top].copy()
    # cut level: children become (brick) leaves; child_base column -> brick id
    lo, hi = int(ls[top_depth - 1]), n_top
    vm_cut = (top_masks[lo:hi] >> 8) & 0xFF
    top_masks[lo:hi] = (vm_cut << 8) | vm_cut
    top_child[lo:hi] = child_base[lo:hi] - nb_start

    # ---- brick bits: expand the 3 levels under each brick node ----------
    brick_rows = np.arange(nb_start, nb_end, dtype=np.int64)
    r1, p1, s1 = _expand_children(masks, child_base, brick_rows)
    r2, p2, s2 = _expand_children(masks, child_base, r1)
    # leaves of level depth-1 nodes (valid == leaf there)
    lm2 = masks[r2] & 0xFF
    hit3 = ((lm2[:, None] >> np.arange(8)) & 1).astype(bool)
    pidx3, s3 = np.nonzero(hit3)
    s3 = s3.astype(np.int32)

    brick_of = p1[p2[pidx3]]
    bitidx = (s1[p2[pidx3]].astype(np.int64) << 6) | (s2[pidx3] << 3) | s3
    flat = brick_of * 16 + (bitidx >> 5)           # sorted non-decreasing
    bit = np.uint32(1) << (bitidx & 31).astype(np.uint32)

    words = np.zeros(n_bricks * 16, np.uint32)
    if flat.size:
        starts = np.concatenate(
            [np.zeros(1, np.int64), np.flatnonzero(flat[1:] != flat[:-1]) + 1])
        words[flat[starts]] = np.bitwise_or.reduceat(bit, starts)

    # first global leaf id per brick = leaf_base of its first depth-1 node
    bleaf = np.zeros(n_bricks, np.uint32)
    if r2.size:
        b_of_r2 = p1[p2]  # brick of each depth-1 node, sorted non-decreasing
        starts2 = np.concatenate(
            [np.zeros(1, np.int64),
             np.flatnonzero(b_of_r2[1:] != b_of_r2[:-1]) + 1])
        bleaf[b_of_r2[starts2]] = leaf_base[r2[starts2]].astype(np.uint32)

    bricks = np.concatenate(
        [words.reshape(n_bricks, 16), bleaf[:, None]], axis=1)
    if n_bricks == 0:
        # empty scene: keep one zero row so the (masked) batched fetch is
        # always well-formed
        bricks = np.zeros((1, 17), np.uint32)
    return BrickSVO(
        top_masks=top_masks, top_child=top_child, top_parent=top_parent,
        bricks=bricks, depth=depth, top_depth=top_depth,
    )


# ---------------------------------------------------------------------------
# traversal
# ---------------------------------------------------------------------------

def _popcount32(v):
    v = v - ((v >> 1) & jnp.uint32(0x55555555))
    v = (v & jnp.uint32(0x33333333)) + ((v >> 2) & jnp.uint32(0x33333333))
    v = (v + (v >> 4)) & jnp.uint32(0x0F0F0F0F)
    return (v * jnp.uint32(0x01010101)) >> 24


def _spread3(x):
    """Interleave the low 3 bits of x to positions 0,3,6."""
    return (x & 1) | ((x & 2) << 2) | ((x & 4) << 4)


def _sel16(words, w):
    """Per-lane select of words[:, w] from (N,16) via a binary select tree
    (written for the original target, which has no per-lane gather: 15
    wheres on shrinking arrays)."""
    t = jnp.where(((w >> 3) & 1)[:, None] != 0, words[:, 8:], words[:, :8])
    t = jnp.where(((w >> 2) & 1)[:, None] != 0, t[:, 4:], t[:, :4])
    t = jnp.where(((w >> 1) & 1)[:, None] != 0, t[:, 2:], t[:, :2])
    return jnp.where((w & 1) != 0, t[:, 1], t[:, 0])


def _top_step(st, nodes_packed, lod=None):
    """One structure iteration: _fast_step on the top tree, except entering a
    leaf child PARKS the ray at that brick (records brick id + keeps the full
    traversal state for the post-DDA resume) instead of terminating.

    lod=(coef, bias, n_top): LOD early-exit at top-tree levels (the brick
    level inclusive — hit_node = n_top + brick_id matches the original SVO's
    node row for the brick's node). Footprints finer than a brick walk the
    full DDA (extra detail, never less; Trace.cu:135-136 semantics above the
    brick cut)."""
    f32, i32 = jnp.float32, jnp.int32
    runnable = ~st["done"] & ~st["parked"]

    nd = jnp.take(nodes_packed, st["parent"], axis=0)  # (N, 3)
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
    can = child_valid & (st["t_min"] <= t_max) & runnable & ~st["popped"]

    tv_max = jnp.minimum(t_max, tc_max)
    half = scale_exp2 * f32(0.5)
    enter = can & (st["t_min"] <= tv_max)
    below = (jnp.int32(1) << child_shift) - 1
    leaf_bit = ((lm >> child_shift) & 1) != 0

    # ---- brick entry: park (leaf children of the top tree are bricks) ----
    park_now = enter & leaf_bit
    leaf_rank = popc8(vm & lm & below, jnp)
    node_rank = popc8(vm & ~lm & below, jnp)
    done = st["done"]
    if lod is not None:
        coef, bias, n_top = lod
        big = tc_max * coef + bias >= half * f32(2.0)
        small_node = enter & ~leaf_bit & big
        small_brick = park_now & big
        park_now = park_now & ~big
        hit_node = jnp.where(
            small_node, cbase + node_rank,
            jnp.where(small_brick, n_top + cbase + leaf_rank,
                      st["hit_node"]))
        hit_t_lod = jnp.where(small_node | small_brick, st["t_min"],
                              st["hit_t"])
        done = done | small_node | small_brick
    brick_id = jnp.where(park_now, cbase + leaf_rank, st["brick_id"])
    parked = st["parked"] | park_now

    # ---- PUSH ----
    push = enter & ~leaf_bit
    if lod is not None:
        push = push & ~small_node
    parent = jnp.where(push, cbase + node_rank, st["parent"])

    t_center = half[:, None] * st["t_coef"] + t_corner
    upper = t_center > st["t_min"][:, None]
    bit = jnp.asarray([1, 2, 4], i32)
    idx_descend = jnp.sum(jnp.where(upper, bit[None, :], 0), axis=1, dtype=i32)
    pos_descend = pos + jnp.where(upper, half[:, None], f32(0.0))

    idx = jnp.where(push, idx_descend, st["idx"])
    pos = jnp.where(push[:, None], pos_descend, pos)
    scale = jnp.where(push, scale - 1, scale)

    # ---- ADVANCE / POP ----
    adv_any = runnable & ~push & ~park_now
    if lod is not None:
        adv_any = adv_any & ~small_node & ~small_brick
    step_bits = t_corner <= tc_max[:, None]
    step_mask = jnp.sum(jnp.where(step_bits, bit[None, :], 0), axis=1,
                        dtype=i32)
    idx_adv = st["idx"] ^ step_mask
    pop = adv_any & ((idx_adv & step_mask) != 0)
    move = adv_any & ~pop
    t_min = jnp.where(adv_any, jnp.maximum(st["t_min"], tc_max), st["t_min"])

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

    out = dict(
        pos=pos, idx=idx, parent=parent, scale=scale, t_min=t_min,
        octant_mask=st["octant_mask"], t_coef=st["t_coef"],
        t_bias=st["t_bias"], done=done, popped=pop_ok, parked=parked,
        brick_id=brick_id, hit_leaf=st["hit_leaf"], hit_t=st["hit_t"],
        hit_parent=st["hit_parent"], hit_child=st["hit_child"],
        iters=st["iters"] + runnable.astype(i32),
    )
    if lod is not None:
        out["hit_node"] = hit_node
        out["hit_t"] = hit_t_lod
    return out


def _brick_round(st, nodes_packed, bricks, depth, top_depth, n_max_top,
                 lod=None):
    """One round: drain the structure loop, fetch parked rays' bricks, run
    the gather-free DDA, and fold results back into the structure state."""
    f32, i32, u32 = jnp.float32, jnp.int32, jnp.uint32

    def top_cond(carry):
        i, s = carry
        runnable = ~s["done"] & ~s["parked"]
        n_run = jnp.sum(runnable)
        n_act = jnp.sum(~s["done"])
        return (i < n_max_top) & (n_run > 0) & (n_run * TOP_DRAIN > n_act)

    def top_body(carry):
        i, s = carry
        for _ in range(TOP_UNROLL):
            s = _top_step(s, nodes_packed, lod=lod)
        return i + TOP_UNROLL, s

    _, st = jax.lax.while_loop(top_cond, top_body, (jnp.int32(0), st))

    # ---- brick fetch: one batched row gather -----------------------------
    safe_bid = jnp.where(st["parked"], st["brick_id"], 0)
    brow = jnp.take(bricks, safe_bid, axis=0)          # (N, 17) uint32
    words = brow[:, :16]
    bleaf = brow[:, 16].astype(i32)

    # ---- DDA entry: descend BRICK_LEVELS geometric levels to the voxel
    # containing the entry point (same plane arithmetic as ESVO PUSH) ------
    brick_exp2 = f32(2.0 ** (-top_depth))              # brick size in [1,2]
    bpos = st["pos"]
    t_min = st["t_min"]
    for l in range(1, BRICK_LEVELS + 1):
        half = f32(brick_exp2 * 2.0 ** (-l))
        # half*coef + (pos*coef - bias), the same expression shape as the
        # plain path's descent: where XLA contracts multiply-adds into
        # FMAs, (pos+half)*coef - bias rounds differently at exact
        # voxel-corner ties
        t_center = half * st["t_coef"] + (bpos * st["t_coef"]
                                          - st["t_bias"])
        upper = t_center > t_min[:, None]
        bpos = bpos + jnp.where(upper, half, f32(0.0))

    vsize = f32(2.0 ** (-depth))
    vshift = S_MAX - depth
    om = st["octant_mask"]
    om_bits = jnp.stack([om & 1, (om >> 1) & 1, (om >> 2) & 1], axis=1)
    # unmirror: actual_bit = mirrored_bit ^ om_bit ^ 1 per level
    flip = jnp.where(om_bits == 1, jnp.int32(0), jnp.int32(7))  # (N,3)
    word_iota = jnp.arange(16, dtype=i32)[None, :]
    pc_bit = jnp.asarray([1, 2, 4], i32)

    dda = dict(
        bpos=bpos, t_min=t_min, parked=st["parked"] & ~st["done"],
        done=st["done"], popped=st["popped"],
        hit_leaf=st["hit_leaf"], hit_t=st["hit_t"], iters=st["iters"],
    )

    def dda_cond(carry):
        i, s = carry
        return (i < 3 * 8 + 2) & jnp.any(s["parked"])

    def dda_body(carry):
        i, s = carry
        for _ in range(DDA_UNROLL):
            s = _dda_step(s)
        return i + DDA_UNROLL, s

    def _dda_step(s):
        act = s["parked"]
        li = (_f2i(s["bpos"], jnp) >> vshift) & 7       # (N,3) mirrored
        a = li ^ flip
        idx9 = (_spread3(a[:, 0]) | (_spread3(a[:, 1]) << 1)
                | (_spread3(a[:, 2]) << 2))
        wsel = idx9 >> 5
        bitpos = (idx9 & 31).astype(u32)
        w = _sel16(words, wsel)
        occ = ((w >> bitpos) & 1) != 0
        hit_now = act & occ

        pc = _popcount32(words).astype(i32)             # (N,16)
        full = jnp.sum(jnp.where(word_iota < wsel[:, None], pc, 0), axis=1)
        partial = _popcount32(w & ((u32(1) << bitpos) - 1)).astype(i32)
        leaf_id = bleaf + full + partial

        hit_leaf = jnp.where(hit_now, leaf_id, s["hit_leaf"])
        hit_t = jnp.where(hit_now, s["t_min"], s["hit_t"])
        done = s["done"] | hit_now

        # advance (ESVO step semantics at fixed voxel scale)
        t_corner = s["bpos"] * st["t_coef"] - st["t_bias"]
        tc_max = jnp.min(t_corner, axis=1)
        adv = act & ~hit_now
        step_bits = t_corner <= tc_max[:, None]
        exit_b = adv & jnp.any(step_bits & (li == 0), axis=1)
        stay = adv & ~exit_b
        bpos = s["bpos"] - jnp.where(step_bits & stay[:, None], vsize,
                                     f32(0.0))
        t_min = jnp.where(adv, jnp.maximum(s["t_min"], tc_max), s["t_min"])

        return dict(
            bpos=bpos, t_min=t_min,
            parked=act & ~hit_now & ~exit_b,
            done=done,
            popped=jnp.where(exit_b, True, s["popped"]),
            hit_leaf=hit_leaf, hit_t=hit_t,
            iters=s["iters"] + act.astype(i32),
        )

    _, dda = jax.lax.while_loop(dda_cond, dda_body, (jnp.int32(0), dda))

    # rays whose DDA hit this round: top parent / brick slot are still held
    # in the (frozen-while-parked) structure state
    newly_hit = dda["done"] & ~st["done"]
    child_shift = st["idx"] ^ st["octant_mask"] ^ 7
    out = dict(st)
    out["t_min"] = dda["t_min"]
    out["done"] = dda["done"]
    out["popped"] = dda["popped"]
    out["parked"] = jnp.zeros_like(st["parked"])
    out["hit_leaf"] = dda["hit_leaf"]
    out["hit_t"] = dda["hit_t"]
    out["hit_parent"] = jnp.where(newly_hit, st["parent"], st["hit_parent"])
    out["hit_child"] = jnp.where(newly_hit, child_shift, st["hit_child"])
    out["iters"] = dda["iters"]
    return out


# phase-compaction schedule (same rationale as traverse._trace_core)
COMPACT_FACTOR = 4
COMPACT_MIN = 2048
TRACE_CHUNK = _env_int("RTT_TRACE_CHUNK", 65536, 1)


def _chunked(n):
    """Chunk count for an n-ray trace; warns when chunking silently falls
    through to one full-width loop (non-divisible ray counts)."""
    if n > TRACE_CHUNK and n % TRACE_CHUNK:
        import warnings
        warnings.warn(
            f"ray count {n} is not a multiple of RTT_TRACE_CHUNK="
            f"{TRACE_CHUNK}; tracing unchunked (one full-width loop; "
            "expect long compiles at large widths)", stacklevel=3)
    return n // TRACE_CHUNK if n > TRACE_CHUNK and n % TRACE_CHUNK == 0 else 0


def _trace_brick_core(top_masks, top_child, top_parent, bricks, origin,
                      direction, depth, top_depth, lod=None, root=None):
    """root (optional, (N,) i32): per-ray top-tree root row — the arena /
    clipmap stitching hook (each ray traces its own chunk's subtree, the
    role of the reference's offset-addressed chunk blocks,
    RaytracingMaster.cs:118-135)."""
    i32 = jnp.int32
    nodes_packed = jnp.stack([top_masks, top_child, top_parent], axis=1)
    st0 = init_state(origin, direction, top_depth, jnp, root=root)
    n = origin.shape[0]
    st = dict(
        pos=st0.pos, idx=st0.idx, parent=st0.parent, scale=st0.scale,
        t_min=st0.t_min, octant_mask=st0.octant_mask, t_coef=st0.t_coef,
        t_bias=st0.t_bias, done=st0.done, popped=jnp.zeros_like(st0.done),
        parked=jnp.zeros_like(st0.done), brick_id=jnp.zeros_like(st0.idx),
        hit_leaf=st0.hit_leaf, hit_t=st0.hit_t,
        hit_parent=st0.hit_parent, hit_child=st0.hit_child,
        iters=st0.iters,
    )
    if lod is not None:
        st["hit_node"] = st0.hit_parent
    n_max_top = max_iters_for_depth(top_depth)
    # rounds bound: generous; the loop exits when every ray is done
    n_max_rounds = 16 * depth + 64

    out_keys = ("hit_leaf", "hit_t", "hit_parent", "hit_child")
    if lod is not None:
        out_keys = out_keys + ("hit_node",)
    out_keys = out_keys + ("iters",)
    outs = {k: st[k] for k in out_keys}
    orig = jnp.zeros_like(st0.idx) + jnp.arange(n, dtype=i32)
    st["orig"] = orig
    st["base_iters"] = jnp.zeros_like(st0.iters)

    widths = [n]
    w = n
    while w // COMPACT_FACTOR >= COMPACT_MIN:
        w = w // COMPACT_FACTOR
        widths.append(w)

    r_total = jnp.int32(0)
    for phase, width in enumerate(widths):
        is_last = phase == len(widths) - 1
        next_width = None if is_last else widths[phase + 1]

        def cond(carry, _next=next_width, _last=is_last):
            r, s = carry
            go = (r < n_max_rounds) & jnp.any(~s["done"])
            if not _last:
                go = go & (jnp.sum(~s["done"]) > _next)
            return go

        def body(carry):
            r, s = carry
            extra = {"orig": s["orig"], "base_iters": s["base_iters"]}
            core = {k: v for k, v in s.items() if k not in extra}
            core = _brick_round(core, nodes_packed, bricks, depth, top_depth,
                                n_max_top, lod=lod)
            core.update(extra)
            return r + 1, core

        r_total, st = jax.lax.while_loop(cond, body, (r_total, st))

        if phase == 0:
            outs = {k: st[k] for k in out_keys[:-1]}
            outs["iters"] = st["base_iters"] + st["iters"]
        else:
            for k in out_keys[:-1]:
                outs[k] = outs[k].at[st["orig"]].set(st[k])
            outs["iters"] = outs["iters"].at[st["orig"]].set(
                st["base_iters"] + st["iters"])
        if not is_last:
            perm = jnp.argsort(st["done"])[:next_width]
            st = {k: jnp.take(v, perm, axis=0) for k, v in st.items()}
            st["base_iters"] = st["base_iters"] + st["iters"]
            st["iters"] = jnp.zeros_like(st["base_iters"])

    return TraceResult(outs["hit_leaf"], outs["hit_t"], outs["hit_parent"],
                       outs["hit_child"], outs["iters"],
                       outs["hit_node"] if lod is not None else None)


def _trace_brick_multi_core(top_masks, top_child, top_parent, bricks,
                            origin, direction, depth, top_depth, k):
    """K-segment brick traversal (volumetric all-hits): the DDA records each
    solid voxel's (leaf, t_in, t_out=voxel exit) and keeps walking; rays stop
    at k segments or root exit. Segment values are bit-identical to
    traverse._trace_multi_core (t_out = the voxel's corner-plane exit, which
    equals its min(t_max, tc_max) — the voxel's planes dominate its
    ancestors')."""
    from raytracingtest_tpu.ops.traverse import MultiTraceResult
    f32, i32, u32 = jnp.float32, jnp.int32, jnp.uint32
    nodes_packed = jnp.stack([top_masks, top_child, top_parent], axis=1)
    st0 = init_state(origin, direction, top_depth, jnp)
    n = origin.shape[0]
    st = dict(
        pos=st0.pos, idx=st0.idx, parent=st0.parent, scale=st0.scale,
        t_min=st0.t_min, octant_mask=st0.octant_mask, t_coef=st0.t_coef,
        t_bias=st0.t_bias, done=st0.done, popped=jnp.zeros_like(st0.done),
        parked=jnp.zeros_like(st0.done), brick_id=jnp.zeros_like(st0.idx),
        hit_leaf=st0.hit_leaf, hit_t=st0.hit_t,
        hit_parent=st0.hit_parent, hit_child=st0.hit_child,
        iters=st0.iters,
        hits_leaf=vconst(st0.idx, -1, shape=(k, n)),
        hits_tin=vconst(st0.hit_t, shape=(k, n)),
        hits_tout=vconst(st0.hit_t, shape=(k, n)),
        count=jnp.zeros_like(st0.idx),
    )
    k_iota = jax.lax.broadcasted_iota(jnp.int32, (k, n), 0)
    n_max_top = max_iters_for_depth(top_depth) + 8 * k
    n_max_rounds = 16 * depth + 8 * k + 64

    brick_exp2 = f32(2.0 ** (-top_depth))
    vsize = f32(2.0 ** (-depth))
    vshift = S_MAX - depth

    def round_body(carry):
        r, st = carry
        def top_cond(c):
            i, s = c
            runnable = ~s["done"] & ~s["parked"]
            n_run = jnp.sum(runnable)
            n_act = jnp.sum(~s["done"])
            return (i < n_max_top) & (n_run > 0) & (n_run * TOP_DRAIN > n_act)

        def top_body(c):
            i, s = c
            keep = {kk: s[kk] for kk in ("hits_leaf", "hits_tin",
                                         "hits_tout", "count")}
            core = {kk: v for kk, v in s.items() if kk not in keep}
            for _ in range(TOP_UNROLL):
                core = _top_step(core, nodes_packed)
            core.update(keep)
            return i + TOP_UNROLL, core

        _, st = jax.lax.while_loop(top_cond, top_body, (jnp.int32(0), st))

        safe_bid = jnp.where(st["parked"], st["brick_id"], 0)
        brow = jnp.take(bricks, safe_bid, axis=0)
        words = brow[:, :16]
        bleaf = brow[:, 16].astype(i32)

        bpos = st["pos"]
        t_min = st["t_min"]
        for l in range(1, BRICK_LEVELS + 1):
            half = f32(brick_exp2 * 2.0 ** (-l))
            # same expression shape as the plain path's descent (FMA
            # rounding — see _brick_round)
            t_center = half * st["t_coef"] + (bpos * st["t_coef"]
                                              - st["t_bias"])
            upper = t_center > t_min[:, None]
            bpos = bpos + jnp.where(upper, half, f32(0.0))

        om = st["octant_mask"]
        om_bits = jnp.stack([om & 1, (om >> 1) & 1, (om >> 2) & 1], axis=1)
        flip = jnp.where(om_bits == 1, jnp.int32(0), jnp.int32(7))
        word_iota = jnp.arange(16, dtype=i32)[None, :]

        dda = dict(
            bpos=bpos, t_min=t_min, parked=st["parked"] & ~st["done"],
            done=st["done"], popped=st["popped"],
            hits_leaf=st["hits_leaf"], hits_tin=st["hits_tin"],
            hits_tout=st["hits_tout"], count=st["count"],
            iters=st["iters"],
        )

        def dda_cond(c):
            i, s = c
            return (i < 3 * 8 + 2 + k) & jnp.any(s["parked"])

        def dda_body(c):
            i, s = c
            act = s["parked"]
            li = (_f2i(s["bpos"], jnp) >> vshift) & 7
            a = li ^ flip
            idx9 = (_spread3(a[:, 0]) | (_spread3(a[:, 1]) << 1)
                    | (_spread3(a[:, 2]) << 2))
            wsel = idx9 >> 5
            bitpos = (idx9 & 31).astype(u32)
            w = _sel16(words, wsel)
            occ = ((w >> bitpos) & 1) != 0
            hit_now = act & occ & (s["count"] < k)

            pc = _popcount32(words).astype(i32)
            full = jnp.sum(jnp.where(word_iota < wsel[:, None], pc, 0),
                           axis=1)
            partial = _popcount32(w & ((u32(1) << bitpos) - 1)).astype(i32)
            leaf_id = bleaf + full + partial

            t_corner = s["bpos"] * st["t_coef"] - st["t_bias"]
            tc_max = jnp.min(t_corner, axis=1)

            sel_k = (k_iota == s["count"][None]) & hit_now[None]
            hits_leaf = jnp.where(sel_k, leaf_id[None], s["hits_leaf"])
            hits_tin = jnp.where(sel_k, s["t_min"][None], s["hits_tin"])
            hits_tout = jnp.where(sel_k, tc_max[None], s["hits_tout"])
            count = s["count"] + hit_now.astype(i32)
            full_now = count >= k
            done = s["done"] | full_now

            # advance (hit segments keep walking unless full)
            adv = act & ~full_now
            step_bits = t_corner <= tc_max[:, None]
            exit_b = adv & jnp.any(step_bits & (li == 0), axis=1)
            stay = adv & ~exit_b
            bpos = s["bpos"] - jnp.where(step_bits & stay[:, None], vsize,
                                         f32(0.0))
            t_min = jnp.where(adv, jnp.maximum(s["t_min"], tc_max),
                              s["t_min"])

            return i + 1, dict(
                bpos=bpos, t_min=t_min,
                parked=act & ~full_now & ~exit_b,
                done=done,
                popped=jnp.where(exit_b, True, s["popped"]),
                hits_leaf=hits_leaf, hits_tin=hits_tin,
                hits_tout=hits_tout, count=count,
                iters=s["iters"] + act.astype(i32),
            )

        _, dda = jax.lax.while_loop(dda_cond, dda_body, (jnp.int32(0), dda))

        out = dict(st)
        out["t_min"] = dda["t_min"]
        out["done"] = dda["done"]
        out["popped"] = dda["popped"]
        out["parked"] = jnp.zeros_like(st["parked"])
        out["hits_leaf"] = dda["hits_leaf"]
        out["hits_tin"] = dda["hits_tin"]
        out["hits_tout"] = dda["hits_tout"]
        out["count"] = dda["count"]
        out["iters"] = dda["iters"]
        return r + 1, out

    def round_cond(carry):
        r, st = carry
        return (r < n_max_rounds) & jnp.any(~st["done"])

    _, st = jax.lax.while_loop(round_cond, round_body, (jnp.int32(0), st))
    return MultiTraceResult(st["hits_leaf"].T, st["hits_tin"].T,
                            st["hits_tout"].T, st["count"], st["iters"])


@partial(jax.jit, static_argnames=("depth", "top_depth", "k"))
def _trace_brick_multi_jax(top_masks, top_child, top_parent, bricks, origin,
                           direction, depth, top_depth, k):
    from raytracingtest_tpu.ops.traverse import MultiTraceResult
    n = origin.shape[0]
    g = _chunked(n)
    if g:
        o_c = origin.reshape(g, TRACE_CHUNK, 3)
        d_c = direction.reshape(g, TRACE_CHUNK, 3)
        res = jax.lax.map(
            lambda od: _trace_brick_multi_core(top_masks, top_child,
                                               top_parent, bricks, od[0],
                                               od[1], depth, top_depth, k),
            (o_c, d_c))
        return MultiTraceResult(
            res.hit_leaf.reshape(n, k), res.t_in.reshape(n, k),
            res.t_out.reshape(n, k), res.count.reshape(n),
            res.iters.reshape(n))
    return _trace_brick_multi_core(top_masks, top_child, top_parent, bricks,
                                   origin, direction, depth, top_depth, k)


def trace_brick_multi_jax(bsvo: BrickSVO, origin, direction, k=4):
    """All-hits brick trace (volumetric segments; bit-identical to
    traverse.trace_multi_jax)."""
    return _trace_brick_multi_jax(
        jnp.asarray(bsvo.top_masks), jnp.asarray(bsvo.top_child),
        jnp.asarray(bsvo.top_parent), jnp.asarray(bsvo.bricks),
        jnp.asarray(origin, jnp.float32), jnp.asarray(direction, jnp.float32),
        bsvo.depth, bsvo.top_depth, k)


@partial(jax.jit, static_argnames=("depth", "top_depth"))
def _trace_brick_jax(top_masks, top_child, top_parent, bricks, origin,
                     direction, depth, top_depth):
    n = origin.shape[0]
    g = _chunked(n)
    if g:
        o_c = origin.reshape(g, TRACE_CHUNK, 3)
        d_c = direction.reshape(g, TRACE_CHUNK, 3)
        res = jax.lax.map(
            lambda od: _trace_brick_core(top_masks, top_child, top_parent,
                                         bricks, od[0], od[1], depth,
                                         top_depth),
            (o_c, d_c))
        return TraceResult(
            res.hit_leaf.reshape(n), res.hit_t.reshape(n),
            res.hit_parent.reshape(n), res.hit_child.reshape(n),
            res.iters.reshape(n))
    return _trace_brick_core(top_masks, top_child, top_parent, bricks,
                             origin, direction, depth, top_depth)


@partial(jax.jit, static_argnames=("depth", "top_depth"))
def _trace_brick_lod_jax(top_masks, top_child, top_parent, bricks, origin,
                         direction, depth, top_depth, coef, bias):
    lod = (jnp.float32(coef), jnp.float32(bias),
           jnp.int32(top_masks.shape[0]))
    n = origin.shape[0]
    g = _chunked(n)
    if g:
        o_c = origin.reshape(g, TRACE_CHUNK, 3)
        d_c = direction.reshape(g, TRACE_CHUNK, 3)
        res = jax.lax.map(
            lambda od: _trace_brick_core(top_masks, top_child, top_parent,
                                         bricks, od[0], od[1], depth,
                                         top_depth, lod=lod),
            (o_c, d_c))
        return TraceResult(
            res.hit_leaf.reshape(n), res.hit_t.reshape(n),
            res.hit_parent.reshape(n), res.hit_child.reshape(n),
            res.iters.reshape(n), res.hit_node.reshape(n))
    return _trace_brick_core(top_masks, top_child, top_parent, bricks,
                             origin, direction, depth, top_depth, lod=lod)


def trace_brick_lod_jax(bsvo: BrickSVO, origin, direction, pixel_size_coef,
                        pixel_size_bias=0.0) -> TraceResult:
    """LOD trace on the brick path (Trace.cu:135-136 ray_size semantics):
    descent stops when the child size falls below the ray footprint, at
    top-tree levels INCLUDING the brick level (hit_node uses original-SVO
    node rows: top rows coincide and a brick-level stop maps to
    n_top + brick_id). Footprints finer than a brick walk the exact DDA to
    the leaf — never less detail than requested."""
    return _trace_brick_lod_jax(
        jnp.asarray(bsvo.top_masks), jnp.asarray(bsvo.top_child),
        jnp.asarray(bsvo.top_parent), jnp.asarray(bsvo.bricks),
        jnp.asarray(origin, jnp.float32),
        jnp.asarray(direction, jnp.float32), bsvo.depth, bsvo.top_depth,
        float(pixel_size_coef), float(pixel_size_bias))


def trace_brick_jax(bsvo: BrickSVO, origin, direction) -> TraceResult:
    """Brick-accelerated trace. hit_leaf / hit_t are bit-identical to
    traverse.trace_jax on the source SVO; hit_parent / hit_child refer to the
    TOP tree (the level-(top_depth-1) node and the brick slot under it), not
    the finest-level parent."""
    return _trace_brick_jax(
        jnp.asarray(bsvo.top_masks), jnp.asarray(bsvo.top_child),
        jnp.asarray(bsvo.top_parent), jnp.asarray(bsvo.bricks),
        jnp.asarray(origin, jnp.float32), jnp.asarray(direction, jnp.float32),
        bsvo.depth, bsvo.top_depth)
