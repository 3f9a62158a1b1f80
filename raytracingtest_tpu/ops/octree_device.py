"""Device-side SVO builder: the frontier sweep runs on the accelerator.

The host build (ops/octree.py build_svo) is bound by scene evaluation and
numpy bookkeeping; on the device the same work is elementwise math (the
noise gradient decode is branch-free — utils/noise.py) plus segment
reductions. This module runs every phase on the device:

  A. per-level frontier expansion + Lipschitz pruning (one scene eval per
     level; candidate buffers live on device, only ONE scalar count per
     level crosses to the host — coordinate arrays never leave the device)
  B. exact leaf test (6-neighbor air probe, one batched eval)
  C. upward pruning + mask/pointer assembly via sorted segment sums
     (bit-identical layout to the host builder: OR of per-(parent,slot)
     bits == sum because each bit appears once; first-child == segment_min
     because candidate order is parent-major)
  D. leaf attributes (palette albedo + central-difference normals)

Working buffers are padded to power-of-two buckets so jit caches converge
across levels and scenes (every distinct shape costs a compile; the bucket
sizes were chosen where compiles were slow, and whether the padding pays on
the H100 is unmeasured, ROADMAP.md Design 3). The output SVO's arrays are
exact-size device arrays; the structure is bit-identical to build_svo's (tested) because every keep/leaf
decision uses the same f32 formulas on the same dyadic inputs.

Reference role: the recursive CPU builder NaiveCreator.Create
(Assets/Scripts/SVO/CompactSVO/NaiveCreator.cs:10-24, 8^depth sampler calls
single-threaded) re-designed as data-parallel level sweeps on the
accelerator.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from raytracingtest_tpu.ops.octree import (
    SVO, CHILD_OFFSETS, default_albedo, compute_parent_ptr,
)

_SQRT3 = float(np.sqrt(3.0))


def _bucket(n: int, lo: int = 1024) -> int:
    b = lo
    while b < n:
        b <<= 1
    return b


@partial(jax.jit, static_argnames=("scene", "level", "depth", "lipschitz"))
def _expand_eval(cc, valid, *, scene, level, depth, lipschitz):
    """Expand one level's candidates to children, evaluate the scene at the
    child centers, and return (child coords, keep mask, f). Padding rows
    (valid=False) produce keep=False."""
    f32 = jnp.float32
    child = (cc[:, None, :] * 2 + jnp.asarray(CHILD_OFFSETS)[None, :, :])
    child = child.reshape(-1, 3)
    v8 = jnp.repeat(valid, 8)
    l = level
    half = 2.0 ** -(l + 1)
    finest = 2.0 ** -depth
    scale_l = f32(2.0 ** -l)
    px = (child[:, 0].astype(f32) + f32(0.5)) * scale_l
    py = (child[:, 1].astype(f32) + f32(0.5)) * scale_l
    pz = (child[:, 2].astype(f32) + f32(0.5)) * scale_l
    f = jnp.asarray(scene(px, py, pz, xp=jnp), f32)
    L = lipschitz
    r = _SQRT3 * half
    keep = (f <= L * r + 1e-6) & (f >= -(L * (r + 2.0 * finest)) - 1e-6) & v8
    return child, keep, f


@partial(jax.jit, static_argnames=("cap",))
def _compact(child, keep, f, cap):
    """Pack kept children (+ parent index, slot, f) into a cap-sized bucket.
    Returns coords (cap,3), par (cap,) int32 (-1 padding), slot, f."""
    idx = jnp.flatnonzero(keep, size=cap, fill_value=-1)
    ok = idx >= 0
    safe = jnp.maximum(idx, 0)
    coords = jnp.where(ok[:, None], jnp.take(child, safe, axis=0), -1)
    par = jnp.where(ok, (safe >> 3).astype(jnp.int32), -1)
    slot = jnp.where(ok, (safe & 7).astype(jnp.int32), 0)
    fv = jnp.where(ok, jnp.take(f, safe), jnp.float32(0))
    return coords, par, slot, fv


@partial(jax.jit, static_argnames=("cap",))
def _compact_merged(cc, par, slot, fv, cap):
    """Re-compact concatenated per-chunk buckets (padding rows par=-1)."""
    idx = jnp.flatnonzero(par >= 0, size=cap, fill_value=-1)
    ok = idx >= 0
    safe = jnp.maximum(idx, 0)
    return (jnp.where(ok[:, None], jnp.take(cc, safe, axis=0), -1),
            jnp.where(ok, jnp.take(par, safe), -1),
            jnp.where(ok, jnp.take(slot, safe), 0),
            jnp.where(ok, jnp.take(fv, safe), jnp.float32(0)))


# Parents per expansion chunk: bounds the 8x child blowup's working set so
# depth-12 frontiers (hundreds of millions of candidates) fit in HBM.
CHUNK_PARENTS = 1 << 22


def _expand_level(coords_prev, valid_prev, scene, l, depth, L):
    """Expand + prune one level, chunking the parent set when large.
    Returns (coords, par, slot, f, n_valid) in a power-of-two bucket."""
    prev_cap = coords_prev.shape[0]
    if prev_cap <= CHUNK_PARENTS:
        child, keep, f = _expand_eval(coords_prev, valid_prev, scene=scene,
                                      level=l, depth=depth, lipschitz=L)
        n = int(jnp.sum(keep))
        cc, par, slot, fv = _compact(child, keep, f, _bucket(max(n, 1)))
        return cc, par, slot, fv, n
    g = prev_cap // CHUNK_PARENTS
    parts = []
    n_total = 0
    for c in range(g):
        sl = slice(c * CHUNK_PARENTS, (c + 1) * CHUNK_PARENTS)
        child, keep, f = _expand_eval(coords_prev[sl], valid_prev[sl],
                                      scene=scene, level=l, depth=depth,
                                      lipschitz=L)
        nc = int(jnp.sum(keep))
        n_total += nc
        cc, par, slot, fv = _compact(child, keep, f, _bucket(max(nc, 1)))
        par = jnp.where(par >= 0, par + c * CHUNK_PARENTS, -1)
        parts.append((cc, par, slot, fv))
    cc = jnp.concatenate([p[0] for p in parts])
    par = jnp.concatenate([p[1] for p in parts])
    slot = jnp.concatenate([p[2] for p in parts])
    fv = jnp.concatenate([p[3] for p in parts])
    cap = _bucket(max(n_total, 1))
    cc, par, slot, fv = _compact_merged(cc, par, slot, fv, cap)
    return cc, par, slot, fv, n_total


@partial(jax.jit, static_argnames=("scene", "depth"))
def _leaf_test(coords, par, f0, *, scene, depth):
    """Exact leaf predicate at the finest level: solid center AND at least
    one of the 6 axis neighbors (one voxel away) is air."""
    f32 = jnp.float32
    fin = f32(2.0 ** -depth)
    px = (coords[:, 0].astype(f32) + f32(0.5)) * fin
    py = (coords[:, 1].astype(f32) + f32(0.5)) * fin
    pz = (coords[:, 2].astype(f32) + f32(0.5)) * fin
    solid = (f0 <= 0.0) & (par >= 0)
    air = jnp.zeros_like(solid)
    for ax in range(3):
        for sgn in (fin, -fin):
            q = [px, py, pz]
            q[ax] = q[ax] + sgn
            air = air | (jnp.asarray(scene(q[0], q[1], q[2], xp=jnp),
                                     f32) > 0.0)
    return solid & air


@partial(jax.jit, static_argnames=("n_parents",))
def _level_up(par, slot, survive_child, n_parents):
    """OR child-survival bits into each parent's valid mask (segment sum —
    each (parent, slot) bit appears at most once, so sum == or)."""
    sid = jnp.where(survive_child, par, n_parents)
    bits = jnp.where(survive_child, jnp.int32(1) << slot, 0)
    vm = jax.ops.segment_sum(bits, sid,
                             num_segments=n_parents + 1)[:n_parents]
    return vm


@partial(jax.jit, static_argnames=("n_parents",))
def _first_child(par, child_vals, active, n_parents):
    """Per-parent first (minimum) child value over active children; 0 where
    a parent has none (matches the host builder's zeros)."""
    sid = jnp.where(active, par, n_parents)
    big = jnp.int32(2**31 - 1)
    fb = jax.ops.segment_min(jnp.where(active, child_vals, big), sid,
                             num_segments=n_parents + 1)[:n_parents]
    return jnp.where(fb == big, 0, fb)


def build_svo_device(scene, depth: int, verbose: bool = False,
                     root_level: int = 0,
                     root_coord=(0, 0, 0)) -> SVO:
    """Build a packed SVO on the device. Bit-identical structure and
    attributes to build_svo(scene, depth) (tested); arrays stay on device.

    Per level, only one scalar (the surviving-candidate count) crosses the
    host link. Scene evals happen on the accelerator.

    root_level/root_coord build the SUBTREE rooted at that world octant
    (integer coords at root_level) down to world level `depth`: the octant's
    dyadic corner makes every child center/probe position bit-identical to
    the monolithic build's, so per-octant builds merge into exactly the
    monolithic structure (build_svo_device_split). The returned SVO has
    depth == depth - root_level; leaf attributes are evaluated at WORLD
    coordinates.
    """
    sub_depth = depth - root_level
    if sub_depth < 1:
        raise ValueError("depth must be >= root_level + 1")
    L = float(scene.lipschitz)
    i32 = jnp.int32

    # ---- Phase A: downward frontier sweep (device); list index k is the
    # SUB level (world level root_level + k) ------------------------------
    coords = [jnp.asarray([root_coord], i32)]
    pars = [jnp.zeros((1,), i32)]
    slots = [jnp.zeros((1,), i32)]
    valid_n = [1]
    f_fin = None
    import time as _time
    for k in range(1, sub_depth + 1):
        t0 = _time.time()
        valid_prev = (pars[k - 1] >= 0 if k > 1
                      else jnp.ones((1,), bool))
        cc, par, slot, fv, n = _expand_level(coords[k - 1], valid_prev,
                                             scene, root_level + k, depth, L)
        del valid_prev
        if verbose:
            print(f"# build level {root_level + k}: {n} candidates "
                  f"({_time.time() - t0:.1f}s)", flush=True)
        coords.append(cc)
        pars.append(par)
        slots.append(slot)
        valid_n.append(n)
        if k == sub_depth:
            f_fin = fv
        if k >= 2:
            # phase C needs only par/slot per level; freeing parent coords
            # halves peak HBM on deep builds
            coords[k - 1] = None

    # ---- Phase B: leaf test (chunked at large frontiers) ----------------
    survive = [None] * (sub_depth + 1)
    fin_cap = coords[sub_depth].shape[0]
    chunk_b = CHUNK_PARENTS * 2
    if fin_cap <= chunk_b:
        survive[sub_depth] = _leaf_test(coords[sub_depth], pars[sub_depth],
                                        f_fin, scene=scene, depth=depth)
    else:
        parts = [
            _leaf_test(coords[sub_depth][c:c + chunk_b],
                       pars[sub_depth][c:c + chunk_b],
                       f_fin[c:c + chunk_b], scene=scene, depth=depth)
            for c in range(0, fin_cap, chunk_b)
        ]
        survive[sub_depth] = jnp.concatenate(parts)

    # ---- Phase C: upward pruning + assembly -----------------------------
    valid_masks = [None] * sub_depth
    for k in range(sub_depth - 1, -1, -1):
        n_par = pars[k].shape[0]
        vm = _level_up(pars[k + 1], slots[k + 1], survive[k + 1], n_par)
        valid_masks[k] = vm
        sv = vm != 0
        if k == 0:
            sv = sv | (jnp.arange(n_par) == 0)  # root always survives
        survive[k] = sv

    level_counts = [int(jnp.sum(survive[k])) for k in range(sub_depth)]
    n_leaves = int(jnp.sum(survive[sub_depth]))
    level_start = np.zeros(sub_depth + 1, np.int64)
    np.cumsum(level_counts, out=level_start[1:])
    n_nodes = int(level_start[-1])

    new_idx = [jnp.cumsum(survive[k].astype(i32)) - 1
               for k in range(sub_depth)]
    leaf_idx = jnp.cumsum(survive[sub_depth].astype(i32)) - 1

    masks_parts = []
    child_parts = []
    leaf_parts = []
    for k in range(sub_depth):
        s = survive[k]
        cnt = level_counts[k]
        rows = jnp.flatnonzero(s, size=max(cnt, 1), fill_value=0)
        vm = jnp.take(valid_masks[k], rows)
        if k == sub_depth - 1:
            m = (vm << 8) | vm
            fb = _first_child(pars[sub_depth], leaf_idx, survive[sub_depth],
                              pars[k].shape[0])
            cb = jnp.zeros_like(vm)
            lb = jnp.take(fb, rows)
        else:
            m = vm << 8
            fb = _first_child(
                pars[k + 1],
                jnp.int32(level_start[k + 1]) + new_idx[k + 1],
                survive[k + 1], pars[k].shape[0])
            cb = jnp.take(fb, rows)
            lb = jnp.zeros_like(vm)
        if cnt == 0:
            m, cb, lb = m[:0], cb[:0], lb[:0]
        masks_parts.append(m)
        child_parts.append(cb)
        leaf_parts.append(lb)
    masks = jnp.concatenate(masks_parts)
    child_base = jnp.concatenate(child_parts)
    leaf_base = jnp.concatenate(leaf_parts)

    # ---- Phase D: leaf attributes (WORLD coordinates) -------------------
    lrows = jnp.flatnonzero(survive[sub_depth], size=max(n_leaves, 1),
                            fill_value=0)
    lcc = jnp.take(coords[sub_depth], lrows, axis=0)
    albedo, normal = _leaf_attrs(lcc, scene=scene, depth=depth)
    if n_leaves == 0:
        albedo, normal = albedo[:0], normal[:0]
    density = jnp.ones(n_leaves, jnp.float32)

    pptr = derive_parent_ptr_device(masks, child_base)
    return SVO(
        masks=masks, child_base=child_base, leaf_base=leaf_base,
        leaf_albedo=albedo, leaf_normal=normal, leaf_density=density,
        depth=sub_depth, level_start=tuple(int(v) for v in level_start),
        parent_ptr=pptr,
    )


@partial(jax.jit, static_argnames=("scene", "depth"))
def _leaf_attrs(lcc, *, scene, depth):
    f32 = jnp.float32
    fin = f32(2.0 ** -depth)
    px = (lcc[:, 0].astype(f32) + f32(0.5)) * fin
    py = (lcc[:, 1].astype(f32) + f32(0.5)) * fin
    pz = (lcc[:, 2].astype(f32) + f32(0.5)) * fin
    albedo = default_albedo(px, py, pz, xp=jnp).astype(f32)
    h = 1e-3
    fx = scene(px + h, py, pz, xp=jnp) - scene(px - h, py, pz, xp=jnp)
    fy = scene(px, py + h, pz, xp=jnp) - scene(px, py - h, pz, xp=jnp)
    fz = scene(px, py, pz + h, xp=jnp) - scene(px, py, pz - h, xp=jnp)
    nv = jnp.stack([fx, fy, fz], axis=-1)
    norm = jnp.sqrt(jnp.sum(nv * nv, axis=-1, keepdims=True))
    normal = (nv / jnp.maximum(norm, 1e-12)).astype(f32)
    return albedo, normal


@jax.jit
def derive_parent_ptr_device(masks, child_base):
    """Device twin of octree.compute_parent_ptr (scatter + running max)."""
    n = masks.shape[0]
    vm = (masks >> 8) & 0xFF
    lm = masks & 0xFF
    has = ((vm & ~lm) & 0xFF) != 0
    tgt = jnp.where(has, child_base, n)
    seed = jnp.zeros(n + 1, jnp.int32).at[tgt].max(
        jnp.arange(n, dtype=jnp.int32), mode="drop")[:n]
    return jax.lax.associative_scan(jnp.maximum, seed)


def _compact3(v):
    """Extract every 3rd bit (morton decode helper, <= 10 bits/axis)."""
    v &= 0x9249249
    v = (v | (v >> 2)) & 0x30C30C3
    v = (v | (v >> 4)) & 0x300F00F
    v = (v | (v >> 8)) & 0x30000FF
    return (v | (v >> 16)) & 0x3FF


def build_svo_device_split(scene, depth: int, split_level: int = 2,
                           verbose: bool = False) -> SVO:
    """Config-5-scale device build: one bounded, REUSED program set.

    The monolithic depth-12 build needs one phase-C program over a
    ~200M-candidate frontier, which compiles very slowly and needs the
    whole frontier in device memory at once. Here the world is split into
    8^split_level octants and each octant's subtree is built independently with build_svo_device
    (root_level/root_coord): every octant hits the SAME power-of-two bucket
    shapes, so programs compile once and run 8^split times. Octant corners
    are dyadic, so per-octant child centers / probes / attribute positions
    are bit-identical to the monolithic build's — the merged SVO equals
    build_svo_device(scene, depth) exactly (tested).

    This is also the per-device build shape of the level-sharded config
    (parallel/level_sharded.py): at scale each device builds its own
    octants and keeps them as its arena shard.
    """
    if split_level < 1 or depth <= split_level:
        raise ValueError("need 1 <= split_level < depth")
    i32 = jnp.int32
    n_oct = 8 ** split_level
    sub_depth = depth - split_level

    subs = {}
    for o in range(n_oct):                      # morton order
        cx = int(_compact3(o))
        cy = int(_compact3(o >> 1))
        cz = int(_compact3(o >> 2))
        sub = build_svo_device(scene, depth, verbose=verbose,
                               root_level=split_level,
                               root_coord=(cx, cy, cz))
        if sub.n_leaves > 0:
            # pull the octant to host right away: the merge below runs in
            # numpy (see the host-merge note at the merge section)
            subs[o] = jax.tree_util.tree_map(np.asarray, sub)
        if verbose:
            print(f"# octant {o}: {sub.n_nodes} nodes "
                  f"{sub.n_leaves} leaves", flush=True)

    # ---- top levels 0..split_level-1 over octant occupancy (host; tiny) --
    occ = [None] * (split_level + 1)
    occ[split_level] = np.zeros(n_oct, bool)
    for o in subs:
        occ[split_level][o] = True
    for t in range(split_level - 1, -1, -1):
        occ[t] = occ[t + 1].reshape(-1, 8).any(axis=1)

    top_masks, top_child = [], []
    counts_top = [int(occ[t].sum()) for t in range(split_level + 1)]
    # merged level starts: top levels, then per-sub-level totals
    lvl_counts = counts_top[:split_level] + [
        sum(int(sub.level_start[k + 1] - sub.level_start[k])
            for sub in subs.values())
        for k in range(sub_depth)]
    level_start = np.zeros(depth + 1, np.int64)
    np.cumsum(lvl_counts, out=level_start[1:])

    for t in range(split_level):
        cells = np.flatnonzero(occ[t])
        child_occ = occ[t + 1].reshape(-1, 8)
        vm = np.zeros(len(cells), np.int32)
        for j, c in enumerate(cells):
            vm[j] = int(np.packbits(child_occ[c], bitorder="little")[0])
        # first-child rows: children are packed morton parent-major at the
        # next level, so a prefix count over occupied cells gives the base
        child_prefix = np.concatenate(
            [[0], np.cumsum(child_occ.sum(axis=1))])[cells]
        top_masks.append(vm << 8)
        top_child.append((level_start[t + 1] + child_prefix).astype(np.int32))
    if not subs:                                 # empty world: root only
        top_masks = [np.zeros(1, np.int32)]
        top_child = [np.zeros(1, np.int32)]
        level_start[:] = 0
        level_start[1:] = 1

    # ---- merge sub levels with pointer rebasing (host numpy) ------------
    # (a ~640-operand device concatenate compiles very slowly — the same
    # compile-wall class this function exists to avoid; at true config-5
    # scale octants stay sharded per-device via split_svo and never merge
    # anyway, so the host merge is the single-device convenience path)
    masks_parts = list(top_masks)
    child_parts = list(top_child)
    leaf_parts = [np.zeros(sum(counts_top[:split_level]), np.int32)]
    # per-octant prefixes per sub level and for leaves
    order = sorted(subs)
    leaf_prefix = {}
    lvl_prefix = {k: {} for k in range(sub_depth + 1)}
    acc_leaf = 0
    acc_lvl = [0] * (sub_depth + 1)
    for o in order:
        sub = subs[o]
        leaf_prefix[o] = acc_leaf
        acc_leaf += sub.n_leaves
        for k in range(sub_depth):
            lvl_prefix[k][o] = acc_lvl[k]
            acc_lvl[k] += int(sub.level_start[k + 1] - sub.level_start[k])

    leaf_mid_parts = []
    for k in range(sub_depth):
        for o in order:
            sub = subs[o]
            lo, hi = int(sub.level_start[k]), int(sub.level_start[k + 1])
            m = sub.masks[lo:hi]
            cb = sub.child_base[lo:hi]
            lb = sub.leaf_base[lo:hi]
            has_child = ((m >> 8) & ~m & 0xFF) != 0
            has_leaf = (m & 0xFF) != 0
            if k < sub_depth - 1:
                cb = np.where(
                    has_child,
                    cb - int(sub.level_start[k + 1])
                    + int(level_start[split_level + k + 1])
                    + lvl_prefix[k + 1][o], 0).astype(np.int32)
            else:
                cb = np.zeros_like(cb)
            lb = np.where(has_leaf, lb + leaf_prefix[o], 0).astype(np.int32)
            masks_parts.append(m)
            child_parts.append(cb)
            leaf_mid_parts.append(lb)
    masks = np.concatenate(masks_parts).astype(np.int32)
    child_base = np.concatenate(child_parts).astype(np.int32)
    leaf_base = np.concatenate(leaf_parts + leaf_mid_parts).astype(np.int32)

    if subs:
        albedo = np.concatenate([subs[o].leaf_albedo for o in order])
        normal = np.concatenate([subs[o].leaf_normal for o in order])
    else:
        albedo = np.zeros((0, 3), np.float32)
        normal = np.zeros((0, 3), np.float32)
    density = np.ones(acc_leaf if subs else 0, np.float32)

    from raytracingtest_tpu.ops.octree import compute_parent_ptr
    pptr = compute_parent_ptr(masks, child_base)
    return SVO(
        masks=masks, child_base=child_base, leaf_base=leaf_base,
        leaf_albedo=albedo, leaf_normal=normal, leaf_density=density,
        depth=depth, level_start=tuple(int(v) for v in level_start),
        parent_ptr=pptr,
    )
