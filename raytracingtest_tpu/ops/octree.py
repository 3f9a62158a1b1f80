"""SVO data model + hierarchical builder (pointer-free, breadth-first, vectorized).

Replaces the reference's recursive pointer-tree construction
(Assets/Scripts/SVO/CompactSVO/NaiveCreator.cs:52-193) with an array
design: the octree is a struct-of-arrays over *levels*, built by a frontier
sweep of vectorized per-level passes instead of 8^depth scalar recursion.

Canonical node layout (SURVEY.md §7.3.8 — one layout, absolute pointers):

  masks[i]      int32  (valid_mask << 8) | leaf_mask   — same 8+8 mask split as
                        the ESVO child descriptor (NaiveCreator.cs:184-187,
                        Trace.cu), but the 16-bit *relative* child pointer is
                        replaced by two absolute int32 indices:
  child_base[i] int32  flat node index of this node's first non-leaf child
  leaf_base[i]  int32  index of this node's first leaf child in the leaf
                        attribute arrays

Children are packed contiguously in Morton child order (x fastest — the
reference's `vfoffsets`, Constants.cs:23-26); a specific child is found with
popcount-rank exactly as in ESVO:

  node_child  k: child_base[i] + popcount(valid & ~leaf & ((1<<k)-1))
  leaf_child  k: leaf_base[i]  + popcount(valid &  leaf & ((1<<k)-1))

Build semantics match the reference (NaiveCreator.cs:52-130): a finest-level
voxel is a leaf iff sample(center) <= 0 AND it has at least one of its six
axis neighbors (probed at one voxel-size distance) with sample > 0; interior
nodes exist iff their subtree contains a leaf; leaf normals are
central-difference gradients of the sampler; leaf colors are position-derived
(the reference's SinColor palette, Misc.cs:120-126).

Scaling: instead of visiting all 8^depth cells, the downward sweep prunes
octants using the scene's Lipschitz bound — an octant is kept only if the
surface *can* pass within it (|f(center)| small enough). This keeps the
frontier O(surface area * 4^level) and makes depth 10-12 tractable.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any

import numpy as np

import jax
import jax.numpy as jnp

_SQRT3 = float(np.sqrt(3.0))

# Morton child order: slot k -> offset ((k>>0)&1, (k>>1)&1, (k>>2)&1).
CHILD_OFFSETS = np.array(
    [[(k >> 0) & 1, (k >> 1) & 1, (k >> 2) & 1] for k in range(8)], dtype=np.int32
)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SVO:
    """Packed sparse voxel octree as a JAX pytree.

    Array fields are data (device arrays under jit); depth and counts are
    static metadata. The root node is index 0; level l's nodes occupy
    [level_start[l], level_start[l+1]) for l in 0..depth-1. Leaves carry no
    descriptors — only attribute rows.
    """

    masks: Any        # int32 [n_nodes]   (valid<<8)|leaf
    child_base: Any   # int32 [n_nodes]
    leaf_base: Any    # int32 [n_nodes]
    leaf_albedo: Any  # float32 [n_leaves, 3]
    leaf_normal: Any  # float32 [n_leaves, 3]  unit outward normals
    leaf_density: Any  # float32 [n_leaves]    for volumetric/diff rendering
    depth: int = dataclasses.field(metadata=dict(static=True))
    level_start: tuple = dataclasses.field(metadata=dict(static=True))
    # int32 [n_nodes] row of each node's parent (root -> itself). Used by the
    # stackless traversal's one-level POP; derivable from masks/child_base
    # (compute_parent_ptr) so it is optional on construction.
    parent_ptr: Any = None

    @property
    def n_nodes(self) -> int:
        return int(self.level_start[-1])

    @property
    def n_leaves(self) -> int:
        return self.leaf_albedo.shape[0]

    def device(self) -> "SVO":
        """Move arrays to jnp (device) arrays."""
        pptr = self.parent_ptr
        if pptr is None:
            pptr = compute_parent_ptr(np.asarray(self.masks),
                                      np.asarray(self.child_base))
        return SVO(
            masks=jnp.asarray(self.masks),
            child_base=jnp.asarray(self.child_base),
            leaf_base=jnp.asarray(self.leaf_base),
            leaf_albedo=jnp.asarray(self.leaf_albedo),
            leaf_normal=jnp.asarray(self.leaf_normal),
            leaf_density=jnp.asarray(self.leaf_density),
            depth=self.depth,
            level_start=self.level_start,
            parent_ptr=jnp.asarray(pptr),
        )

    def with_parent_ptr(self) -> "SVO":
        """Host-side copy with parent_ptr filled in (no-op if present)."""
        if self.parent_ptr is not None:
            return self
        return dataclasses.replace(
            self, parent_ptr=compute_parent_ptr(
                np.asarray(self.masks), np.asarray(self.child_base)))


@dataclasses.dataclass
class BuildResult:
    """Builder output: the SVO plus host-side debris useful for tests/IO.

    frontier_coords is the finest-level *candidate* set (post Lipschitz
    pruning, pre leaf test) — the slice pipeline (stream/slices.py) refines
    it so an incremental extend reproduces a fresh deeper build exactly.
    """

    svo: SVO
    leaf_coords: np.ndarray  # int32 [n_leaves, 3] finest-grid integer coords
    node_coords: list        # per level: int32 [n_l, 3] octant coords
    n_candidates: list       # per level candidate counts (pre-prune), for stats
    frontier_coords: np.ndarray = None  # int32 [n_cand, 3] finest candidates


def default_albedo(px, py, pz, xp=np):
    """Position-derived rainbow palette (reference SinColor, Misc.cs:120-126)."""
    px = xp.asarray(px, xp.float32)
    py = xp.asarray(py, xp.float32)
    pz = xp.asarray(pz, xp.float32)
    t = px * 3.1 + py * 5.3 + pz * 7.9
    r = 0.5 + 0.5 * xp.sin(6.0 * t)
    g = 0.5 + 0.5 * xp.sin(6.0 * t + 2.094)
    b = 0.5 + 0.5 * xp.sin(6.0 * t + 4.188)
    return xp.stack([r, g, b], axis=-1)


def sampler_normal(scene, px, py, pz, h=1e-3, xp=np):
    """Central-difference gradient normal (reference NaiveCreator.cs:58-63,
    which uses one-sided differences at h=0.001; central is strictly better)."""
    fx = scene(px + h, py, pz, xp=xp) - scene(px - h, py, pz, xp=xp)
    fy = scene(px, py + h, pz, xp=xp) - scene(px, py - h, pz, xp=xp)
    fz = scene(px, py, pz + h, xp=xp) - scene(px, py, pz - h, xp=xp)
    n = xp.stack([fx, fy, fz], axis=-1)
    norm = xp.sqrt(xp.sum(n * n, axis=-1, keepdims=True))
    return n / xp.maximum(norm, 1e-12)


def compute_parent_ptr(masks, child_base):
    """Derive each node row's parent row (root/orphan rows point at the last
    preceding parent, root at itself).

    Relies on the canonical layout invariant that child blocks are contiguous
    and ordered by parent row (true for the breadth-first builder and for each
    sub-block of a streaming arena): scatter each parent id at its block start
    and forward-fill with a running maximum.
    """
    masks = np.asarray(masks)
    child_base = np.asarray(child_base)
    n = masks.shape[0]
    vm = (masks >> 8) & 0xFF
    lm = masks & 0xFF
    nl = (vm & ~lm) & 0xFF
    has = nl != 0  # has at least one non-leaf child
    seed = np.zeros(n, np.int32)
    seed[child_base[has]] = np.arange(n, dtype=np.int32)[has]
    return np.maximum.accumulate(seed).astype(np.int32)


def _sorted_unique(par):
    """(unique values, first-occurrence starts) of an already-sorted array —
    O(n), unlike np.unique which re-sorts."""
    starts = np.concatenate(
        [np.zeros(1, np.int64), np.flatnonzero(par[1:] != par[:-1]) + 1])
    return par[starts], starts


def build_from_leaves(leaf_coords, depth: int, albedo=None, normal=None,
                      density=None) -> SVO:
    """Bottom-up Morton builder: packed SVO directly from finest-level leaf
    coordinates — no sampler, no top-down recursion.

    The vectorized redesign of the reference's disabled streaming builder
    (Utility/Old/SVOCreatorMorton.cs.disabled: leaves enumerated in Morton
    order, parents emitted as 8-child groups complete, pointers fixed up in
    a second pass): here each level is ONE unique-prefix pass over sorted
    Morton codes, which reproduces the canonical breadth-first layout of
    build_svo bit-for-bit (tested). Useful for building from point clouds /
    fit outputs and as the slice pipeline's batch form.

    Attribute arrays (n_leaves,*) are reordered to Morton leaf order; when
    omitted, albedo falls back to the position palette, normal to +y, and
    density to 1.
    """
    from raytracingtest_tpu.ops.morton import morton_encode64

    leaf_coords = np.asarray(leaf_coords, np.int64)
    n_in = leaf_coords.shape[0]
    if depth < 1:
        raise ValueError("depth must be >= 1")
    if n_in and int(leaf_coords.max()) >= (1 << depth):
        raise ValueError("leaf coordinate out of range for depth")

    code = morton_encode64(leaf_coords[:, 0], leaf_coords[:, 1],
                           leaf_coords[:, 2])
    order = np.argsort(code, kind="stable")
    code = code[order]
    if n_in and np.any(code[1:] == code[:-1]):
        raise ValueError("duplicate leaf coordinates")

    # per-level sorted node codes, bottom-up: level l nodes = unique
    # (leaf_code >> 3*(depth-l))
    codes = [None] * (depth + 1)
    codes[depth] = code
    for l in range(depth - 1, -1, -1):
        parent = codes[l + 1] >> 3
        keep = np.ones(parent.shape[0], bool)
        keep[1:] = parent[1:] != parent[:-1]
        codes[l] = parent[keep]
    if codes[0].shape[0] == 0:
        codes[0] = np.zeros(1, np.int64)  # keep an (empty) root

    level_counts = [c.shape[0] for c in codes[:depth]]
    level_start = np.zeros(depth + 1, np.int64)
    np.cumsum(level_counts, out=level_start[1:])
    n_nodes = int(level_start[-1])
    masks = np.zeros(n_nodes, np.int32)
    child_base = np.zeros(n_nodes, np.int32)
    leaf_base = np.zeros(n_nodes, np.int32)

    for l in range(depth):
        child = codes[l + 1]
        if child.shape[0] == 0:
            continue
        parent = child >> 3
        first = np.ones(child.shape[0], bool)
        first[1:] = parent[1:] != parent[:-1]
        starts = np.flatnonzero(first)
        rows = level_start[l] + np.arange(codes[l].shape[0])
        bits = (np.int32(1) << (child & 7).astype(np.int32))
        vm = np.bitwise_or.reduceat(bits, starts)
        if l == depth - 1:
            masks[rows] = (vm << 8) | vm
            leaf_base[rows] = starts.astype(np.int32)
        else:
            masks[rows] = vm << 8
            child_base[rows] = (level_start[l + 1] + starts).astype(np.int32)

    n_leaves = n_in
    lc = leaf_coords[order]
    fin = np.float32(2.0 ** (-depth))
    px = (lc[:, 0].astype(np.float32) + 0.5) * fin
    py = (lc[:, 1].astype(np.float32) + 0.5) * fin
    pz = (lc[:, 2].astype(np.float32) + 0.5) * fin
    if albedo is not None:
        alb = np.asarray(albedo, np.float32)[order]
    else:
        alb = default_albedo(px, py, pz, xp=np).astype(np.float32)
    if normal is not None:
        nrm = np.asarray(normal, np.float32)[order]
    else:
        nrm = np.tile(np.array([[0.0, 1.0, 0.0]], np.float32), (n_leaves, 1))
    den = (np.asarray(density, np.float32)[order] if density is not None
           else np.ones(n_leaves, np.float32))

    return SVO(
        masks=masks, child_base=child_base, leaf_base=leaf_base,
        leaf_albedo=alb, leaf_normal=nrm, leaf_density=den,
        depth=depth, level_start=tuple(int(v) for v in level_start),
        parent_ptr=compute_parent_ptr(masks, child_base),
    )


def build_svo(scene, depth: int, prune: bool = True,
              attr_frame=None) -> BuildResult:
    """Build a packed SVO from a signed-density scene.

    Host-side (numpy) frontier build; per-level passes are fully vectorized.
    With prune=True uses the scene's Lipschitz bound to skip empty/deep-solid
    octants; with prune=False expands every octant (exact, 8^depth work —
    use only for small depths in tests).

    attr_frame=(world_scene, origin, size): when `scene` is a chunk-local
    rescale of a larger world (stream/clipmap._chunk_scene), evaluate leaf
    ATTRIBUTES (position palette + gradient normals) in world coordinates so
    streamed chunks are attribute-identical to a monolithic world build.
    """
    if depth < 1:
        raise ValueError("depth must be >= 1")
    L = float(scene.lipschitz)
    finest = 2.0 ** (-depth)

    # ---- Phase A: downward frontier sweep -------------------------------
    # coords[l]: int32 [n_l, 3] candidate octant coords at level l (Morton-
    # sorted); parent_of[l]: index into coords[l-1]; slot_of[l]: child slot.
    coords = [np.zeros((1, 3), np.int32)]
    parent_of = [np.zeros((1,), np.int64)]
    slot_of = [np.zeros((1,), np.int32)]
    n_candidates = [1]
    f_finest = None  # finest-level f(center) values, reused by phase B

    for l in range(1, depth + 1):
        p = coords[l - 1]
        n_p = p.shape[0]
        # expand: children in Morton child order, parent-major
        cc = (p[:, None, :] * 2 + CHILD_OFFSETS[None, :, :]).reshape(-1, 3)
        if prune:
            half = 2.0 ** (-(l + 1))
            # float32 is exact here: coords < 2^depth <= 2^12, and
            # (c + 0.5) * 2^-l is a dyadic rational well inside f32 range
            scale_l = np.float32(2.0 ** (-l))
            px = (cc[:, 0].astype(np.float32) + np.float32(0.5)) * scale_l
            py = (cc[:, 1].astype(np.float32) + np.float32(0.5)) * scale_l
            pz = (cc[:, 2].astype(np.float32) + np.float32(0.5)) * scale_l
            f = np.asarray(scene(px, py, pz, xp=np), np.float32)
            # Octant can contain a solid voxel center: f(center) <= L*r
            # Octant can contain a voxel with an air neighbor (neighbor probe
            # reaches one voxel size outside): f(center) >= -L*(r + 2*finest)
            r = _SQRT3 * half
            keep = (f <= L * r + 1e-6) & (f >= -(L * (r + 2.0 * finest)) - 1e-6)
            # parent index / child slot recovered from the kept flat positions
            # (children are parent-major, 8 per parent) — avoids materializing
            # full pre-prune repeat/tile arrays
            kept = np.nonzero(keep)[0]
            cc = cc[kept]
            par = kept >> 3
            slot = (kept & 7).astype(np.int32)
            if l == depth:
                f_finest = f[kept]  # same points phase B needs — don't re-eval
        else:
            par = np.repeat(np.arange(n_p, dtype=np.int64), 8)
            slot = np.tile(np.arange(8, dtype=np.int32), n_p)
        coords.append(cc)
        parent_of.append(par)
        slot_of.append(slot)
        n_candidates.append(cc.shape[0])

    # ---- Phase B: exact leaf test at the finest level -------------------
    cc = coords[depth]
    fin32 = np.float32(finest)
    px = (cc[:, 0].astype(np.float32) + np.float32(0.5)) * fin32
    py = (cc[:, 1].astype(np.float32) + np.float32(0.5)) * fin32
    pz = (cc[:, 2].astype(np.float32) + np.float32(0.5)) * fin32
    if f_finest is not None:
        f0 = f_finest
    else:
        f0 = np.asarray(scene(px, py, pz, xp=np), np.float32)
    solid = f0 <= 0.0
    # six-neighbor air probe at one voxel-size distance
    # (reference IsEdge, NaiveCreator.cs:121-130). Only solid voxels can be
    # leaves, so probe just those, and in ONE batched scene call (the native
    # threaded sampler amortizes far better over one big batch).
    survive_leaf = np.zeros_like(solid)
    si = np.nonzero(solid)[0]
    if si.size:
        sx, sy, sz = px[si], py[si], pz[si]
        m = si.size
        qx = np.empty(6 * m, np.float32)
        qy = np.empty(6 * m, np.float32)
        qz = np.empty(6 * m, np.float32)
        k = 0
        for ax, sgn in ((0, fin32), (0, -fin32), (1, fin32), (1, -fin32),
                        (2, fin32), (2, -fin32)):
            off = [sx, sy, sz]
            off[ax] = off[ax] + sgn
            qx[k * m:(k + 1) * m] = off[0]
            qy[k * m:(k + 1) * m] = off[1]
            qz[k * m:(k + 1) * m] = off[2]
            k += 1
        fq = np.asarray(scene(qx, qy, qz, xp=np), np.float32)
        air = (fq.reshape(6, m) > 0.0).any(axis=0)
        survive_leaf[si] = air

    # ---- Phase C: upward pruning + mask/pointer assembly ----------------
    # survive[l]: bool over candidates at level l; masks assembled per level.
    # parent_of[l] is non-decreasing (children emitted parent-major), so the
    # per-parent scatters reduce to sorted-segment ops (np.ufunc.at is ~50x
    # slower than reduceat on these sizes).
    survive = [None] * (depth + 1)
    survive[depth] = survive_leaf
    valid_masks = [None] * depth  # for node levels 0..depth-1
    for l in range(depth - 1, -1, -1):
        n_c = coords[l].shape[0]
        vm = np.zeros(n_c, np.int32)
        s_child = survive[l + 1]
        par = parent_of[l + 1][s_child]
        bits = np.int32(1) << slot_of[l + 1][s_child]
        if par.size:
            upar, starts = _sorted_unique(par)
            vm[upar] = np.bitwise_or.reduceat(bits, starts)
        valid_masks[l] = vm
        survive[l] = vm != 0
    # Always keep the root (possibly with an empty valid mask) so traversal
    # has a well-formed entry point even for empty scenes.
    survive[0][0] = True

    # Compact per-level node indices.
    new_idx = [None] * (depth + 1)
    level_counts = []
    for l in range(depth):
        s = survive[l]
        ni = np.cumsum(s, dtype=np.int64) - 1
        new_idx[l] = ni
        level_counts.append(int(s.sum()))
    # leaf indices at finest level
    s = survive[depth]
    leaf_idx = np.cumsum(s, dtype=np.int64) - 1
    n_leaves = int(s.sum())

    level_start = np.zeros(depth + 1, np.int64)
    np.cumsum(level_counts, out=level_start[1:])

    n_nodes = int(level_start[-1])
    masks = np.zeros(n_nodes, np.int32)
    child_base = np.zeros(n_nodes, np.int32)
    leaf_base = np.zeros(n_nodes, np.int32)
    node_coords = []

    def _first_child_per_parent(n_parents, par, vals):
        # par sorted non-decreasing, vals increasing in candidate order -> the
        # per-parent minimum is the value at each parent's first occurrence
        fb = np.zeros(n_parents, np.int64)
        if par.size:
            upar, starts = _sorted_unique(par)
            fb[upar] = vals[starts]
        return fb

    for l in range(depth):
        s = survive[l]
        rows = level_start[l] + new_idx[l][s]
        vm = valid_masks[l][s]
        node_coords.append(coords[l][s])
        if l == depth - 1:
            # all children are leaves
            masks[rows] = (vm << 8) | vm
            # first leaf child's index in the global leaf array
            sc = survive[depth]
            fb = _first_child_per_parent(
                coords[l].shape[0], parent_of[depth][sc], leaf_idx[sc])
            leaf_base[rows] = fb[s].astype(np.int32)
        else:
            masks[rows] = vm << 8
            sc = survive[l + 1]
            fb = _first_child_per_parent(
                coords[l].shape[0], parent_of[l + 1][sc],
                level_start[l + 1] + new_idx[l + 1][sc])
            child_base[rows] = fb[s].astype(np.int32)

    # ---- Leaf attributes -------------------------------------------------
    sl = survive[depth]
    leaf_cc = cc[sl]
    lpx, lpy, lpz = px[sl], py[sl], pz[sl]
    if attr_frame is not None:
        wscene, worg, wsize = attr_frame
        wpx = lpx * np.float32(wsize) + np.float32(worg[0])
        wpy = lpy * np.float32(wsize) + np.float32(worg[1])
        wpz = lpz * np.float32(wsize) + np.float32(worg[2])
        albedo = default_albedo(wpx, wpy, wpz, xp=np).astype(np.float32)
        normal = sampler_normal(wscene, wpx, wpy, wpz, xp=np).astype(
            np.float32)
    else:
        albedo = default_albedo(lpx, lpy, lpz, xp=np).astype(np.float32)
        normal = sampler_normal(scene, lpx, lpy, lpz, xp=np).astype(
            np.float32)
    density = np.ones(n_leaves, np.float32)

    svo = SVO(
        masks=masks,
        child_base=child_base,
        leaf_base=leaf_base,
        leaf_albedo=albedo,
        leaf_normal=normal,
        leaf_density=density,
        depth=depth,
        level_start=tuple(int(v) for v in level_start),
        parent_ptr=compute_parent_ptr(masks, child_base),
    )
    return BuildResult(
        svo=svo,
        leaf_coords=leaf_cc.astype(np.int32),
        node_coords=node_coords,
        n_candidates=n_candidates,
        frontier_coords=cc.astype(np.int32),
    )
