"""Tile-amortized traversal: frustum-shared structure walk + per-ray brick DDA.

The production forward path. It was designed for the original target
(README), where a random row gather cost far more than elementwise work
and loop iterations: per-ray hierarchical traversal (ops/traverse.py,
ops/brick.py) pays one gather per ray per step — ~50-100 rows/ray — so
this path AMORTIZES structure access across coherent rays. Whether that trade still wins on
the H100, which has per-thread loads and caches, is unmeasured (ROADMAP.md,
Speed 2 and Design 3):

  * Rays are grouped into P-pixel camera tiles (default 16x16). Each tile's
    frustum (4 corner-ray planes) walks a dense occupancy-bit mip pyramid of
    the octree ONCE, producing up to K brick candidates in conservative
    front-to-back order. Structure gathers: ~O(tiles x candidates), a ~200x
    reduction vs per-ray walks. One u32 pyramid word holds all 8 children
    of a cell (and 4 sibling groups), so candidate expansion costs ONE
    gather per surviving parent.
  * Candidate selection per level is a value-packed jnp.sort (quantized
    conservative-t | morton code in one int32) — compaction and front-to-
    back ordering in a single sort, no scatters.
  * Per-ray work is dense VPU math on the (tiles, P) layout: one fused
    while_loop per chunk walks each tile's candidate list front-to-back
    with per-tile cursors, running the exact 8^3-brick DDA (ops/brick.py
    semantics, bit-identical hits) against tile-uniform brick words
    (broadcast, no per-ray structure gathers); the hit's leaf rank is
    resolved after the walk with one fat row gather per ray.
  * Every dropped candidate is accounted: per-tile and per-ray conservative
    lower bounds on the t of anything dropped produce an `unresolved` mask;
    trace_tile_exact() re-traces unresolved rays on the per-ray brick path.
    No silent ray loss by construction (VERDICT r02 item 6).

Reference role: this replaces the per-thread megakernel loop of
Assets/Shaders/NVIDIASVO.compute:57-156 + dispatch RaytracingMaster.cs:66-68
with a tile formulation of the same capability (hierarchical empty-space
skipping + leaf DDA), with hits equal to the scalar oracle
(reference/traverse.py) — tested on the CPU; on the H100 chip_smoke.py
compares them.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any

import numpy as np

import jax
import jax.numpy as jnp

from raytracingtest_tpu.ops.traverse import (
    S_MAX, TraceResult, init_state, _f2i, vconst)
from raytracingtest_tpu.ops.brick import (
    BRICK_LEVELS, BrickSVO, make_brick_svo, _popcount32, _spread3, _sel16,
)

_SENTINEL = np.int32(2**31 - 1)

# walker selection: "window" (round-4 per-ray-cursor walker, the default) or
# "lockstep" (round-3 tile-synchronous walker, kept for A/B measurement).
# NOTE: these A/B knobs are read ONCE at module import (they select traced
# program structure, so call-time reads would silently recompile) — set the
# RTT_* env vars BEFORE importing raytracingtest_tpu (ADVICE r04).
import os as _os  # noqa: E402
TILE_WALKER = _os.environ.get("RTT_TILE_WALKER", "window")
TILE_WIN = int(_os.environ.get("RTT_TILE_WIN", "4"))
TILE_LOADS = int(_os.environ.get("RTT_TILE_LOADS", "2"))
TILE_SKIPS = int(_os.environ.get("RTT_TILE_SKIPS", "3"))
# fallback-walk window: fb lists run to fb_k=256 candidates, so the walker
# there is load-trip-bound — wide loads cut its trip count ~4x
FB_WIN = int(_os.environ.get("RTT_TILE_FB_WIN", "8"))
FB_LOADS = int(_os.environ.get("RTT_TILE_FB_LOADS", "8"))
FB_SKIPS = int(_os.environ.get("RTT_TILE_FB_SKIPS", "6"))


def _walk_chunk(st, codes, ids, t_codes, bricks, depth, top_depth, k_max,
                dda_unroll=6, win=None, loads=None, skips=None):
    """Dispatch to the selected walker; returns (hit_leaf, hit_t, iters,
    unfin) with unfin the backstop-bail mask (always False for lockstep).
    win/loads/skips default to the module knobs; call sites with long
    candidate lists (the enlarged-K fallback re-walk) pass wider values —
    a k-candidate tile needs ceil(k/loads) load trips, so at fb_k=256 the
    loads=2 default would make the fallback walk take ~4x the trips."""
    if TILE_WALKER == "lockstep":
        hl, ht, it = _walk_chunk_lockstep(st, codes, ids, t_codes, bricks,
                                          depth, top_depth, k_max,
                                          dda_unroll=dda_unroll)
        return hl, ht, it, jnp.zeros_like(st["miss0"])
    return _walk_chunk_window(st, codes, ids, t_codes, bricks, depth,
                              top_depth, k_max, dda_unroll=dda_unroll,
                              win=win or TILE_WIN, loads=loads or TILE_LOADS,
                              skips=skips or TILE_SKIPS)


# ---------------------------------------------------------------------------
# 3D Morton helpers (vectorized, <= 10 bits/axis, x fastest — the same
# axis-bit convention as the traversal's child idx: bit0=x, bit1=y, bit2=z)
# ---------------------------------------------------------------------------

def spread3_10(x):
    """Spread the low 10 bits of x to every 3rd bit position."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    x = (x | (x << 2)) & 0x9249249
    return x


def compact3_10(x):
    """Inverse of spread3_10 (extract every 3rd bit)."""
    x = x & 0x9249249
    x = (x | (x >> 2)) & 0x30C30C3
    x = (x | (x >> 4)) & 0x300F00F
    x = (x | (x >> 8)) & 0x30000FF
    x = (x | (x >> 16)) & 0x3FF
    return x


def morton3(x, y, z):
    return spread3_10(x) | (spread3_10(y) << 1) | (spread3_10(z) << 2)


def unmorton3(code):
    return compact3_10(code), compact3_10(code >> 1), compact3_10(code >> 2)


def _popcount_np(v):
    v = v.astype(np.uint32)
    v = v - ((v >> 1) & np.uint32(0x55555555))
    v = (v & np.uint32(0x33333333)) + ((v >> 2) & np.uint32(0x33333333))
    v = (v + (v >> 4)) & np.uint32(0x0F0F0F0F)
    return ((v * np.uint32(0x01010101)) >> 24).astype(np.int64)


# ---------------------------------------------------------------------------
# TileSVO: occupancy-bit mip pyramid + brick table
# ---------------------------------------------------------------------------

def _pyr_layout(top_depth):
    """Static (offsets, total_words): level l in 1..top_depth has
    max(1, 8^l/32) words; bit m&31 of word off_l + (m>>5) is morton cell m."""
    offs = [0, 0]  # level 0 unused (root always occupied), level 1 at 0
    words = 0
    for l in range(1, top_depth + 1):
        if l > 1:
            offs.append(offs[-1])
        offs[l] = words
        words += max(1, (8 ** l) // 32)
    return tuple(offs), words


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TileSVO:
    """Brick SVO + dense occupancy pyramid for the tile traversal.

    pyr: uint32 [n_words] — concatenated per-level morton occupancy bits
    (levels 1..top_depth; see _pyr_layout). cellmap: int32 [W_top, 2] —
    per finest-level word: (prefix popcount of occupied cells before this
    word, the word itself); brick id of occupied cell m =
    cellmap[m>>5,0] + popcount(cellmap[m>>5,1] & below-bits) — valid because
    the builder lays level nodes out in global morton order (tested)."""

    bsvo: BrickSVO
    pyr: Any       # uint32 [n_words]
    cellmap: Any   # int32 [W_top, 2]

    @property
    def depth(self):
        return self.bsvo.depth

    @property
    def top_depth(self):
        return self.bsvo.top_depth

    def device(self) -> "TileSVO":
        return TileSVO(bsvo=self.bsvo.device(), pyr=jnp.asarray(self.pyr),
                       cellmap=jnp.asarray(self.cellmap))


def make_tile_svo(svo, bsvo: BrickSVO | None = None) -> TileSVO:
    """Host-side pyramid build from a packed SVO (numpy)."""
    if bsvo is None:
        bsvo = make_brick_svo(svo)
    top_depth = bsvo.top_depth
    if top_depth > 10:
        raise ValueError("tile path supports top_depth <= 10 (depth <= 13)")
    masks = np.asarray(svo.masks)
    child_base = np.asarray(svo.child_base)
    offs, n_words = _pyr_layout(top_depth)
    pyr = np.zeros(n_words, np.uint32)

    from raytracingtest_tpu.ops.brick import _expand_children
    rows = np.zeros(1, np.int64)
    coords = np.zeros((1, 3), np.int64)
    for l in range(1, top_depth + 1):
        rows, pidx, slots = _expand_children(masks, child_base, rows)
        coords = coords[pidx] * 2 + np.stack(
            [slots & 1, (slots >> 1) & 1, (slots >> 2) & 1], axis=1)
        m = morton3(coords[:, 0].astype(np.int64), coords[:, 1].astype(np.int64),
                    coords[:, 2].astype(np.int64))
        # children emerge sorted by (parent-rank, slot) == sorted morton
        np.bitwise_or.at(pyr, offs[l] + (m >> 5),
                         np.uint32(1) << (m & 31).astype(np.uint32))

    # finest level: brick id == morton rank among occupied cells (the
    # builder's parent-major slot-order layout IS global morton order)
    w_top = pyr[offs[top_depth]:]
    pc = _popcount_np(w_top)
    prefix = np.concatenate([[0], np.cumsum(pc)[:-1]]).astype(np.int32)
    assert int(pc.sum()) == bsvo.n_bricks or bsvo.n_bricks == 1, (
        "pyramid occupancy disagrees with brick count")
    cellmap = np.stack([prefix, w_top.astype(np.int32)], axis=1)
    return TileSVO(bsvo=bsvo, pyr=pyr, cellmap=cellmap)


# ---------------------------------------------------------------------------
# camera tiling
# ---------------------------------------------------------------------------

def tile_rays(cam, xp=np, tile_px=16, jitter=None):
    """Tile-major rays for a pinhole camera: (T, P, 3) origins/directions,
    (T, 4, 3) corner directions (tile pixel-boundary corners, cyclic order),
    and the (tiles_y, tiles_x) grid shape. flat_index = tile * P + p maps
    back to row-major pixels via untile_image()."""
    H, W = cam.height, cam.width
    if H % tile_px or W % tile_px:
        raise ValueError(f"resolution {W}x{H} not divisible by tile {tile_px}")
    if cam.ortho_height > 0.0:
        raise ValueError("tile path is pinhole-only; use the brick path")
    o, d = cam.rays(xp, jitter=jitter)
    ty, tx = H // tile_px, W // tile_px
    o = o.reshape(ty, tile_px, tx, tile_px, 3).transpose(0, 2, 1, 3, 4)
    d = d.reshape(ty, tile_px, tx, tile_px, 3).transpose(0, 2, 1, 3, 4)
    o = o.reshape(ty * tx, tile_px * tile_px, 3)
    d = d.reshape(ty * tx, tile_px * tile_px, 3)

    # corner directions at pixel boundaries (jitter stays inside [0,1)px)
    pos, fwd, right, up = cam.basis(np)
    tan_half = float(np.tan(np.radians(cam.fov_y_deg) * 0.5))
    aspect = W / H
    iy = np.arange(ty + 1, dtype=np.float32) * tile_px
    jx = np.arange(tx + 1, dtype=np.float32) * tile_px
    u = jx / W * 2.0 - 1.0
    v = 1.0 - iy / H * 2.0
    cdir = (fwd[None, None] + right[None, None] * (u[None, :, None] * aspect * tan_half)
            + up[None, None] * (v[:, None, None] * tan_half))  # (ty+1, tx+1, 3)
    corners = np.stack([
        cdir[:-1, :-1], cdir[:-1, 1:], cdir[1:, 1:], cdir[1:, :-1],
    ], axis=2).reshape(ty * tx, 4, 3).astype(np.float32)
    return xp.asarray(o), xp.asarray(d), xp.asarray(corners), (ty, tx)


def tile_pixels(img_flat, grid, tile_px=16):
    """Row-major pixels -> tile-major ray order (inverse of untile_image);
    used to reorder target images for the tile-path train step."""
    ty, tx = grid
    c = img_flat.shape[1:]
    x = img_flat.reshape(ty, tile_px, tx, tile_px, *c)
    x = x.transpose(0, 2, 1, 3, *range(4, 4 + len(c)))
    return x.reshape(ty * tx * tile_px * tile_px, *c)


def untile_image(img_flat, grid, tile_px=16):
    """Inverse of tile_rays' pixel ordering: (T*P, C) -> (H*W, C)."""
    ty, tx = grid
    c = img_flat.shape[-1:] if img_flat.ndim > 1 else ()
    x = img_flat.reshape(ty, tx, tile_px, tile_px, *c)
    x = x.transpose(0, 2, 1, 3, *range(4, 4 + len(c)))
    return x.reshape(ty * tile_px * tx * tile_px, *c)


# ---------------------------------------------------------------------------
# phase 1: frustum candidate selection over the pyramid
# ---------------------------------------------------------------------------

def _frustum_planes(corners, apex):
    """(T,4,3) corner dirs -> (T,4,3) inward plane normals through apex."""
    nrm = jnp.cross(corners, jnp.roll(corners, -1, axis=1))
    center = jnp.sum(corners, axis=1, keepdims=True)
    sgn = jnp.sign(jnp.sum(nrm * center, axis=2, keepdims=True))
    return nrm * jnp.where(sgn == 0, 1.0, sgn)


def _candidates(pyr, cellmap, corners, apex, top_depth, caps, k_max):
    """Per-tile brick candidates. Returns (codes (T,K), brick_ids (T,K),
    t_lb (T,K) — conservative per-tile lower bound on any ray's entry t,
    ascending) and drop_t (T,) — lower bound on the t of anything dropped
    (inf when nothing was dropped)."""
    f32, i32 = jnp.float32, jnp.int32
    T = corners.shape[0]
    planes = _frustum_planes(corners, apex)           # (T,4,3)
    fwd = jnp.sum(corners, axis=1)                    # (T,3) central dir
    apex = apex.astype(f32)

    codes = jnp.zeros((T, 1), i32)                    # level-0 root
    drop_t = jnp.full((T,), jnp.inf, f32)

    for l in range(1, top_depth + 1):
        c_prev = codes.shape[1]
        valid_p = codes >= 0
        safe = jnp.where(valid_p, codes, 0)
        # one u32 word holds all 8 children's occupancy bits
        word = jnp.take(pyr, _pyr_layout(top_depth)[0][l] + (safe >> 2),
                        axis=0)                       # (T,C) uint32
        # ALL per-cell math runs on flattened (T, C*8) arrays with one
        # scalar array per axis/plane (on the original target a trailing
        # dim of 3/4/8 wasted most of each vector register; same flop count)
        rep8 = lambda x: jnp.repeat(x, 8, axis=1)     # (T,C) -> (T,W)
        oct8 = jnp.tile(jnp.arange(8, dtype=i32), (1, c_prev))  # (1,W)
        child = rep8(safe * 8) + oct8                 # (T,W)
        shift = (rep8((safe & 3) << 3).astype(jnp.uint32)
                 + oct8.astype(jnp.uint32))
        occ = ((rep8(word) >> shift) & jnp.uint32(1)) != 0
        occ = occ & rep8(valid_p)

        cx, cy, cz = unmorton3(child)
        half = f32(2.0 ** -(l + 1))
        cell = f32(2.0 ** -l)
        rx = (cx.astype(f32) * cell + half) - apex[0]
        ry = (cy.astype(f32) * cell + half) - apex[1]
        rz = (cz.astype(f32) * cell + half) - apex[2]

        # 4 frustum side planes: outside iff dist(center) + r < 0
        pr = jnp.sum(jnp.abs(planes), axis=2) * half  # (T,4)
        in_frustum = occ                              # fold cull chain
        for p in range(4):
            pd = (planes[:, p, 0, None] * rx + planes[:, p, 1, None] * ry
                  + planes[:, p, 2, None] * rz)
            in_frustum = in_frustum & (pd + pr[:, p, None] >= 0)
        # view half-space: box entirely behind apex is out
        fd = (fwd[:, 0, None] * rx + fwd[:, 1, None] * ry
              + fwd[:, 2, None] * rz)
        fr = jnp.sum(jnp.abs(fwd), axis=1)[:, None] * half
        keep = in_frustum & (fd + fr >= 0)

        # conservative entry-t lower bound: euclidean distance from the
        # apex to the box (per-ray entry t >= distance since |d| = 1);
        # tighter than chebyshev, so fewer dropped-candidate false alarms
        # in the unresolved accounting
        ax = jnp.maximum(jnp.abs(rx) - half, 0.0)
        ay = jnp.maximum(jnp.abs(ry) - half, 0.0)
        az = jnp.maximum(jnp.abs(rz) - half, 0.0)
        t_lb = jnp.sqrt(ax * ax + ay * ay + az * az)

        # pack (quantized t | morton code) and sort: compaction + ordering
        code_bits = 3 * l
        qbits = max(0, 30 - code_bits)
        qmax = (1 << qbits) - 2 if qbits else 0
        q = jnp.clip((t_lb * f32((1 << qbits) / 4.0)).astype(i32), 0, qmax)
        val = jnp.where(keep, (q << code_bits) | child, _SENTINEL)
        val = jnp.sort(val, axis=1)

        cap = min(caps[l] if l < len(caps) else caps[-1], 8 ** l)
        if l == top_depth:
            cap = min(k_max, 8 ** l)
        kept = val[:, :cap]
        if cap < c_prev * 8:
            # anything beyond the cap is dropped: record its t lower bound
            nxt = val[:, cap]
            dropped = nxt != _SENTINEL
            t_drop = (nxt >> code_bits).astype(f32) * f32(4.0 / (1 << qbits))
            drop_t = jnp.minimum(drop_t, jnp.where(dropped, t_drop, jnp.inf))
        codes = jnp.where(kept == _SENTINEL, -1, kept & ((1 << code_bits) - 1))
        t_codes = jnp.where(kept == _SENTINEL, jnp.inf,
                            (kept >> code_bits).astype(f32)
                            * f32(4.0 / (1 << qbits)))

    # pad to k_max columns (small trees can produce fewer candidates)
    if codes.shape[1] < k_max:
        padw = k_max - codes.shape[1]
        codes = jnp.concatenate(
            [codes, jnp.full((T, padw), -1, i32)], axis=1)
        t_codes = jnp.concatenate(
            [t_codes, jnp.full((T, padw), jnp.inf, f32)], axis=1)

    # finest level: map codes -> brick ids via morton-rank prefix popcount
    valid = codes >= 0
    safe = jnp.where(valid, codes, 0)
    pw = jnp.take(cellmap, safe >> 5, axis=0)          # (T,K,2)
    below = (jnp.uint32(1) << (safe & 31).astype(jnp.uint32)) - 1
    rank = _popcount32(pw[..., 1].astype(jnp.uint32) & below).astype(i32)
    ids = jnp.where(valid, pw[..., 0] + rank, -1)
    return codes, ids, t_codes, drop_t


# ---------------------------------------------------------------------------
# phase 2: per-candidate tile-uniform resolution
#
# One fused while_loop walks the tile's candidate list front-to-back. Each
# "advance" iteration loads candidate k's brick row for the whole tile (a
# tiny (Tc,17) gather — tile-uniform data broadcasts densely across the
# tile's rays, no per-ray gather), computes each ray's exact box entry, and
# initializes the 8^3 DDA; subsequent iterations run DDA_UNROLL exact DDA
# steps for every ray still walking. Rays terminate when the remaining
# candidates' conservative t lower bound can no longer beat their hit.
# Chunked over tiles to bound the loop-carried state (sized to stay in the
# original target's on-chip memory; the right chunk on the H100 is
# unmeasured, ROADMAP.md Design 3).
# ---------------------------------------------------------------------------

def _mirrored_brick_corner(code, om, top_depth):
    """Mirrored [1,2]-space lower corner of a brick cell. code (...,) i32,
    om (...,) per-ray octant mask; returns (..., 3) f32 (exact dyadic)."""
    s = (1 << top_depth) - 1
    cx, cy, cz = unmorton3(code)
    c = jnp.stack([cx, cy, cz], axis=-1)
    om_bits = jnp.stack([om & 1, (om >> 1) & 1, (om >> 2) & 1], axis=-1)
    m = jnp.where(om_bits == 1, c, s - c)
    return 1.0 + m.astype(jnp.float32) * jnp.float32(2.0 ** -top_depth)


def _sel16b(words, w):
    """Per-lane select words[t, w[t,p]] with words (Tc,16), w (Tc,P):
    binary mux tree on w's 4 bits — 15 selects + 4 bit tests on (Tc,P)
    operands (the 16-way masked-accumulate chain costs 48; a gather-style
    select over (Tc,P,8) slices materializes MBs of intermediates per DDA
    step — this stays in vector registers)."""
    sel = [words[:, j, None] for j in range(16)]
    for k in range(4):
        bit = (w & (1 << k)) != 0
        sel = [jnp.where(bit, sel[2 * j + 1], sel[2 * j])
               for j in range(len(sel) // 2)]
    return sel[0]


def _walk_chunk_window(st, codes, ids, t_codes, bricks, depth, top_depth,
                       k_max, dda_unroll=6, win=4, loads=2, skips=3):
    """Fused candidate walk with PER-RAY cursors and a rotating per-tile
    candidate window (the round-4 forward hot path).

    The lockstep walker (_walk_chunk_lockstep) serializes a tile on every
    candidate: the whole tile waits for its slowest ray's DDA before the
    next candidate loads, so a tile pays (1 load + max-ray DDA rounds) per
    candidate. Here each tile instead streams one candidate per iteration
    into a `win`-slot rotating buffer (win_words holds the brick's 16
    occupancy words, tile-uniform), and every ray walks its OWN cursor
    through the t-ascending list: initialize into candidate `cur` as soon
    as its slot is loaded, run the exact brick DDA, advance `cur` on exit,
    and finish when t_codes[cur] can no longer beat the ray's current hit
    (the same exactness invariant as the lockstep walker — all candidates
    with t_lb < hit_t are visited, min-t hit kept). Loads overlap DDA work
    instead of alternating with it, so a tile's iteration count drops from
    sum_c (1 + rounds_c) to ~max(n_candidates, per-ray DDA rounds).

    A ray's current brick words are staged into rwords (Tc,P,16) once at
    init (win-way x 16 masked select) so the per-step word select stays the
    cheap 16-way chain. st fields are (Tc,P,...) ray state; codes/ids/
    t_codes are the chunk's (Tc,K) candidate lists (t_codes ascending).
    Hits are exact ESVO DDA results, bit-identical to the per-ray paths."""
    f32, i32, u32 = jnp.float32, jnp.int32, jnp.uint32
    Tc, P = st["t0"].shape
    # slot math below indexes the window as base & (win-1): win MUST be a
    # power of two or slots collide silently (ADVICE r04) — round down
    win = min(win, k_max)
    win = 1 << (win.bit_length() - 1)
    bsize = f32(2.0 ** -top_depth)
    vsize = f32(2.0 ** -depth)
    vshift = S_MAX - depth
    om = st["om"]
    om_bits = jnp.stack([om & 1, (om >> 1) & 1, (om >> 2) & 1], axis=-1)
    flip = jnp.where(om_bits == 1, jnp.int32(0), jnp.int32(7))   # (Tc,P,3)
    t_coef, t_bias = st["t_coef"], st["t_bias"]

    zf2 = jnp.zeros_like(st["t0"])            # f32 (Tc,P), vma-consistent
    zi2 = jnp.zeros_like(om)                  # i32 (Tc,P)
    zt = jnp.zeros_like(st["t0"][:, 0])       # f32 (Tc,)
    zti = zt.astype(i32)
    carry = dict(
        base=zti,                             # candidates loaded so far
        list_end=zt != 0.0,
        win_words=vconst(zt, dtype=u32, shape=(Tc, win, 16)),
        win_bid=vconst(zti, -1, shape=(Tc, win)),
        win_code=vconst(zti, shape=(Tc, win)),
        win_tlb=vconst(zt, jnp.inf, shape=(Tc, win)),
        cur=zi2,                              # per-ray candidate cursor
        cur_bid=zi2 - 1,                      # brick id being walked
        rwords=vconst(zi2, dtype=u32, shape=(Tc, P, 16)),
        walking=zf2 != 0.0,
        fin=st["miss0"],
        bpos=vconst(zf2, 1.0, shape=(Tc, P, 3)),
        t_cur=zf2,
        hit_bid=zi2 - 1,
        hit_idx9=zi2,
        hit_t=zf2 + jnp.inf,
        iters=zi2,
    )
    slot_iota = jnp.arange(win, dtype=i32)[None, :]          # (1,win)
    # candidate metadata packed to ONE row table so the in-loop load is a
    # single take_along_axis + one bricks gather regardless of `loads`
    # (separate gathers per load per trip cost one kernel launch each)
    cand3 = jnp.stack(
        [ids, codes, jax.lax.bitcast_convert_type(t_codes, i32)],
        axis=-1).reshape(ids.shape[0], k_max * 3)

    def body(c):
        # ---- per-tile rotating loads: stream up to `loads` candidates per
        # iteration into the win-slot buffer. Loads are (Tc,)-cheap next to
        # the (Tc,P)-wide ray work, and streaming several per iteration
        # keeps high-K tiles fed while their rays skip-scan. A slot is only
        # overwritten once no active ray can still need it (min active
        # cursor >= base - win + 1) ----
        act = ~c["fin"]
        m = jnp.min(jnp.where(act, c["cur"], k_max), axis=1)     # (Tc,)
        any_act = jnp.any(act, axis=1)
        base, list_end = c["base"], c["list_end"]
        win_words, win_bid = c["win_words"], c["win_bid"]
        win_code, win_tlb = c["win_code"], c["win_tlb"]
        # batched fetch of candidates base..base+loads-1 (the insert loop
        # below discards any the guards reject — a rejected candidate's
        # insertion conditions are suffix-closed, so candidate j inserts
        # iff all i<j did, exactly as the one-at-a-time form)
        Tc_ = base.shape[0]
        kk = jnp.minimum(base[:, None] + jnp.arange(loads, dtype=i32),
                         k_max - 1)                              # (Tc,L)
        meta = jnp.take_along_axis(
            cand3, (kk[:, :, None] * 3
                    + jnp.arange(3, dtype=i32)).reshape(Tc_, loads * 3),
            axis=1).reshape(Tc_, loads, 3)
        id_b = meta[..., 0]
        code_b = meta[..., 1]
        tlb_b = jax.lax.bitcast_convert_type(meta[..., 2], jnp.float32)
        nwords_b = jnp.take(bricks, jnp.maximum(id_b, 0).reshape(-1),
                            axis=0)[:, :16].reshape(Tc_, loads, 16)
        for j in range(loads):
            can_load = ((m >= base - (win - 1)) & ~list_end
                        & (base < k_max) & any_act)
            id_k = id_b[:, j]
            sm = ((slot_iota == (base & (win - 1))[:, None])
                  & can_load[:, None])                           # (Tc,win)
            win_words = jnp.where(sm[..., None], nwords_b[:, None, j],
                                  win_words)
            win_bid = jnp.where(sm, id_k[:, None], win_bid)
            win_tlb = jnp.where(
                sm, jnp.where(id_k >= 0, tlb_b[:, j], jnp.inf)[:, None],
                win_tlb)
            win_code = jnp.where(sm, code_b[:, j:j + 1], win_code)
            base = base + can_load.astype(i32)
            list_end = list_end | (can_load & (id_k < 0))

        # ---- per-ray skip-scan: non-walking rays evaluate up to `skips`
        # cursor candidates per iteration. Cheap reject (no box
        # intersection, or can't beat the current hit) advances the cursor;
        # the first accept is captured for the expensive entry init below.
        # The cap check must NOT require the slot to be loaded: on a
        # saturated list (no sentinel) cur == k_max == base is never
        # in-window and would deadlock ----
        fin = c["fin"]
        cur = c["cur"]
        entered = c["walking"] & ~c["walking"]                   # all-False
        e_pos = c["bpos"]
        e_tin = c["t_cur"]
        e_bid = c["cur_bid"]
        e_rs = jnp.zeros_like(cur)
        for _ in range(skips):
            scan = ~c["walking"] & ~fin & ~entered
            in_win = (cur < base[:, None]) & (cur >= base[:, None] - win)
            ready = scan & in_win
            rs = cur & (win - 1)                                 # (Tc,P)
            # win-way masked selects on (Tc,P) operands (no (Tc,P,win)
            # materialization)
            r_bid = jnp.full_like(rs, -1)
            r_code = jnp.zeros_like(rs)
            r_tlb = jnp.full_like(c["t_cur"], jnp.inf)
            for j in range(win):
                mj = rs == j
                r_bid = jnp.where(mj, win_bid[:, j, None], r_bid)
                r_code = jnp.where(mj, win_code[:, j, None], r_code)
                r_tlb = jnp.where(mj, win_tlb[:, j, None], r_tlb)

            fin_over = scan & (cur >= k_max)
            fin_now = (ready & ((r_tlb >= c["hit_t"]) | (r_bid < 0))) \
                | fin_over
            fin = fin | fin_now
            try_init = ready & ~fin_now

            pos_b = _mirrored_brick_corner(r_code, om, top_depth)
            t_hi = (pos_b + bsize) * t_coef - t_bias
            t_lo = pos_b * t_coef - t_bias
            t_in = jnp.maximum(jnp.max(t_hi, axis=-1), st["t0"])
            t_out = jnp.min(t_lo, axis=-1)
            enter_now = try_init & (t_in < t_out) & (t_in < c["hit_t"])
            cur = cur + (try_init & ~enter_now).astype(i32)
            entered = entered | enter_now
            e_pos = jnp.where(enter_now[..., None], pos_b, e_pos)
            e_tin = jnp.where(enter_now, t_in, e_tin)
            e_bid = jnp.where(enter_now, r_bid, e_bid)
            e_rs = jnp.where(enter_now, rs, e_rs)

        # ---- expensive entry init, once per iteration for entered rays:
        # 3-level ESVO plane descent to the entry voxel + brick-word
        # staging into the per-ray cache ----
        nbpos = e_pos
        for l in range(1, BRICK_LEVELS + 1):
            half = f32(bsize * 2.0 ** -l)
            t_center = half * t_coef + (nbpos * t_coef - t_bias)
            upper = t_center > e_tin[..., None]
            nbpos = nbpos + jnp.where(upper, half, f32(0.0))

        rwords = c["rwords"]
        for j in range(win):
            mj = (entered & (e_rs == j))[..., None]              # (Tc,P,1)
            rwords = jnp.where(mj, win_words[:, None, j, :], rwords)

        walking = c["walking"] | entered
        bpos = jnp.where(entered[..., None], nbpos, c["bpos"])
        t_cur = jnp.where(entered, e_tin, c["t_cur"])
        cur_bid = jnp.where(entered, e_bid, c["cur_bid"])

        # ---- dda_unroll exact DDA steps (masked by walking) ----
        hit_bid, hit_idx9, hit_t = c["hit_bid"], c["hit_idx9"], c["hit_t"]
        iters = c["iters"]
        for _ in range(dda_unroll):
            a_ = walking
            li = (_f2i(bpos, jnp) >> vshift) & 7                 # (Tc,P,3)
            aa = li ^ flip
            idx9 = (_spread3(aa[..., 0]) | (_spread3(aa[..., 1]) << 1)
                    | (_spread3(aa[..., 2]) << 2))
            wsel = idx9 >> 5
            bitpos = (idx9 & 31).astype(u32)
            w = _sel16r(rwords, wsel)
            occ = ((w >> bitpos) & 1) != 0
            hit_now = a_ & occ & (t_cur < hit_t)

            t_corner = bpos * t_coef - t_bias
            tc_max = jnp.min(t_corner, axis=-1)
            adv = a_ & ~hit_now
            step_bits = t_corner <= tc_max[..., None]
            exit_b = adv & jnp.any(step_bits & (li == 0), axis=-1)
            stay = adv & ~exit_b
            bpos = bpos - jnp.where(step_bits & stay[..., None], vsize,
                                    f32(0.0))
            t_cur = jnp.where(adv, jnp.maximum(t_cur, tc_max), t_cur)
            ended = hit_now | exit_b
            cur = cur + ended.astype(i32)
            walking = stay
            hit_bid = jnp.where(hit_now, cur_bid, hit_bid)
            hit_idx9 = jnp.where(hit_now, idx9, hit_idx9)
            hit_t = jnp.where(hit_now, t_cur, hit_t)
            iters = iters + a_.astype(i32)

        return dict(
            base=base, list_end=list_end, win_words=win_words,
            win_bid=win_bid, win_code=win_code, win_tlb=win_tlb,
            cur=cur, cur_bid=cur_bid, rwords=rwords, walking=walking,
            fin=fin, bpos=bpos, t_cur=t_cur, hit_bid=hit_bid,
            hit_idx9=hit_idx9, hit_t=hit_t, iters=iters)

    # hard backstop: liveness argues the loop always drains (each iteration
    # loads, inits, steps, or finishes someone), but a bound keeps any
    # unforeseen stall from hanging a device; bailed rays are REPORTED via
    # the unfin mask (folded into unresolved — never silent)
    n_max = k_max * (2 + (3 * 8 + 2) // dda_unroll) + win + loads + 64

    def cond(ic):
        i, c = ic
        return (i < n_max) & jnp.any(~c["fin"] | c["walking"])

    def body_i(ic):
        i, c = ic
        return i + 1, body(c)

    trips, carry = jax.lax.while_loop(cond, body_i, (jnp.int32(0), carry))
    hit_leaf, hit_t, iters = _resolve_hits(carry, bricks, Tc, P)
    if _os.environ.get("RTT_TILE_DEBUG_TRIPS"):
        # diagnostics: report the chunk's while-loop trip count instead of
        # per-ray DDA iters (scratch probes only)
        iters = jnp.broadcast_to(trips, iters.shape)
    unfin = ~carry["fin"] | carry["walking"]
    return hit_leaf, hit_t, iters, unfin


def _sel16r(rwords, w):
    """Per-lane select rwords[t, p, w[t,p]] with rwords (Tc,P,16): the same
    binary mux tree as _sel16b against the per-ray word cache."""
    sel = [rwords[:, :, j] for j in range(16)]
    for k in range(4):
        bit = (w & (1 << k)) != 0
        sel = [jnp.where(bit, sel[2 * j + 1], sel[2 * j])
               for j in range(len(sel) // 2)]
    return sel[0]


def _resolve_hits(carry, bricks, Tc, P):
    """Post-walk leaf resolution: one fat row gather per ray."""
    i32, u32 = jnp.int32, jnp.uint32
    hit = carry["hit_bid"] >= 0
    brow = jnp.take(bricks, jnp.maximum(carry["hit_bid"], 0).reshape(-1),
                    axis=0)                                      # (Tc*P,17)
    words = brow[:, :16]
    bleaf = brow[:, 16].astype(i32)
    idx9 = carry["hit_idx9"].reshape(-1)
    wsel = idx9 >> 5
    bitpos = (idx9 & 31).astype(u32)
    w = _sel16(words, wsel)
    pc = _popcount32(words).astype(i32)
    word_iota = jnp.arange(16, dtype=i32)[None, :]
    full = jnp.sum(jnp.where(word_iota < wsel[:, None], pc, 0), axis=1)
    partial = _popcount32(w & ((u32(1) << bitpos) - 1)).astype(i32)
    leaf = (bleaf + full + partial).reshape(Tc, P)
    hit_leaf = jnp.where(hit, leaf, -1)
    hit_t = jnp.where(hit, carry["hit_t"], 0.0)
    return hit_leaf, hit_t, carry["iters"]


def _walk_chunk_lockstep(st, codes, ids, t_codes, bricks, depth, top_depth,
                         k_max, dda_unroll=6):
    """Fused front-to-back candidate walk for one chunk of tiles (the
    round-3 lockstep walker: the whole tile advances one candidate at a
    time). Kept for A/B measurement against _walk_chunk_window.

    st fields are (Tc,P,...) ray state; codes/ids/t_codes are the chunk's
    (Tc,K) candidate lists (t_codes ascending per tile). Hits are exact ESVO
    DDA results, bit-identical to the per-ray paths."""
    f32, i32, u32 = jnp.float32, jnp.int32, jnp.uint32
    Tc, P = st["t0"].shape
    bsize = f32(2.0 ** -top_depth)
    vsize = f32(2.0 ** -depth)
    vshift = S_MAX - depth
    om = st["om"]
    om_bits = jnp.stack([om & 1, (om >> 1) & 1, (om >> 2) & 1], axis=-1)
    flip = jnp.where(om_bits == 1, jnp.int32(0), jnp.int32(7))   # (Tc,P,3)
    t_coef, t_bias = st["t_coef"], st["t_bias"]

    # carry constants derive from the (varying) ray state so the while_loop
    # stays vma-consistent under shard_map (traverse.vconst)
    zf2 = jnp.zeros_like(st["t0"])           # f32 (Tc,P)
    zi2 = jnp.zeros_like(om)                 # i32 (Tc,P)
    zt = jnp.zeros_like(st["t0"][:, 0])      # f32 (Tc,)
    carry = dict(
        k=zt.astype(i32),                   # per-tile next candidate
        cur_bid=zt.astype(i32),             # current candidate's brick id
        words=vconst(zt, dtype=u32, shape=(Tc, 16)),
        walking=zf2 != 0.0,
        bpos=vconst(zf2, 1.0, shape=(Tc, P, 3)),
        t_cur=zf2,
        hit_bid=zi2 - 1,                    # brick id of the hit
        hit_idx9=zi2,                       # morton bit index of the hit
        hit_t=zf2 + jnp.inf,
        iters=zi2,
        tile_done=zt != 0.0,
    )

    def body(c):
        he = c["hit_t"]                      # inf until a hit lands

        # ---- per-tile candidate advance (tiles with no walking rays) ----
        load = ~jnp.any(c["walking"], axis=1) & ~c["tile_done"]   # (Tc,)
        kk = jnp.minimum(c["k"], k_max - 1)[:, None]
        id_k = jnp.take_along_axis(ids, kk, axis=1)[:, 0]
        code_k = jnp.take_along_axis(codes, kk, axis=1)[:, 0]
        t_lb = jnp.take_along_axis(t_codes, kk, axis=1)[:, 0]
        nwords = jnp.take(bricks, jnp.maximum(id_k, 0), axis=0)[:, :16]

        pos_b = _mirrored_brick_corner(code_k[:, None], om, top_depth)
        t_hi = (pos_b + bsize) * t_coef - t_bias
        t_lo = pos_b * t_coef - t_bias
        t_in = jnp.maximum(jnp.max(t_hi, axis=-1), st["t0"])
        t_out = jnp.min(t_lo, axis=-1)
        enter = ((t_in < t_out) & (id_k >= 0)[:, None] & ~st["miss0"]
                 & (t_in < he) & load[:, None])

        # entry descent: brick corner -> entry voxel (exact ESVO planes)
        nbpos = pos_b
        for l in range(1, BRICK_LEVELS + 1):
            half = f32(bsize * 2.0 ** -l)
            t_center = half * t_coef + (nbpos * t_coef - t_bias)
            upper = t_center > t_in[..., None]
            nbpos = nbpos + jnp.where(upper, half, f32(0.0))

        # a loading tile retires when its remaining candidates can't beat
        # any of its rays (list t-ascending) or the list is exhausted
        tile_live = jnp.any((t_lb[:, None] < he) & ~st["miss0"], axis=1) \
            & (c["k"] < k_max) & (id_k >= 0)
        tile_done = c["tile_done"] | (load & ~tile_live)

        lw = load[:, None]
        c = dict(c)
        c.update(
            k=jnp.where(load, c["k"] + 1, c["k"]),
            cur_bid=jnp.where(load, id_k, c["cur_bid"]),
            words=jnp.where(lw, nwords, c["words"]),
            walking=jnp.where(lw, enter, c["walking"]),
            bpos=jnp.where(lw[..., None], nbpos, c["bpos"]),
            t_cur=jnp.where(lw, t_in, c["t_cur"]),
            tile_done=tile_done,
        )

        # ---- dda_unroll exact DDA steps (masked by walking); the hit's
        # leaf id is resolved AFTER the walk (one fat gather + rank), so
        # the hot step carries only (brick id, morton bit, t) ----
        for _ in range(dda_unroll):
            act = c["walking"]
            li = (_f2i(c["bpos"], jnp) >> vshift) & 7            # (Tc,P,3)
            a = li ^ flip
            idx9 = (_spread3(a[..., 0]) | (_spread3(a[..., 1]) << 1)
                    | (_spread3(a[..., 2]) << 2))
            wsel = idx9 >> 5
            bitpos = (idx9 & 31).astype(u32)
            w = _sel16b(c["words"], wsel)
            occ = ((w >> bitpos) & 1) != 0
            hit_now = act & occ & (c["t_cur"] < c["hit_t"])

            t_corner = c["bpos"] * t_coef - t_bias
            tc_max = jnp.min(t_corner, axis=-1)
            adv = act & ~hit_now
            step_bits = t_corner <= tc_max[..., None]
            exit_b = adv & jnp.any(step_bits & (li == 0), axis=-1)
            stay = adv & ~exit_b
            bpos = c["bpos"] - jnp.where(step_bits & stay[..., None], vsize,
                                         f32(0.0))
            t_cur = jnp.where(adv, jnp.maximum(c["t_cur"], tc_max),
                              c["t_cur"])
            c.update(
                bpos=bpos, t_cur=t_cur, walking=stay,
                hit_bid=jnp.where(hit_now, c["cur_bid"][:, None],
                                  c["hit_bid"]),
                hit_idx9=jnp.where(hit_now, idx9, c["hit_idx9"]),
                hit_t=jnp.where(hit_now, c["t_cur"], c["hit_t"]),
                iters=c["iters"] + act.astype(i32))
        return c

    def cond(c):
        return jnp.any(~c["tile_done"] | jnp.any(c["walking"], axis=1))

    carry = jax.lax.while_loop(cond, body, carry)

    # ---- post-walk leaf resolution: one fat row gather per ray ----
    hit = carry["hit_bid"] >= 0
    brow = jnp.take(bricks, jnp.maximum(carry["hit_bid"], 0).reshape(-1),
                    axis=0)                                      # (Tc*P,17)
    words = brow[:, :16]
    bleaf = brow[:, 16].astype(i32)
    idx9 = carry["hit_idx9"].reshape(-1)
    wsel = idx9 >> 5
    bitpos = (idx9 & 31).astype(u32)
    w = _sel16(words, wsel)
    pc = _popcount32(words).astype(i32)
    word_iota = jnp.arange(16, dtype=i32)[None, :]
    full = jnp.sum(jnp.where(word_iota < wsel[:, None], pc, 0), axis=1)
    partial = _popcount32(w & ((u32(1) << bitpos) - 1)).astype(i32)
    leaf = (bleaf + full + partial).reshape(Tc, P)
    hit_leaf = jnp.where(hit, leaf, -1)
    hit_t = jnp.where(hit, carry["hit_t"], 0.0)
    return hit_leaf, hit_t, carry["iters"]


@partial(jax.jit,
         static_argnames=("depth", "top_depth", "caps", "k_max",
                          "chunk_tiles", "dda_unroll"))
def _trace_tile(pyr, cellmap, bricks, o, d, corners, apex, depth, top_depth,
                caps, k_max, chunk_tiles, dda_unroll=8, brickmap=None):
    """brickmap (optional int32 [n_cells_occupied]): indirection from the
    pyramid's morton-rank brick id to a row of `bricks` — lets one walk
    serve bricks living at arbitrary offsets of a streaming arena
    (stream/clipmap.py master_tile); None = identity (monolithic SVO)."""
    T, P = o.shape[0], o.shape[1]
    n = T * P
    if not (chunk_tiles and T % chunk_tiles == 0 and T > chunk_tiles):
        chunk_tiles = T
    g = T // chunk_tiles

    # phase 1: per-tile candidate lists (chunked to bound sort widths;
    # the results equal a single unchunked pass)
    codes, ids, t_codes, drop_t = jax.tree_util.tree_map(
        lambda x: x.reshape((T,) + x.shape[2:]),
        jax.lax.map(
            lambda c: _candidates(pyr, cellmap, c, apex, top_depth, caps,
                                  k_max),
            corners.reshape(g, chunk_tiles, 4, 3)))
    if brickmap is not None:
        ids = jnp.where(ids >= 0, jnp.take(brickmap, jnp.maximum(ids, 0)),
                        -1)

    # schedule: sort tiles by candidate count so each walk chunk holds
    # uniformly-expensive tiles (the chunk serializes on its worst tile)
    count = jnp.sum(ids >= 0, axis=1)
    order = jnp.argsort(count)
    inv = jnp.argsort(order)
    perm = lambda x: jnp.take(x, order, axis=0)

    res = jax.lax.map(
        lambda args: _walk_tiles_chunk(bricks, *args, depth=depth,
                                       top_depth=top_depth, k_max=k_max,
                                       dda_unroll=dda_unroll),
        tuple(x.reshape((g, chunk_tiles) + x.shape[1:]) for x in
              (perm(o), perm(d), perm(codes), perm(ids), perm(t_codes),
               perm(drop_t))))

    unperm = lambda x: jnp.take(x.reshape((T,) + x.shape[2:]), inv,
                                axis=0).reshape(n)
    hit_leaf, hit_t, iters, unresolved = map(unperm, res)
    return TraceResult(hit_leaf, hit_t, jnp.full(n, -1, jnp.int32),
                       jnp.zeros(n, jnp.int32), iters), unresolved


def _walk_tiles_chunk(bricks, o, d, codes, ids, t_codes, drop_t, *, depth,
                      top_depth, k_max, dda_unroll=8, win=None, loads=None,
                      skips=None):
    Tc, P = o.shape[0], o.shape[1]
    n = Tc * P
    st0 = init_state(o.reshape(n, 3), d.reshape(n, 3), top_depth, jnp)
    st = dict(
        t_coef=st0.t_coef.reshape(Tc, P, 3),
        t_bias=st0.t_bias.reshape(Tc, P, 3),
        om=st0.octant_mask.reshape(Tc, P),
        t0=st0.t_min.reshape(Tc, P),
        miss0=st0.done.reshape(Tc, P),   # never entered the root cube
    )
    hit_leaf, hit_t, iters, unfin = _walk_chunk(
        st, codes, ids, t_codes, bricks, depth, top_depth, k_max,
        dda_unroll=dda_unroll, win=win, loads=loads, skips=skips)

    # the walk visits every candidate that could matter; the loss channels
    # left are per-level cap dropping (bounded by drop_t per tile) and the
    # window walker's trip backstop (unfin — provably empty, never silent)
    hit_eff = jnp.where(hit_leaf >= 0, hit_t, jnp.inf)
    unresolved = ((drop_t[:, None] < hit_eff) & ~st["miss0"]) | unfin
    return hit_leaf, hit_t, iters, unresolved


def _walk_tiles_scheduled(bricks, o, d, codes, ids, t_codes, drop_t, *,
                          depth, top_depth, k_max, dda_unroll=8, win=None,
                          loads=None, skips=None, lane_budget=65536):
    """Cost-sorted chunked dispatch of _walk_tiles_chunk — the main walk's
    schedule applied to the FALLBACK walks. A single unchunked fb walk
    serializes every tile on the globally worst tile's trip count; at the
    depth-12 exactness budgets (2048 tiles x 4x4 sub-tiles, k=256) that
    one while_loop set the whole frame's trip count. Sorting by candidate count
    and chunking to ~lane_budget lanes lets light sub-tiles retire in few
    trips. Small budgets (the bench config's 96-tile fb) stay a single
    call.

    Identity caveat: tiles are independent, but the different static
    shapes let the compiler contract multiply-adds differently, so hit_t
    can wobble by ~1 ULP vs the single-call program on the CPU (hit ids,
    iters and the unresolved mask stay exact) — see
    tests/test_tile.py::test_walk_scheduled_chunked_parity."""
    T, P = o.shape[0], o.shape[1]
    rows = max(1, lane_budget // max(P, 1))
    if T <= rows:
        return _walk_tiles_chunk(bricks, o, d, codes, ids, t_codes, drop_t,
                                 depth=depth, top_depth=top_depth,
                                 k_max=k_max, dda_unroll=dda_unroll,
                                 win=win, loads=loads, skips=skips)
    g = -(-T // rows)
    while T % g:
        g += 1
    if g > 4 * (-(-T // rows)):     # pathological divisor: keep one call
        return _walk_tiles_chunk(bricks, o, d, codes, ids, t_codes, drop_t,
                                 depth=depth, top_depth=top_depth,
                                 k_max=k_max, dda_unroll=dda_unroll,
                                 win=win, loads=loads, skips=skips)
    count = jnp.sum(ids >= 0, axis=1)
    order = jnp.argsort(count)
    inv = jnp.argsort(order)
    perm = lambda x: jnp.take(x, order, axis=0)
    rows_c = T // g
    res = jax.lax.map(
        lambda args: _walk_tiles_chunk(bricks, *args, depth=depth,
                                       top_depth=top_depth, k_max=k_max,
                                       dda_unroll=dda_unroll, win=win,
                                       loads=loads, skips=skips),
        tuple(x.reshape((g, rows_c) + x.shape[1:]) for x in
              (perm(o), perm(d), perm(codes), perm(ids), perm(t_codes),
               perm(drop_t))))
    unperm = lambda x: jnp.take(x.reshape((T,) + x.shape[2:]), inv, axis=0)
    return tuple(map(unperm, res))


# default per-level candidate caps (level-indexed; clipped to 8^l and to
# k_max at the finest level). Ramp: coarse levels are cheap to keep small,
# the finest carries the real list.
def _default_caps(top_depth, k_max):
    if _os.environ.get("RTT_TILE_CAPS_TIGHT"):
        # tighter ramp: ~45% fewer sorted elements in phase 1, more
        # cap-dropping absorbed by the enlarged-K re-walk (A/B knob)
        caps = [1, 8]
        for l in range(2, top_depth + 1):
            caps.append(min(k_max, caps[-1] + max(4, caps[-1] // 3)))
        return tuple(caps)
    caps = [1, 8]
    for l in range(2, top_depth + 1):
        caps.append(min(k_max, max(12, caps[-1] + caps[-1] // 2)))
    return tuple(caps)


def trace_tile(tsvo: TileSVO, o, d, corners, k_max=48, caps=None,
               chunk_tiles=256, dda_unroll=8):
    """Tile-amortized trace. o/d: (T, P, 3) tile-major rays (tile_rays),
    corners: (T, 4, 3). Returns (TraceResult (T*P,), unresolved (T*P,)).
    Resolved rays' hit_leaf / hit_t are bit-identical to trace_jax; the
    unresolved mask marks rays that must be re-traced exactly
    (trace_tile_exact does this automatically)."""
    o = jnp.asarray(o, jnp.float32)
    d = jnp.asarray(d, jnp.float32)
    apex = o[0, 0]
    caps = caps or _default_caps(tsvo.top_depth, k_max)
    return _trace_tile(
        jnp.asarray(tsvo.pyr), jnp.asarray(tsvo.cellmap),
        jnp.asarray(tsvo.bsvo.bricks), o, d,
        jnp.asarray(corners, jnp.float32), apex,
        tsvo.depth, tsvo.top_depth, caps, k_max, chunk_tiles, dda_unroll)


def _subtile_split(o_s, d_s, c_s, split):
    """Split (Ts, P, 3) tiles into (Ts*split^2, P/split^2, 3) sub-tiles.

    Camera ray directions are affine in pixel coordinates, so the sub-tile
    corner directions are EXACT bilinear interpolations of the parent
    tile's 4 pixel-boundary corners (cyclic order [tl, tr, br, bl] from
    tile_rays) — the sub-frustum planes contain exactly the sub-tile's
    boundary rays. Returns (o2, d2, corners2); sub-tile order is (sy, sx)
    row-major, within-sub pixels row-major (_subtile_merge inverts it)."""
    Ts, P = o_s.shape[0], o_s.shape[1]
    px = int(round(P ** 0.5))
    q = px // split
    assert q * split == px, (P, split)

    def regroup(x):
        x = x.reshape(Ts, split, q, split, q, 3)
        x = x.transpose(0, 1, 3, 2, 4, 5)
        return x.reshape(Ts * split * split, q * q, 3)

    o2, d2 = regroup(o_s), regroup(d_s)
    c00, c01, c11, c10 = (c_s[:, j] for j in range(4))
    f = jnp.arange(split + 1, dtype=jnp.float32) / split
    fy = f[:, None, None, None]
    fx = f[None, :, None, None]
    grid = (c00[None, None] * (1 - fx) * (1 - fy)
            + c01[None, None] * fx * (1 - fy)
            + c11[None, None] * fx * fy
            + c10[None, None] * (1 - fx) * fy)        # (s+1, s+1, Ts, 3)
    sub = jnp.stack([grid[:-1, :-1], grid[:-1, 1:], grid[1:, 1:],
                     grid[1:, :-1]], axis=2)          # (s, s, 4, Ts, 3)
    c2 = sub.transpose(3, 0, 1, 2, 4).reshape(Ts * split * split, 4, 3)
    return o2, d2, c2


def _subtile_merge(x, n_tiles, split, q):
    """Inverse of _subtile_split's ray regrouping: (Ts*s^2, q^2) -> (Ts, P)."""
    x = x.reshape(n_tiles, split, split, q, q)
    x = x.transpose(0, 1, 3, 2, 4)
    return x.reshape(n_tiles, split * split * q * q)


def _fb2_caps(top_depth, fb_k):
    """Doubling ramp for the sub-tile re-walk: frustum volume is split^2
    smaller, so a generous-but-bounded ramp replaces the all-cells caps."""
    caps = [1]
    for l in range(1, top_depth + 1):
        caps.append(min(fb_k, 8 ** l, 8 << l))
    return tuple(caps)


@partial(jax.jit,
         static_argnames=("depth", "top_depth", "caps", "k_max",
                          "chunk_tiles", "fb_tiles", "fb_k", "fb2_tiles",
                          "fb2_split"))
def _trace_tile_fb(pyr, cellmap, bricks, o, d, corners, apex, depth,
                   top_depth, caps, k_max, chunk_tiles, fb_tiles, fb_k,
                   fb2_tiles=0, fb2_split=2, brickmap=None):
    """trace_tile + in-jit enlarged-K tile re-walk fallback (+ optional
    sub-tile re-walk for cap-saturated tiles).

    Unresolved rays exist only because per-level candidate caps dropped a
    candidate whose conservative t could precede a ray's hit. They cluster
    in few (horizon-band) tiles, so instead of re-tracing rays on the
    ~30 ms per-ray brick path (the r3 fallback), the fb_tiles tiles that
    contain unresolved rays are RE-WALKED with enlarged caps (fb_k
    candidates) — one extra chunk walk, same program.

    Horizon-grazing tiles at depth >= 12 can saturate even fb_k=256; when
    fb2_tiles > 0, the
    tiles still unresolved after the enlarged-K pass are SPLIT into
    fb2_split^2 sub-tiles (frustum volume ~split^2 smaller, so candidate
    lists shrink accordingly) and re-walked per sub-tile with exact
    bilinear sub-corners (_subtile_split).

    Returns (TraceResult, residual mask): residual rays are those in
    unresolved tiles beyond the fb/fb2 tile budgets or still cap-limited
    after every pass (typically none; callers surface the count rather
    than silently dropping it)."""
    T, P = o.shape[0], o.shape[1]
    fb_tiles = min(fb_tiles, T)
    res, unresolved = _trace_tile(pyr, cellmap, bricks, o, d, corners, apex,
                                  depth, top_depth, caps, k_max, chunk_tiles,
                                  brickmap=brickmap)
    un = unresolved.reshape(T, P)
    hl = res.hit_leaf.reshape(T, P)
    ht = res.hit_t.reshape(T, P)

    def _remap(ids_):
        if brickmap is None:
            return ids_
        return jnp.where(ids_ >= 0, jnp.take(brickmap,
                                             jnp.maximum(ids_, 0)), -1)

    if fb_tiles:
        un_tile = jnp.any(un, axis=1)
        order = jnp.argsort(~un_tile)           # unresolved tiles first
        sel_t = order[:fb_tiles]
        m_t = jnp.take(un_tile, sel_t)          # real (non-padding) tiles

        o_s = jnp.take(o, sel_t, axis=0)
        d_s = jnp.take(d, sel_t, axis=0)
        c_s = jnp.take(corners, sel_t, axis=0)
        # generous caps: the re-walk exists to undo cap-dropping, so every
        # level keeps up to fb_k candidates (clipped to the level's 8^l
        # cells)
        caps2 = tuple(min(fb_k, 8 ** l) for l in range(top_depth + 1))
        codes2, ids2, t2, drop2 = _candidates(pyr, cellmap, c_s, apex,
                                              top_depth, caps2, fb_k)
        ids2 = _remap(ids2)
        # wide window for the long fb_k lists; cost-sorted chunking when
        # the budget exceeds one chunk's lanes (depth-12 exactness configs)
        hit2, t_hit2, _it2, un2 = _walk_tiles_scheduled(
            bricks, o_s, d_s, codes2, ids2, t2, drop2, depth=depth,
            top_depth=top_depth, k_max=fb_k, win=FB_WIN, loads=FB_LOADS,
            skips=FB_SKIPS)

        rep = m_t[:, None]
        hl = hl.at[sel_t].set(jnp.where(rep, hit2,
                                        jnp.take(hl, sel_t, axis=0)))
        ht = ht.at[sel_t].set(jnp.where(rep, t_hit2,
                                        jnp.take(ht, sel_t, axis=0)))
        # after substitution `un` IS the residual: re-walked tiles carry
        # their re-walk unresolved mask, uncovered tiles keep the original
        un = un.at[sel_t].set(jnp.where(rep, un2,
                                        jnp.take(un, sel_t, axis=0)))

    if fb2_tiles:
        fb2_tiles = min(fb2_tiles, T)
        un_tile2 = jnp.any(un, axis=1)
        order2 = jnp.argsort(~un_tile2)
        sel2 = order2[:fb2_tiles]
        m2 = jnp.take(un_tile2, sel2)
        o3, d3, c3 = _subtile_split(jnp.take(o, sel2, axis=0),
                                    jnp.take(d, sel2, axis=0),
                                    jnp.take(corners, sel2, axis=0),
                                    fb2_split)
        caps3 = _fb2_caps(top_depth, fb_k)
        codes3, ids3, t3, drop3 = _candidates(pyr, cellmap, c3, apex,
                                              top_depth, caps3, fb_k)
        ids3 = _remap(ids3)
        hit3, t_hit3, _it3, un3 = _walk_tiles_scheduled(
            bricks, o3, d3, codes3, ids3, t3, drop3, depth=depth,
            top_depth=top_depth, k_max=fb_k, win=FB_WIN, loads=FB_LOADS,
            skips=FB_SKIPS)
        q = int(round(P ** 0.5)) // fb2_split
        hit3 = _subtile_merge(hit3, fb2_tiles, fb2_split, q)
        t_hit3 = _subtile_merge(t_hit3, fb2_tiles, fb2_split, q)
        un3 = _subtile_merge(un3, fb2_tiles, fb2_split, q)
        rep2 = m2[:, None]
        hl = hl.at[sel2].set(jnp.where(rep2, hit3,
                                       jnp.take(hl, sel2, axis=0)))
        ht = ht.at[sel2].set(jnp.where(rep2, t_hit3,
                                       jnp.take(ht, sel2, axis=0)))
        un = un.at[sel2].set(jnp.where(rep2, un3,
                                       jnp.take(un, sel2, axis=0)))

    return TraceResult(hl.reshape(T * P), ht.reshape(T * P),
                       res.hit_parent, res.hit_child, res.iters), \
        un.reshape(T * P)


def retrace_residual(bsvo, o, d, hit_leaf, hit_t, unresolved, chunk):
    """In-jit exact re-trace of every ray the tile walks left cap-limited,
    on the per-ray brick path (hits identical to the tile walk's resolved
    rays), `chunk` (static) rays per pass of a while loop that runs until
    none is left. o/d: tile-major (T, P, 3). Returns (hit_leaf, hit_t,
    unresolved); the returned mask is all False."""
    from raytracingtest_tpu.ops import brick as brick_mod
    N = hit_leaf.shape[0]
    chunk = min(chunk, N)
    o_f, d_f = o.reshape(-1, 3), d.reshape(-1, 3)

    def one_pass(carry):
        leaf, t, un = carry
        sel = jnp.flatnonzero(un, size=chunk, fill_value=0)
        # padding slots re-trace ray 0 and are dropped on the write-back
        dst = jnp.where(jnp.arange(chunk) < jnp.sum(un), sel, N)
        sub = brick_mod._trace_brick_jax(
            bsvo.top_masks, bsvo.top_child, bsvo.top_parent, bsvo.bricks,
            jnp.take(o_f, sel, axis=0), jnp.take(d_f, sel, axis=0),
            bsvo.depth, bsvo.top_depth)
        return (leaf.at[dst].set(sub.hit_leaf, mode="drop"),
                t.at[dst].set(sub.hit_t, mode="drop"),
                un.at[dst].set(False, mode="drop"))

    return jax.lax.while_loop(lambda c: jnp.any(c[2]), one_pass,
                              (hit_leaf, hit_t, unresolved))


def trace_tile_fb(tsvo: TileSVO, o, d, corners, k_max=64, caps=None,
                  chunk_tiles=256, fb_tiles=128, fb_k=256, fb2_tiles=0,
                  fb2_split=2):
    """Single-dispatch tile trace with in-jit enlarged-K tile re-walk
    fallback (+ sub-tile re-walk when fb2_tiles > 0). The residual mask is
    nonzero only when unresolved rays span more than the fb tile budgets
    or stay cap-limited after every pass."""
    o = jnp.asarray(o, jnp.float32)
    d = jnp.asarray(d, jnp.float32)
    caps = caps or _default_caps(tsvo.top_depth, k_max)
    b = tsvo.bsvo
    return _trace_tile_fb(
        jnp.asarray(tsvo.pyr), jnp.asarray(tsvo.cellmap),
        jnp.asarray(b.bricks),
        o, d, jnp.asarray(corners, jnp.float32), o[0, 0],
        tsvo.depth, tsvo.top_depth, caps, k_max, chunk_tiles, fb_tiles,
        fb_k, fb2_tiles, fb2_split)


def trace_tile_exact(tsvo: TileSVO, o, d, corners, k_max=48, caps=None,
                     chunk_tiles=256, fb_tiles=128, fb_k=256,
                     fb2_tiles=32, fb2_split=2) -> TraceResult:
    """Exact tile trace: the in-jit enlarged-K re-walk (then the sub-tile
    re-walk) resolves nearly all cap-dropped rays in the same dispatch;
    any residual rays (rare) are re-traced per-ray on the host-sync brick
    path."""
    from raytracingtest_tpu.ops import brick as brick_mod
    res, unresolved = trace_tile_fb(tsvo, o, d, corners, k_max=k_max,
                                    caps=caps, chunk_tiles=chunk_tiles,
                                    fb_tiles=fb_tiles, fb_k=fb_k,
                                    fb2_tiles=fb2_tiles,
                                    fb2_split=fb2_split)
    n_un = int(jnp.sum(unresolved))
    if n_un == 0:
        return res
    idx = np.flatnonzero(np.asarray(unresolved))
    pad = max(4096, 1 << int(np.ceil(np.log2(n_un))))
    sel = np.zeros(pad, np.int64)
    sel[:n_un] = idx
    o_f = np.asarray(o).reshape(-1, 3)[sel]
    d_f = np.asarray(d).reshape(-1, 3)[sel]
    sub = brick_mod.trace_brick_jax(tsvo.bsvo, o_f, d_f)
    hit_leaf = np.asarray(res.hit_leaf).copy()
    hit_t = np.asarray(res.hit_t).copy()
    hit_leaf[idx] = np.asarray(sub.hit_leaf)[:n_un]
    hit_t[idx] = np.asarray(sub.hit_t)[:n_un]
    return TraceResult(jnp.asarray(hit_leaf), jnp.asarray(hit_t),
                       res.hit_parent, res.hit_child, res.iters)
