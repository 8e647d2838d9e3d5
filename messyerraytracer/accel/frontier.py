"""Frontier caster — per-ray breadth-first traversal as dense XLA ops.

The traversal kernel (kernels/walk.py) gives each ray its own stack walk
in one lane.  This module is the level-synchronous alternative, and is
pure jnp — no Pallas at all:

  * the wide (8-ary) BVH is descended LEVEL BY LEVEL for all rays at once:
    the frontier is a flat list of (ray, node) pairs, each level is one
    dense batch of 8-child slab tests, and the surviving pairs are
    compacted with a cumsum + scatter (classic stream compaction, the
    GPU wavefront idiom mapped to XLA);
  * leaf pairs intersect their (<=4) triangles with the same
    Moller-Trumbore arithmetic as the brute oracle (core/geometry.py) and
    fold into per-ray bests via scatter-min — per-RAY exact, no tile
    sharing;
  * closest-hit semantics match the serial reference loop
    (triangle.h:93-102): strictly-closer update, lowest-slot win on exact
    t ties — enforced here as a lexicographic (t, slot) scatter-min;
  * the per-ray best_t feeds back into the NEXT level's slab cap
    (level-lagged front-to-back culling, the dense analogue of the
    traversal early-exit at bvh_traverse.comp.glsl:251).

Because every ray advances independently, incoherent (bounce/shadow) rays
cost the same as primaries, and stats are per-ray exact — this backend is
what the OVERHEAT/HEATMAP debug modes mean (raytracer_debug.cpp:607-618).

**Layout rule:** every traversal-sized array here is flat 1-D: scene
tables and per-pair values are stored as separate x/y/z component arrays,
so no gather materializes a padded (P, 8, 3) block.

Capacity: frontier and leaf-pair lists are fixed-size (static shapes under
jit) with overflow flags; the wrapper retries with doubled caps, so
results are never silently truncated.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core.types import (
    ALL_LAYERS,
    INV_DIR_EPS,
    MT_DET_EPS,
    NO_HIT,
    T_MAX_DEFAULT,
    Hits,
    Rays,
    RayStats,
    Triangles,
)
from ..utils.struct import pytree_dataclass
from .bvh import BVH

_BIG = 3.0e38
_IMAX = np.iinfo(np.int32).max


@pytree_dataclass(meta_fields=("depth", "quantized"))
class FrontierScene:
    """Wide-tree tables for the frontier caster (flat device arrays).

    Child slot i of wide node w lives at flat index 8*w + i.  Missing
    children carry NaN boxes (never hit — the NaN sentinel of
    gpu_ray_caster.cpp:263-268).  ``child_enc`` is 2*ptr + is_leaf
    (ptr = wide-node or leaf index).  Leaves cover tri slots
    [first, first+count) of the slot-ordered triangle SoA, whose
    coordinates are mirrored here as component arrays.
    """

    child_min_x: jnp.ndarray  # (8W,) f32   — likewise _y, _z
    child_min_y: jnp.ndarray
    child_min_z: jnp.ndarray
    child_max_x: jnp.ndarray
    child_max_y: jnp.ndarray
    child_max_z: jnp.ndarray
    child_enc: jnp.ndarray    # (8W,) int32
    leaf_first: jnp.ndarray   # (L,) int32
    leaf_count: jnp.ndarray   # (L,) int32
    tri: tuple                # 9 x (T,) f32: v0.xyz, e1.xyz, e2.xyz
    # quantized (CWBVH-equivalent) tables — None unless quantize=True.
    # Child AABBs as 8-bit offsets from the parent anchor at a per-node
    # power-of-two scale (Ylitie 2017 / cwbvh_traverse.comp.glsl:237-253:
    # exponent-byte decode; conservative rounding -> traversal superset,
    # leaf MT results identical).  xyz bytes packed into one int32 each
    # for min and max: 3 gathered words per child slot instead of 7.
    node_pmin: tuple | None = None   # 3 x (W,) f32 anchor
    node_psc: tuple | None = None    # 3 x (W,) f32 power-of-two scale
    child_qlo: jnp.ndarray | None = None  # (8W,) int32  x | y<<8 | z<<16
    child_qhi: jnp.ndarray | None = None  # (8W,) int32
    depth: int = 1            # static: number of expansion levels
    quantized: bool = False   # static: which box tables the cast uses


WIDE8_CAP = 8


def _collapse8(amin: np.ndarray, amax: np.ndarray, lf: np.ndarray,
               cnt: np.ndarray):
    """Collapse the binary DFS BVH into an 8-wide tree (host, vectorized).

    Greedy: starting from a node's two children, repeatedly expand the
    internal child with the largest surface area until 8 children (the
    standard BVH2->BVH8 collapse, tiny_bvh.h BVH8 conversion shape).
    Returns (children, axis): ``children`` is an (W, 8) int32 array of
    binary node ids (-1 = missing), sorted per node along ``axis`` (W,)
    by box centroid for consensus front-to-back ordering.

    Whole BFS levels expand together as (F, 8) numpy passes instead of a
    per-node Python loop.
    """
    is_leaf = cnt > 0
    ext = np.maximum(amax - amin, 0.0)
    area = ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2] + ext[:, 2] * ext[:, 0]
    cent = (amin + amax) * 0.5

    if bool(is_leaf[0]):
        # degenerate: root is a leaf — one wide node holding it
        return (np.array([[0] + [-1] * 7], np.int32), np.zeros(1, np.int32))

    children_lvls: list[np.ndarray] = []
    axes_lvls: list[np.ndarray] = []
    frontier = np.array([0], np.int32)   # binary ids becoming wide nodes
    while frontier.size:
        f = frontier.size
        kids = np.full((f, WIDE8_CAP), -1, np.int32)
        kids[:, 0] = frontier + 1
        kids[:, 1] = lf[frontier]
        ncount = np.full(f, 2, np.int32)
        # greedy expansion: 6 rounds of replace-max-area-internal-child
        for _ in range(WIDE8_CAP - 2):
            present = kids >= 0
            safe = np.where(present, kids, 0)
            expandable = present & ~is_leaf[safe]
            a = np.where(expandable, area[safe], -np.inf)
            best = np.argmax(a, axis=1)                    # (F,)
            rows = np.nonzero((a[np.arange(f), best] > -np.inf)
                              & (ncount < WIDE8_CAP))[0]
            if rows.size == 0:
                break
            kd = kids[rows, best[rows]]
            kids[rows, best[rows]] = kd + 1                # replace in place
            kids[rows, ncount[rows]] = lf[kd]              # append sibling
            ncount[rows] += 1
        # sort present kids along the max-centroid-spread axis
        present = kids >= 0
        safe = np.where(present, kids, 0)
        ck = np.where(present[..., None], cent[safe], np.nan)
        spread = np.nanmax(ck, axis=1) - np.nanmin(ck, axis=1)   # (F, 3)
        ax = np.argmax(spread, axis=1)                           # (F,)
        key = np.where(present, np.take_along_axis(
            cent[safe], ax[:, None, None], axis=2)[..., 0], np.inf)
        ordr = np.argsort(key, axis=1, kind="stable")
        kids = np.take_along_axis(kids, ordr, axis=1)
        children_lvls.append(kids)
        axes_lvls.append(ax)
        flat = kids.reshape(-1)
        flat = flat[flat >= 0]
        frontier = flat[~is_leaf[flat]]                    # row-major BFS
    return (np.concatenate(children_lvls).astype(np.int32),
            np.concatenate(axes_lvls).astype(np.int32))


def collapse_tables(amin, amax, lf, cnt):
    """Shared 8-wide collapse -> frontier tables: (child boxes (W,8,3)x2
    NaN-padded, enc (W,8) int32, leaf binary-node index list, depth).

    Single source of truth for the frontier and two-level-TLAS builders
    (enc packing, missing-child NaN boxes, BFS depth) — both traversals
    must agree on the wide topology encoding.
    """
    m = amin.shape[0]
    is_leaf = cnt > 0
    leaves = np.nonzero(is_leaf)[0]
    leaf_of = (np.cumsum(is_leaf) - 1).astype(np.int32)
    children, _ = _collapse8(amin, amax, lf, cnt)
    children = np.asarray(children, np.int32)

    wide_of = np.full(m, -1, np.int32)
    order = children[children >= 0]
    internal_kids = order[~is_leaf[order]]
    wide_of[0] = 0
    wide_of[internal_kids] = np.arange(1, len(internal_kids) + 1,
                                       dtype=np.int32)

    present = children >= 0
    ck = np.where(present, children, 0)
    ptr = np.where(is_leaf[ck], leaf_of[ck], wide_of[ck])
    enc = np.where(present, 2 * ptr + is_leaf[ck], 0).astype(np.int32)
    cmin = np.where(present[..., None], amin[ck], np.nan).astype(np.float32)
    cmax = np.where(present[..., None], amax[ck], np.nan).astype(np.float32)

    depth = 0
    frontier = np.array([0], np.int32)
    while frontier.size:
        depth += 1
        kids = children[frontier].reshape(-1)
        kids = kids[kids >= 0]
        frontier = wide_of[kids[~is_leaf[kids]]]
    return cmin, cmax, enc, leaves, depth


def _quantize_wide_boxes(cmin, cmax, present):
    """Quantize (W,8,3) child AABBs to 8-bit offsets from a per-node
    anchor at a power-of-two scale (the CWBVH/Ylitie exponent-byte form,
    cwbvh_traverse.comp.glsl:237-253, tiny_bvh.h BVH8_CWBVH).

    Conservative by verification: after floor/ceil quantization the f32
    decode is checked against the true box and widened (or the node's
    scale doubled) until decoded_lo <= lo and decoded_hi >= hi hold
    exactly in f32 — traversal visits a superset, MT results unchanged.

    Returns (anchor (W,3) f32, scale (W,3) f32, qlo (W,8) i32 packed
    x|y<<8|z<<16, qhi (W,8) i32).  Missing children get qlo=255s, qhi=0
    (inverted box) and are additionally culled by enc==0 in the cast.
    """
    pm = present[..., None]
    anchor = np.where(pm, cmin, np.inf).min(axis=1)          # (W,3)
    top = np.where(pm, cmax, -np.inf).max(axis=1)
    anchor = np.where(np.isfinite(anchor), anchor, 0.0).astype(np.float32)
    top = np.where(np.isfinite(top), top, 0.0).astype(np.float32)
    extent = np.maximum(top - anchor, 0.0)
    e = np.ceil(np.log2(np.maximum(extent, 1e-30) / 255.0))
    scale = np.exp2(e).astype(np.float32)

    lo = np.where(pm, cmin, anchor[:, None, :]).astype(np.float32)
    hi = np.where(pm, cmax, anchor[:, None, :]).astype(np.float32)
    for _attempt in range(4):
        a3 = anchor[:, None, :]
        s3 = scale[:, None, :]
        qlo = np.clip(np.floor((lo - a3) / s3), 0, 255).astype(np.float32)
        qhi = np.clip(np.ceil((hi - a3) / s3), 0, 255).astype(np.float32)
        # widen one quantum where f32 decode rounding bites
        for _ in range(2):
            viol_lo = (a3 + qlo * s3).astype(np.float32) > lo
            viol_hi = (a3 + qhi * s3).astype(np.float32) < hi
            if not (viol_lo.any() or viol_hi.any()):
                break
            qlo = np.where(viol_lo & (qlo > 0), qlo - 1, qlo)
            qhi = np.where(viol_hi & (qhi < 255), qhi + 1, qhi)
        ok = ((a3 + qlo * s3).astype(np.float32) <= lo) & (
            (a3 + qhi * s3).astype(np.float32) >= hi
        )
        bad_nodes = ~ok.all(axis=(1, 2))
        if not bad_nodes.any():
            break
        scale = np.where(bad_nodes[:, None], scale * 2.0, scale)
    else:
        raise AssertionError("quantization not conservative after retries")

    qlo = qlo.astype(np.int32)
    qhi = qhi.astype(np.int32)
    qlo = np.where(present, qlo[..., 0] | (qlo[..., 1] << 8)
                   | (qlo[..., 2] << 16), 0x00FFFFFF)
    qhi = np.where(present, qhi[..., 0] | (qhi[..., 1] << 8)
                   | (qhi[..., 2] << 16), 0)
    return anchor, scale, qlo.astype(np.int32), qhi.astype(np.int32)


def build_frontier_scene(bvh: BVH, tris: Triangles,
                         quantize: bool = False) -> FrontierScene:
    """Build the frontier tables from a binary BVH (host index math only;
    triangle components are device slices of the resident SoA).

    Shares the 8-wide collapse (``collapse_tables``) with the two-level
    TLAS builder so both traverse the same wide topology.
    """
    host = getattr(bvh, "host", None)
    if host is not None:
        amin, amax = host["aabb_min"], host["aabb_max"]
        lf, cnt = host["left_first"], host["count"]
    else:
        amin = np.asarray(bvh.aabb_min)
        amax = np.asarray(bvh.aabb_max)
        lf = np.asarray(bvh.left_first)
        cnt = np.asarray(bvh.count)

    cmin, cmax, enc, leaves, depth = collapse_tables(amin, amax, lf, cnt)
    present = ~np.isnan(cmin[..., 0])

    tri = tuple(
        arr[:, a] for arr in (tris.v0, tris.edge1, tris.edge2)
        for a in range(3)
    )
    if quantize:
        anchor, scale, qlo, qhi = _quantize_wide_boxes(cmin, cmax, present)
        return FrontierScene(
            child_min_x=None, child_min_y=None, child_min_z=None,
            child_max_x=None, child_max_y=None, child_max_z=None,
            child_enc=jnp.asarray(enc.reshape(-1)),
            leaf_first=jnp.asarray(lf[leaves].astype(np.int32)),
            leaf_count=jnp.asarray(cnt[leaves].astype(np.int32)),
            tri=tri,
            node_pmin=tuple(jnp.asarray(anchor[:, a]) for a in range(3)),
            node_psc=tuple(jnp.asarray(scale[:, a]) for a in range(3)),
            child_qlo=jnp.asarray(qlo.reshape(-1)),
            child_qhi=jnp.asarray(qhi.reshape(-1)),
            depth=depth,
            quantized=True,
        )
    return FrontierScene(
        child_min_x=jnp.asarray(cmin[:, :, 0].reshape(-1)),
        child_min_y=jnp.asarray(cmin[:, :, 1].reshape(-1)),
        child_min_z=jnp.asarray(cmin[:, :, 2].reshape(-1)),
        child_max_x=jnp.asarray(cmax[:, :, 0].reshape(-1)),
        child_max_y=jnp.asarray(cmax[:, :, 1].reshape(-1)),
        child_max_z=jnp.asarray(cmax[:, :, 2].reshape(-1)),
        child_enc=jnp.asarray(enc.reshape(-1)),
        leaf_first=jnp.asarray(lf[leaves].astype(np.int32)),
        leaf_count=jnp.asarray(cnt[leaves].astype(np.int32)),
        tri=tri,
        depth=depth,
    )


def _safe_inv(x):
    """Identical safe inverse to the traversal kernel (core/ray.h:62-75)."""
    small = jnp.abs(x) < INV_DIR_EPS
    sign = jnp.where(x < 0.0, -1.0, 1.0)
    return jnp.where(small, sign / INV_DIR_EPS, 1.0 / jnp.where(small, 1.0, x))


def _compact(keep_flat, values, cap):
    """Stream compaction: scatter ``values`` where ``keep`` into a (cap,)
    array (zero-filled), returning (compacted, count).  Overflowing entries
    are dropped (the caller checks count > cap and retries)."""
    pos = jnp.cumsum(keep_flat.astype(jnp.int32)) - 1
    idx = jnp.where(keep_flat, pos, cap)
    out = [
        jnp.zeros((cap,), v.dtype).at[idx].set(v, mode="drop") for v in values
    ]
    count = jnp.sum(keep_flat.astype(jnp.int32))
    return out, count


@functools.partial(
    jax.jit,
    static_argnames=("query_mask", "any_hit", "pair_cap", "leaf_cap"),
)
def _cast_frontier_jit(
    rays: Rays,
    fs: FrontierScene,
    layers: jnp.ndarray,
    *,
    query_mask: int,
    any_hit: bool,
    pair_cap: int,
    leaf_cap: int,
):
    r = rays.count
    num_tris = fs.tri[0].shape[0]
    ox, oy, oz = (rays.origin[:, a] for a in range(3))
    dx, dy, dz = (rays.direction[:, a] for a in range(3))
    ix, iy, iz = _safe_inv(dx), _safe_inv(dy), _safe_inv(dz)
    t_min, t_max = rays.t_min, rays.t_max
    qm = jnp.int32(query_mask)
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = fs.tri

    best_t = jnp.full((r,), _BIG, jnp.float32)
    best_slot = jnp.full((r,), _IMAX, jnp.int32)
    best_u = jnp.zeros((r,), jnp.float32)
    best_v = jnp.zeros((r,), jnp.float32)
    nodes_visited = jnp.zeros((r,), jnp.int32)
    tri_tests = jnp.zeros((r,), jnp.int32)
    overflow = jnp.bool_(False)

    # level 0: every ray at the root (exact size, no padding)
    pr = jnp.arange(r, dtype=jnp.int32)
    pn = jnp.zeros((r,), jnp.int32)
    pvalid = t_max >= t_min  # degenerate rays (t_max < t_min) never start
    pcount = jnp.int32(r)

    for _lvl in range(fs.depth):
        p = pr.shape[0]
        pv = pvalid
        if _lvl:
            pv = pv & (jnp.arange(p, dtype=jnp.int32) < pcount)
        nodes_visited = nodes_visited.at[pr].add(pv.astype(jnp.int32))

        # ---- 8-child slab tests, fully flat (P*8,) ---------------------
        # per-PAIR gathers expanded 8-wide by broadcast (a reshape, not a
        # gather) — ray and node-anchor data cost P gathered elements
        # instead of 8P; only per-child tables gather at 8P.
        def rep8(a):
            return jnp.broadcast_to(a[:, None], (p, 8)).reshape(p * 8)

        kj = jnp.arange(p * 8, dtype=jnp.int32) & 7
        ray = rep8(pr)
        fidx = rep8(pn * 8) + kj
        enc = fs.child_enc[fidx]

        rox, roy, roz = rep8(ox[pr]), rep8(oy[pr]), rep8(oz[pr])
        rix, riy, riz = rep8(ix[pr]), rep8(iy[pr]), rep8(iz[pr])
        if fs.quantized:
            # CWBVH-style decode: anchor + byte * power-of-two scale
            # (cwbvh_traverse.comp.glsl:237-253); 2 gathered words per
            # child slot instead of 6 box floats
            ax, ay, az = (rep8(c[pn]) for c in fs.node_pmin)
            sx, sy, sz = (rep8(c[pn]) for c in fs.node_psc)
            qlo = fs.child_qlo[fidx]
            qhi = fs.child_qhi[fidx]
            f32 = jnp.float32
            lox = ax + (qlo & 255).astype(f32) * sx
            hix = ax + (qhi & 255).astype(f32) * sx
            loy = ay + ((qlo >> 8) & 255).astype(f32) * sy
            hiy = ay + ((qhi >> 8) & 255).astype(f32) * sy
            loz = az + ((qlo >> 16) & 255).astype(f32) * sz
            hiz = az + ((qhi >> 16) & 255).astype(f32) * sz
        else:
            lox, hix = fs.child_min_x[fidx], fs.child_max_x[fidx]
            loy, hiy = fs.child_min_y[fidx], fs.child_max_y[fidx]
            loz, hiz = fs.child_min_z[fidx], fs.child_max_z[fidx]
        t1 = (lox - rox) * rix
        t2 = (hix - rox) * rix
        tn = jnp.minimum(t1, t2)
        tf = jnp.maximum(t1, t2)
        t1 = (loy - roy) * riy
        t2 = (hiy - roy) * riy
        tn = jnp.maximum(tn, jnp.minimum(t1, t2))
        tf = jnp.minimum(tf, jnp.maximum(t1, t2))
        t1 = (loz - roz) * riz
        t2 = (hiz - roz) * riz
        tn = jnp.maximum(tn, jnp.minimum(t1, t2))
        tf = jnp.minimum(tf, jnp.maximum(t1, t2))
        cap_t = rep8(jnp.minimum(best_t[pr], t_max[pr]))
        # NaN boxes (missing children) fail both comparisons; quantized
        # tables mark missing children via enc==0 (nothing points at the
        # root, so 0 is free) and the inverted qlo>qhi box
        hit = (tf >= jnp.maximum(tn, 0.0)) & (tn <= cap_t) & rep8(pv)
        if fs.quantized:
            hit = hit & (enc != 0)

        isleaf = (enc & 1) == 1
        cptr = jax.lax.shift_right_logical(enc, 1)

        # ---- leaf pairs: compact then dense 4-tri Moller-Trumbore ------
        (lr, lp), ln = _compact(hit & isleaf, (ray, cptr), leaf_cap)
        overflow = overflow | (ln > leaf_cap)
        lvalid = jnp.arange(leaf_cap, dtype=jnp.int32) < ln
        tri_tests = tri_tests.at[lr].add(
            jnp.where(lvalid, fs.leaf_count[lp], 0)
        )

        jj = jnp.arange(leaf_cap * 4, dtype=jnp.int32)
        lj = jax.lax.shift_right_logical(jj, 2)      # jj // 4
        kk = jj & 3
        ray4 = lr[lj]
        leaf4 = lp[lj]
        slot = jnp.clip(fs.leaf_first[leaf4] + kk, 0, num_tris - 1)
        kval = (kk < fs.leaf_count[leaf4]) & lvalid[lj]

        # Moller-Trumbore, same arithmetic as core/geometry.py
        rdx, rdy, rdz = dx[ray4], dy[ray4], dz[ray4]
        te2x, te2y, te2z = e2x[slot], e2y[slot], e2z[slot]
        pvx = rdy * te2z - rdz * te2y
        pvy = rdz * te2x - rdx * te2z
        pvz = rdx * te2y - rdy * te2x
        det = e1x[slot] * pvx + e1y[slot] * pvy + e1z[slot] * pvz
        parallel = jnp.abs(det) < MT_DET_EPS
        idet = 1.0 / jnp.where(parallel, 1.0, det)
        tvx = ox[ray4] - v0x[slot]
        tvy = oy[ray4] - v0y[slot]
        tvz = oz[ray4] - v0z[slot]
        u = (tvx * pvx + tvy * pvy + tvz * pvz) * idet
        qvx = tvy * e1z[slot] - tvz * e1y[slot]
        qvy = tvz * e1x[slot] - tvx * e1z[slot]
        qvz = tvx * e1y[slot] - tvy * e1x[slot]
        v = (rdx * qvx + rdy * qvy + rdz * qvz) * idet
        t = (te2x * qvx + te2y * qvy + te2z * qvz) * idet
        mt_valid = (
            (~parallel)
            & (u >= 0.0) & (u <= 1.0)
            & (v >= 0.0) & (u + v <= 1.0)
            & (t >= t_min[ray4]) & (t <= t_max[ray4])
            & kval
        )
        if query_mask != ALL_LAYERS:
            mt_valid = mt_valid & ((layers[slot] & qm) != 0)

        ft = jnp.where(mt_valid, t, _BIG)
        fslot = jnp.where(mt_valid, slot, _IMAX)

        # lexicographic (t, slot) fold — lowest slot wins exact-t ties,
        # matching the serial loop (triangle.h:93-102 + brute oracle)
        new_t = best_t.at[ray4].min(ft)
        cand = ft <= new_t[ray4]               # pairs tying the new best
        keep_old = best_t <= new_t             # previous best still ties
        if any_hit:
            best_slot = jnp.minimum(
                best_slot, best_slot.at[ray4].min(fslot)
            )
        else:
            slot_pool = jnp.where(keep_old, best_slot, _IMAX)
            new_slot = slot_pool.at[ray4].min(
                jnp.where(cand, fslot, _IMAX)
            )
            sel = cand & (fslot == new_slot[ray4]) & (fslot != _IMAX)
            tgt = jnp.where(sel, ray4, r)
            keep_uv = keep_old & (new_slot == best_slot)
            best_u = jnp.where(keep_uv, best_u, 0.0).at[tgt].set(
                u, mode="drop")
            best_v = jnp.where(keep_uv, best_v, 0.0).at[tgt].set(
                v, mode="drop")
            best_slot = new_slot
        best_t = new_t

        # ---- internal pairs -> next frontier ---------------------------
        if _lvl + 1 < fs.depth:
            (pr, pn), pcount = _compact(hit & ~isleaf, (ray, cptr), pair_cap)
            overflow = overflow | (pcount > pair_cap)
            pvalid = jnp.ones((pair_cap,), bool)

    found = best_slot != _IMAX
    gslot = jnp.where(found, best_slot, 0)
    d = rays.direction
    hits = Hits(
        t=jnp.where(found, best_t, T_MAX_DEFAULT),
        position=jnp.where(
            found[:, None],
            rays.origin + d * jnp.where(found, best_t, 0.0)[:, None],
            0.0,
        ),
        normal=jnp.zeros((r, 3), jnp.float32),  # gathered by the wrapper
        u=jnp.where(found, best_u, 0.0),
        v=jnp.where(found, best_v, 0.0),
        prim_id=jnp.where(found, gslot, NO_HIT),  # slot; wrapper maps to id
        hit_layers=jnp.zeros((r,), jnp.int32),
    )
    stats = RayStats(
        rays_cast=jnp.int32(r),
        tri_tests=jnp.sum(tri_tests.astype(jnp.float32)),
        bvh_nodes_visited=jnp.sum(nodes_visited),
        hits=jnp.sum(found.astype(jnp.int32)),
    )
    per_ray = {"tri_tests": tri_tests, "nodes_visited": nodes_visited}
    return hits, stats, found, overflow, per_ray


@jax.jit
def _finalize_hits(hits: Hits, found, tris: Triangles) -> Hits:
    """Map winning slots to prim ids / normals / layers (one gather set)."""
    gslot = jnp.where(found, hits.prim_id, 0).astype(jnp.int32)
    return hits.replace(
        normal=jnp.where(found[:, None], tris.normal[gslot], 0.0),
        prim_id=jnp.where(found, tris.prim_id[gslot], NO_HIT),
        hit_layers=jnp.where(found, tris.layers[gslot], 0),
    )


def cast_rays_frontier(
    rays: Rays,
    fs: FrontierScene,
    tris: Triangles,
    query_mask: int = ALL_LAYERS,
    any_hit: bool = False,
    pair_cap_factor: int = 4,
    leaf_cap_factor: int = 4,
    return_per_ray_stats: bool = False,
):
    """Cast a batch through the frontier backend.

    Returns (hits, stats, occluded[, per_ray_stats]).  On frontier/leaf
    list overflow the cast retries with doubled caps (a recompile) — never
    silently truncates.
    """
    n = int(rays.count)
    pf, lf_ = pair_cap_factor, leaf_cap_factor
    for _attempt in range(4):
        hits, stats, found, overflow, per_ray = _cast_frontier_jit(
            rays, fs, tris.layers, query_mask=int(query_mask),
            any_hit=bool(any_hit),
            pair_cap=pf * n, leaf_cap=lf_ * n,
        )
        if not bool(overflow):
            hits = _finalize_hits(hits, found, tris)
            if return_per_ray_stats:
                return hits, stats, found, per_ray
            return hits, stats, found
        pf, lf_ = pf * 2, lf_ * 2
    raise RuntimeError(
        f"frontier cast overflowed at pair_cap={pf}x, leaf_cap={lf_}x rays"
    )
