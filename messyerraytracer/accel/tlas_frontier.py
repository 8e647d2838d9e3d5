"""Scalable two-level (TLAS/BLAS) cast on the frontier machinery.

The reference's TLAS traversal is log-time over instances with an
object-space ray transform at the instance boundary
(src/accel/scene_tlas.h:203-251, blas_instance.h:48-59).  The flattened
hot path (accel/tlas.py) duplicates every instance's triangles in world
space — N instances of one mesh cost N x memory.  This module keeps
two-level semantics AND device-native execution:

  Phase A — frontier descent (accel/frontier.py style) over a wide TLAS
  built on instance world AABBs; TLAS leaves expand to per-instance AABB
  tests, yielding compacted (ray, instance) pairs.

  Phase B — each pair transforms its ray into object space (direction NOT
  renormalized, so t stays world-parameterized — blas_instance.h:48-59)
  and descends the BLAS *forest*: every registered mesh's wide tree lives
  once in concatenated tables, so memory scales with unique meshes, not
  instances.  Pairs carry their own ray data; per-ray best_t still feeds
  level-lagged culling across all instances at once.

Winner selection is a lexicographic (t, instance, slot) scatter-min so
results are deterministic; prim_id is reported in the flattened scene's
numbering (instance_base + mesh-local id) so this path is bit-comparable
with the flattened path on t/prim_id.

Layout rule as in accel/frontier.py: all traversal-sized arrays are flat
1-D.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core.types import (
    ALL_LAYERS,
    MT_DET_EPS,
    NO_HIT,
    T_MAX_DEFAULT,
    Hits,
    Rays,
    RayStats,
)
from ..utils.struct import pytree_dataclass
from .bvh import build_bvh_over_aabbs
from .frontier import _BIG, _IMAX, _compact, _safe_inv


@pytree_dataclass(meta_fields=("tlas_depth", "blas_depth"))
class FrontierTLAS:
    """Two-level frontier tables (flat device arrays).

    TLAS: wide tree over instances; leaf slots map to instance ids.
    Forest: every mesh's wide tree concatenated (node/leaf/tri indices are
    global).  Instances carry [R|t], its inverse, blas root, layer mask,
    and the flat-scene prim-id base.
    """

    # TLAS wide tree (8Wt,) + leaf->instance slots (4Lt,)
    tlas_box: tuple           # 6 x (8Wt,) f32  (min xyz, max xyz)
    tlas_enc: jnp.ndarray     # (8Wt,) int32
    tlas_leaf_inst: jnp.ndarray   # (4Lt,) int32 instance id (-1 pad)
    # instance world AABBs (for leaf-level per-instance culling)
    inst_box: tuple           # 6 x (I,) f32
    inst_inv: tuple           # 12 x (I,) f32  world->object [R|t] rows
    inst_root: jnp.ndarray    # (I,) int32 forest wide-node root
    inst_layers: jnp.ndarray  # (I,) int32
    inst_prim_base: jnp.ndarray  # (I,) int32 flat-scene prim id base
    # BLAS forest (8Wf,), leaves (Lf,), object-space tris (F,)
    forest_box: tuple         # 6 x (8Wf,) f32
    forest_enc: jnp.ndarray   # (8Wf,) int32 (global ids)
    leaf_first: jnp.ndarray   # (Lf,) int32 global tri slot
    leaf_count: jnp.ndarray   # (Lf,) int32
    tri: tuple                # 9 x (F,) f32 object-space v0/e1/e2
    tri_prim: jnp.ndarray     # (F,) int32 mesh-local original prim id
    tri_layers: jnp.ndarray   # (F,) int32
    tri_normal: jnp.ndarray   # (F, 3) f32 object-space normals
    tlas_depth: int = 1
    blas_depth: int = 1


# the wide-collapse -> table encoding lives in accel/frontier.py
# (collapse_tables): one source of truth for both traversals
from .frontier import collapse_tables as _collapse_tables  # noqa: E402


def build_frontier_tlas(tlas) -> FrontierTLAS:
    """Build two-level tables from a ``SceneTLAS`` (host index math).

    Forest memory scales with registered *meshes*; instances add only a
    handful of scalars each (the sub-linear-memory contract of
    scene_tlas.h's native TLAS).
    """
    from .tlas import _bvh_host

    meshes, instances = tlas.meshes, tlas.instances
    assert instances, "build_frontier_tlas: no instances"

    # ---- BLAS forest ---------------------------------------------------
    fmin, fmax, fenc, ffirst, fcount = [], [], [], [], []
    roots, node_off, leaf_off, tri_off = [], 0, 0, 0
    tri_parts, prim_parts, lay_parts, nrm_parts = [], [], [], []
    blas_depth = 1
    mesh_tris = []
    for mesh in meshes:
        bvh = mesh.scene.bvh
        amin = _bvh_host(bvh, "aabb_min")
        amax = _bvh_host(bvh, "aabb_max")
        lf = _bvh_host(bvh, "left_first")
        cnt = _bvh_host(bvh, "count")
        cmin, cmax, enc, leaves, depth = _collapse_tables(amin, amax, lf, cnt)
        blas_depth = max(blas_depth, depth)
        # globalize: internal ptr += node_off, leaf ptr += leaf_off
        is_leaf_enc = (enc & 1) == 1
        gptr = (enc >> 1) + np.where(is_leaf_enc, leaf_off, node_off)
        fenc.append((2 * gptr + is_leaf_enc).astype(np.int32).reshape(-1))
        fmin.append(cmin.reshape(-1, 3))
        fmax.append(cmax.reshape(-1, 3))
        ffirst.append((lf[leaves] + tri_off).astype(np.int32))
        fcount.append(cnt[leaves].astype(np.int32))
        roots.append(node_off)
        node_off += enc.shape[0]
        leaf_off += len(leaves)
        t = mesh.scene.tris
        tri_parts.append(t)
        prim_parts.append(np.asarray(t.prim_id))
        lay_parts.append(np.asarray(t.layers))
        mesh_tris.append(mesh.num_tris)
        tri_off += mesh.num_tris

    tri = tuple(
        jnp.concatenate([getattr(t, f)[:, a] for t in tri_parts])
        for f in ("v0", "edge1", "edge2")
        for a in range(3)
    )
    tri_normal = jnp.concatenate([t.normal for t in tri_parts])

    # ---- instances ------------------------------------------------------
    n_inst = len(instances)
    inv = np.stack([i.inv_transform for i in instances])     # (I,3,4)
    ibox_min = np.zeros((n_inst, 3), np.float32)
    ibox_max = np.zeros((n_inst, 3), np.float32)
    prim_base = np.zeros(n_inst, np.int32)
    base = 0
    for i, inst in enumerate(instances):
        omn, omx = meshes[inst.blas_id].object_bounds()
        ibox_min[i], ibox_max[i] = inst.world_aabb(omn, omx)
        prim_base[i] = base
        base += mesh_tris[inst.blas_id]

    # ---- TLAS wide tree over instance AABBs -----------------------------
    cent = (ibox_min + ibox_max) * 0.5
    tbvh = build_bvh_over_aabbs(ibox_min, ibox_max, cent)
    tmin_h = _bvh_host(tbvh, "aabb_min")
    tmax_h = _bvh_host(tbvh, "aabb_max")
    tlf = _bvh_host(tbvh, "left_first")
    tcnt = _bvh_host(tbvh, "count")
    torder = _bvh_host(tbvh, "tri_order")    # instance permutation
    cmin, cmax, enc, leaves, tlas_depth = _collapse_tables(
        tmin_h, tmax_h, tlf, tcnt
    )
    # leaf slots -> instance ids (4 per leaf, -1 pad)
    lt = len(leaves)
    leaf_inst = np.full((lt, 4), -1, np.int32)
    for k in range(4):
        slot = np.clip(tlf[leaves] + k, 0, n_inst - 1)
        leaf_inst[:, k] = np.where(k < tcnt[leaves], torder[slot], -1)

    return FrontierTLAS(
        tlas_box=tuple(
            jnp.asarray(arr[:, :, a].reshape(-1))
            for arr in (cmin, cmax) for a in range(3)
        ),
        tlas_enc=jnp.asarray(enc.reshape(-1)),
        tlas_leaf_inst=jnp.asarray(leaf_inst.reshape(-1)),
        inst_box=tuple(
            jnp.asarray(arr[:, a]) for arr in (ibox_min, ibox_max)
            for a in range(3)
        ),
        inst_inv=tuple(
            jnp.asarray(inv[:, i, j].copy()) for i in range(3)
            for j in range(4)
        ),
        inst_root=jnp.asarray(np.asarray(roots, np.int32)[
            np.asarray([i.blas_id for i in instances], np.int32)]),
        inst_layers=jnp.asarray(
            np.asarray([i.layers for i in instances], np.int32)),
        inst_prim_base=jnp.asarray(prim_base),
        forest_box=tuple(
            jnp.asarray(np.concatenate(arrs)[:, a])
            for arrs in (fmin, fmax) for a in range(3)
        ),
        forest_enc=jnp.asarray(np.concatenate(fenc)),
        leaf_first=jnp.asarray(np.concatenate(ffirst)),
        leaf_count=jnp.asarray(np.concatenate(fcount)),
        tri=tri,
        tri_prim=jnp.asarray(np.concatenate(prim_parts)),
        tri_layers=jnp.asarray(np.concatenate(lay_parts)),
        tri_normal=tri_normal,
        tlas_depth=tlas_depth,
        blas_depth=blas_depth,
    )


def _slab_flat(bminx, bmaxx, bminy, bmaxy, bminz, bmaxz,
               ox, oy, oz, ix, iy, iz, cap_t):
    t1 = (bminx - ox) * ix
    t2 = (bmaxx - ox) * ix
    tn = jnp.minimum(t1, t2)
    tf = jnp.maximum(t1, t2)
    t1 = (bminy - oy) * iy
    t2 = (bmaxy - oy) * iy
    tn = jnp.maximum(tn, jnp.minimum(t1, t2))
    tf = jnp.minimum(tf, jnp.maximum(t1, t2))
    t1 = (bminz - oz) * iz
    t2 = (bmaxz - oz) * iz
    tn = jnp.maximum(tn, jnp.minimum(t1, t2))
    tf = jnp.minimum(tf, jnp.maximum(t1, t2))
    return (tf >= jnp.maximum(tn, 0.0)) & (tn <= cap_t)


@functools.partial(
    jax.jit,
    static_argnames=("query_mask", "any_hit", "inst_cap", "pair_cap",
                     "leaf_cap"),
)
def _cast_tlas_jit(rays: Rays, ft: FrontierTLAS, *, query_mask: int,
                   any_hit: bool, inst_cap: int, pair_cap: int,
                   leaf_cap: int):
    r = rays.count
    num_tris = ft.tri[0].shape[0]
    ox, oy, oz = (rays.origin[:, a] for a in range(3))
    dx, dy, dz = (rays.direction[:, a] for a in range(3))
    ix, iy, iz = _safe_inv(dx), _safe_inv(dy), _safe_inv(dz)
    t_min, t_max = rays.t_min, rays.t_max
    qm = jnp.int32(query_mask)

    best_t = jnp.full((r,), _BIG, jnp.float32)
    best_inst = jnp.full((r,), _IMAX, jnp.int32)
    best_slot = jnp.full((r,), _IMAX, jnp.int32)
    best_u = jnp.zeros((r,), jnp.float32)
    best_v = jnp.zeros((r,), jnp.float32)
    nodes_visited = jnp.zeros((r,), jnp.int32)
    tri_tests = jnp.zeros((r,), jnp.int32)
    overflow = jnp.bool_(False)

    # ================= Phase A: TLAS descent =========================
    pr = jnp.arange(r, dtype=jnp.int32)
    pn = jnp.zeros((r,), jnp.int32)
    pvalid = t_max >= t_min
    pcount = jnp.int32(r)
    ir = jnp.zeros((inst_cap,), jnp.int32)     # (ray, instance) pairs
    ii = jnp.zeros((inst_cap,), jnp.int32)
    icount = jnp.int32(0)

    bminx, bmaxx, bminy, bmaxy, bminz, bmaxz = (
        ft.tlas_box[0], ft.tlas_box[3], ft.tlas_box[1], ft.tlas_box[4],
        ft.tlas_box[2], ft.tlas_box[5],
    )
    for _lvl in range(ft.tlas_depth):
        p = pr.shape[0]
        pv = pvalid
        if _lvl:
            pv = pv & (jnp.arange(p, dtype=jnp.int32) < pcount)
        nodes_visited = nodes_visited.at[pr].add(pv.astype(jnp.int32))
        j = jnp.arange(p * 8, dtype=jnp.int32)
        pj = jax.lax.shift_right_logical(j, 3)
        ray = pr[pj]
        fidx = pn[pj] * 8 + (j & 7)
        enc = ft.tlas_enc[fidx]
        cap_t = jnp.minimum(best_t[ray], t_max[ray])
        hit = _slab_flat(
            bminx[fidx], bmaxx[fidx], bminy[fidx], bmaxy[fidx],
            bminz[fidx], bmaxz[fidx],
            ox[ray], oy[ray], oz[ray], ix[ray], iy[ray], iz[ray], cap_t,
        ) & pv[pj]
        isleaf = (enc & 1) == 1
        cptr = jax.lax.shift_right_logical(enc, 1)

        # leaf -> expand 4 instance slots, cull by instance world AABB
        (lr, lp), ln = _compact(hit & isleaf, (ray, cptr), pair_cap)
        overflow = overflow | (ln > pair_cap)
        lvalid = jnp.arange(pair_cap, dtype=jnp.int32) < ln
        jj = jnp.arange(pair_cap * 4, dtype=jnp.int32)
        lj = jax.lax.shift_right_logical(jj, 2)
        kk = jj & 3
        ray4 = lr[lj]
        inst = ft.tlas_leaf_inst[jnp.clip(lp[lj] * 4 + kk, 0,
                                          ft.tlas_leaf_inst.shape[0] - 1)]
        ivalid = lvalid[lj] & (inst >= 0)
        gi = jnp.maximum(inst, 0)
        cap4 = jnp.minimum(best_t[ray4], t_max[ray4])
        ihit = _slab_flat(
            ft.inst_box[0][gi], ft.inst_box[3][gi],
            ft.inst_box[1][gi], ft.inst_box[4][gi],
            ft.inst_box[2][gi], ft.inst_box[5][gi],
            ox[ray4], oy[ray4], oz[ray4],
            ix[ray4], iy[ray4], iz[ray4], cap4,
        ) & ivalid
        if query_mask != ALL_LAYERS:
            ihit = ihit & ((ft.inst_layers[gi] & qm) != 0)
        (nir, nii), nic = _compact(ihit, (ray4, gi), inst_cap)
        # append into the (ray, instance) accumulator
        take = jnp.arange(inst_cap, dtype=jnp.int32) < nic
        dst = jnp.where(take, icount + jnp.arange(inst_cap, dtype=jnp.int32),
                        inst_cap)
        ir = ir.at[dst].set(nir, mode="drop")
        ii = ii.at[dst].set(nii, mode="drop")
        icount = icount + nic
        overflow = overflow | (icount > inst_cap)

        if _lvl + 1 < ft.tlas_depth:
            (pr, pn), pcount = _compact(hit & ~isleaf, (ray, cptr), pair_cap)
            overflow = overflow | (pcount > pair_cap)
            pvalid = jnp.ones((pair_cap,), bool)

    # ============== ray -> object space per (ray, instance) pair =======
    iv = [ft.inst_inv[k][ii] for k in range(12)]
    box_, boy_, boz_ = ox[ir], oy[ir], oz[ir]
    bdx_, bdy_, bdz_ = dx[ir], dy[ir], dz[ir]
    oox = iv[0] * box_ + iv[1] * boy_ + iv[2] * boz_ + iv[3]
    ooy = iv[4] * box_ + iv[5] * boy_ + iv[6] * boz_ + iv[7]
    ooz = iv[8] * box_ + iv[9] * boy_ + iv[10] * boz_ + iv[11]
    odx = iv[0] * bdx_ + iv[1] * bdy_ + iv[2] * bdz_
    ody = iv[4] * bdx_ + iv[5] * bdy_ + iv[6] * bdz_
    odz = iv[8] * bdx_ + iv[9] * bdy_ + iv[10] * bdz_
    oix, oiy, oiz = _safe_inv(odx), _safe_inv(ody), _safe_inv(odz)

    # pair-carried state for phase B (compaction threads it through)
    pb = {
        "ray": ir, "inst": ii,
        "ox": oox, "oy": ooy, "oz": ooz,
        "dx": odx, "dy": ody, "dz": odz,
        "ix": oix, "iy": oiy, "iz": oiz,
    }
    pb_keys = list(pb.keys())
    pn_b = ft.inst_root[ii]
    pcount_b = icount
    pair_n = inst_cap

    fbx, fBx, fby, fBy, fbz, fBz = (
        ft.forest_box[0], ft.forest_box[3], ft.forest_box[1],
        ft.forest_box[4], ft.forest_box[2], ft.forest_box[5],
    )
    # ================= Phase B: BLAS forest descent ====================
    for _lvl in range(ft.blas_depth):
        p = pair_n
        pv = jnp.arange(p, dtype=jnp.int32) < pcount_b
        nodes_visited = nodes_visited.at[pb["ray"]].add(pv.astype(jnp.int32))
        j = jnp.arange(p * 8, dtype=jnp.int32)
        pj = jax.lax.shift_right_logical(j, 3)
        fidx = pn_b[pj] * 8 + (j & 7)
        enc = ft.forest_enc[fidx]
        ray = pb["ray"][pj]
        cap_t = jnp.minimum(best_t[ray], t_max[ray])
        hit = _slab_flat(
            fbx[fidx], fBx[fidx], fby[fidx], fBy[fidx], fbz[fidx],
            fBz[fidx],
            pb["ox"][pj], pb["oy"][pj], pb["oz"][pj],
            pb["ix"][pj], pb["iy"][pj], pb["iz"][pj], cap_t,
        ) & pv[pj]
        isleaf = (enc & 1) == 1
        cptr = jax.lax.shift_right_logical(enc, 1)

        # ---- leaf pairs: 4-tri object-space Moller-Trumbore -----------
        lvals, ln = _compact(
            hit & isleaf,
            tuple(pb[k][pj] for k in pb_keys) + (cptr,), leaf_cap,
        )
        overflow = overflow | (ln > leaf_cap)
        lp = lvals[-1]
        lb = dict(zip(pb_keys, lvals[:-1]))
        lvalid = jnp.arange(leaf_cap, dtype=jnp.int32) < ln
        tri_tests = tri_tests.at[lb["ray"]].add(
            jnp.where(lvalid, ft.leaf_count[lp], 0)
        )

        jj = jnp.arange(leaf_cap * 4, dtype=jnp.int32)
        lj = jax.lax.shift_right_logical(jj, 2)
        kk = jj & 3
        ray4 = lb["ray"][lj]
        inst4 = lb["inst"][lj]
        leaf4 = lp[lj]
        slot = jnp.clip(ft.leaf_first[leaf4] + kk, 0, num_tris - 1)
        kval = (kk < ft.leaf_count[leaf4]) & lvalid[lj]

        v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = ft.tri
        rdx, rdy, rdz = lb["dx"][lj], lb["dy"][lj], lb["dz"][lj]
        te2x, te2y, te2z = e2x[slot], e2y[slot], e2z[slot]
        pvx = rdy * te2z - rdz * te2y
        pvy = rdz * te2x - rdx * te2z
        pvz = rdx * te2y - rdy * te2x
        det = e1x[slot] * pvx + e1y[slot] * pvy + e1z[slot] * pvz
        parallel = jnp.abs(det) < MT_DET_EPS
        idet = 1.0 / jnp.where(parallel, 1.0, det)
        tvx = lb["ox"][lj] - v0x[slot]
        tvy = lb["oy"][lj] - v0y[slot]
        tvz = lb["oz"][lj] - v0z[slot]
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
            mt_valid = mt_valid & (
                ((ft.tri_layers[slot] & ft.inst_layers[inst4]) & qm) != 0
            )

        ft_ = jnp.where(mt_valid, t, _BIG)
        finst = jnp.where(mt_valid, inst4, _IMAX)
        fslot = jnp.where(mt_valid, slot, _IMAX)

        # lexicographic (t, inst, slot) fold
        new_t = best_t.at[ray4].min(ft_)
        t_tie = ft_ <= new_t[ray4]
        keep_t = best_t <= new_t
        inst_pool = jnp.where(keep_t, best_inst, _IMAX)
        new_inst = inst_pool.at[ray4].min(jnp.where(t_tie, finst, _IMAX))
        i_tie = t_tie & (finst == new_inst[ray4])
        keep_i = keep_t & (new_inst == best_inst)
        slot_pool = jnp.where(keep_i, best_slot, _IMAX)
        new_slot = slot_pool.at[ray4].min(jnp.where(i_tie, fslot, _IMAX))
        if not any_hit:
            sel = i_tie & (fslot == new_slot[ray4]) & (fslot != _IMAX)
            tgt = jnp.where(sel, ray4, r)
            keep_uv = keep_i & (new_slot == best_slot)
            best_u = jnp.where(keep_uv, best_u, 0.0).at[tgt].set(
                u, mode="drop")
            best_v = jnp.where(keep_uv, best_v, 0.0).at[tgt].set(
                v, mode="drop")
        best_t, best_inst, best_slot = new_t, new_inst, new_slot

        # ---- internal pairs -> next frontier --------------------------
        if _lvl + 1 < ft.blas_depth:
            nvals, pcount_b = _compact(
                hit & ~isleaf,
                tuple(pb[k][pj] for k in pb_keys) + (cptr,), pair_cap,
            )
            pn_b = nvals[-1]
            pb = dict(zip(pb_keys, nvals[:-1]))
            overflow = overflow | (pcount_b > pair_cap)
            pair_n = pair_cap

    # ================= finalize ========================================
    found = best_slot != _IMAX
    gslot = jnp.where(found, best_slot, 0)
    gi = jnp.where(found, best_inst, 0)
    # object normal -> world: n_w = n_o @ R^-1 (blas_instance.h:62-70)
    n_o = ft.tri_normal[gslot]
    ivr = [ft.inst_inv[k][gi] for k in range(12)]
    nwx = n_o[:, 0] * ivr[0] + n_o[:, 1] * ivr[4] + n_o[:, 2] * ivr[8]
    nwy = n_o[:, 0] * ivr[1] + n_o[:, 1] * ivr[5] + n_o[:, 2] * ivr[9]
    nwz = n_o[:, 0] * ivr[2] + n_o[:, 1] * ivr[6] + n_o[:, 2] * ivr[10]
    nrm = jnp.stack([nwx, nwy, nwz], axis=1)
    nl = jnp.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm = nrm / jnp.where(nl > 0, nl, 1.0)

    prim_flat = ft.inst_prim_base[gi] + ft.tri_prim[gslot]
    hits = Hits(
        t=jnp.where(found, best_t, T_MAX_DEFAULT),
        position=jnp.where(
            found[:, None],
            rays.origin + rays.direction
            * jnp.where(found, best_t, 0.0)[:, None],
            0.0,
        ),
        normal=jnp.where(found[:, None], nrm, 0.0),
        u=jnp.where(found, best_u, 0.0),
        v=jnp.where(found, best_v, 0.0),
        prim_id=jnp.where(found, prim_flat, NO_HIT),
        hit_layers=jnp.where(
            found, ft.tri_layers[gslot] & ft.inst_layers[gi], 0
        ),
    )
    stats = RayStats(
        rays_cast=jnp.int32(r),
        tri_tests=jnp.sum(tri_tests.astype(jnp.float32)),
        bvh_nodes_visited=jnp.sum(nodes_visited),
        hits=jnp.sum(found.astype(jnp.int32)),
    )
    inst_out = jnp.where(found, best_inst, -1)
    return hits, stats, found, inst_out, overflow


def cast_rays_tlas(rays: Rays, ft: FrontierTLAS,
                   query_mask: int = ALL_LAYERS, any_hit: bool = False,
                   inst_cap_factor: int = 4, pair_cap_factor: int = 4,
                   leaf_cap_factor: int = 4):
    """Two-level cast: returns (hits, stats, occluded, instance_id).

    Overflow retries with doubled caps — never silently truncates.
    Caps scale with BOTH the ray count and the instance count: a 1-ray
    probe through a many-instance scene legitimately produces up to
    rays x instances (ray, instance) pairs, so ray-count-only sizing
    would overflow deterministically regardless of retries.
    """
    n = int(rays.count)
    n_inst = int(ft.inst_root.shape[0])
    # hard bound for the instance-pair list; pair/leaf lists have no small
    # closed-form bound, so they keep doubling with enough attempts
    inst_hard = n * max(n_inst, 1)
    fi, fp, fl = inst_cap_factor, pair_cap_factor, leaf_cap_factor
    for _attempt in range(12):
        hits, stats, found, inst, overflow = _cast_tlas_jit(
            rays, ft, query_mask=int(query_mask), any_hit=bool(any_hit),
            inst_cap=min(fi * n, inst_hard), pair_cap=fp * n,
            leaf_cap=fl * n,
        )
        if not bool(overflow):
            return hits, stats, found, inst
        fi, fp, fl = fi * 2, fp * 2, fl * 2
    raise RuntimeError("two-level frontier cast overflowed after retries")
