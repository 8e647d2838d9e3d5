"""Per-ray BVH traversal kernel (Pallas, Triton route).

One lane owns one ray and walks the binary DFS BVH (accel/bvh.py) front to
back with a private stack, the shape of the reference's per-thread GPU
loop (src/gpu/shaders/bvh_traverse.comp.glsl:198-328: one ray per
invocation, 24-deep stack, near child first).  A program handles ``BLOCK``
rays; the grid runs over ray blocks, so every SM of the card gets work.

Each loop step a lane does exactly one of:

  * internal node: slab-test both children (left = ``node + 1``, right =
    ``left_first``) against the ray's current best t, continue into the
    first child by the direction sign on ``split_axis`` and push the
    other if both hit;
  * leaf: Moller-Trumbore its <= 4 triangles (strictly-closer update, so
    the lowest slot wins exact ties inside a leaf, triangle.h:93), with
    the layer mask filtered during the test (ray_scene.h:124), then pop;
  * instanced scenes only, a TLAS leaf: move the ray into the instance's
    object space (direction not renormalized, so t stays world-
    parameterized, blas_instance.h:48-59) and continue at the mesh's BLAS
    root.  Popping a TLAS node restores the world ray, since the stack
    discipline finishes every BLAS entry before any TLAS entry below it.

Each lane's stack is its own ``depth`` entries of a scratch output in
device memory, pushed and popped with masked scalar stores and loads
(they stay in L1/L2).  A ``(BLOCK, depth)`` register tensor was measured
as the alternative and is slower: every push and pop then selects across
all ``depth`` entries.  ``depth`` comes from the built tree
(``len(bvh.levels)``, TLAS + BLAS levels for two-level scenes) so a push
never overflows on a well-formed tree.  A push that would overflow is
dropped and counted per ray (``RayStats.stack_drops``), never silently.

Numerics follow the oracle (core/brute.py): the classic MT form with
``MT_DET_EPS``, the safe inverse direction with ``INV_DIR_EPS``, and the
``MT_BARY_EPS`` barycentric band that keeps shared edges watertight when
the card's FMA contraction rounds an edge function differently from the
oracle.  Triton lowers f32 ``/`` to an approximate divide, so compiled
kernels divide with ``div.rn.f32``.

``kernel_interpret`` is the one routing decision: compiled on the GPU,
the Pallas interpreter on the CPU (how the tests drive this very kernel),
and an error anywhere else.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..core.types import (
    ALL_LAYERS,
    INV_DIR_EPS,
    MT_BARY_EPS,
    MT_DET_EPS,
    NO_HIT,
    T_MAX_DEFAULT,
    Hits,
    Rays,
    RayStats,
    Triangles,
)
from ..utils.struct import pytree_dataclass

BLOCK = 128       # rays per program, one lane each
NUM_WARPS = 4     # 128 threads: one ray per thread
LEAF_SIZE = 4     # accel/bvh.py MAX_LEAF_SIZE


def kernel_interpret(platform: str | None = None) -> bool:
    """Map the JAX platform to how the traversal kernel runs.

    ``"gpu"`` compiles it through Triton; ``"cpu"`` runs the same kernel
    in the Pallas interpreter.  Any other platform has no kernel and
    raises rather than falling back silently."""
    platform = jax.default_backend() if platform is None else platform
    if platform == "gpu":
        return False
    if platform == "cpu":
        return True
    raise RuntimeError(
        f"no traversal kernel for platform {platform!r}: the kernel runs "
        "compiled on 'gpu' or interpreted on 'cpu'")


def stack_depth(levels: int) -> int:
    """Per-lane stack entries for a tree of ``levels`` levels: the walk
    keeps at most one pending sibling per level, rounded up to a power
    of two (Triton block shapes are power-of-two sized)."""
    need = max(int(levels), 2)
    return 1 << (need - 1).bit_length()


def pad_count(n: int) -> int:
    """Ray count rounded up to whole kernel blocks."""
    return max(-(-n // BLOCK), 1) * BLOCK


# ---------------------------------------------------------------------------
# kernel body
# ---------------------------------------------------------------------------

def _div(a, b, precise: bool):
    """IEEE f32 division in compiled kernels (Triton's ``/`` is the
    approximate ``div.full.f32``); plain division in the interpreter."""
    if not precise:
        return a / b
    [out] = plgpu.elementwise_inline_asm(
        "div.rn.f32 $0, $1, $2;",
        args=[a, b],
        constraints="=f,f,f",
        pack=1,
        result_shape_dtypes=[jax.ShapeDtypeStruct(a.shape, jnp.float32)],
    )
    return out


def _safe_inv(d, precise):
    """core/types.py safe_inv_direction, per component."""
    small = jnp.abs(d) < INV_DIR_EPS
    sign = jnp.where(d < 0.0, -1.0, 1.0).astype(jnp.float32)
    return jnp.where(small, sign * (1.0 / INV_DIR_EPS),
                     _div(jnp.ones_like(d), jnp.where(small, 1.0, d),
                          precise))


def _walk_kernel(*refs, instanced: bool, any_hit: bool, query_mask: int,
                 depth: int, n_tlas: int, precise: bool):
    (ox_r, oy_r, oz_r, dx_r, dy_r, dz_r, tn_r, tx_r,
     nmin_r, nmax_r, lf_r, cnt_r, ax_r, v0_r, e1_r, e2_r, lay_r) = refs[:17]
    rest = refs[17:]
    if instanced:
        inv_r, root_r, ilay_r = rest[:3]
        rest = rest[3:]
    (t_o, u_o, v_o, slot_o, inst_o, tt_o, nv_o, drop_o, stack_r) = rest

    def gather(ref, idx, mask, other=0):
        return plgpu.load(ref.at[jnp.where(mask, idx, 0)], mask=mask,
                          other=other)

    wo = (ox_r[...], oy_r[...], oz_r[...])
    wd = (dx_r[...], dy_r[...], dz_r[...])
    t_min = tn_r[...]
    t_max = tx_r[...]
    b = t_min.shape[0]
    winv = tuple(_safe_inv(c, precise) for c in wd)
    lane_base = jax.lax.broadcasted_iota(jnp.int32, (b,), 0) * depth
    zi = jnp.zeros((b,), jnp.int32)
    zf = jnp.zeros((b,), jnp.float32)

    def load_box(node, mask):
        base = node * 3
        bmin = tuple(gather(nmin_r, base + k, mask, 0.0) for k in range(3))
        bmax = tuple(gather(nmax_r, base + k, mask, 0.0) for k in range(3))
        return bmin, bmax

    def slab(bmin, bmax, o, inv, cap):
        tn = None
        tf = None
        for k in range(3):
            t1 = (bmin[k] - o[k]) * inv[k]
            t2 = (bmax[k] - o[k]) * inv[k]
            lo = jnp.minimum(t1, t2)
            hi = jnp.maximum(t1, t2)
            tn = lo if tn is None else jnp.maximum(tn, lo)
            tf = hi if tf is None else jnp.minimum(tf, hi)
        return (tf >= jnp.maximum(tn, 0.0)) & (tn <= cap)

    # root-box gate: a dead (t_max < t_min) or degenerate ray never walks
    live = t_max >= t_min
    best_t0 = jnp.minimum(t_max, T_MAX_DEFAULT)
    rmin, rmax = load_box(zi, live)
    root_hit = live & slab(rmin, rmax, wo, winv, best_t0)
    node0 = jnp.where(root_hit, 0, -1)

    def body(carry):
        (node, sp, best_t, best_u, best_v, best_slot, best_inst,
         tt, nv, drops, cur, cur_inst, lane_qm) = carry
        co, cd, cinv = cur
        alive = node >= 0
        nidx = jnp.where(alive, node, 0)
        cnt = gather(cnt_r, nidx, alive)
        lf = gather(lf_r, nidx, alive)
        nv = nv + alive.astype(jnp.int32)
        is_leaf = alive & (cnt > 0)
        if instanced:
            tlas_node = node < n_tlas
            blas_leaf = is_leaf & ~tlas_node
        else:
            blas_leaf = is_leaf

        # ---- leaf: <= 4 triangles, strictly-closer update ------------
        occluded = jnp.zeros((b,), jnp.bool_)
        for k in range(LEAF_SIZE):
            mk = blas_leaf & (cnt > k)
            s3 = (lf + k) * 3
            v0 = tuple(gather(v0_r, s3 + a, mk, 0.0) for a in range(3))
            e1 = tuple(gather(e1_r, s3 + a, mk, 0.0) for a in range(3))
            e2 = tuple(gather(e2_r, s3 + a, mk, 0.0) for a in range(3))
            pvx = cd[1] * e2[2] - cd[2] * e2[1]
            pvy = cd[2] * e2[0] - cd[0] * e2[2]
            pvz = cd[0] * e2[1] - cd[1] * e2[0]
            det = e1[0] * pvx + e1[1] * pvy + e1[2] * pvz
            parallel = jnp.abs(det) < MT_DET_EPS
            idet = _div(jnp.ones_like(det), jnp.where(parallel, 1.0, det),
                        precise)
            tvx = co[0] - v0[0]
            tvy = co[1] - v0[1]
            tvz = co[2] - v0[2]
            u = (tvx * pvx + tvy * pvy + tvz * pvz) * idet
            qvx = tvy * e1[2] - tvz * e1[1]
            qvy = tvz * e1[0] - tvx * e1[2]
            qvz = tvx * e1[1] - tvy * e1[0]
            v = (cd[0] * qvx + cd[1] * qvy + cd[2] * qvz) * idet
            t = (e2[0] * qvx + e2[1] * qvy + e2[2] * qvz) * idet
            valid = (
                mk & ~parallel
                & (u >= -MT_BARY_EPS) & (u <= 1.0 + MT_BARY_EPS)
                & (v >= -MT_BARY_EPS) & (u + v <= 1.0 + MT_BARY_EPS)
                & (t >= t_min) & (t <= t_max)
            )
            if instanced or query_mask != ALL_LAYERS:
                lay = gather(lay_r, lf + k, mk)
                valid = valid & ((lay & lane_qm) != 0)
            better = valid & (t < best_t)
            best_t = jnp.where(better, t, best_t)
            best_u = jnp.where(better, u, best_u)
            best_v = jnp.where(better, v, best_v)
            best_slot = jnp.where(better, lf + k, best_slot)
            if instanced:
                best_inst = jnp.where(better, cur_inst, best_inst)
            occluded = occluded | valid
        tt = tt + jnp.where(blas_leaf, cnt, 0)

        # ---- internal: both children, first by direction sign --------
        internal = alive & (cnt == 0)
        left = node + 1
        right = lf
        lmin, lmax = load_box(left, internal)
        rmin_, rmax_ = load_box(right, internal)
        lhit = internal & slab(lmin, lmax, co, cinv, best_t)
        rhit = internal & slab(rmin_, rmax_, co, cinv, best_t)
        axis = gather(ax_r, nidx, internal)
        dax = jnp.where(axis == 0, cd[0], jnp.where(axis == 1, cd[1], cd[2]))
        neg = dax < 0.0
        first = jnp.where(neg, right, left)
        second = jnp.where(neg, left, right)
        fhit = jnp.where(neg, rhit, lhit)
        shit = jnp.where(neg, lhit, rhit)
        push = fhit & shit
        fits = sp < depth
        do_push = push & fits
        drops = drops + (push & ~fits).astype(jnp.int32)
        # masked-off lanes still address their own entries: the
        # interpreter's masked store rewrites the addressed old value,
        # which must not race another lane's push
        plgpu.store(stack_r.at[lane_base + jnp.minimum(sp, depth - 1)],
                    second, mask=do_push)
        sp = sp + do_push.astype(jnp.int32)
        nxt = jnp.where(fhit, first, jnp.where(shit, second, -1))

        # ---- TLAS leaf: enter the instance's BLAS in object space -----
        if instanced:
            tlas_leaf = is_leaf & tlas_node
            inst = lf
            lqm = gather(ilay_r, inst, tlas_leaf) & jnp.int32(query_mask)
            enter = tlas_leaf & (lqm != 0)
            m = tuple(gather(inv_r, inst * 12 + j, enter, 0.0)
                      for j in range(12))
            oo = tuple(m[4 * r] * wo[0] + m[4 * r + 1] * wo[1]
                       + m[4 * r + 2] * wo[2] + m[4 * r + 3]
                       for r in range(3))
            od = tuple(m[4 * r] * wd[0] + m[4 * r + 1] * wd[1]
                       + m[4 * r + 2] * wd[2] for r in range(3))
            oinv = tuple(_safe_inv(c, precise) for c in od)
            co = tuple(jnp.where(enter, a, c) for a, c in zip(oo, co))
            cd = tuple(jnp.where(enter, a, c) for a, c in zip(od, cd))
            cinv = tuple(jnp.where(enter, a, c) for a, c in zip(oinv, cinv))
            cur_inst = jnp.where(enter, inst, cur_inst)
            lane_qm = jnp.where(enter, lqm, lane_qm)
            root = gather(root_r, inst, enter)
            nxt = jnp.where(enter, root, nxt)

        # ---- pop where this step produced no next node ----------------
        need_pop = alive & (nxt < 0)
        popped = need_pop & (sp > 0)
        top = gather(stack_r, lane_base + sp - 1, popped)
        node = jnp.where(popped, top, nxt)
        sp = sp - popped.astype(jnp.int32)
        if instanced:
            # back in the TLAS: every entry of the finished BLAS is gone
            leave = popped & (top < n_tlas)
            co = tuple(jnp.where(leave, w, c) for w, c in zip(wo, co))
            cd = tuple(jnp.where(leave, w, c) for w, c in zip(wd, cd))
            cinv = tuple(jnp.where(leave, w, c) for w, c in zip(winv, cinv))
        if any_hit:
            node = jnp.where(occluded, -1, node)   # per-lane retirement
        return (node, sp, best_t, best_u, best_v, best_slot,
                best_inst, tt, nv, drops, (co, cd, cinv), cur_inst, lane_qm)

    def cond(carry):
        return jnp.max(carry[0]) >= 0

    carry = (
        node0, zi, best_t0, zf, zf, zi - 1, zi - 1, zi, zi, zi,
        (wo, wd, winv), zi - 1, zi + jnp.int32(query_mask),
    )
    (_, _, best_t, best_u, best_v, best_slot, best_inst, tt, nv, drops,
     _, _, _) = jax.lax.while_loop(cond, body, carry)
    t_o[...] = best_t
    u_o[...] = best_u
    v_o[...] = best_v
    slot_o[...] = best_slot
    inst_o[...] = best_inst
    tt_o[...] = tt
    nv_o[...] = nv
    drop_o[...] = drops


def _call_walk(fields, scene_args, *, instanced, any_hit, query_mask, depth,
               n_tlas, interpret):
    """pallas_call over ray blocks.  ``fields``: 8 padded (Np,) ray
    arrays; ``scene_args``: whole-array scene tables (gathered).  The
    ninth output is the lanes' stack scratch, dropped here."""
    npad = fields[0].shape[0]
    grid = (npad // BLOCK,)
    ray_spec = pl.BlockSpec((BLOCK,), lambda i: (i,))
    f32 = jax.ShapeDtypeStruct((npad,), jnp.float32)
    i32 = jax.ShapeDtypeStruct((npad,), jnp.int32)
    kernel = functools.partial(
        _walk_kernel, instanced=instanced, any_hit=any_hit,
        query_mask=int(query_mask), depth=depth, n_tlas=n_tlas,
        precise=not interpret,
    )
    return pl.pallas_call(
        kernel,
        out_shape=(f32, f32, f32, i32, i32, i32, i32, i32,
                   jax.ShapeDtypeStruct((npad * depth,), jnp.int32)),
        grid=grid,
        in_specs=[ray_spec] * 8 + [pl.BlockSpec()] * len(scene_args),
        out_specs=[ray_spec] * 8 + [pl.BlockSpec((BLOCK * depth,),
                                                 lambda i: (i,))],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="bvh_walk",
    )(*fields, *scene_args)[:8]


def _ray_fields(rays: Rays):
    """Pad to whole blocks; pad rays are dead (t_max < t_min)."""
    n = rays.count
    pad = pad_count(n) - n

    def fld(x, fill):
        return jnp.concatenate([x, jnp.full((pad,), fill, x.dtype)]) \
            if pad else x

    o, d = rays.origin, rays.direction
    return (fld(o[:, 0], 0.0), fld(o[:, 1], 0.0), fld(o[:, 2], 0.0),
            fld(d[:, 0], 0.0), fld(d[:, 1], 0.0), fld(d[:, 2], 1.0),
            fld(rays.t_min, 0.0), fld(rays.t_max, -1.0))


def _stats(n, found, tt, nv, drops):
    return RayStats(
        rays_cast=jnp.int32(n),
        tri_tests=jnp.sum(tt),
        bvh_nodes_visited=jnp.sum(nv),
        hits=jnp.sum(found.astype(jnp.int32)),
        stack_drops=jnp.sum(drops),
    )


# ---------------------------------------------------------------------------
# flat scenes: BVH + slot-ordered triangles, no extra tables
# ---------------------------------------------------------------------------

def cast_rays_walk(rays: Rays, bvh, tris: Triangles,
                   query_mask: int = ALL_LAYERS, any_hit: bool = False,
                   return_per_ray: bool = False,
                   interpret: bool | None = None,
                   depth: int | None = None):
    """Closest-hit (or any-hit) cast of a flat scene through the kernel.

    ``tris`` is in BVH slot order (scene/scene.py build_scene).  Returns
    (hits, stats, occluded[, per_ray]) where ``per_ray`` holds the exact
    per-ray ``tri_tests`` and ``node_visits`` counters (stats.h:20-55).
    ``depth`` overrides the stack width (tests force overflows with it).
    """
    if interpret is None:
        interpret = kernel_interpret()
    if depth is None:
        depth = stack_depth(len(bvh.levels))
    hits, stats, found, tt, nv = _cast_flat_jit(
        rays, bvh, tris, query_mask=int(query_mask), any_hit=bool(any_hit),
        interpret=bool(interpret), depth=int(depth),
    )
    if return_per_ray:
        return hits, stats, found, {"tri_tests": tt, "node_visits": nv}
    return hits, stats, found


@functools.partial(jax.jit, static_argnames=("query_mask", "any_hit",
                                             "interpret", "depth"))
def _cast_flat_jit(rays, bvh, tris, *, query_mask, any_hit, interpret,
                   depth):
    n = rays.count
    scene_args = (
        bvh.aabb_min.reshape(-1), bvh.aabb_max.reshape(-1), bvh.left_first,
        bvh.count, bvh.split_axis, tris.v0.reshape(-1),
        tris.edge1.reshape(-1), tris.edge2.reshape(-1), tris.layers,
    )
    t, u, v, slot, _, tt, nv, drops = _call_walk(
        _ray_fields(rays), scene_args, instanced=False, any_hit=any_hit,
        query_mask=query_mask, depth=depth, n_tlas=0, interpret=interpret,
    )
    t, u, v, slot, tt, nv = (x[:n] for x in (t, u, v, slot, tt, nv))
    found = slot >= 0
    s = jnp.maximum(slot, 0)
    hits = _assemble(rays, found, t, u, v, tris.normal[s],
                     tris.prim_id[s], tris.layers[s])
    return hits, _stats(n, found, tt, nv, drops), found, tt, nv


def _assemble(rays, found, t, u, v, normal, prim, layers):
    return Hits(
        t=jnp.where(found, t, T_MAX_DEFAULT),
        position=jnp.where(
            found[:, None],
            rays.origin + rays.direction * jnp.where(found, t, 0.0)[:, None],
            0.0),
        normal=jnp.where(found[:, None], normal, 0.0),
        u=jnp.where(found, u, 0.0),
        v=jnp.where(found, v, 0.0),
        prim_id=jnp.where(found, prim, NO_HIT),
        hit_layers=jnp.where(found, layers, 0),
    )


# ---------------------------------------------------------------------------
# instanced scenes: TLAS over instance AABBs above the BLAS forest
# ---------------------------------------------------------------------------

@pytree_dataclass(meta_fields=("n_tlas", "levels"))
class InstanceTables:
    """Two-level tables for the instanced walk (device arrays).

    One node space: TLAS nodes ``[0, n_tlas)`` (singleton leaves whose
    ``left_first`` is the instance id) followed by every registered mesh's
    BLAS, concatenated once (memory ~ meshes, not instances).  Internal
    nodes keep the DFS rule (left child ``node + 1``, right child id in
    ``left_first``, globalized); BLAS leaves point at the concatenated
    slot-ordered object-space triangles.

    tris:          object-space Triangles; ``prim_id`` is mesh-local
    inst_inv:      (I*12,) world->object [R|t], row-major
    inst_root:     (I,) global BLAS root node per instance
    inst_layers:   (I,) instance layer mask (ANDed with triangle layers)
    inst_prim_base:(I,) flattened-scene prim id base
    """

    aabb_min: jnp.ndarray      # (M, 3)
    aabb_max: jnp.ndarray      # (M, 3)
    left_first: jnp.ndarray    # (M,)
    count: jnp.ndarray         # (M,)
    split_axis: jnp.ndarray    # (M,)
    tris: Triangles
    inst_inv: jnp.ndarray
    inst_root: jnp.ndarray
    inst_layers: jnp.ndarray
    inst_prim_base: jnp.ndarray
    n_tlas: int = 0
    levels: int = 1            # TLAS levels + deepest BLAS levels

    @property
    def bounds(self):
        """World AABB of the scene (the TLAS root box)."""
        return self.aabb_min[0], self.aabb_max[0]


def cast_rays_walk_instanced(rays: Rays, tables: InstanceTables,
                             query_mask: int = ALL_LAYERS,
                             any_hit: bool = False,
                             return_per_ray: bool = False,
                             interpret: bool | None = None):
    """Two-level cast through the kernel.  Returns (hits, stats,
    occluded, instance_id[, per_ray]).  ``prim_id`` is in the flattened
    scene's numbering (instance base + mesh-local id) and normals are in
    world space (inverse-transpose, blas_instance.h:62-70)."""
    if interpret is None:
        interpret = kernel_interpret()
    hits, stats, found, inst, tt, nv = _cast_instanced_jit(
        rays, tables, query_mask=int(query_mask), any_hit=bool(any_hit),
        interpret=bool(interpret), depth=stack_depth(tables.levels),
    )
    if return_per_ray:
        return hits, stats, found, inst, {"tri_tests": tt, "node_visits": nv}
    return hits, stats, found, inst


@functools.partial(jax.jit, static_argnames=("query_mask", "any_hit",
                                             "interpret", "depth"))
def _cast_instanced_jit(rays, tb, *, query_mask, any_hit, interpret, depth):
    n = rays.count
    tris = tb.tris
    scene_args = (
        tb.aabb_min.reshape(-1), tb.aabb_max.reshape(-1), tb.left_first,
        tb.count, tb.split_axis, tris.v0.reshape(-1),
        tris.edge1.reshape(-1), tris.edge2.reshape(-1), tris.layers,
        tb.inst_inv, tb.inst_root, tb.inst_layers,
    )
    t, u, v, slot, inst, tt, nv, drops = _call_walk(
        _ray_fields(rays), scene_args, instanced=True, any_hit=any_hit,
        query_mask=query_mask, depth=depth, n_tlas=tb.n_tlas,
        interpret=interpret,
    )
    t, u, v, slot, inst, tt, nv = (x[:n] for x in
                                   (t, u, v, slot, inst, tt, nv))
    found = slot >= 0
    s = jnp.maximum(slot, 0)
    gi = jnp.maximum(inst, 0)
    # object normal -> world: n_w = n_o @ R^-1 as explicit multiply-adds
    inv = tb.inst_inv.reshape(-1, 12)[gi]
    n_o = tris.normal[s]
    nw = jnp.stack([
        n_o[:, 0] * inv[:, 0 + c] + n_o[:, 1] * inv[:, 4 + c]
        + n_o[:, 2] * inv[:, 8 + c] for c in range(3)], axis=1)
    nl = jnp.sqrt(jnp.sum(nw * nw, axis=1, keepdims=True))
    nw = nw / jnp.where(nl > 0.0, nl, 1.0)
    hits = _assemble(rays, found, t, u, v, nw,
                     tb.inst_prim_base[gi] + tris.prim_id[s],
                     tris.layers[s] & tb.inst_layers[gi])
    inst_id = jnp.where(found, inst, -1)
    return hits, _stats(n, found, tt, nv, drops), found, inst_id, tt, nv


class KernelScene:
    """RayScene cast interface over kernel tables, usable inside jit
    (the in-jit path tracer and the sharded render step).

    ``tables`` is ``(tris, bvh)`` for a flat scene or an
    ``InstanceTables``."""

    def __init__(self, tables):
        self.tables = tables

    def _cast(self, rays, query_mask, any_hit):
        if isinstance(self.tables, tuple):
            tris, bvh = self.tables
            return cast_rays_walk(rays, bvh, tris, int(query_mask),
                                  any_hit=any_hit)
        return cast_rays_walk_instanced(rays, self.tables, int(query_mask),
                                        any_hit=any_hit)

    def cast_rays(self, rays: Rays, query_mask: int = ALL_LAYERS):
        hits, stats = self._cast(rays, query_mask, False)[:2]
        return hits, stats

    def any_hit_rays(self, rays: Rays, query_mask: int = ALL_LAYERS):
        return self._cast(rays, query_mask, True)[2]
