"""Reference BVH traversal in pure jnp (vmapped stack walk).

This is the *semantic* traversal: one ``lax.while_loop`` per ray, vmapped
over the batch.  It defines the hit and stats semantics the traversal
kernel (kernels/walk.py) reproduces, and is the plain-XLA rival path
(runs anywhere JAX runs — the analogue of the reference's CPU backend,
src/dispatch/ray_dispatcher.h:153-180).

Traversal rules (README.md:128-131 + src/gpu/shaders/bvh_traverse.comp.glsl):
  * stack-based DFS, depth cap 64
  * internal node: slab-test both children (left = node+1, right =
    ``left_first``), push far-then-near so the near child pops first
    (front-to-back, bvh_traverse.comp.glsl:287-318)
  * child culled when its entry-t exceeds the ray's current best t
    (entry-tmin early-exit, bvh_traverse.comp.glsl:251)
  * leaf: Moller-Trumbore the <=4 triangles in its contiguous slot range,
    layer-mask filtered during the test
  * stats: bvh_nodes_visited counts every popped node, tri_tests counts
    masked-in leaf triangle tests (src/core/stats.h:20-55)
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..core.geometry import moller_trumbore
from ..core.types import (
    ALL_LAYERS,
    NO_HIT,
    T_MAX_DEFAULT,
    Hits,
    Rays,
    RayStats,
    Triangles,
    safe_inv_direction,
)
from .bvh import BVH, MAX_LEAF_SIZE, STACK_DEPTH


def _traverse_one(o, d, t_min, t_max, bvh: BVH, tris: Triangles, query_mask,
                  any_hit: bool):
    """Stack traversal for a single ray. Returns
    (best_t, best_slot, best_u, best_v, nodes_visited, tri_tests)."""
    inv_d = safe_inv_direction(d)
    num_tris = tris.v0.shape[0]

    def slab(node, best_t):
        bmin = bvh.aabb_min[node]
        bmax = bvh.aabb_max[node]
        t1 = (bmin - o) * inv_d
        t2 = (bmax - o) * inv_d
        tnear = jnp.max(jnp.minimum(t1, t2))
        tfar = jnp.min(jnp.maximum(t1, t2))
        hit = (tfar >= jnp.maximum(tnear, 0.0)) & (tnear <= best_t)
        return hit, tnear

    def body(state):
        stack, sp, best_t, best_slot, best_u, best_v, nv, tt, occluded = state
        sp = sp - 1
        node = stack[sp]
        nv = nv + 1
        cnt = bvh.count[node]
        lf = bvh.left_first[node]
        is_leaf = cnt > 0

        # ---- leaf: test up to MAX_LEAF_SIZE triangles ----------------
        offs = jnp.arange(MAX_LEAF_SIZE, dtype=jnp.int32)
        slots = jnp.clip(lf + offs, 0, num_tris - 1)
        in_leaf = is_leaf & (offs < cnt)
        valid, t, u, v = moller_trumbore(
            o, d, t_min, jnp.minimum(t_max, best_t),
            tris.v0[slots], tris.edge1[slots], tris.edge2[slots],
        )
        valid = valid & in_leaf & ((tris.layers[slots] & query_mask) != 0)
        # strictly-closer update against current best; lowest slot wins ties
        t_m = jnp.where(valid, t, jnp.inf)
        k = jnp.argmin(t_m)
        cand_t = t_m[k]
        better = cand_t < best_t
        best_slot = jnp.where(better, slots[k], best_slot)
        best_u = jnp.where(better, u[k], best_u)
        best_v = jnp.where(better, v[k], best_v)
        best_t = jnp.where(better, cand_t, best_t)
        tt = tt + jnp.sum(in_leaf.astype(jnp.int32))
        if any_hit:
            occluded = occluded | jnp.any(valid)

        # ---- internal: push far then near ----------------------------
        left = node + 1
        right = lf
        lhit, lt = slab(left, best_t)
        rhit, rt = slab(right, best_t)
        lhit = lhit & ~is_leaf
        rhit = rhit & ~is_leaf
        near_is_left = lt <= rt
        near = jnp.where(near_is_left, left, right)
        far = jnp.where(near_is_left, right, left)
        near_hit = jnp.where(near_is_left, lhit, rhit)
        far_hit = jnp.where(near_is_left, rhit, lhit)

        stack = jax.lax.cond(
            far_hit & (sp < STACK_DEPTH),
            lambda s: s.at[sp].set(far), lambda s: s, stack)
        sp = sp + jnp.where(far_hit & (sp < STACK_DEPTH), 1, 0)
        stack = jax.lax.cond(
            near_hit & (sp < STACK_DEPTH),
            lambda s: s.at[sp].set(near), lambda s: s, stack)
        sp = sp + jnp.where(near_hit & (sp < STACK_DEPTH), 1, 0)

        return stack, sp, best_t, best_slot, best_u, best_v, nv, tt, occluded

    def cond(state):
        _, sp, _, _, _, _, _, _, occluded = state
        alive = sp > 0
        if any_hit:
            alive = alive & ~occluded
        return alive

    stack0 = jnp.zeros((STACK_DEPTH,), jnp.int32)
    # Root-box test gates the whole walk (degenerate-ray early out,
    # bvh_traverse.comp.glsl:210-222 analogue: a NaN/inf ray misses the root).
    root_hit, _ = slab(0, t_max)
    sp0 = jnp.where(root_hit, 1, 0).astype(jnp.int32)
    state0 = (
        stack0, sp0,
        jnp.minimum(t_max, T_MAX_DEFAULT), jnp.int32(-1),
        jnp.float32(0.0), jnp.float32(0.0),
        jnp.int32(0), jnp.int32(0), jnp.bool_(False),
    )
    state = jax.lax.while_loop(cond, body, state0)
    _, _, best_t, best_slot, best_u, best_v, nv, tt, occluded = state
    # A "hit" at exactly t_max is not a hit (initial best_t was the bound).
    found = best_slot >= 0
    return best_t, best_slot, best_u, best_v, nv, tt, occluded, found


@partial(jax.jit, static_argnames=("any_hit",))
def cast_rays_bvh(
    rays: Rays,
    tris: Triangles,
    bvh: BVH,
    query_mask=ALL_LAYERS,
    any_hit: bool = False,
) -> tuple[Hits, RayStats, jnp.ndarray]:
    """Batched closest-hit (or occlusion) cast through a BVH.

    ``tris`` must already be in BVH slot order (reordered by
    ``bvh.tri_order`` — see ``scene.build_scene``).  Returns
    (hits, stats, occluded); ``occluded`` is only meaningful for
    ``any_hit=True``.
    """
    query_mask = jnp.asarray(query_mask, jnp.int32)

    f = jax.vmap(
        lambda o, d, tn, tx: _traverse_one(
            o, d, tn, tx, bvh, tris, query_mask, any_hit
        )
    )
    best_t, best_slot, best_u, best_v, nv, tt, occluded, found = f(
        rays.origin, rays.direction, rays.t_min, rays.t_max
    )

    slot = jnp.maximum(best_slot, 0)
    hits = Hits(
        t=jnp.where(found, best_t, T_MAX_DEFAULT),
        position=jnp.where(
            found[:, None], rays.origin + rays.direction * best_t[:, None], 0.0
        ),
        normal=jnp.where(found[:, None], tris.normal[slot], 0.0),
        u=jnp.where(found, best_u, 0.0),
        v=jnp.where(found, best_v, 0.0),
        prim_id=jnp.where(found, tris.prim_id[slot], NO_HIT),
        hit_layers=jnp.where(found, tris.layers[slot], 0),
    )
    stats = RayStats(
        rays_cast=jnp.int32(rays.count),
        tri_tests=jnp.sum(tt),
        bvh_nodes_visited=jnp.sum(nv),
        hits=jnp.sum(found.astype(jnp.int32)),
    )
    return hits, stats, occluded
