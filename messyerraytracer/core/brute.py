"""Brute-force O(N*T) cast — the validation oracle.

Rewrite of the reference's brute-force fallbacks
(``RayScene::cast_ray`` with use_bvh=false, src/accel/ray_scene.h:120-131;
``SceneTLAS::_cast_ray_brute``, src/accel/scene_tlas.h:345-379): instead of a
serial per-ray loop over triangles, every (ray, triangle) pair is tested by a
dense vectorized Moller-Trumbore, scanned over triangle tiles so memory stays
O(rays + tile).

This is the parity oracle for the BVH/Pallas paths (SURVEY.md §4): identical
hit semantics — strictly-closer update, lowest-prim-index tie win, layer-mask
filtering *during* iteration (ray_scene.h:124).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .geometry import closest_select, moller_trumbore
from .types import (
    ALL_LAYERS,
    NO_HIT,
    T_MAX_DEFAULT,
    Hits,
    Rays,
    RayStats,
    Triangles,
    make_miss,
)


def _pad_tris(tris: Triangles, chunk: int) -> Triangles:
    """Pad triangle arrays to a multiple of ``chunk`` with degenerate tris.

    Padding has layers=0 so no query mask matches, and zero edges so
    Moller-Trumbore rejects via the determinant epsilon regardless.
    """
    t = tris.count
    pad = (-t) % chunk
    if pad == 0:
        return tris
    z3 = jnp.zeros((pad, 3), jnp.float32)
    return Triangles(
        v0=jnp.concatenate([tris.v0, z3]),
        edge1=jnp.concatenate([tris.edge1, z3]),
        edge2=jnp.concatenate([tris.edge2, z3]),
        normal=jnp.concatenate([tris.normal, z3]),
        prim_id=jnp.concatenate([tris.prim_id, jnp.full((pad,), NO_HIT, jnp.int32)]),
        layers=jnp.concatenate([tris.layers, jnp.zeros((pad,), jnp.int32)]),
    )


@partial(jax.jit, static_argnames=("chunk",))
def cast_rays_brute(
    rays: Rays,
    tris: Triangles,
    query_mask: jnp.ndarray | int = ALL_LAYERS,
    chunk: int = 2048,
) -> tuple[Hits, RayStats]:
    """Closest-hit cast of every ray against every triangle.

    Returns (hits, stats).  Scans triangle tiles of size ``chunk`` keeping a
    per-ray running best (t, slot, u, v); tiles are visited in index order so
    exact-t ties resolve to the lowest triangle index, matching the serial
    reference loop (triangle.h:93).
    """
    n = rays.count
    query_mask = jnp.asarray(query_mask, jnp.int32)
    if tris.count == 0:  # static shape — safe under jit
        return make_miss(n), RayStats(
            rays_cast=jnp.int32(n),
            tri_tests=jnp.int32(0),
            bvh_nodes_visited=jnp.int32(0),
            hits=jnp.int32(0),
        )
    tp = _pad_tris(tris, chunk)
    num_chunks = tp.count // chunk

    def body(carry, chunk_idx):
        best_t, best_slot, best_u, best_v = carry
        s = chunk_idx * chunk
        v0 = jax.lax.dynamic_slice_in_dim(tp.v0, s, chunk)
        e1 = jax.lax.dynamic_slice_in_dim(tp.edge1, s, chunk)
        e2 = jax.lax.dynamic_slice_in_dim(tp.edge2, s, chunk)
        layers = jax.lax.dynamic_slice_in_dim(tp.layers, s, chunk)

        valid, t, u, v = moller_trumbore(
            rays.origin[:, None, :],
            rays.direction[:, None, :],
            rays.t_min[:, None],
            rays.t_max[:, None],
            v0[None, :, :],
            e1[None, :, :],
            e2[None, :, :],
        )
        valid = valid & ((layers[None, :] & query_mask) != 0)

        local_idx = jnp.arange(chunk, dtype=jnp.int32)
        any_valid, arg = closest_select(valid, t, local_idx[None, :])
        cand_t = jnp.where(any_valid, jnp.take_along_axis(t, arg[:, None], 1)[:, 0], T_MAX_DEFAULT)
        cand_u = jnp.take_along_axis(u, arg[:, None], 1)[:, 0]
        cand_v = jnp.take_along_axis(v, arg[:, None], 1)[:, 0]
        cand_slot = s + arg

        better = cand_t < best_t  # strict: earlier chunk wins ties
        best_t = jnp.where(better, cand_t, best_t)
        best_slot = jnp.where(better, cand_slot, best_slot)
        best_u = jnp.where(better, cand_u, best_u)
        best_v = jnp.where(better, cand_v, best_v)
        return (best_t, best_slot, best_u, best_v), None

    init = (
        jnp.full((n,), T_MAX_DEFAULT, jnp.float32),
        jnp.full((n,), -1, jnp.int32),
        jnp.zeros((n,), jnp.float32),
        jnp.zeros((n,), jnp.float32),
    )
    (best_t, best_slot, best_u, best_v), _ = jax.lax.scan(
        body, init, jnp.arange(num_chunks, dtype=jnp.int32)
    )

    hit = best_slot >= 0
    slot = jnp.maximum(best_slot, 0)
    hits = Hits(
        t=jnp.where(hit, best_t, T_MAX_DEFAULT),
        position=jnp.where(
            hit[:, None], rays.origin + rays.direction * best_t[:, None], 0.0
        ),
        normal=jnp.where(hit[:, None], tp.normal[slot], 0.0),
        u=jnp.where(hit, best_u, 0.0),
        v=jnp.where(hit, best_v, 0.0),
        prim_id=jnp.where(hit, tp.prim_id[slot], NO_HIT),
        hit_layers=jnp.where(hit, tp.layers[slot], 0),
    )

    masked_tris = jnp.sum(((tris.layers & query_mask) != 0).astype(jnp.int32))
    stats = RayStats(
        rays_cast=jnp.int32(n),
        tri_tests=jnp.int32(n) * masked_tris,
        bvh_nodes_visited=jnp.int32(0),
        hits=jnp.sum(hit.astype(jnp.int32)),
    )
    return hits, stats


@partial(jax.jit, static_argnames=("chunk",))
def any_hit_brute(
    rays: Rays,
    tris: Triangles,
    query_mask: jnp.ndarray | int = ALL_LAYERS,
    chunk: int = 2048,
) -> jnp.ndarray:
    """(N,) bool occlusion query — does each ray hit *anything*?

    Mirrors ``RayScene::any_hit`` brute path (ray_scene.h:150-160).
    """
    query_mask = jnp.asarray(query_mask, jnp.int32)
    if tris.count == 0:  # static shape — safe under jit
        return jnp.zeros((rays.count,), bool)
    tp = _pad_tris(tris, chunk)
    num_chunks = tp.count // chunk

    def body(occluded, chunk_idx):
        s = chunk_idx * chunk
        v0 = jax.lax.dynamic_slice_in_dim(tp.v0, s, chunk)
        e1 = jax.lax.dynamic_slice_in_dim(tp.edge1, s, chunk)
        e2 = jax.lax.dynamic_slice_in_dim(tp.edge2, s, chunk)
        layers = jax.lax.dynamic_slice_in_dim(tp.layers, s, chunk)
        valid, _, _, _ = moller_trumbore(
            rays.origin[:, None, :],
            rays.direction[:, None, :],
            rays.t_min[:, None],
            rays.t_max[:, None],
            v0[None, :, :],
            e1[None, :, :],
            e2[None, :, :],
        )
        valid = valid & ((layers[None, :] & query_mask) != 0)
        return occluded | jnp.any(valid, axis=-1), None

    occluded, _ = jax.lax.scan(
        body, jnp.zeros((rays.count,), bool), jnp.arange(num_chunks, dtype=jnp.int32)
    )
    return occluded
