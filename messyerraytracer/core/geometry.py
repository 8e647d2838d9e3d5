"""Vectorized intersection math: Moller-Trumbore and the slab AABB test.

These are the pure-jnp building blocks shared by the brute-force oracle, the
jnp BVH traversal, and (re-expressed per lane) the traversal kernel.
Everything broadcasts: rays and triangles may carry arbitrary leading batch
dimensions as long as they are mutually broadcastable.

Reference semantics:
  * Moller-Trumbore: ``Triangle::intersect`` (src/core/triangle.h:58-105) —
    reject |det| < 1e-8, u in [0,1], v >= 0, u+v <= 1, t in [t_min, t_max].
  * Slab test: ``ray_intersects_aabb`` (src/core/aabb_intersect.h:27-57) —
    division-free via precomputed inverse direction, hit iff
    tmax >= max(tmin, 0).
"""

from __future__ import annotations

import jax.numpy as jnp

from .types import MT_DET_EPS, T_MAX_DEFAULT


def _dot(a, b):
    return jnp.sum(a * b, axis=-1)


def _cross(a, b):
    return jnp.cross(a, b)


def moller_trumbore(origin, direction, t_min, t_max, v0, edge1, edge2):
    """Batched Moller-Trumbore ray/triangle test.

    Args broadcast against each other over leading dims; the trailing dim of
    the vector args is 3.

    Returns (valid, t, u, v):
      valid: bool — hit inside the triangle and inside [t_min, t_max]
      t, u, v: float32 (t is garbage where ``valid`` is False)
    """
    pvec = _cross(direction, edge2)
    det = _dot(edge1, pvec)
    parallel = jnp.abs(det) < MT_DET_EPS
    inv_det = 1.0 / jnp.where(parallel, 1.0, det)

    tvec = origin - v0
    u = _dot(tvec, pvec) * inv_det
    qvec = _cross(tvec, edge1)
    v = _dot(direction, qvec) * inv_det
    t = _dot(edge2, qvec) * inv_det

    valid = (
        (~parallel)
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t >= t_min)
        & (t <= t_max)
    )
    return valid, t, u, v


def slab_test(origin, inv_direction, t_max, box_min, box_max):
    """Batched division-free slab ray/AABB test (aabb_intersect.h:27-57).

    Additionally clips against the ray's current ``t_max`` (the entry-tmin
    early-exit the GPU traversal applies at bvh_traverse.comp.glsl:251 — a
    box entirely behind the closest hit so far cannot improve it).

    Returns (hit, tentry): hit iff the slab intervals overlap, the box is in
    front (tmax >= max(tmin, 0)), and tentry <= ray t_max.
    """
    t1 = (box_min - origin) * inv_direction
    t2 = (box_max - origin) * inv_direction
    tnear = jnp.minimum(t1, t2)
    tfar = jnp.maximum(t1, t2)
    tmin = jnp.max(tnear, axis=-1)
    tmax = jnp.min(tfar, axis=-1)
    hit = (tmax >= jnp.maximum(tmin, 0.0)) & (tmin <= t_max)
    return hit, tmin


def closest_select(valid, t, tie_idx):
    """Pick the winning triangle among candidates along axis -1.

    Matches the serial loop semantics of the reference (strictly-closer
    update + iteration order): the lowest-index triangle among those with the
    minimal valid t wins.  ``tie_idx`` is the per-candidate ordering key
    (usually the original prim index).  Returns (best_valid, argbest).
    """
    t_masked = jnp.where(valid, t, T_MAX_DEFAULT)
    best_t = jnp.min(t_masked, axis=-1, keepdims=True)
    is_best = valid & (t_masked <= best_t)
    big = jnp.iinfo(jnp.int32).max
    idx_masked = jnp.where(is_best, tie_idx, big)
    arg = jnp.argmin(idx_masked, axis=-1)
    any_valid = jnp.any(valid, axis=-1)
    return any_valid, arg


def aabb_of_triangles(v0, v1, v2):
    """Per-triangle AABB (Triangle::aabb, triangle.h:113-131)."""
    mn = jnp.minimum(jnp.minimum(v0, v1), v2)
    mx = jnp.maximum(jnp.maximum(v0, v1), v2)
    return mn, mx


def centroid_of_triangles(v0, v1, v2):
    """Triangle centroid for SAH binning (triangle.h:134-136)."""
    return (v0 + v1 + v2) * (1.0 / 3.0)
