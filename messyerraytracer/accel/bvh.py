"""Binned-SAH BVH: build (host, vectorized numpy) + SoA device arrays + refit.

Implements the reference's *documented* BVH semantics (README.md:128-131,
BASELINE.json north star) rather than the vendored TinyBVH code:

  * binned SAH, 12 candidate split planes per axis   (BVH_BINS = 12)
  * MAX_LEAF_SIZE = 4 triangles
  * DFS-ordered node array: left child is implicitly ``node + 1``;
    internal nodes store the *right* child index in ``left_first``
  * leaf nodes: ``left_first`` = first triangle slot, ``count`` > 0
  * traversal: stack-based, front-to-back child ordering, stack depth 64

The build itself runs on host (numpy) — topology construction is a
pointer-chasing recursion with data-dependent shapes, which is precisely the
part that does NOT belong under XLA.  The *output* is a set of dense SoA
arrays that live in HBM and are consumed by jnp / Pallas traversal kernels.
Refit (``refit_bvh``) IS device-side: a level-synchronous bottom-up sweep of
vectorized AABB merges, so per-frame geometry updates never leave the device
(reference refit: tinybvh Refit via scene_tlas.h:180-196).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.struct import pytree_dataclass

BVH_BINS = 12        # README.md:128 — 12 candidate split planes per axis
MAX_LEAF_SIZE = 4    # README.md:129
STACK_DEPTH = 64     # README.md:131 — traversal stack cap


@pytree_dataclass
class BVH:
    """SoA BVH node arrays (device-resident).

    aabb_min:   (M, 3) float32
    aabb_max:   (M, 3) float32
    left_first: (M,)   int32 — internal: right-child index; leaf: first tri slot
    count:      (M,)   int32 — 0 for internal nodes, leaf triangle count otherwise
    tri_order:  (N,)   int32 — tri slot -> original triangle index permutation
    split_axis: (M,)   int32 — SAH split axis per internal node (0 on leaves);
                used for the traversal kernel's near-child-first order
    levels:     tuple of int32 index arrays, one per tree depth (root level
                first); used by the level-synchronous refit.  Stored as
                traced pytree leaves (NOT static metadata) so jit calls
                never hash million-entry index lists.
    """

    aabb_min: jnp.ndarray
    aabb_max: jnp.ndarray
    left_first: jnp.ndarray
    count: jnp.ndarray
    tri_order: jnp.ndarray
    split_axis: jnp.ndarray
    levels: tuple

    @property
    def num_nodes(self) -> int:
        return self.aabb_min.shape[0]

    @property
    def num_tris(self) -> int:
        return self.tri_order.shape[0]


@dataclasses.dataclass
class _BuildNode:
    start: int
    end: int


def build_bvh(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray,
              use_native: bool = True) -> BVH:
    """Build a binned-SAH BVH over triangles given by vertex arrays (N,3).

    Returns a ``BVH`` whose ``tri_order`` permutation the caller must apply
    to its triangle SoA so leaf ranges are contiguous (the reference's
    TinyBVH keeps an index array instead; we reorder once at build so the
    hot traversal kernels do pure contiguous reads).

    Termination: leaf when count <= MAX_LEAF_SIZE, or when SAH finds no
    improving split and the node is small; degenerate centroid bounds fall
    back to a median split so the tree stays balanced.
    """
    v0 = np.asarray(v0, np.float32)
    v1 = np.asarray(v1, np.float32)
    v2 = np.asarray(v2, np.float32)
    if use_native:
        from ..native import native_build_bvh

        res = native_build_bvh(v0, v1, v2)
        if res is not None:
            (node_min, node_max, left_first, count, depth, axis, order,
             num) = res
            return _finalize_bvh(
                node_min, node_max, left_first, count, depth, axis, order
            )
    tri_min = np.minimum(np.minimum(v0, v1), v2)
    tri_max = np.maximum(np.maximum(v0, v1), v2)
    centroid = (v0 + v1 + v2) * (1.0 / 3.0)
    return build_bvh_over_aabbs(tri_min, tri_max, centroid)


def _finalize_bvh(node_min, node_max, left_first, count, depth, axis,
                  order) -> BVH:
    """Assemble device arrays + per-depth level index lists.

    All slicing happens in numpy, then each final array is device_put
    directly: the host ships finished arrays and runs zero eager device
    ops (each of which would compile per new shape).
    """
    max_depth = int(depth.max()) if depth.size else 0
    sort_key = np.argsort(depth, kind="stable").astype(np.int32)
    counts = np.bincount(depth, minlength=max_depth + 1)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    levels = tuple(
        jnp.asarray(sort_key[offsets[lvl]:offsets[lvl + 1]])
        for lvl in range(max_depth + 1)
    )
    b = BVH(
        aabb_min=jnp.asarray(node_min.astype(np.float32)),
        aabb_max=jnp.asarray(node_max.astype(np.float32)),
        left_first=jnp.asarray(left_first.astype(np.int32)),
        count=jnp.asarray(count.astype(np.int32)),
        tri_order=jnp.asarray(order.astype(np.int32)),
        split_axis=jnp.asarray(axis.astype(np.int32)),
        levels=levels,
    )
    # Host mirror of the build outputs, so build-time consumers (the tri
    # permutation, the two-level tables) never read the device back.
    # Plain object attribute — not a pytree leaf; absent after a jit
    # round trip, in which case consumers fall back to a readback.
    object.__setattr__(b, "host", {
        "aabb_min": node_min.astype(np.float32),
        "aabb_max": node_max.astype(np.float32),
        "left_first": left_first.astype(np.int32),
        "count": count.astype(np.int32),
        "tri_order": order.astype(np.int32),
        "split_axis": axis.astype(np.int32),
    })
    return b


def build_bvh_over_aabbs(tri_min, tri_max, centroid,
                         max_leaf_size: int = MAX_LEAF_SIZE,
                         use_native: bool = True) -> BVH:
    """Binned-SAH build over arbitrary primitive AABBs + centroids.

    Used for triangles (``build_bvh``) and for the TLAS over instance
    world-space AABBs (the analogue of TinyBVH's native TLAS build,
    scene_tlas.h:140-176).  ``max_leaf_size=1`` yields singleton leaves
    (the kernel's TLAS has one instance per leaf).

    Routes through the native builder when available (the recursive
    numpy path is orders of magnitude slower on large inputs); the numpy
    body below is the readable specification and the no-compiler
    fallback.
    """
    tri_min = np.asarray(tri_min, np.float32)
    tri_max = np.asarray(tri_max, np.float32)
    centroid = np.asarray(centroid, np.float32)
    n = tri_min.shape[0]
    if n == 0:
        raise ValueError("build_bvh: cannot build over 0 primitives")

    if use_native:
        from ..native import native_build_bvh_aabbs

        res = native_build_bvh_aabbs(tri_min, tri_max, centroid,
                                     max_leaf_size)
        if res is not None:
            (node_min, node_max, left_first, count, depth, axis, order,
             num) = res
            return _finalize_bvh(
                node_min, node_max, left_first, count, depth, axis, order
            )

    order = np.arange(n, dtype=np.int32)  # tri slots -> original index

    max_nodes = max(2 * n - 1, 1)
    node_min = np.empty((max_nodes, 3), np.float32)
    node_max = np.empty((max_nodes, 3), np.float32)
    left_first = np.zeros(max_nodes, np.int32)
    count = np.zeros(max_nodes, np.int32)
    depth_arr = np.zeros(max_nodes, np.int32)
    axis_arr = np.zeros(max_nodes, np.int32)
    num_nodes = 0

    def surface_area(bmin, bmax):
        d = np.maximum(bmax - bmin, 0.0)
        return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0])

    def emit(start, end, depth):
        """Recursively emit the subtree over tri slots [start, end) in DFS
        order.  Returns the node index."""
        nonlocal num_nodes
        node = num_nodes
        num_nodes += 1
        idx = order[start:end]
        bmin = tri_min[idx].min(axis=0)
        bmax = tri_max[idx].max(axis=0)
        node_min[node] = bmin
        node_max[node] = bmax
        depth_arr[node] = depth
        cnt = end - start

        if cnt <= max_leaf_size:
            left_first[node] = start
            count[node] = cnt
            return node

        # --- binned SAH over all 3 axes -------------------------------
        cent = centroid[idx]
        cmin = cent.min(axis=0)
        cmax = cent.max(axis=0)
        extent = cmax - cmin
        best_cost = np.inf
        best_axis = -1
        best_bin = -1

        for axis in range(3):
            if extent[axis] <= 1e-12:
                continue
            scale = BVH_BINS / extent[axis]
            bins = np.minimum(
                ((cent[:, axis] - cmin[axis]) * scale).astype(np.int32),
                BVH_BINS - 1,
            )
            # per-bin count + AABB via vectorized grouping
            bin_counts = np.bincount(bins, minlength=BVH_BINS)
            bin_min = np.full((BVH_BINS, 3), np.inf, np.float32)
            bin_max = np.full((BVH_BINS, 3), -np.inf, np.float32)
            np.minimum.at(bin_min, bins, tri_min[idx])
            np.maximum.at(bin_max, bins, tri_max[idx])

            # prefix (left) and suffix (right) sweeps
            lcnt = np.cumsum(bin_counts)[:-1]
            rcnt = cnt - lcnt
            lmin = np.minimum.accumulate(bin_min, axis=0)[:-1]
            lmax = np.maximum.accumulate(bin_max, axis=0)[:-1]
            rmin = np.minimum.accumulate(bin_min[::-1], axis=0)[::-1][1:]
            rmax = np.maximum.accumulate(bin_max[::-1], axis=0)[::-1][1:]

            valid = (lcnt > 0) & (rcnt > 0)
            cost = np.where(
                valid,
                lcnt * surface_area(lmin, lmax) + rcnt * surface_area(rmin, rmax),
                np.inf,
            )
            k = int(np.argmin(cost))
            if cost[k] < best_cost:
                best_cost = cost[k]
                best_axis = axis
                best_bin = k

        if best_axis < 0:
            # Degenerate centroids: median split on the longest AABB axis.
            best_axis = int(np.argmax(bmax - bmin))
            axis_arr[node] = best_axis
            key = cent[:, best_axis]
            mid_local = cnt // 2
            part = np.argpartition(key, mid_local)
            order[start:end] = idx[part]
            mid = start + mid_local
        else:
            scale = BVH_BINS / extent[best_axis]
            bins = np.minimum(
                ((cent[:, best_axis] - cmin[best_axis]) * scale).astype(np.int32),
                BVH_BINS - 1,
            )
            go_left = bins <= best_bin
            order[start:end] = np.concatenate([idx[go_left], idx[~go_left]])
            mid = start + int(go_left.sum())
            if mid == start or mid == end:  # safety: never emit empty child
                mid_local = cnt // 2
                part = np.argpartition(cent[:, best_axis], mid_local)
                order[start:end] = idx[part]
                mid = start + mid_local

        count[node] = 0
        axis_arr[node] = best_axis
        emit(start, mid, depth + 1)                     # left child = node+1
        right = emit(mid, end, depth + 1)
        left_first[node] = right                        # store right child
        return node

    import sys

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 4 * n + 1000))
    try:
        emit(0, n, 0)
    finally:
        sys.setrecursionlimit(old_limit)

    return _finalize_bvh(
        node_min[:num_nodes], node_max[:num_nodes], left_first[:num_nodes],
        count[:num_nodes], depth_arr[:num_nodes], axis_arr[:num_nodes],
        order,
    )


def sah_cost(bvh: BVH) -> float:
    """Total SAH cost of the tree (diagnostic; lower = better culling)."""
    area = 2.0 * jnp.sum(
        jnp.roll(bvh.aabb_max - bvh.aabb_min, 1, axis=-1)
        * (bvh.aabb_max - bvh.aabb_min),
        axis=-1,
    )
    root_area = area[0]
    w = jnp.where(bvh.count > 0, bvh.count.astype(jnp.float32), 1.0)
    return float(jnp.sum(area * w) / jnp.maximum(root_area, 1e-30))


def refit_bvh(bvh: BVH, tri_min: jnp.ndarray, tri_max: jnp.ndarray) -> BVH:
    """Device-side O(N) refit: recompute node AABBs for moved vertices.

    Level-synchronous bottom-up sweep — each depth level is one vectorized
    gather/merge, so the whole refit is ~tree-depth fused XLA ops and never
    leaves the device.  Topology (left_first/count/tri_order) is unchanged;
    ``tri_min``/``tri_max`` are per-*slot* (already reordered) triangle AABBs.

    Mirrors ``SceneTLAS::refit_tlas`` (scene_tlas.h:180-196): 10-100x faster
    than rebuild for dynamic scenes.
    """
    m = bvh.num_nodes
    amin = jnp.full((m, 3), jnp.inf, jnp.float32)
    amax = jnp.full((m, 3), -jnp.inf, jnp.float32)

    # Leaf AABBs: segment-reduce each leaf's MAX_LEAF_SIZE slot window.
    # Gather a fixed-size window per node (padded by clamping) and mask.
    k = MAX_LEAF_SIZE
    slot0 = bvh.left_first  # for leaves; garbage for internal (masked below)
    offs = jnp.arange(k, dtype=jnp.int32)[None, :]
    gather_idx = jnp.clip(slot0[:, None] + offs, 0, bvh.num_tris - 1)
    w_min = tri_min[gather_idx]          # (M, k, 3)
    w_max = tri_max[gather_idx]
    valid = offs < bvh.count[:, None]    # (M, k)
    leaf_min = jnp.min(jnp.where(valid[..., None], w_min, jnp.inf), axis=1)
    leaf_max = jnp.max(jnp.where(valid[..., None], w_max, -jnp.inf), axis=1)
    is_leaf = bvh.count > 0
    amin = jnp.where(is_leaf[:, None], leaf_min, amin)
    amax = jnp.where(is_leaf[:, None], leaf_max, amax)

    # Internal nodes, deepest level first: merge (node+1, left_first) children.
    for li in reversed(bvh.levels):
        internal = bvh.count[li] == 0
        lc = jnp.clip(li + 1, 0, m - 1)
        rc = jnp.clip(bvh.left_first[li], 0, m - 1)
        nmin = jnp.minimum(amin[lc], amin[rc])
        nmax = jnp.maximum(amax[lc], amax[rc])
        amin = amin.at[li].set(jnp.where(internal[:, None], nmin, amin[li]))
        amax = amax.at[li].set(jnp.where(internal[:, None], nmax, amax[li]))

    return bvh.replace(aabb_min=amin, aabb_max=amax)
