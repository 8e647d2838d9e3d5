"""Watertightness + traversal-stack regression tests.

Two failure classes a traversal kernel must never hide:

  * shared-edge cracks: an exactly edge-on ray lies in both neighbor
    triangles in exact arithmetic; rounding that differs from the
    oracle's (the card contracts FMAs) can put it in neither.  The
    kernel's ``MT_BARY_EPS`` band (core/types.py) closes interior edges;
  * stack overflow: the kernel's per-lane stack is sized from the built
    tree's depth (``walk.stack_depth``) and counts any dropped push in
    ``RayStats.stack_drops``, so a drop can never silently pass a bench.

Reference behavior: TinyBVH traverses until its stack empties
(thirdparty/tinybvh/tiny_bvh.h Intersect) — it has no drop path at all.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from messyerraytracer.accel.bvh import BVH
from messyerraytracer.core.brute import cast_rays_brute
from messyerraytracer.core.types import NO_HIT, make_rays, make_triangles
from messyerraytracer.kernels.walk import cast_rays_walk, stack_depth
from messyerraytracer.scene.scene import build_scene_from_tri_array
from messyerraytracer.utils import meshes


def wavy_scene(subdiv=16):
    g = meshes.plane(10.0, y=0.0, subdiv=subdiv)
    g[:, :, 1] = (np.sin(g[:, :, 0] * 0.7)
                  * np.cos(g[:, :, 2] * 0.6)) * 1.5
    return g, build_scene_from_tri_array(g)


def shared_edge_points(tris, per_edge=4, max_edges=160):
    """Sample points ON interior (shared) triangle edges, f64 then f32.

    Edge-on rays are exactly the crack population: in exact arithmetic
    the hit lies in both neighbors; a non-watertight kernel can round it
    into neither."""
    quant = {}
    for i, t in enumerate(tris):
        for a, b in ((0, 1), (1, 2), (2, 0)):
            key = tuple(sorted(
                (tuple(np.round(t[a], 5)), tuple(np.round(t[b], 5)))))
            quant.setdefault(key, []).append((i, t[a], t[b]))
    pts = []
    for key, owners in quant.items():
        if len(owners) < 2:
            continue                      # boundary edge: silhouette
        _, va, vb = owners[0]
        for s in np.linspace(0.15, 0.85, per_edge):
            pts.append(va.astype(np.float64) * (1 - s)
                       + vb.astype(np.float64) * s)
        if len(pts) >= max_edges * per_edge:
            break
    return np.asarray(pts, np.float64)


def comb_scene(levels):
    """A hand-built comb BVH ``levels`` internal nodes deep: internal node
    k (id 2k) has a one-triangle leaf on its left (id 2k+1) and the next
    comb node on its right (id 2k+2).  Every box spans the whole scene,
    and rays along -z (split axis z) continue right first, so each level
    leaves its leaf pending on the stack: the walk needs ``levels``
    entries."""
    n_leaf = levels + 1
    z = -np.arange(n_leaf, dtype=np.float32) - 1.0     # slot j at z=-1-j
    v0 = np.stack([np.full(n_leaf, -1.0), np.full(n_leaf, -1.0), z], 1)
    v1 = np.stack([np.full(n_leaf, 1.0), np.full(n_leaf, -1.0), z], 1)
    v2 = np.stack([np.zeros(n_leaf), np.full(n_leaf, 1.0), z], 1)
    tris = make_triangles(v0.astype(np.float32), v1.astype(np.float32),
                          v2.astype(np.float32))
    m = 2 * levels + 1
    lf = np.zeros(m, np.int32)
    cnt = np.zeros(m, np.int32)
    depth = np.zeros(m, np.int32)
    for k in range(levels):
        lf[2 * k] = 2 * k + 2              # right child: next comb node
        cnt[2 * k + 1] = 1
        lf[2 * k + 1] = k                  # left leaf -> slot k
        depth[2 * k] = k
        depth[2 * k + 1] = k + 1
    cnt[m - 1] = 1
    lf[m - 1] = levels                     # last right leaf -> slot levels
    depth[m - 1] = levels
    lo = np.float32([-1, -1, z.min()])
    hi = np.float32([1, 1, z.max()])
    bvh = BVH(
        aabb_min=jnp.asarray(np.tile(lo, (m, 1))),
        aabb_max=jnp.asarray(np.tile(hi, (m, 1))),
        left_first=jnp.asarray(lf), count=jnp.asarray(cnt),
        tri_order=jnp.arange(n_leaf, dtype=jnp.int32),
        split_axis=jnp.full((m,), 2, jnp.int32),
        levels=tuple(jnp.asarray(np.nonzero(depth == d)[0].astype(np.int32))
                     for d in range(levels + 1)),
    )
    rays = make_rays(np.float32([[0.1, -0.2, 1.0], [0.3, 0.1, 1.0]]),
                     np.float32([[0, 0, -1], [0, 0, -1]]))
    return bvh, tris, rays


class TestWatertight:
    def test_edge_on_rays_no_cracks(self):
        """Rays aimed exactly at interior shared edges: wherever the
        oracle reports a hit, the kernel must too (either neighbor is a
        correct closest hit), with t matching closely."""
        g, scene = wavy_scene()
        pts = shared_edge_points(np.asarray(g, np.float64))
        assert len(pts) >= 200
        origin = np.float64([0.3, 9.0, 11.0])
        d = pts - origin
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        rays = make_rays(np.tile(origin.astype(np.float32), (len(pts), 1)),
                         d.astype(np.float32))
        hb, _ = cast_rays_brute(rays, scene.tris)
        hk, sk = scene.cast_rays(rays)
        pb, pk = np.asarray(hb.prim_id), np.asarray(hk.prim_id)
        tb, tk = np.asarray(hb.t), np.asarray(hk.t)
        oracle_hit = pb != NO_HIT
        assert oracle_hit.sum() >= 100
        cracks = oracle_hit & (pk == NO_HIT)
        assert cracks.sum() == 0, f"crack rays: {np.nonzero(cracks)[0]}"
        np.testing.assert_allclose(tk[oracle_hit], tb[oracle_hit],
                                   rtol=1e-4)
        # the kernel may resolve a tie to the OTHER neighbor; t must
        # agree to formulation rounding (bench.py parity TIE_RTOL)
        swapped = oracle_hit & (pk != pb)
        assert np.all(np.abs(tk[swapped] - tb[swapped])
                      <= 4e-6 * np.maximum(np.abs(tb[swapped]), 1.0))
        assert int(sk.stack_drops) == 0

    def test_stack_need_bounds_exact_traversal(self):
        """stack_depth(levels) upper-bounds the EXACT worst-case stack
        peak of the kernel's discipline (continue into one child, push
        the other) on a real built tree, in BOTH child orders."""
        _, scene = wavy_scene(subdiv=24)
        host = scene.bvh.host
        lf, cnt = host["left_first"], host["count"]

        def peak(first_is_left):
            best, todo = 0, [(0, 0)]          # (node, stack size there)
            while todo:
                node, sp = todo.pop()
                best = max(best, sp)
                if cnt[node] > 0:
                    continue
                a, b = node + 1, int(lf[node])
                first, second = (a, b) if first_is_left else (b, a)
                todo.append((first, sp + 1))  # second waits on the stack
                todo.append((second, sp))
            return best

        bound = stack_depth(len(scene.bvh.levels))
        assert peak(True) <= len(scene.bvh.levels) - 1 <= bound
        assert peak(False) <= len(scene.bvh.levels) - 1 <= bound

    def test_stack_need_synthetic_deep_comb(self):
        """A 100-level comb needs 100 stack entries: the stack sized from
        the tree's levels holds them all, and every leaf is reached."""
        bvh, tris, rays = comb_scene(100)
        depth = stack_depth(len(bvh.levels))
        assert depth >= 100
        hits, stats, _ = cast_rays_walk(rays, bvh, tris)
        ref, _ = cast_rays_brute(rays, tris)
        np.testing.assert_array_equal(np.asarray(hits.prim_id),
                                      np.asarray(ref.prim_id))
        np.testing.assert_array_equal(np.asarray(hits.prim_id), [0, 0])
        assert int(stats.stack_drops) == 0
        assert int(stats.tri_tests) == 2 * 101    # every leaf visited

    def test_stack_drop_counter_not_silent(self):
        """Force an undersized stack: the kernel must COUNT dropped
        pushes (RayStats.stack_drops), never silently return wrong hits
        with a zero counter."""
        bvh, tris, rays = comb_scene(40)
        _, stats, _ = cast_rays_walk(rays, bvh, tris, depth=16)
        assert int(stats.stack_drops) == 2 * (40 - 16)
        # properly-sized cast on the same scene: zero drops
        hits, stats, _ = cast_rays_walk(rays, bvh, tris)
        assert int(stats.stack_drops) == 0
        np.testing.assert_array_equal(np.asarray(hits.prim_id), [0, 0])


if __name__ == "__main__":
    pytest.main([__file__, "-v"])
