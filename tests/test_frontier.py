"""Frontier-backend tests: parity vs the brute oracle, edge cases, caps.

The frontier caster (accel/frontier.py) is the dense per-ray BFS backend;
its headline invariant is exact t/prim_id/u/v parity with the brute
oracle, including lowest-slot tie wins and layer masking.
"""

import numpy as np
import jax.numpy as jnp
import pytest

import messyerraytracer as mrt
from messyerraytracer.accel.frontier import (
    build_frontier_scene,
    cast_rays_frontier,
)
from messyerraytracer.core.brute import any_hit_brute, cast_rays_brute
from messyerraytracer.core.types import Rays, make_rays
from messyerraytracer.scene.scene import build_scene, build_scene_from_tri_array
from messyerraytracer.utils import meshes


def _scene_and_rays():
    tris = np.concatenate(
        [meshes.cornell_room(4.0),
         meshes.uv_sphere(0.8, 10, 20, center=(0, -1.2, 0))]
    )
    scene = build_scene_from_tri_array(tris, backend="frontier")
    cam = mrt.CameraParams.look_at((0, 0.3, 5.4), (0, -0.3, 0),
                                   fov_degrees=60)
    rays = mrt.generate_rays(cam, 64, 48)
    return scene, rays


class TestFrontierParity:
    def test_nearest_parity(self):
        scene, rays = _scene_and_rays()
        hb, _ = cast_rays_brute(rays, scene.tris)
        h, stats = scene.cast_rays(rays)
        np.testing.assert_array_equal(np.asarray(h.prim_id),
                                      np.asarray(hb.prim_id))
        np.testing.assert_allclose(np.asarray(h.t), np.asarray(hb.t),
                                   rtol=1e-6)
        # u/v: same formula but XLA may fuse mul+add into fma differently
        # per compilation -> ULP-level drift; the parity CONTRACT is
        # t/prim_id (BASELINE.json), u/v to 1e-5
        np.testing.assert_allclose(np.asarray(h.u), np.asarray(hb.u),
                                   atol=1e-5)
        np.testing.assert_allclose(np.asarray(h.normal),
                                   np.asarray(hb.normal), atol=1e-6)
        # per-ray exact stats: far fewer tests than brute's T per ray
        assert float(stats.tri_tests) / rays.count < scene.num_tris / 4

    def test_any_hit_parity(self):
        scene, rays = _scene_and_rays()
        occ = scene.any_hit_rays(rays)
        occ_b = any_hit_brute(rays, scene.tris)
        np.testing.assert_array_equal(np.asarray(occ), np.asarray(occ_b))

    def test_layer_mask(self):
        room = meshes.cornell_room(4.0)
        sph = meshes.uv_sphere(0.8, 8, 16, center=(0, 0, 0))
        tris = np.concatenate([room, sph])
        lay = np.full(tris.shape[0], 1, np.int32)
        lay[len(room):] = 4
        scene = build_scene(tris[:, 0], tris[:, 1], tris[:, 2], layers=lay,
                            backend="frontier")
        cam = mrt.CameraParams.look_at((0, 0, 5.4), (0, 0, 0),
                                       fov_degrees=60)
        rays = mrt.generate_rays(cam, 32, 24)
        for mask in (1, 4, 5):
            h, _ = scene.cast_rays(rays, query_mask=mask)
            hb, _ = cast_rays_brute(rays, scene.tris, mask)
            np.testing.assert_array_equal(np.asarray(h.prim_id),
                                          np.asarray(hb.prim_id))

    def test_degenerate_and_missing_rays(self):
        scene, _ = _scene_and_rays()
        rays = Rays(
            origin=jnp.asarray([[0, 0, 5], [0, 0, 5], [0, 0, 5]],
                               jnp.float32),
            direction=jnp.asarray([[0, 0, -1], [0, 0, 0], [0, 1, 0]],
                                  jnp.float32),
            t_min=jnp.asarray([1e-3, 1e-3, 1e-3], jnp.float32),
            t_max=jnp.asarray([1e30, -1.0, 1e30], jnp.float32),
        )
        h, _ = scene.cast_rays(rays)
        assert bool(h.hit[0])              # forward ray hits the room
        assert not bool(h.hit[1])          # degenerate t range: instant miss
        assert np.isfinite(np.asarray(h.t)).all()

    def test_single_triangle_scene(self):
        v = np.asarray([[[-1, 0, -1], [1, 0, -1], [0, 1, -1]]], np.float32)
        scene = build_scene_from_tri_array(v, backend="frontier")
        r = make_rays([[0, 0.3, 1]], [[0, 0, -1]])
        h, _ = scene.cast_rays(r)
        assert bool(h.hit[0]) and int(h.prim_id[0]) == 0
        assert float(h.t[0]) == pytest.approx(2.0, rel=1e-6)

    def test_overflow_retry(self):
        scene, rays = _scene_and_rays()
        # absurdly small caps force the doubling retry path
        h, _, _ = cast_rays_frontier(
            rays, scene.frontier, scene.tris,
            pair_cap_factor=1, leaf_cap_factor=1,
        )
        hb, _ = cast_rays_brute(rays, scene.tris)
        np.testing.assert_array_equal(np.asarray(h.prim_id),
                                      np.asarray(hb.prim_id))

    def test_quantized_parity(self):
        # CWBVH-equivalent 8-bit boxes: conservative rounding means the
        # traversal visits a superset — t/prim_id results stay EXACT
        scene, rays = _scene_and_rays()
        sq = scene
        sq.backend = "frontier_q"
        hb, _ = cast_rays_brute(rays, scene.tris)
        h, stats = sq.cast_rays(rays)
        np.testing.assert_array_equal(np.asarray(h.prim_id),
                                      np.asarray(hb.prim_id))
        np.testing.assert_allclose(np.asarray(h.t), np.asarray(hb.t),
                                   rtol=1e-6)
        occ = sq.any_hit_rays(rays)
        occ_b = any_hit_brute(rays, scene.tris)
        np.testing.assert_array_equal(np.asarray(occ), np.asarray(occ_b))

    def test_quantized_conservative_superset(self):
        # quantized tri-tests may only exceed the exact-box counts
        scene, rays = _scene_and_rays()
        _, stats_e, _ = cast_rays_frontier(rays, scene.frontier, scene.tris)
        _, stats_q, _ = cast_rays_frontier(rays, scene.frontier_q, scene.tris)
        assert float(stats_q.tri_tests) >= float(stats_e.tri_tests)
        # inflation from 8-bit boxes should be mild (<35%)
        assert float(stats_q.tri_tests) <= 1.35 * float(stats_e.tri_tests)

    def test_quantized_tables_smaller(self):
        scene, _ = _scene_and_rays()
        fe, fq = scene.frontier, scene.frontier_q
        exact_bytes = 7 * 4 * fe.child_enc.shape[0]
        q_bytes = (3 * 4 * fq.child_enc.shape[0]
                   + 6 * 4 * fq.node_pmin[0].shape[0])
        assert q_bytes < 0.55 * exact_bytes

    def test_quantized_decode_is_conservative(self):
        # decoded boxes must contain the exact boxes, elementwise in f32
        scene, _ = _scene_and_rays()
        fe, fq = scene.frontier, scene.frontier_q
        present = ~np.isnan(np.asarray(fe.child_min_x))
        # the quantized cast culls missing children via enc==0
        np.testing.assert_array_equal(present, np.asarray(fq.child_enc) != 0)
        w = np.arange(present.shape[0]) // 8
        for axis, (lo_e, hi_e) in enumerate(
            [(fe.child_min_x, fe.child_max_x),
             (fe.child_min_y, fe.child_max_y),
             (fe.child_min_z, fe.child_max_z)]
        ):
            a = np.asarray(fq.node_pmin[axis])[w]
            s = np.asarray(fq.node_psc[axis])[w]
            qlo = (np.asarray(fq.child_qlo) >> (8 * axis)) & 255
            qhi = (np.asarray(fq.child_qhi) >> (8 * axis)) & 255
            dec_lo = (a + qlo.astype(np.float32) * s).astype(np.float32)
            dec_hi = (a + qhi.astype(np.float32) * s).astype(np.float32)
            lo_e, hi_e = np.asarray(lo_e), np.asarray(hi_e)
            assert (dec_lo[present] <= lo_e[present]).all()
            assert (dec_hi[present] >= hi_e[present]).all()

    def test_per_ray_stats(self):
        scene, rays = _scene_and_rays()
        h, stats, found, per_ray = cast_rays_frontier(
            rays, scene.frontier, scene.tris, return_per_ray_stats=True
        )
        tt = np.asarray(per_ray["tri_tests"])
        nv = np.asarray(per_ray["nodes_visited"])
        assert tt.shape == (rays.count,) and nv.shape == (rays.count,)
        assert int(tt.sum()) == int(float(stats.tri_tests))
        assert int(nv.sum()) == int(stats.bvh_nodes_visited)
        assert (nv >= 1).all()  # every live ray visits at least the root
