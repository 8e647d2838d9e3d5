"""BVH build / traversal / refit tests — parity against the brute oracle."""

import numpy as np
import jax.numpy as jnp
import pytest

from messyerraytracer.core.brute import any_hit_brute, cast_rays_brute
from messyerraytracer.core.types import NO_HIT, make_rays
from messyerraytracer.accel.bvh import (
    BVH_BINS,
    MAX_LEAF_SIZE,
    build_bvh,
    sah_cost,
)
from messyerraytracer.scene.scene import build_scene_from_tri_array
from messyerraytracer.render.camera import CameraParams, generate_rays
from messyerraytracer.utils import meshes


def make_sphere_scene(**kw):
    s = meshes.uv_sphere(radius=1.0, rings=16, segments=32)
    return build_scene_from_tri_array(s, **kw)


def random_rays(n, seed=0, extent=3.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return make_rays(o, d)


class TestBuild:
    def test_structure_invariants(self):
        s = meshes.uv_sphere(radius=1.0, rings=8, segments=16)
        bvh = build_bvh(s[:, 0], s[:, 1], s[:, 2])
        n = s.shape[0]
        count = np.asarray(bvh.count)
        lf = np.asarray(bvh.left_first)
        amin = np.asarray(bvh.aabb_min)
        amax = np.asarray(bvh.aabb_max)
        m = bvh.num_nodes

        assert m <= 2 * n - 1
        # permutation is a bijection
        assert sorted(np.asarray(bvh.tri_order).tolist()) == list(range(n))
        # leaves cover [0, n) exactly once, each <= MAX_LEAF_SIZE
        leaf = count > 0
        assert count[leaf].max() <= MAX_LEAF_SIZE
        covered = np.zeros(n, bool)
        for i in np.nonzero(leaf)[0]:
            sl = slice(lf[i], lf[i] + count[i])
            assert not covered[sl].any()
            covered[sl] = True
        assert covered.all()
        # internal: left child = node+1 (DFS), right child in bounds, and
        # children boxes are contained in the parent box
        for i in np.nonzero(~leaf)[0]:
            l, r = i + 1, lf[i]
            assert 0 < r < m and l < m
            for c in (l, r):
                assert (amin[i] <= amin[c] + 1e-6).all()
                assert (amax[i] >= amax[c] - 1e-6).all()

    def test_single_triangle(self):
        v = np.float32([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]])
        bvh = build_bvh(v[:, 0], v[:, 1], v[:, 2])
        assert bvh.num_nodes == 1
        assert int(bvh.count[0]) == 1

    def test_identical_centroids_terminates(self):
        # 64 coincident triangles: degenerate centroid bounds must still
        # produce a valid tree (median-split fallback), not infinite
        # recursion.
        tri = np.float32([[0, 0, 0], [1, 0, 0], [0, 1, 0]])
        v = np.tile(tri[None], (64, 1, 1))
        bvh = build_bvh(v[:, 0], v[:, 1], v[:, 2])
        count = np.asarray(bvh.count)
        assert count[count > 0].max() <= MAX_LEAF_SIZE

    def test_sah_quality(self):
        # Good BVH ~ 5-20 tri tests/ray (stats.h:13-16). SAH cost of a
        # uniform soup should be far below the brute-force N.
        soup = meshes.random_soup(4096, extent=10.0, seed=1)
        bvh = build_bvh(soup[:, 0], soup[:, 1], soup[:, 2])
        assert sah_cost(bvh) < 200.0
        assert BVH_BINS == 12 and MAX_LEAF_SIZE == 4


class TestNativeBuilder:
    def test_native_available_and_fast(self):
        from messyerraytracer.native import get_native_lib

        assert get_native_lib() is not None, "g++ toolchain expected in CI"

    def test_native_structure_invariants(self):
        s = meshes.random_soup(3000, extent=5.0, seed=8)
        bvh = build_bvh(s[:, 0], s[:, 1], s[:, 2], use_native=True)
        n = s.shape[0]
        count = np.asarray(bvh.count)
        lf = np.asarray(bvh.left_first)
        assert bvh.num_nodes <= 2 * n - 1
        assert sorted(np.asarray(bvh.tri_order).tolist()) == list(range(n))
        leaf = count > 0
        assert count[leaf].max() <= MAX_LEAF_SIZE
        covered = np.zeros(n, bool)
        for i in np.nonzero(leaf)[0]:
            sl = slice(lf[i], lf[i] + count[i])
            assert not covered[sl].any()
            covered[sl] = True
        assert covered.all()

    def test_native_cast_parity(self):
        s = meshes.random_soup(3000, extent=5.0, seed=8)
        scene = build_scene_from_tri_array(s)  # uses native by default
        rays = random_rays(256, seed=21, extent=6.0)
        hb, _ = scene.cast_rays(rays)
        hr, _ = cast_rays_brute(rays, scene.tris)
        np.testing.assert_array_equal(
            np.asarray(hb.prim_id), np.asarray(hr.prim_id)
        )
        # 1e-5: the kernel's per-component MT and the oracle's broadcast
        # MT round differently in the last ulps
        np.testing.assert_allclose(np.asarray(hb.t), np.asarray(hr.t), rtol=1e-5)

    def test_native_quality_comparable_to_python(self):
        # the trees may differ in FP tie-breaks but SAH quality must match
        s = meshes.random_soup(4096, extent=10.0, seed=1)
        bn = build_bvh(s[:, 0], s[:, 1], s[:, 2], use_native=True)
        bp = build_bvh(s[:, 0], s[:, 1], s[:, 2], use_native=False)
        cn, cp = sah_cost(bn), sah_cost(bp)
        assert cn < cp * 1.1  # within 10%


class TestTraversalParity:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_sphere_parity_random_rays(self, seed):
        scene = make_sphere_scene()
        rays = random_rays(256, seed=seed)
        hits_bvh, stats = scene.cast_rays(rays)
        hits_ref, _ = cast_rays_brute(rays, scene.tris)
        np.testing.assert_array_equal(
            np.asarray(hits_bvh.prim_id), np.asarray(hits_ref.prim_id)
        )
        np.testing.assert_allclose(
            np.asarray(hits_bvh.t), np.asarray(hits_ref.t), rtol=1e-6
        )
        np.testing.assert_allclose(
            np.asarray(hits_bvh.u), np.asarray(hits_ref.u), atol=1e-6
        )
        np.testing.assert_allclose(
            np.asarray(hits_bvh.normal), np.asarray(hits_ref.normal), atol=1e-6
        )

    def test_soup_parity_camera_rays(self):
        soup = meshes.random_soup(2000, extent=5.0, tri_size=0.5, seed=3)
        # jnp backend: this test asserts PER-RAY traversal efficiency
        # (packet tiles share visits; their stats are tile-level)
        scene = build_scene_from_tri_array(soup, backend="jnp")
        cam = CameraParams.look_at((0, 0, 14), (0, 0, 0), fov_degrees=70.0)
        rays = generate_rays(cam, 32, 24)
        hits_bvh, stats = scene.cast_rays(rays)
        hits_ref, _ = cast_rays_brute(rays, scene.tris)
        np.testing.assert_array_equal(
            np.asarray(hits_bvh.prim_id), np.asarray(hits_ref.prim_id)
        )
        np.testing.assert_allclose(
            np.asarray(hits_bvh.t), np.asarray(hits_ref.t), rtol=1e-6
        )
        # BVH efficiency: far fewer tri tests than brute force
        assert int(stats.tri_tests) < rays.count * scene.num_tris * 0.05
        assert int(stats.bvh_nodes_visited) > 0

    def test_layer_mask_parity(self):
        soup = meshes.random_soup(512, extent=3.0, tri_size=0.5, seed=5)
        layers = (np.arange(512) % 4 + 1).astype(np.int32)  # layers 1,2,3,4
        scene = build_scene_from_tri_array(soup, layers=layers)
        rays = random_rays(128, seed=7)
        for mask in (0b01, 0b10, 0b110):
            hb, _ = scene.cast_rays(rays, query_mask=mask)
            hr, _ = cast_rays_brute(rays, scene.tris, query_mask=mask)
            np.testing.assert_array_equal(
                np.asarray(hb.prim_id), np.asarray(hr.prim_id)
            )

    def test_any_hit_parity(self):
        scene = make_sphere_scene()
        rays = random_rays(256, seed=11)
        occ_bvh = scene.any_hit_rays(rays)
        occ_ref = any_hit_brute(rays, scene.tris)
        np.testing.assert_array_equal(np.asarray(occ_bvh), np.asarray(occ_ref))

    def test_t_max_respected(self):
        scene = make_sphere_scene()
        # Ray toward sphere but t_max short of the surface.
        rays = make_rays((0, 0, 4), (0, 0, -1), t_max=2.0)
        hits, _ = scene.cast_rays(rays)
        assert int(hits.prim_id[0]) == NO_HIT

    def test_use_bvh_false_is_brute(self):
        scene = make_sphere_scene(use_bvh=False)
        rays = random_rays(64, seed=13)
        h1, s1 = scene.cast_rays(rays)
        h2, s2 = cast_rays_brute(rays, scene.tris)
        np.testing.assert_array_equal(np.asarray(h1.prim_id), np.asarray(h2.prim_id))
        assert int(s1.bvh_nodes_visited) == 0


class TestRefit:
    def test_refit_matches_rebuild_aabbs(self):
        soup = meshes.random_soup(1024, extent=4.0, seed=17)
        scene = build_scene_from_tri_array(soup)
        # Translate all vertices; refit.
        moved = soup + np.float32([1.5, -0.5, 2.0])
        scene2 = scene.refit(moved[:, 0], moved[:, 1], moved[:, 2])
        # Root AABB must equal the moved geometry's bounds.
        np.testing.assert_allclose(
            np.asarray(scene2.bvh.aabb_min[0]),
            moved.reshape(-1, 3).min(axis=0),
            atol=1e-5,
        )
        np.testing.assert_allclose(
            np.asarray(scene2.bvh.aabb_max[0]),
            moved.reshape(-1, 3).max(axis=0),
            atol=1e-5,
        )
        # Casts after refit match brute force on the moved triangles.
        rays = random_rays(128, seed=19, extent=6.0)
        hb, _ = scene2.cast_rays(rays)
        hr, _ = cast_rays_brute(rays, scene2.tris)
        np.testing.assert_array_equal(np.asarray(hb.prim_id), np.asarray(hr.prim_id))
        np.testing.assert_allclose(np.asarray(hb.t), np.asarray(hr.t), rtol=1e-6)

    def test_refit_nonuniform_deform(self):
        soup = meshes.random_soup(512, extent=3.0, seed=23)
        scene = build_scene_from_tri_array(soup)
        moved = soup * np.float32([1.3, 0.7, 1.1]) + np.float32([0.2, 0, -1])
        scene2 = scene.refit(moved[:, 0], moved[:, 1], moved[:, 2])
        rays = random_rays(128, seed=29, extent=5.0)
        hb, _ = scene2.cast_rays(rays)
        hr, _ = cast_rays_brute(rays, scene2.tris)
        np.testing.assert_array_equal(np.asarray(hb.prim_id), np.asarray(hr.prim_id))
