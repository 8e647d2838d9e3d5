"""Per-ray traversal kernel (kernels/walk.py) in interpret mode on CPU.

The CPU runs the very kernel the GPU compiles, through the Pallas
interpreter.  Parity gate: t/prim_id against the brute-force oracle
(core/brute.py), u/v to formulation rounding.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from messyerraytracer.core.brute import any_hit_brute, cast_rays_brute
from messyerraytracer.core.types import NO_HIT, Rays, make_rays
from messyerraytracer.kernels import walk
from messyerraytracer.kernels.walk import cast_rays_walk
from messyerraytracer.render.camera import CameraParams, generate_rays
from messyerraytracer.scene.scene import build_scene_from_tri_array
from messyerraytracer.utils import meshes


def random_rays(n, seed=0, extent=3.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return make_rays(o, d)


def assert_parity(hits, ref, rtol=1e-5):
    np.testing.assert_array_equal(np.asarray(hits.prim_id),
                                  np.asarray(ref.prim_id))
    hit = np.asarray(ref.prim_id) != NO_HIT
    np.testing.assert_allclose(np.asarray(hits.t)[hit],
                               np.asarray(ref.t)[hit], rtol=rtol)
    np.testing.assert_allclose(np.asarray(hits.u), np.asarray(ref.u),
                               atol=5e-5)
    np.testing.assert_allclose(np.asarray(hits.v), np.asarray(ref.v),
                               atol=5e-5)
    np.testing.assert_allclose(np.asarray(hits.normal),
                               np.asarray(ref.normal), atol=1e-6)
    np.testing.assert_array_equal(np.asarray(hits.hit_layers),
                                  np.asarray(ref.hit_layers))


def _terrain(subdiv=10, size=8.0):
    g = meshes.plane(size, y=0.0, subdiv=subdiv)
    g[:, :, 1] = np.sin(g[:, :, 0]) * 0.6
    return g


def _far_sphere():
    sph = meshes.uv_sphere(radius=1.0, rings=10, segments=20)
    return sph + np.float32([80.0, -40.0, 60.0])


# scenario -> (triangles, rays); sized for the interpreter
SCENARIOS = {
    "sphere_random": lambda: (
        meshes.uv_sphere(radius=1.0, rings=12, segments=24),
        random_rays(512, seed=0)),
    "soup_camera": lambda: (
        meshes.random_soup(1500, extent=5.0, tri_size=0.5, seed=3),
        generate_rays(CameraParams.look_at((0, 0, 14), (0, 0, 0),
                                           fov_degrees=70.0), 40, 30)),
    "non_block_multiple": lambda: (
        meshes.uv_sphere(radius=1.0, rings=8, segments=16),
        random_rays(37, seed=5)),
    "far_scene": lambda: (
        _far_sphere(),
        generate_rays(CameraParams.look_at((0, 0, 0), (80, -40, 60),
                                           fov_degrees=10.0), 32, 24)),
    "terrain_sphere": lambda: (
        np.concatenate([_terrain(),
                        meshes.uv_sphere(1.2, 6, 12, center=(0, 1.5, 0))]),
        random_rays(300, seed=1, extent=5.0)),
}


class TestRouting:
    @pytest.mark.parametrize("platform,interpret",
                             [("cpu", True), ("gpu", False)])
    def test_platform_maps_to_mode(self, platform, interpret):
        assert walk.kernel_interpret(platform) is interpret

    @pytest.mark.parametrize("platform", ["rocm", "METAL", "sycl"])
    def test_other_platforms_raise(self, platform):
        with pytest.raises(RuntimeError, match="no traversal kernel"):
            walk.kernel_interpret(platform)

    def test_default_follows_jax_backend(self):
        assert jax.default_backend() == "cpu"   # conftest forces the CPU
        assert walk.kernel_interpret() is True

    def test_explicit_interpret_matches_default(self):
        scene = build_scene_from_tri_array(
            meshes.uv_sphere(1.0, 8, 16))
        rays = random_rays(64, seed=3)
        h0, _, _ = cast_rays_walk(rays, scene.bvh, scene.tris)
        h1, _, _ = cast_rays_walk(rays, scene.bvh, scene.tris,
                                  interpret=True)
        np.testing.assert_array_equal(np.asarray(h0.t), np.asarray(h1.t))


class TestWrapperShapes:
    @pytest.mark.parametrize("n,padded", [(1, 128), (127, 128), (128, 128),
                                          (129, 256), (1000, 1024)])
    def test_pad_count(self, n, padded):
        assert walk.BLOCK == 128
        assert walk.pad_count(n) == padded

    @pytest.mark.parametrize("levels,depth", [(1, 2), (2, 2), (22, 32),
                                              (33, 64)])
    def test_stack_depth_power_of_two(self, levels, depth):
        assert walk.stack_depth(levels) == depth

    def test_pad_rays_are_dead(self):
        rays = random_rays(37, seed=1)
        fields = walk._ray_fields(rays)
        assert all(f.shape == (128,) for f in fields)
        t_min, t_max = np.asarray(fields[6]), np.asarray(fields[7])
        assert (t_max[37:] < t_min[37:]).all()
        assert (t_max[:37] >= t_min[:37]).all()

    def test_output_shapes_and_dtypes(self):
        scene = build_scene_from_tri_array(meshes.uv_sphere(1.0, 6, 12))
        rays = random_rays(200, seed=2)
        hits, stats, occ, pr = cast_rays_walk(rays, scene.bvh, scene.tris,
                                              return_per_ray=True)
        assert hits.t.shape == (200,) and hits.position.shape == (200, 3)
        assert hits.prim_id.dtype == jnp.int32 and occ.shape == (200,)
        assert pr["tri_tests"].shape == (200,)
        assert pr["node_visits"].shape == (200,)
        assert int(stats.rays_cast) == 200


class TestFlatParity:
    @pytest.mark.parametrize("name", list(SCENARIOS))
    def test_closest_hit_parity(self, name):
        tris, rays = SCENARIOS[name]()
        scene = build_scene_from_tri_array(tris)
        assert scene.backend == "kernel"
        hits, stats = scene.cast_rays(rays)
        ref, _ = cast_rays_brute(rays, scene.tris)
        assert_parity(hits, ref)
        assert int(stats.hits) == int(np.asarray(ref.hit).sum())
        assert int(stats.stack_drops) == 0
        if int(stats.hits):
            assert int(stats.tri_tests) > 0
            assert int(stats.bvh_nodes_visited) > 0

    @pytest.mark.parametrize("name", ["sphere_random", "terrain_sphere",
                                      "far_scene"])
    def test_any_hit_matches_brute(self, name):
        tris, rays = SCENARIOS[name]()
        scene = build_scene_from_tri_array(tris)
        occ = scene.any_hit_rays(rays)
        np.testing.assert_array_equal(np.asarray(occ),
                                      np.asarray(any_hit_brute(rays,
                                                               scene.tris)))

    @pytest.mark.parametrize("name", ["sphere_random", "terrain_sphere"])
    def test_matches_jnp_traversal(self, name):
        tris, rays = SCENARIOS[name]()
        scene = build_scene_from_tri_array(tris)
        hk, sk = scene.cast_rays(rays)
        scene.backend = "jnp"
        hj, sj = scene.cast_rays(rays)
        np.testing.assert_array_equal(np.asarray(hk.prim_id),
                                      np.asarray(hj.prim_id))
        np.testing.assert_allclose(np.asarray(hk.t), np.asarray(hj.t),
                                   rtol=1e-6)
        # the same leaves get tested, whatever the child order
        assert int(sk.hits) == int(sj.hits)

    def test_root_leaf_two_triangles(self):
        v = np.float32([
            [[-1, -1, -5], [1, -1, -5], [0, 1, -5]],
            [[-1, -1, -8], [1, -1, -8], [0, 1, -8]],
        ])
        scene = build_scene_from_tri_array(v)
        assert int(scene.bvh.count[0]) == 2          # the root is a leaf
        hits, stats = scene.cast_rays(make_rays((0, 0, 0), (0, 0, -1)))
        assert int(hits.prim_id[0]) == 0
        assert float(hits.t[0]) == pytest.approx(5.0, abs=1e-5)
        assert int(stats.bvh_nodes_visited) == 1

    def test_single_triangle_scene(self):
        v = np.float32([[[-1, -1, -3], [1, -1, -3], [0, 1, -3]]])
        scene = build_scene_from_tri_array(v)
        rays = make_rays(np.float32([[0, 0, 0], [5, 5, 0]]),
                         np.float32([[0, 0, -1], [0, 0, -1]]))
        hits, _ = scene.cast_rays(rays)
        np.testing.assert_array_equal(np.asarray(hits.prim_id), [0, NO_HIT])
        assert float(hits.t[0]) == pytest.approx(3.0, abs=1e-5)

    def test_miss_returns_no_hit(self):
        scene = build_scene_from_tri_array(meshes.uv_sphere(1.0, 8, 16))
        hits, stats = scene.cast_rays(make_rays((0, 0, 4), (0, 0, 1)))
        assert int(hits.prim_id[0]) == NO_HIT
        assert float(hits.t[0]) > 1e38
        assert int(stats.hits) == 0

    def test_t_max_bound(self):
        scene = build_scene_from_tri_array(meshes.uv_sphere(1.0, 8, 16))
        hits, _ = scene.cast_rays(make_rays((0, 0, 4), (0, 0, -1),
                                            t_max=2.0))
        assert int(hits.prim_id[0]) == NO_HIT

    def test_t_min_skips_near_surface(self):
        scene = build_scene_from_tri_array(meshes.uv_sphere(1.0, 8, 16))
        rays = make_rays((0.11, 0.07, 4), (0, 0, -1), t_min=3.5)
        hits, _ = scene.cast_rays(rays)
        ref, _ = cast_rays_brute(rays, scene.tris)
        assert bool(hits.hit[0])
        assert float(hits.t[0]) == pytest.approx(float(ref.t[0]), rel=1e-5)
        assert float(hits.t[0]) > 4.5                 # the far side


class TestLayerMasks:
    @pytest.mark.parametrize("mask", [0b01, 0b10, 0b11])
    def test_mask_matches_brute(self, mask):
        g = meshes.plane(6.0, y=0.0, subdiv=8)
        sph = meshes.uv_sphere(1.0, 8, 14, center=(0, 1.2, 0))
        layers = np.concatenate([np.full(len(g), 0b01, np.int32),
                                 np.full(len(sph), 0b10, np.int32)])
        scene = build_scene_from_tri_array(np.concatenate([g, sph]),
                                           layers=layers)
        rays = random_rays(256, seed=4, extent=4.0)
        hits, _ = scene.cast_rays(rays, query_mask=mask)
        ref, _ = cast_rays_brute(rays, scene.tris, query_mask=mask)
        assert_parity(hits, ref)
        got = np.asarray(hits.hit_layers)[np.asarray(hits.hit)]
        assert np.all((got & mask) != 0)

    def test_masked_near_returns_far(self):
        v = np.float32([
            [[-1, -1, -5], [1, -1, -5], [0, 1, -5]],
            [[-1, -1, -8], [1, -1, -8], [0, 1, -8]],
        ])
        scene = build_scene_from_tri_array(v, layers=np.int32([1, 2]))
        hits, _ = scene.cast_rays(make_rays((0, 0, 0), (0, 0, -1)),
                                  query_mask=2)
        assert int(hits.prim_id[0]) == 1
        assert float(hits.t[0]) == pytest.approx(8.0, abs=1e-4)


class TestRefit:
    def test_refit_after_move(self):
        sph = meshes.uv_sphere(radius=1.0, rings=10, segments=20)
        scene = build_scene_from_tri_array(sph)
        moved = sph + np.float32([0.5, 0.0, -2.0])
        scene2 = scene.refit(moved[:, 0], moved[:, 1], moved[:, 2])
        rays = random_rays(256, seed=9)
        hits, stats = scene2.cast_rays(rays)
        ref, _ = cast_rays_brute(rays, scene2.tris)
        assert_parity(hits, ref)
        assert int(stats.stack_drops) == 0

    def test_refit_moves_hits_away(self):
        sph = meshes.uv_sphere(radius=1.0, rings=8, segments=16)
        scene = build_scene_from_tri_array(sph)
        ray = make_rays((0.11, 0.07, 4), (0, 0, -1))
        assert bool(scene.cast_rays(ray)[0].hit[0])
        away = sph + np.float32([0.0, 10.0, 0.0])
        scene2 = scene.refit(away[:, 0], away[:, 1], away[:, 2])
        assert not bool(scene2.cast_rays(ray)[0].hit[0])


class TestPerRayCounters:
    def test_counters_sum_to_stats(self):
        tris, rays = SCENARIOS["terrain_sphere"]()
        scene = build_scene_from_tri_array(tris)
        hits, stats, _, pr = cast_rays_walk(rays, scene.bvh, scene.tris,
                                            return_per_ray=True)
        tt = np.asarray(pr["tri_tests"])
        nv = np.asarray(pr["node_visits"])
        assert int(tt.sum()) == int(stats.tri_tests)
        assert int(nv.sum()) == int(stats.bvh_nodes_visited)
        hit = np.asarray(hits.hit)
        assert (tt[hit] > 0).all() and (nv[hit] > 0).all()
        # a ray tests at most MAX_LEAF_SIZE triangles per visited node
        assert (tt <= 4 * nv).all()

    def test_dead_rays_cost_nothing(self):
        scene = build_scene_from_tri_array(meshes.uv_sphere(1.0, 8, 16))
        rays = random_rays(256, seed=7)
        n = rays.count
        tmax = jnp.where(jnp.arange(n) < 100, rays.t_max, -1.0)
        mixed = Rays(origin=rays.origin, direction=rays.direction,
                     t_min=rays.t_min, t_max=tmax)
        hm, _, _, pr = cast_rays_walk(mixed, scene.bvh, scene.tris,
                                      return_per_ray=True)
        hl, _, _ = cast_rays_walk(
            Rays(origin=rays.origin[:100], direction=rays.direction[:100],
                 t_min=rays.t_min[:100], t_max=rays.t_max[:100]),
            scene.bvh, scene.tris)
        np.testing.assert_array_equal(np.asarray(hm.prim_id)[:100],
                                      np.asarray(hl.prim_id))
        assert (np.asarray(hm.prim_id)[100:] == NO_HIT).all()
        assert (np.asarray(pr["node_visits"])[100:] == 0).all()
        assert (np.asarray(pr["tri_tests"])[100:] == 0).all()

    def test_debug_heatmap_reads_kernel_counters(self):
        from messyerraytracer.debug.debug import per_ray_cost_heatmap

        tris, rays = SCENARIOS["sphere_random"]()
        scene = build_scene_from_tri_array(tris)
        colors, tt, nodes = per_ray_cost_heatmap(scene, rays)
        _, stats = scene.cast_rays(rays)
        assert colors.shape == (rays.count, 3)
        assert int(tt.sum()) == int(stats.tri_tests)
        assert int(nodes.sum()) == int(stats.bvh_nodes_visited)


class TestBackendSelection:
    def test_unknown_backend_raises(self):
        with pytest.raises(ValueError, match="unknown cast backend"):
            build_scene_from_tri_array(meshes.uv_sphere(1.0, 4, 8),
                                       backend="cluster")

    @pytest.mark.parametrize("old", ["cluster", "pallas"])
    def test_saved_scene_with_retired_backend_loads(self, tmp_path, old):
        from messyerraytracer.scene.serialize import load_scene, save_scene

        scene = build_scene_from_tri_array(meshes.uv_sphere(1.0, 6, 12))
        path = str(tmp_path / "s.npz")
        save_scene(path, scene)
        z = dict(np.load(path))
        z["backend"] = np.bytes_(old.encode())
        np.savez(path, **z)
        loaded = load_scene(path)
        assert loaded.backend == "kernel"
        rays = random_rays(64, seed=1)
        np.testing.assert_array_equal(
            np.asarray(loaded.cast_rays(rays)[0].prim_id),
            np.asarray(scene.cast_rays(rays)[0].prim_id))

    def test_service_auto_is_kernel(self):
        from messyerraytracer.api.service import RayTracerService

        svc = RayTracerService()
        assert svc.get_backend() == "kernel"
        with pytest.raises(AssertionError):
            svc.set_backend("pallas")
