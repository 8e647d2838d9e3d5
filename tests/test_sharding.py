"""Multi-device sharding tests on the 8-device virtual CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from messyerraytracer.core.types import make_rays
from messyerraytracer.parallel.sharding import (
    cast_rays_sharded,
    make_mesh,
    render_step_sharded,
)
from messyerraytracer.render.camera import CameraParams
from messyerraytracer.render.shade import make_environment, make_lights
from messyerraytracer.scene.scene import build_scene_from_tri_array
from messyerraytracer.utils import meshes


@pytest.fixture(scope="module")
def scene():
    return build_scene_from_tri_array(
        meshes.uv_sphere(radius=1.0, rings=8, segments=16)
    )


def random_rays(n, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return make_rays(o, d)


class TestShardedCast:
    def test_eight_device_mesh_available(self):
        assert len(jax.devices()) >= 8  # conftest virtual devices

    def test_sharded_matches_single_chip(self, scene):
        mesh = make_mesh(8)
        rays = random_rays(4096, seed=1)
        hits_s, stats_s, _ = cast_rays_sharded(rays, scene, mesh)
        hits_1, stats_1 = scene.cast_rays(rays)
        np.testing.assert_array_equal(
            np.asarray(hits_s.prim_id), np.asarray(hits_1.prim_id)
        )
        np.testing.assert_allclose(
            np.asarray(hits_s.t), np.asarray(hits_1.t), rtol=1e-6
        )
        # psum-merged stats: each ray walks alone, so the per-ray work
        # counters sum to exactly the single-device totals
        assert int(stats_s.hits) == int(stats_1.hits)
        assert int(stats_s.tri_tests) == int(stats_1.tri_tests)
        assert int(stats_s.bvh_nodes_visited) == int(
            stats_1.bvh_nodes_visited)

    def test_repeat_call_reuses_compiled_program(self, scene):
        from messyerraytracer.parallel.sharding import _cast_sharded_jit

        mesh = make_mesh(8)
        rays = random_rays(1024, seed=3)
        cast_rays_sharded(rays, scene, mesh)
        compiled = _cast_sharded_jit._cache_size()
        cast_rays_sharded(random_rays(1024, seed=4), scene, mesh)
        assert _cast_sharded_jit._cache_size() == compiled

    def test_non_divisible_ray_count(self, scene):
        mesh = make_mesh(8)
        rays = random_rays(1000, seed=2)  # not divisible by 8*BLOCK
        hits_s, stats_s, _ = cast_rays_sharded(rays, scene, mesh)
        hits_1, _ = scene.cast_rays(rays)
        np.testing.assert_array_equal(
            np.asarray(hits_s.prim_id), np.asarray(hits_1.prim_id)
        )
        assert int(stats_s.rays_cast) == 1000

    def test_any_hit_sharded(self, scene):
        mesh = make_mesh(8)
        rays = random_rays(2048, seed=3)
        _, _, occ_s = cast_rays_sharded(rays, scene, mesh, any_hit=True)
        occ_1 = scene.any_hit_rays(rays)
        np.testing.assert_array_equal(np.asarray(occ_s), np.asarray(occ_1))


class TestShardedRenderStep:
    def test_full_step_compiles_and_runs(self, scene):
        mesh = make_mesh(8)
        cam = CameraParams.look_at((0, 0, 4), (0, 0, 0), fov_degrees=60)
        lights = make_lights(
            [{"type": 0, "direction": (0.3, 1, 0.4), "energy": 1.0}]
        )
        img = render_step_sharded(
            scene, cam, 128, 64, mesh, lights=lights,
            env=make_environment(), max_bounces=1,
        )
        arr = np.asarray(img)
        assert arr.shape == (128 * 64, 3)
        assert np.isfinite(arr).all()
        assert arr.mean() > 0.0


class TestSceneSharded:
    """Scene-parallel axis: triangles partitioned over the mesh, rays
    replicated, closest hit combined over the collective axis."""

    def test_matches_single_scene(self):
        from messyerraytracer.parallel.sharding import (
            build_sharded_scene,
            cast_rays_scene_sharded,
        )

        tris = np.concatenate([
            meshes.uv_sphere(1.0, 8, 16, center=(-1.5, 0, 0)),
            meshes.uv_sphere(0.7, 8, 16, center=(1.5, 0.3, 0)),
            meshes.plane(8.0, y=-1.2, subdiv=6),
        ])
        single = build_scene_from_tri_array(tris)
        mesh = make_mesh(8)
        stacked, meta, id_maps = build_sharded_scene(tris, 8)
        rays = random_rays(1024, seed=7)
        hits_s, stats_s = cast_rays_scene_sharded(
            rays, stacked, meta, id_maps, mesh
        )
        hits_1, _ = single.cast_rays(rays)
        np.testing.assert_array_equal(
            np.asarray(hits_s.prim_id), np.asarray(hits_1.prim_id)
        )
        np.testing.assert_allclose(
            np.asarray(hits_s.t), np.asarray(hits_1.t), rtol=1e-6
        )
        assert int(stats_s.hits) == int(np.asarray(hits_1.hit).sum())
        assert int(stats_s.stack_drops) == 0

    def test_shard_memory_is_partitioned(self):
        from messyerraytracer.parallel.sharding import (
            build_sharded_scene,
        )

        tris = meshes.uv_sphere(1.0, 16, 32)
        stacked, meta, id_maps = build_sharded_scene(tris, 8)
        # each shard's triangle table holds ~1/8 of the triangles
        single = build_scene_from_tri_array(tris)
        per_shard_rows = stacked["v0"].shape[1]
        single_rows = single.tris.v0.shape[0]
        assert per_shard_rows < single_rows / 2
        assert stacked["aabb_min"].shape[1] < single.bvh.num_nodes / 2
