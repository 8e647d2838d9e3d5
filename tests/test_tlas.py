"""TLAS / instancing tests: flatten path, two-level path, refit."""

import numpy as np
import jax.numpy as jnp

from messyerraytracer.accel.tlas import SceneTLAS
from messyerraytracer.core.brute import cast_rays_brute
from messyerraytracer.core.types import NO_HIT, make_rays
from messyerraytracer.render.camera import CameraParams, generate_rays
from messyerraytracer.utils import meshes


def translate(t):
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = t
    return m


def rot_y(theta, t=(0, 0, 0)):
    c, s = np.cos(theta), np.sin(theta)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    m[:3, 3] = t
    return m


def scale(s, t=(0, 0, 0)):
    m = np.eye(4, dtype=np.float32)
    m[0, 0] = m[1, 1] = m[2, 2] = s
    m[:3, 3] = t
    return m


def build_three_spheres(backend="kernel"):
    tlas = SceneTLAS(backend=backend)
    sphere = meshes.uv_sphere(radius=1.0, rings=8, segments=16)
    sid = tlas.add_mesh(sphere)
    tlas.add_instance(sid, translate((-3, 0, 0)))
    tlas.add_instance(sid, translate((0, 0, 0)))
    tlas.add_instance(sid, rot_y(0.7, (3, 0, 0)))
    tlas.build_tlas()
    return tlas


class TestFlattenPath:
    def test_hits_per_instance(self):
        tlas = build_three_spheres()
        # origins slightly off the spheres' symmetry planes: exactly-on-axis
        # rays hit shared mesh edges at barycentric boundaries, where f32
        # rounding legitimately differs between kernel and oracle
        origins = np.float32(
            [[-2.89, 0.07, 5], [0.11, 0.07, 5], [3.11, 0.07, 5], [9, 0.07, 5]]
        )
        dirs = np.float32([[0, 0, -1]] * 4)
        rays = make_rays(origins, dirs)
        hits, stats, inst = tlas.cast_rays(rays)
        assert np.asarray(hits.hit)[:3].all()
        assert not bool(hits.hit[3])
        np.testing.assert_array_equal(np.asarray(inst), [0, 1, 2, -1])
        # sphere front faces at z=1 -> t=4 for all three
        np.testing.assert_allclose(np.asarray(hits.t[:3]), 4.0, atol=0.1)

    def test_flat_matches_brute(self):
        tlas = build_three_spheres()
        rng = np.random.default_rng(0)
        o = rng.uniform(-5, 5, (256, 3)).astype(np.float32)
        d = rng.normal(size=(256, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        rays = make_rays(o, d)
        hits, _, _ = tlas.cast_rays(rays)
        ref, _ = cast_rays_brute(rays, tlas.flat.tris)
        np.testing.assert_array_equal(
            np.asarray(hits.prim_id), np.asarray(ref.prim_id)
        )
        np.testing.assert_allclose(np.asarray(hits.t), np.asarray(ref.t), rtol=1e-6)


class TestTwoLevelPath:
    def test_matches_flatten(self):
        tlas = build_three_spheres(backend="jnp")
        rng = np.random.default_rng(1)
        o = rng.uniform(-5, 5, (64, 3)).astype(np.float32)
        d = rng.normal(size=(64, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        rays = make_rays(o, d)
        h_flat, _, inst_flat = tlas.cast_rays(rays)
        h_two, inst_two = tlas.cast_rays_two_level(rays)
        # t values must agree closely (different arithmetic order)
        np.testing.assert_allclose(
            np.asarray(h_flat.t), np.asarray(h_two.t), rtol=2e-4
        )
        np.testing.assert_array_equal(
            np.asarray(h_flat.hit), np.asarray(h_two.hit)
        )
        np.testing.assert_array_equal(
            np.asarray(inst_flat), np.asarray(inst_two)
        )
        # both paths report the flattened scene's global prim numbering
        np.testing.assert_array_equal(
            np.asarray(h_flat.prim_id), np.asarray(h_two.prim_id)
        )

    def test_scaled_instance_world_t(self):
        # t stays world-parameterized for non-uniform instance scaling
        # because the object-space direction is NOT renormalized
        # (blas_instance.h:48-59).
        tlas = SceneTLAS(backend="jnp")
        sphere = meshes.uv_sphere(radius=1.0, rings=12, segments=24)
        sid = tlas.add_mesh(sphere)
        tlas.add_instance(sid, scale(2.0))  # radius-2 sphere at origin
        tlas.build_tlas()
        rays = make_rays((0.11, 0.07, 10), (0, 0, -1))
        h, inst = tlas.cast_rays_two_level(rays)
        assert bool(h.hit[0])
        assert abs(float(h.t[0]) - 8.0) < 0.1  # world distance to r=2 front
        h2, _, _ = tlas.cast_rays(rays)
        assert abs(float(h2.t[0]) - 8.0) < 0.1


class TestTwoLevelFast:
    """Scalable frontier TLAS/BLAS path (accel/tlas_frontier.py)."""

    @staticmethod
    def _rand_rays(n, seed):
        rng = np.random.default_rng(seed)
        o = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
        d = rng.normal(size=(n, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        return make_rays(o, d)

    def test_matches_flatten_exact(self):
        tlas = build_three_spheres(backend="jnp")
        rays = self._rand_rays(512, 11)
        h_flat, _, inst_flat = tlas.cast_rays(rays)
        h_fast, _, _, inst_fast = tlas.cast_rays_two_level_fast(rays)
        np.testing.assert_array_equal(
            np.asarray(h_fast.prim_id), np.asarray(h_flat.prim_id)
        )
        np.testing.assert_array_equal(
            np.asarray(inst_fast), np.asarray(inst_flat)
        )
        # object-space vs world-space MT rounding: ~1e-6 relative
        np.testing.assert_allclose(
            np.asarray(h_fast.t), np.asarray(h_flat.t), rtol=1e-5
        )

    def test_rotated_scaled_instances(self):
        tlas = build_three_spheres(backend="jnp")
        tlas.set_transform(0, rot_y(1.2, (-2, 1, 0)))
        tlas.set_transform(2, scale(1.5, (2.5, -0.5, 1)))
        tlas.refit_tlas()
        rays = self._rand_rays(256, 12)
        h_flat, _, inst_flat = tlas.cast_rays(rays)
        h_fast, _, _, inst_fast = tlas.cast_rays_two_level_fast(rays)
        np.testing.assert_array_equal(
            np.asarray(h_fast.prim_id), np.asarray(h_flat.prim_id)
        )
        np.testing.assert_array_equal(
            np.asarray(inst_fast), np.asarray(inst_flat)
        )
        # object-space MT vs world-space MT: different rounding, tight tol
        np.testing.assert_allclose(
            np.asarray(h_fast.t), np.asarray(h_flat.t), rtol=2e-4
        )

    def test_any_hit_matches(self):
        tlas = build_three_spheres(backend="jnp")
        rays = self._rand_rays(256, 13)
        _, _, occ_fast, _ = tlas.cast_rays_two_level_fast(rays, any_hit=True)
        occ_flat = tlas.any_hit_rays(rays)
        np.testing.assert_array_equal(
            np.asarray(occ_fast), np.asarray(occ_flat)
        )

    def test_memory_scales_with_meshes_not_instances(self):
        # 12 instances of ONE mesh: forest tables must hold the mesh once
        tlas = SceneTLAS(backend="jnp")
        sphere = meshes.uv_sphere(radius=0.5, rings=6, segments=12)
        sid = tlas.add_mesh(sphere)
        for i in range(12):
            tlas.add_instance(sid, translate((2.0 * (i % 4), 0, 2.0 * (i // 4))))
        tlas.build_tlas()
        ft = tlas.build_two_level()
        assert int(ft.tri[0].shape[0]) == tlas.meshes[0].num_tris
        assert int(tlas.flat.tris.v0.shape[0]) == 12 * tlas.meshes[0].num_tris
        rays = self._rand_rays(256, 14)
        h_flat, _, inst_flat = tlas.cast_rays(rays)
        h_fast, _, _, inst_fast = tlas.cast_rays_two_level_fast(rays)
        np.testing.assert_array_equal(
            np.asarray(h_fast.prim_id), np.asarray(h_flat.prim_id)
        )
        np.testing.assert_array_equal(
            np.asarray(inst_fast), np.asarray(inst_flat)
        )

    def test_transform_update_invalidates_cache(self):
        tlas = build_three_spheres(backend="jnp")
        rays = make_rays((0.11, 0.07, 5), (0, 0, -1))
        h0, _, _, inst0 = tlas.cast_rays_two_level_fast(rays)
        assert int(inst0[0]) == 1
        tlas.set_transform(1, translate((0, 10, 0)))
        tlas.refit_tlas()
        h1, _, _, inst1 = tlas.cast_rays_two_level_fast(rays)
        assert not bool(h1.hit[0])
        rays2 = make_rays((0.11, 15, 0.07), (0, -1, 0))
        h2, _, _, inst2 = tlas.cast_rays_two_level_fast(rays2)
        assert bool(h2.hit[0]) and int(inst2[0]) == 1

    def test_added_instance_invalidates_cache(self):
        # add_instance/build_tlas after a fast cast must rebuild the
        # frontier tables — a stale cache silently misses new instances
        tlas = SceneTLAS(backend="jnp")
        sphere = meshes.uv_sphere(radius=1.0, rings=8, segments=16)
        sid = tlas.add_mesh(sphere)
        tlas.add_instance(sid, translate((0, 0, 0)))
        tlas.build_tlas()
        rays = make_rays((2.5, 0.07, 5), (0, 0, -1))
        h0, _, _, inst0 = tlas.cast_rays_two_level_fast(rays)
        assert not bool(h0.hit[0])
        tlas.add_instance(sid, translate((2.5, 0, 0)))
        tlas.build_tlas()
        h1, _, _, inst1 = tlas.cast_rays_two_level_fast(rays)
        assert bool(h1.hit[0]) and int(inst1[0]) == 1

    def test_layer_mask(self):
        tlas = SceneTLAS(backend="jnp")
        sphere = meshes.uv_sphere(radius=1.0, rings=8, segments=16)
        sid = tlas.add_mesh(sphere)
        tlas.add_instance(sid, translate((-2, 0, 0)), layers=0b01)
        tlas.add_instance(sid, translate((2, 0, 0)), layers=0b10)
        tlas.build_tlas()
        rays = make_rays(
            np.float32([[-1.9, 0.07, 5], [2.1, 0.07, 5]]),
            np.float32([[0, 0, -1], [0, 0, -1]]),
        )
        h, _, _, inst = tlas.cast_rays_two_level_fast(rays, query_mask=0b01)
        assert bool(h.hit[0]) and int(inst[0]) == 0
        assert not bool(h.hit[1])


class TestRefit:
    def test_transform_update_moves_hits(self):
        tlas = build_three_spheres()
        rays = make_rays((0.11, 0.07, 5), (0, 0, -1))
        h0, _, inst0 = tlas.cast_rays(rays)
        assert int(inst0[0]) == 1
        # move center sphere out of the way
        tlas.set_transform(1, translate((0, 10, 0)))
        tlas.refit_tlas()
        h1, _, inst1 = tlas.cast_rays(rays)
        assert not bool(h1.hit[0])
        # moved sphere visible from above
        rays2 = make_rays((0.11, 15, 0.07), (0, -1, 0))
        h2, _, inst2 = tlas.cast_rays(rays2)
        assert bool(h2.hit[0]) and int(inst2[0]) == 1

    def test_refit_parity_vs_brute(self):
        tlas = build_three_spheres()
        tlas.set_transform(0, rot_y(1.2, (-2, 1, 0)))
        tlas.set_transform(2, scale(1.5, (2.5, -0.5, 1)))
        tlas.refit_tlas()
        rng = np.random.default_rng(3)
        o = rng.uniform(-5, 5, (128, 3)).astype(np.float32)
        d = rng.normal(size=(128, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        rays = make_rays(o, d)
        hits, _, _ = tlas.cast_rays(rays)
        ref, _ = cast_rays_brute(rays, tlas.flat.tris)
        np.testing.assert_array_equal(
            np.asarray(hits.prim_id), np.asarray(ref.prim_id)
        )
        np.testing.assert_allclose(np.asarray(hits.t), np.asarray(ref.t), rtol=1e-6)


class TestInstancedClusterPath:
    """SceneTLAS.cast_rays_instanced — the production instanced cast
    (kernels/walk.py through the API TLAS; scene_tlas.h:203-251)."""

    def _rand_rays(self, n, seed):
        rng = np.random.default_rng(seed)
        o = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
        d = rng.normal(size=(n, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        return make_rays(o, d)

    def test_matches_flatten(self):
        tlas = build_three_spheres(backend="jnp")
        rays = self._rand_rays(512, 21)
        h_flat, _, inst_flat = tlas.cast_rays(rays)
        h_inst, _, _, inst_id = tlas.cast_rays_instanced(rays)
        np.testing.assert_array_equal(
            np.asarray(h_inst.prim_id), np.asarray(h_flat.prim_id)
        )
        np.testing.assert_array_equal(
            np.asarray(inst_id), np.asarray(inst_flat)
        )
        # object-space vs world-space MT rounding
        np.testing.assert_allclose(
            np.asarray(h_inst.t), np.asarray(h_flat.t), rtol=1e-5
        )

    def test_any_hit(self):
        tlas = build_three_spheres(backend="jnp")
        rays = self._rand_rays(256, 22)
        _, _, occ, _ = tlas.cast_rays_instanced(rays, any_hit=True)
        occ_flat = tlas.any_hit_rays(rays)
        np.testing.assert_array_equal(np.asarray(occ), np.asarray(occ_flat))

    def test_memory_scales_with_meshes(self):
        # 12 instances of ONE mesh: the BLAS forest holds the mesh once
        tlas = SceneTLAS(backend="jnp")
        sphere = meshes.uv_sphere(radius=0.5, rings=6, segments=12)
        sid = tlas.add_mesh(sphere)
        for i in range(12):
            tlas.add_instance(
                sid, translate((2.0 * (i % 4), 0, 2.0 * (i // 4)))
            )
        tlas.build_tlas()
        ct = tlas.build_instanced()
        one = SceneTLAS(backend="jnp")
        one.add_mesh(sphere)
        one.add_instance(sid, translate((0, 0, 0)))
        one.build_tlas()
        ct1 = one.build_instanced()
        assert ct.tris.count == ct1.tris.count == sphere.shape[0]
        assert ct.count.shape[0] - ct.n_tlas == ct1.count.shape[0] - ct1.n_tlas
        rays = self._rand_rays(256, 23)
        h_flat, _, inst_flat = tlas.cast_rays(rays)
        h_inst, _, _, inst_id = tlas.cast_rays_instanced(rays)
        np.testing.assert_array_equal(
            np.asarray(h_inst.prim_id), np.asarray(h_flat.prim_id)
        )
        np.testing.assert_array_equal(
            np.asarray(inst_id), np.asarray(inst_flat)
        )

    def test_transform_update_refits(self):
        tlas = build_three_spheres(backend="jnp")
        rays = make_rays((0.11, 0.07, 5), (0, 0, -1))
        _, _, _, inst0 = tlas.cast_rays_instanced(rays)
        assert int(inst0[0]) == 1
        tlas.set_transform(1, translate((0, 10, 0)))  # rebuilds the TLAS
        h1, _, _, _ = tlas.cast_rays_instanced(rays)
        assert not bool(h1.hit[0])
        rays2 = make_rays((0.11, 15, 0.07), (0, -1, 0))
        h2, _, _, inst2 = tlas.cast_rays_instanced(rays2)
        assert bool(h2.hit[0]) and int(inst2[0]) == 1

    def test_instance_layer_masks(self):
        # two instances of ONE mesh with different masks: the instanced
        # cast filters per instance exactly like the flattened path
        # (effective layers = tri & instance, ray_scene.h:124)
        tlas = SceneTLAS(backend="jnp")
        sphere = meshes.uv_sphere(radius=1.0, rings=8, segments=16)
        sid = tlas.add_mesh(sphere)
        tlas.add_instance(sid, translate((-2, 0, 0)), layers=0b01)
        tlas.add_instance(sid, translate((2, 0, 0)), layers=0b10)
        tlas.build_tlas()
        rays = make_rays(
            np.float32([[-1.9, 0.07, 5], [2.1, 0.07, 5]]),
            np.float32([[0, 0, -1], [0, 0, -1]]),
        )
        h, _, _, inst = tlas.cast_rays_instanced(rays, query_mask=0b01)
        assert bool(h.hit[0]) and int(inst[0]) == 0
        assert not bool(h.hit[1])
        # random-batch parity vs the flattened cast for mixed masks
        rnd = self._rand_rays(256, 29)
        for qm in (0b01, 0b10, 0b11):
            hi, _, _, _ = tlas.cast_rays_instanced(rnd, query_mask=qm)
            hf, _, _ = tlas.cast_rays(rnd, query_mask=qm)
            np.testing.assert_array_equal(
                np.asarray(hi.prim_id), np.asarray(hf.prim_id)
            )
            np.testing.assert_array_equal(
                np.asarray(hi.hit_layers), np.asarray(hf.hit_layers)
            )
            hitm = np.asarray(hf.hit)
            np.testing.assert_allclose(
                np.asarray(hi.t)[hitm], np.asarray(hf.t)[hitm],
                rtol=2e-4, atol=1e-5,
            )

    def test_per_triangle_layer_masks(self):
        # per-triangle layers travel through the shared forest: half the
        # sphere's triangles are on layer 2 (triangle.h:22-56 semantics)
        sphere = meshes.uv_sphere(radius=1.0, rings=8, segments=16)
        tl = np.where(np.arange(len(sphere)) % 2 == 0, 0b01,
                      0b10).astype(np.int32)
        tlas = SceneTLAS(backend="jnp")
        sid = tlas.add_mesh(sphere, layers=tl)
        tlas.add_instance(sid, translate((0, 0, 0)))
        tlas.add_instance(sid, translate((3, 0, 0)), layers=0b01)
        tlas.build_tlas()
        rnd = self._rand_rays(256, 31)
        for qm in (0b01, 0b10, 0b11):
            hi, _, _, _ = tlas.cast_rays_instanced(rnd, query_mask=qm)
            hf, _, _ = tlas.cast_rays(rnd, query_mask=qm)
            np.testing.assert_array_equal(
                np.asarray(hi.prim_id), np.asarray(hf.prim_id)
            )
            np.testing.assert_array_equal(
                np.asarray(hi.hit_layers), np.asarray(hf.hit_layers)
            )

    def test_layer_group_memory(self):
        # instance masks are ANDed during traversal: instances with
        # distinct masks still share one BLAS (memory ~ meshes)
        sphere = meshes.uv_sphere(radius=1.0, rings=6, segments=12)
        base = SceneTLAS(backend="jnp")
        sid = base.add_mesh(sphere)
        base.add_instance(sid, translate((0, 0, 0)))
        base.build_tlas()
        one = base.build_instanced()
        mixed = SceneTLAS(backend="jnp")
        sid = mixed.add_mesh(sphere)
        mixed.add_instance(sid, translate((0, 0, 0)), layers=0b01)
        mixed.add_instance(sid, translate((3, 0, 0)), layers=0b01)
        mixed.add_instance(sid, translate((6, 0, 0)), layers=0b10)
        mixed.build_tlas()
        two = mixed.build_instanced()
        assert two.tris.count == one.tris.count == sphere.shape[0]
