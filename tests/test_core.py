"""Core-type and oracle tests: Moller-Trumbore, slab test, camera, brute cast.

The numpy reimplementations here are intentionally independent, scalar-style
code so the vectorized JAX paths are checked against straightforward math.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from messyerraytracer.core.types import (
    ALL_LAYERS,
    NO_HIT,
    T_MAX_DEFAULT,
    make_rays,
    make_triangles,
    safe_inv_direction,
)
from messyerraytracer.core.geometry import moller_trumbore, slab_test
from messyerraytracer.core.brute import any_hit_brute, cast_rays_brute
from messyerraytracer.render.camera import (
    CameraParams,
    debug_grid_rays,
    generate_rays,
)
from messyerraytracer.utils import meshes


def single_tri(v0, v1, v2, **kw):
    return make_triangles(
        np.asarray([v0], np.float32),
        np.asarray([v1], np.float32),
        np.asarray([v2], np.float32),
        **kw,
    )


class TestMollerTrumbore:
    def test_head_on_hit(self):
        tris = single_tri((-1, -1, -5), (1, -1, -5), (0, 1, -5))
        rays = make_rays((0, 0, 0), (0, 0, -1))
        hits, stats = cast_rays_brute(rays, tris)
        assert bool(hits.hit[0])
        assert np.isclose(float(hits.t[0]), 5.0, atol=1e-5)
        np.testing.assert_allclose(
            np.asarray(hits.position[0]), [0, 0, -5], atol=1e-5
        )
        assert int(hits.prim_id[0]) == 0
        assert int(stats.hits) == 1

    def test_miss_outside(self):
        tris = single_tri((-1, -1, -5), (1, -1, -5), (0, 1, -5))
        rays = make_rays((10, 0, 0), (0, 0, -1))
        hits, _ = cast_rays_brute(rays, tris)
        assert not bool(hits.hit[0])
        assert int(hits.prim_id[0]) == NO_HIT
        assert float(hits.t[0]) == pytest.approx(T_MAX_DEFAULT)

    def test_parallel_ray_rejected(self):
        tris = single_tri((-1, -1, -5), (1, -1, -5), (0, 1, -5))
        rays = make_rays((0, 0, 0), (1, 0, 0))  # parallel to tri plane
        hits, _ = cast_rays_brute(rays, tris)
        assert not bool(hits.hit[0])

    def test_behind_origin_rejected(self):
        tris = single_tri((-1, -1, 5), (1, -1, 5), (0, 1, 5))
        rays = make_rays((0, 0, 0), (0, 0, -1))  # tri is behind
        hits, _ = cast_rays_brute(rays, tris)
        assert not bool(hits.hit[0])

    def test_t_min_shadow_acne(self):
        # Hit at t=0.0005 < default t_min=0.001 must be rejected.
        tris = single_tri((-1, -1, -0.0005), (1, -1, -0.0005), (0, 1, -0.0005))
        rays = make_rays((0, 0, 0), (0, 0, -1))
        hits, _ = cast_rays_brute(rays, tris)
        assert not bool(hits.hit[0])

    def test_t_max_clipping(self):
        tris = single_tri((-1, -1, -5), (1, -1, -5), (0, 1, -5))
        rays = make_rays((0, 0, 0), (0, 0, -1), t_max=4.0)
        hits, _ = cast_rays_brute(rays, tris)
        assert not bool(hits.hit[0])

    def test_barycentrics(self):
        # hit_point = (1-u-v)*v0 + u*v1 + v*v2
        v0, v1, v2 = (0, 0, -5), (2, 0, -5), (0, 2, -5)
        tris = single_tri(v0, v1, v2)
        rays = make_rays((0.5, 0.5, 0), (0, 0, -1))
        hits, _ = cast_rays_brute(rays, tris)
        assert bool(hits.hit[0])
        u, v = float(hits.u[0]), float(hits.v[0])
        assert u == pytest.approx(0.25, abs=1e-5)
        assert v == pytest.approx(0.25, abs=1e-5)
        recon = (
            (1 - u - v) * np.asarray(v0) + u * np.asarray(v1) + v * np.asarray(v2)
        )
        np.testing.assert_allclose(np.asarray(hits.position[0]), recon, atol=1e-5)

    def test_closest_wins(self):
        near = ((-1, -1, -3), (1, -1, -3), (0, 1, -3))
        far = ((-1, -1, -8), (1, -1, -8), (0, 1, -8))
        tris = make_triangles(
            np.asarray([far[0], near[0]], np.float32),
            np.asarray([far[1], near[1]], np.float32),
            np.asarray([far[2], near[2]], np.float32),
        )
        rays = make_rays((0, 0, 0), (0, 0, -1))
        hits, _ = cast_rays_brute(rays, tris)
        assert int(hits.prim_id[0]) == 1
        assert np.isclose(float(hits.t[0]), 3.0, atol=1e-5)

    def test_exact_tie_lowest_index_wins(self):
        # Two identical coplanar triangles: serial reference loop keeps the
        # first (strictly-closer update, triangle.h:93).
        tri = ((-1, -1, -5), (1, -1, -5), (0, 1, -5))
        tris = make_triangles(
            np.asarray([tri[0], tri[0]], np.float32),
            np.asarray([tri[1], tri[1]], np.float32),
            np.asarray([tri[2], tri[2]], np.float32),
        )
        rays = make_rays((0, 0, 0), (0, 0, -1))
        hits, _ = cast_rays_brute(rays, tris)
        assert int(hits.prim_id[0]) == 0

    def test_layer_mask_filtering(self):
        # Near tri on layer 2, far tri on layer 1. Querying layer 1 must see
        # *through* the near triangle (filter during iteration,
        # ray_scene.h:124).
        near = ((-1, -1, -3), (1, -1, -3), (0, 1, -3))
        far = ((-1, -1, -8), (1, -1, -8), (0, 1, -8))
        tris = make_triangles(
            np.asarray([near[0], far[0]], np.float32),
            np.asarray([near[1], far[1]], np.float32),
            np.asarray([near[2], far[2]], np.float32),
            layers=np.asarray([0b10, 0b01], np.int32),
        )
        rays = make_rays((0, 0, 0), (0, 0, -1))
        hits, _ = cast_rays_brute(rays, tris, query_mask=0b01)
        assert int(hits.prim_id[0]) == 1
        assert np.isclose(float(hits.t[0]), 8.0, atol=1e-5)
        assert int(hits.hit_layers[0]) == 0b01
        # All layers: near tri wins.
        hits_all, _ = cast_rays_brute(rays, tris, query_mask=ALL_LAYERS)
        assert int(hits_all.prim_id[0]) == 0

    def test_any_hit(self):
        tris = single_tri((-1, -1, -5), (1, -1, -5), (0, 1, -5))
        rays = make_rays(
            np.asarray([[0, 0, 0], [10, 0, 0]], np.float32),
            np.asarray([[0, 0, -1], [0, 0, -1]], np.float32),
        )
        occ = any_hit_brute(rays, tris)
        assert bool(occ[0]) and not bool(occ[1])


class TestSlabTest:
    def test_hit_and_entry_t(self):
        o = jnp.asarray([0.0, 0.0, 0.0])
        inv = safe_inv_direction(jnp.asarray([0.0, 0.0, -1.0]))
        hit, tentry = slab_test(
            o, inv, jnp.float32(T_MAX_DEFAULT),
            jnp.asarray([-1.0, -1.0, -5.0]), jnp.asarray([1.0, 1.0, -3.0]),
        )
        assert bool(hit)
        assert float(tentry) == pytest.approx(3.0, abs=1e-5)

    def test_miss(self):
        o = jnp.asarray([5.0, 0.0, 0.0])
        inv = safe_inv_direction(jnp.asarray([0.0, 0.0, -1.0]))
        hit, _ = slab_test(
            o, inv, jnp.float32(T_MAX_DEFAULT),
            jnp.asarray([-1.0, -1.0, -5.0]), jnp.asarray([1.0, 1.0, -3.0]),
        )
        assert not bool(hit)

    def test_origin_inside_box(self):
        o = jnp.asarray([0.0, 0.0, 0.0])
        inv = safe_inv_direction(jnp.asarray([1.0, 0.0, 0.0]))
        hit, tentry = slab_test(
            o, inv, jnp.float32(T_MAX_DEFAULT),
            jnp.asarray([-1.0, -1.0, -1.0]), jnp.asarray([1.0, 1.0, 1.0]),
        )
        assert bool(hit)
        assert float(tentry) < 0.0  # entry behind origin

    def test_box_behind(self):
        o = jnp.asarray([0.0, 0.0, 10.0])
        inv = safe_inv_direction(jnp.asarray([0.0, 0.0, 1.0]))
        hit, _ = slab_test(
            o, inv, jnp.float32(T_MAX_DEFAULT),
            jnp.asarray([-1.0, -1.0, -5.0]), jnp.asarray([1.0, 1.0, -3.0]),
        )
        assert not bool(hit)

    def test_tmax_clip(self):
        # Box entry at t=3 but ray best-t is 2 -> culled.
        o = jnp.asarray([0.0, 0.0, 0.0])
        inv = safe_inv_direction(jnp.asarray([0.0, 0.0, -1.0]))
        hit, _ = slab_test(
            o, inv, jnp.float32(2.0),
            jnp.asarray([-1.0, -1.0, -5.0]), jnp.asarray([1.0, 1.0, -3.0]),
        )
        assert not bool(hit)

    def test_axis_parallel_ray_safe_inverse(self):
        # Direction with a zero component: safe inverse must not produce NaN.
        o = jnp.asarray([0.0, 0.0, 0.0])
        inv = safe_inv_direction(jnp.asarray([0.0, 1.0, 0.0]))
        assert bool(jnp.all(jnp.isfinite(inv)))
        hit, _ = slab_test(
            o, inv, jnp.float32(T_MAX_DEFAULT),
            jnp.asarray([-1.0, 2.0, -1.0]), jnp.asarray([1.0, 4.0, 1.0]),
        )
        assert bool(hit)


class TestCamera:
    def test_debug_grid_matches_reference_math(self):
        origin = (1.0, 2.0, 3.0)
        forward = (0.0, 0.0, -1.0)
        gw, gh, fov = 16, 12, 60.0
        rays = debug_grid_rays(origin, forward, gw, gh, fov)
        assert rays.count == gw * gh

        # Independent numpy recomputation (raytracer_debug.cpp:572-596).
        fwd = np.array(forward, np.float32)
        up_hint = np.array([0, 1, 0], np.float32)
        right = np.cross(fwd, up_hint)
        right /= np.linalg.norm(right)
        up = np.cross(right, fwd)
        half_w = np.tan(np.deg2rad(fov) / 2)
        half_h = half_w * gh / gw
        dirs = np.asarray(rays.direction).reshape(gh, gw, 3)
        for y in [0, 5, 11]:
            for x in [0, 7, 15]:
                u = (2.0 * (x + 0.5) / gw - 1.0) * half_w
                v = (2.0 * (y + 0.5) / gh - 1.0) * half_h
                d = fwd + right * u + up * v
                d /= np.linalg.norm(d)
                np.testing.assert_allclose(dirs[y, x], d, atol=1e-5)
        np.testing.assert_allclose(
            np.asarray(rays.origin[0]), origin, atol=1e-6
        )

    def test_perspective_center_ray_is_forward(self):
        cam = CameraParams.look_at((0, 0, 5), (0, 0, 0), fov_degrees=60.0)
        rays = generate_rays(cam, 4, 4)
        d = np.asarray(rays.direction).reshape(4, 4, 3)
        # Average of the 4 center pixels ~ forward.
        center = d[1:3, 1:3].mean(axis=(0, 1))
        center /= np.linalg.norm(center)
        np.testing.assert_allclose(center, [0, 0, -1], atol=1e-3)
        # Raster order: y=0 row looks *up* (positive world +y component).
        assert d[0, :, 1].mean() > 0.0
        assert d[3, :, 1].mean() < 0.0

    def test_orthographic_rays_parallel(self):
        cam = CameraParams.look_at(
            (0, 0, 5), (0, 0, 0), ortho=True, ortho_size=4.0
        )
        rays = generate_rays(cam, 8, 8)
        d = np.asarray(rays.direction)
        np.testing.assert_allclose(d, np.tile([[0, 0, -1]], (64, 1)), atol=1e-6)
        o = np.asarray(rays.origin)
        assert o[:, 0].min() == pytest.approx(-2 * 7 / 8, abs=1e-5)
        assert o[:, 0].max() == pytest.approx(2 * 7 / 8, abs=1e-5)

    def test_sphere_render_hit_pattern(self):
        # A sphere in front of the camera: center rays hit, corner rays miss.
        sphere = meshes.uv_sphere(radius=1.0, rings=12, segments=24)
        tris = make_triangles(sphere[:, 0], sphere[:, 1], sphere[:, 2])
        cam = CameraParams.look_at((0, 0, 5), (0, 0, 0), fov_degrees=60.0)
        rays = generate_rays(cam, 16, 16)
        hits, stats = cast_rays_brute(rays, tris)
        img = np.asarray(hits.hit).reshape(16, 16)
        assert img[8, 8]
        assert not img[0, 0] and not img[0, 15] and not img[15, 0]
        # hit t ~ 4 (sphere front face at z=1, camera z=5)
        assert float(hits.t[8 * 16 + 8]) == pytest.approx(4.0, abs=0.15)
        assert int(stats.rays_cast) == 256


class TestMeshes:
    def test_sphere_closed_and_near_radius(self):
        s = meshes.uv_sphere(radius=2.0, rings=8, segments=16)
        r = np.linalg.norm(s.reshape(-1, 3), axis=1)
        np.testing.assert_allclose(r, 2.0, atol=1e-5)

    def test_room_and_box_counts(self):
        assert meshes.cornell_room().shape == (10, 3, 3)
        assert meshes.box().shape == (12, 3, 3)
        assert meshes.plane(subdiv=4).shape == (32, 3, 3)

    def test_obj_roundtrip(self, tmp_path):
        p = tmp_path / "tri.obj"
        p.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\nf 1 2 3\nf 2 4 3\n")
        t = meshes.load_obj(str(p))
        assert t.shape == (2, 3, 3)
        np.testing.assert_allclose(t[0, 1], [1, 0, 0])
